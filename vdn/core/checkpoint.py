"""Checkpoint IO.

- ``load_torch_checkpoint``: reads a torch zip-format ``.pth``/``.pt`` file
  into {name: np.ndarray} *without importing torch* (zipfile + a custom
  Unpickler that resolves persistent storage ids against the zip payload).
  Needed for weight parity with the reference model zoo
  (reference run.py:36, scripts/train_v4.py:432-441).
- orbax wrappers for native checkpoints of vdn param/optimizer pytrees.
"""

from __future__ import annotations

import io
import os
import pickle
import struct
import zipfile
from typing import Any, Dict, Optional

import numpy as np

__all__ = ["load_torch_checkpoint", "save_pytree", "restore_pytree"]

_DTYPE_MAP = {
    "FloatStorage": np.float32,
    "DoubleStorage": np.float64,
    "HalfStorage": np.float16,
    "BFloat16Storage": None,  # handled specially (numpy has no bf16)
    "LongStorage": np.int64,
    "IntStorage": np.int32,
    "ShortStorage": np.int16,
    "CharStorage": np.int8,
    "ByteStorage": np.uint8,
    "BoolStorage": np.bool_,
}


class _OrderedDictShim(dict):
    pass


class _StorageStub:
    def __init__(self, storage_type: str, key: str, numel: int):
        self.storage_type = storage_type
        self.key = key
        self.numel = numel


def _bf16_to_f32(raw: bytes, count: int) -> np.ndarray:
    u16 = np.frombuffer(raw, dtype=np.uint16, count=count)
    return (u16.astype(np.uint32) << 16).view(np.float32)


class _TorchUnpickler(pickle.Unpickler):
    def __init__(self, file, zf: zipfile.ZipFile, prefix: str):
        super().__init__(file)
        self._zf = zf
        self._prefix = prefix

    def persistent_load(self, pid):
        assert pid[0] == "storage", pid
        storage_type, key, _location, numel = pid[1], pid[2], pid[3], pid[4]
        name = getattr(storage_type, "__name__", str(storage_type))
        # torch>=2 uses UntypedStorage with dtype in the typename wrapper
        return _StorageStub(name, key, numel)

    def find_class(self, module, name):
        if module.startswith("torch") or module == "collections":
            if name == "OrderedDict":
                # real dict subclass: state_dicts carry a _metadata
                # attribute, set via the pickle BUILD opcode
                return _OrderedDictShim
            if name.endswith("Storage") or name == "UntypedStorage":
                return type(name, (), {"__name__": name})
            if name == "_rebuild_tensor_v2":
                return _rebuild_tensor_v2_factory(self._zf, self._prefix)
            if name == "_rebuild_parameter":
                return lambda data, requires_grad, hooks: data
            if name in ("int64", "float32", "float16", "bfloat16"):
                return name
        raise pickle.UnpicklingError(
            f"refusing to load {module}.{name} from checkpoint")


def _rebuild_tensor_v2_factory(zf: zipfile.ZipFile, prefix: str):
    def rebuild(storage: _StorageStub, storage_offset, size, stride,
                requires_grad=False, backward_hooks=None, metadata=None):
        raw = zf.read(f"{prefix}/data/{storage.key}")
        if storage.storage_type == "BFloat16Storage":
            flat = _bf16_to_f32(raw, storage.numel)
            itemsize = 2
        else:
            dt = _DTYPE_MAP.get(storage.storage_type)
            if dt is None:
                raise ValueError(
                    f"unsupported storage {storage.storage_type}")
            flat = np.frombuffer(raw, dtype=dt, count=storage.numel)
            itemsize = np.dtype(dt).itemsize
        del itemsize
        if not size:
            return flat[storage_offset].copy()
        arr = np.lib.stride_tricks.as_strided(
            flat[storage_offset:],
            shape=tuple(size),
            strides=tuple(s * flat.itemsize for s in stride))
        return np.ascontiguousarray(arr)

    return rebuild


def load_torch_checkpoint(path: str) -> Dict[str, np.ndarray]:
    """Load a torch zip-format checkpoint into a flat {key: ndarray} dict.

    Handles both bare state_dicts and {'model'/'state_dict': ...} wrappers
    (the layouts used across the reference training scripts)."""
    with zipfile.ZipFile(path) as zf:
        pkl_name = next(n for n in zf.namelist()
                        if n.endswith("data.pkl"))
        prefix = pkl_name[: -len("/data.pkl")]
        with zf.open(pkl_name) as f:
            obj = _TorchUnpickler(io.BytesIO(f.read()), zf, prefix).load()
    for wrapper_key in ("model", "state_dict", "module"):
        if isinstance(obj, dict) and wrapper_key in obj and isinstance(
                obj[wrapper_key], dict):
            obj = obj[wrapper_key]
    if not isinstance(obj, dict):
        raise ValueError(f"unexpected checkpoint structure in {path}")
    return {k: np.asarray(v) for k, v in obj.items()
            if isinstance(v, np.ndarray)}


def save_pytree(path: str, tree: Any):
    import orbax.checkpoint as ocp
    ckptr = ocp.StandardCheckpointer()
    ckptr.save(os.path.abspath(path), tree, force=True)
    ckptr.wait_until_finished()


def restore_pytree(path: str, template: Optional[Any] = None) -> Any:
    import orbax.checkpoint as ocp
    ckptr = ocp.StandardCheckpointer()
    if template is not None:
        return ckptr.restore(os.path.abspath(path), template)
    return ckptr.restore(os.path.abspath(path))


class TrainCheckpointer:
    """Async orbax CheckpointManager over the full train state
    (params + optimizer + step + epoch).

    Saves return immediately (the serialization runs in the background so
    the accelerator keeps training — the orbax equivalent of the async-checkpoint
    requirement in SURVEY §5); ``wait()`` or the final ``close()`` blocks
    until durable.  ``restore_latest`` + BatchLoader.set_epoch give
    deterministic resume.
    """

    def __init__(self, directory: str, max_to_keep: int = 3):
        import orbax.checkpoint as ocp
        self._mgr = ocp.CheckpointManager(
            os.path.abspath(directory),
            options=ocp.CheckpointManagerOptions(
                max_to_keep=max_to_keep, enable_async_checkpointing=True))

    def save(self, step: int, state: Any):
        import orbax.checkpoint as ocp
        self._mgr.save(step, args=ocp.args.StandardSave(state))

    def latest_step(self) -> Optional[int]:
        return self._mgr.latest_step()

    def restore_latest(self, template: Any) -> Any:
        import orbax.checkpoint as ocp
        step = self._mgr.latest_step()
        if step is None:
            return None
        return self._mgr.restore(step,
                                 args=ocp.args.StandardRestore(template))

    def wait(self):
        self._mgr.wait_until_finished()

    def close(self):
        self._mgr.wait_until_finished()
        self._mgr.close()
