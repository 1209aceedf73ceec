"""Test configuration: run everything on a virtual 8-device CPU mesh.

Sharded code paths (data parallel, sequence parallel) execute host-side on
8 virtual devices, so multi-device logic is exercised without hardware.
Must run before jax initializes.  Tests marked ``gpu`` skip there (the
``gpu_device`` fixture decides) and run on a card with
``JAX_PLATFORMS=cuda python -m pytest -m gpu tests/``.
"""

import os

os.environ.setdefault("JAX_PLATFORMS", "cpu")
flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    flags = (flags + " --xla_force_host_platform_device_count=8").strip()
if "xla_cpu_collective_call_terminate_timeout_seconds" not in flags:
    # 8 mesh partitions time-slicing few host cores: the first thread at a
    # psum/ppermute can legitimately wait (devices-1) x partition-compute,
    # which overruns XLA:CPU's default 40 s rendezvous termination timeout
    # and aborts the test process.
    flags += (" --xla_cpu_collective_call_warn_stuck_timeout_seconds=120"
              " --xla_cpu_collective_call_terminate_timeout_seconds=1200")
os.environ["XLA_FLAGS"] = flags
os.environ.setdefault("JAX_ENABLE_X64", "0")

import jax  # noqa: E402
import pytest  # noqa: E402

ON_CPU = os.environ["JAX_PLATFORMS"] == "cpu"
jax.config.update("jax_platforms", os.environ["JAX_PLATFORMS"])
# XLA CPU lowers some conv shapes (e.g. 7x7/s4 patchify) to a reduced-
# precision oneDNN fast path under the default precision config (~2e-3
# relative error vs fp64 — enough to sink parity tolerances).  Parity
# tests compare exact fp32 numerics, so force full precision; production
# code keeps the default (bf16 compute is the deliberate policy).
jax.config.update("jax_default_matmul_precision", "highest")

# Persistent compilation cache (vdn.core.compile_cache): the trainer and
# pipeline tests compile the same steps repeatedly across processes.
from vdn.core.compile_cache import enable_compile_cache  # noqa: E402

enable_compile_cache()

if ON_CPU:
    assert jax.device_count() == 8, "expected 8 virtual CPU devices"


@pytest.fixture
def gpu_device():
    """The first GPU; skips the test where JAX has none."""
    dev = jax.devices()[0]
    if dev.platform != "gpu":
        pytest.skip("needs a GPU: JAX_PLATFORMS=cuda python -m pytest "
                    "-m gpu tests/")
    return dev
