"""A small module system: dataclass modules with named, lazily created
parameters.

It covers what the models in this package use:

- ``Module`` subclasses are dataclasses.  Their methods run *bound* to a
  scope that holds the parameter tree.  A submodule made inside a
  ``@compact`` method is named ``ClassName_k`` (k counts that class within
  one call) unless given ``name=``; one assigned to an attribute in
  ``setup()`` takes the attribute's name, and the items of a list or tuple
  attribute take ``attr_i``.
- ``init(rng, *args, method=...)`` runs a method, creating parameters as
  they are first asked for, and returns ``{"params": tree}``;
  ``apply(variables, *args, method=...)`` runs a method against a tree.
  ``method`` is a method, its name, or a function ``f(module, *args)``.
  Trees are nested dicts keyed by submodule name, the layout
  ``vdn.core.convert`` writes from torch checkpoints.
- A parameter's initial value draws from
  ``fold_in(rng, sha1(path, k))``, where ``path`` is the module's name path
  and ``k`` counts the parameters created in that module.  A tree thus
  depends only on the seed and the names, and matches the trees (names,
  shapes and values) that ``flax.linen`` builds for the same modules.
- ``remat`` recomputes a module's forward pass in the backward pass.
"""

from __future__ import annotations

import copy
import dataclasses
import functools
import hashlib
import inspect
import threading
from typing import Any, Callable, Optional

import jax
import jax.numpy as jnp

__all__ = ["Module", "compact", "remat", "Embed"]


def _fold_in_static(rng, data):
    m = hashlib.sha1()
    for x in data:
        if isinstance(x, str):
            m.update(x.encode("utf-8"))
        else:
            m.update(x.to_bytes((x.bit_length() + 7) // 8, byteorder="big"))
    return jax.random.fold_in(
        rng, jnp.uint32(int.from_bytes(m.digest()[:4], byteorder="big")))


class _Scope:
    """Where one bound module reads and creates its parameters."""

    def __init__(self, root, path, rng, initializing):
        self.root = root                # whole tree of this init/apply
        self.path = path                # submodule names from the root
        self.rng = rng
        self.initializing = initializing
        self.counter = 0                # parameters created here so far
        self.children = {}

    def child(self, name: str) -> "_Scope":
        if name not in self.children:
            self.children[name] = _Scope(self.root, self.path + (name,),
                                         self.rng, self.initializing)
        return self.children[name]

    def subtree(self):
        node = self.root
        for p in self.path:
            node = node.get(p) if node is not None else None
        return node

    def param(self, name, init_fn, args):
        node = self.subtree()
        if node is not None and name in node:
            return node[name]
        if not self.initializing:
            raise KeyError("missing parameter "
                           + "/".join(self.path + (name,)))
        self.counter += 1
        value = init_fn(
            _fold_in_static(self.rng, self.path + (self.counter,)), *args)
        node = self.root
        for p in self.path:
            node = node.setdefault(p, {})
        node[name] = value
        return value


class _State:
    __slots__ = ("setup_done", "in_setup", "in_compact", "autoname")

    def __init__(self):
        self.setup_done = False
        self.in_setup = False
        self.in_compact = False
        self.autoname = {}


_context = threading.local()


def _stack():
    if not hasattr(_context, "stack"):
        _context.stack = []
    return _context.stack


def compact(fn):
    """Marks the method that may create submodules inline."""
    fn.compact = True
    return fn


def _wrap_method(fn):
    is_compact = getattr(fn, "compact", False)

    @functools.wraps(fn)
    def wrapped(self, *args, **kwargs):
        if self._scope is None:  # a plain call on an unbound config
            return fn(self, *args, **kwargs)
        self._try_setup()
        state = self._state
        outer = is_compact and not state.in_compact
        if outer:
            state.in_compact = True
        stack = _stack()
        stack.append(self)
        try:
            return fn(self, *args, **kwargs)
        finally:
            stack.pop()
            if outer:
                state.in_compact = False
                state.autoname.clear()

    return wrapped


def _resolve(module, method):
    if method is None:
        return type(module).__call__
    if isinstance(method, str):
        return getattr(type(module), method)
    return getattr(method, "__func__", method)


@dataclasses.dataclass(unsafe_hash=True)
class Module:
    """Base class: subclasses declare their configuration as dataclass
    fields and build themselves in ``setup()`` or one ``@compact``
    method."""
    name: Optional[str] = dataclasses.field(default=None, kw_only=True)

    def __init_subclass__(cls, **kwargs):
        super().__init_subclass__(**kwargs)
        fields = vars(cls).get("__annotations__", {})
        for attr, value in list(vars(cls).items()):
            if attr == "setup" or attr in fields or (
                    attr.startswith("__") and attr != "__call__"):
                continue
            if inspect.isfunction(value):
                setattr(cls, attr, _wrap_method(value))
        dataclasses.dataclass(cls, unsafe_hash="__hash__" not in vars(cls))

    def __post_init__(self):
        object.__setattr__(self, "_scope", None)
        object.__setattr__(self, "_state", _State())
        stack = _stack()
        parent = stack[-1] if stack else None
        object.__setattr__(self, "_parent", parent)
        if parent is None or (parent._state.in_setup and self.name is None):
            return  # top level, or named when setup() assigns it
        if self.name is None:
            prefix = type(self).__name__
            k = parent._state.autoname.get(prefix, 0)
            parent._state.autoname[prefix] = k + 1
            object.__setattr__(self, "name", f"{prefix}_{k}")
        object.__setattr__(self, "_scope", parent._scope.child(self.name))

    def __setattr__(self, key, value):
        state = self.__dict__.get("_state")
        if state is not None and state.in_setup:
            self._adopt(key, value)
        object.__setattr__(self, key, value)

    def __getattr__(self, key):
        # attributes made in setup() exist once setup has run
        state = self.__dict__.get("_state")
        if (state is not None and not state.setup_done
                and self.__dict__.get("_scope") is not None):
            self._try_setup()
            return object.__getattribute__(self, key)
        raise AttributeError(
            f"{type(self).__name__!r} object has no attribute {key!r}")

    def _adopt(self, key, value):
        if isinstance(value, Module):
            items = [(key, value)]
        elif isinstance(value, (list, tuple)):
            items = [(f"{key}_{i}", v) for i, v in enumerate(value)]
        else:
            return
        for name, sub in items:
            if (isinstance(sub, Module) and sub._scope is None
                    and sub._parent is self):
                if sub.name is None:
                    object.__setattr__(sub, "name", name)
                object.__setattr__(sub, "_scope",
                                   self._scope.child(sub.name))

    def _try_setup(self):
        state = self._state
        if state.setup_done:
            return
        state.setup_done = True
        if type(self).setup is Module.setup:
            return
        state.in_setup = True
        stack = _stack()
        stack.append(self)
        try:
            self.setup()
        finally:
            stack.pop()
            state.in_setup = False

    def _bound_copy(self, scope: _Scope) -> "Module":
        m = copy.copy(self)
        object.__setattr__(m, "_scope", scope)
        object.__setattr__(m, "_state", _State())
        object.__setattr__(m, "_parent", None)
        return m

    def setup(self):
        """Builds submodules and parameters; runs once, lazily, per
        binding."""

    def param(self, name: str, init_fn: Callable, *args) -> Any:
        """The parameter ``name``, created as ``init_fn(rng, *args)`` when
        initializing."""
        if self._scope is None:
            raise ValueError(f"{type(self).__name__} is not bound; call it "
                             "through init() or apply()")
        return self._scope.param(name, init_fn, args)

    def init(self, rngs, *args, method=None, **kwargs):
        """Runs ``method`` and returns the parameters it created."""
        rng = rngs["params"] if isinstance(rngs, dict) else rngs
        root = {}
        module = self._bound_copy(_Scope(root, (), rng, True))
        _resolve(self, method)(module, *args, **kwargs)
        return {"params": root}

    def apply(self, variables, *args, method=None, **kwargs):
        """Runs ``method`` with the parameters ``variables["params"]``."""
        module = self._bound_copy(
            _Scope(variables["params"], (), None, False))
        return _resolve(self, method)(module, *args, **kwargs)


def remat(module_cls, *, static_argnums=(), policy=None):
    """``module_cls`` with its forward pass recomputed in the backward pass
    (``jax.checkpoint``).  ``static_argnums`` count ``self`` as 0; those
    arguments are Python values fixed at trace time."""
    static = ({static_argnums} if isinstance(static_argnums, int)
              else set(static_argnums))
    call = module_cls.__call__

    def __call__(self, *args):
        if self._scope.initializing:
            return call(self, *args)
        dyn = [i for i in range(len(args)) if i + 1 not in static]

        def body(params, *dyn_args):
            full = list(args)
            for i, a in zip(dyn, dyn_args):
                full[i] = a
            return call(self._bound_copy(_Scope(params, (), None, False)),
                        *full)

        return jax.checkpoint(body, policy=policy)(
            self._scope.subtree(), *[args[i] for i in dyn])

    return type("Checkpoint" + module_cls.__name__, (module_cls,),
                {"__call__": __call__, "__module__": module_cls.__module__})


_EMBED_INIT = jax.nn.initializers.variance_scaling(1.0, "fan_in", "normal",
                                                   out_axis=0)


class Embed(Module):
    """A learned table ``embedding`` [num_embeddings, features]; callers
    read the table directly."""
    num_embeddings: int
    features: int
    param_dtype: Any = jnp.float32

    def setup(self):
        self.embedding = self.param(
            "embedding", _EMBED_INIT, (self.num_embeddings, self.features),
            self.param_dtype)
