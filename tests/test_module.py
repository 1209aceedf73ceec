"""vdn.nn.module: its semantics, and for every model family at tiny size
the same parameter trees (names, shapes and initial values) and the same
outputs as flax.linen, which the checkpoint converter's names follow.

The flax twin of each model is the same source imported with
``vdn.nn.module`` standing in for flax.linen (see ``flax_twin``)."""

import contextlib
import importlib
import sys
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from vdn.nn import module as nn

# -------------------------------------------------------------- semantics


class Dense(nn.Module):
    features: int

    @nn.compact
    def __call__(self, x):
        w = self.param("kernel", jax.nn.initializers.lecun_normal(),
                       (x.shape[-1], self.features))
        return x @ w


class Stack(nn.Module):
    width: int = 4

    @nn.compact
    def __call__(self, x):
        x = Dense(self.width)(x)           # Dense_0
        x = Dense(self.width)(x)           # Dense_1
        return Dense(2, name="out")(x)

    def twice(self, x):
        return self(x) + self(x)           # second call reuses the names


class WithSetup(nn.Module):
    n: int = 3

    def setup(self):
        self.layers = [Dense(4) for _ in range(self.n)]
        self.head = Dense(1)
        self.bias = self.param("bias", jax.nn.initializers.zeros, (1,))

    def __call__(self, x):
        for layer in self.layers:
            x = layer(x)
        return self.head(x) + self.bias

    def first(self, x):
        return self.layers[0](x)


def test_compact_autonames_and_explicit_names():
    p = Stack().init(jax.random.PRNGKey(0), jnp.ones((2, 3)))["params"]
    assert sorted(p) == ["Dense_0", "Dense_1", "out"]
    assert p["Dense_0"]["kernel"].shape == (3, 4)
    assert p["out"]["kernel"].shape == (4, 2)


def test_repeated_compact_call_shares_parameters():
    m = Stack()
    x = jnp.ones((2, 3))
    p = m.init(jax.random.PRNGKey(0), x, method="twice")
    assert sorted(p["params"]) == ["Dense_0", "Dense_1", "out"]
    np.testing.assert_allclose(m.apply(p, x, method=m.twice),
                               2 * m.apply(p, x), rtol=1e-6)


def test_setup_names_attributes_and_list_items():
    m = WithSetup()
    p = m.init(jax.random.PRNGKey(0), jnp.ones((2, 4)))["params"]
    assert sorted(p) == ["bias", "head", "layers_0", "layers_1",
                         "layers_2"]


def test_lazy_parameters_follow_the_method_run():
    m = WithSetup()
    p = m.init(jax.random.PRNGKey(0), jnp.ones((2, 4)), method=m.first)
    assert sorted(p["params"]) == ["bias", "layers_0"]


def test_method_forms_agree():
    m = WithSetup()
    x = jnp.arange(8.0).reshape(2, 4)
    p = m.init(jax.random.PRNGKey(1), x)
    a = m.apply(p, x, method=m.first)
    b = m.apply(p, x, method="first")
    c = m.apply(p, x, method=lambda mod, x: mod.layers[0](x))
    np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(a, c)


def test_missing_parameter_is_an_error():
    m = Stack()
    p = m.init(jax.random.PRNGKey(0), jnp.ones((2, 3)))
    del p["params"]["out"]
    with pytest.raises(KeyError, match="out/kernel"):
        m.apply(p, jnp.ones((2, 3)))


def test_unbound_param_is_an_error():
    with pytest.raises(ValueError, match="not bound"):
        Dense(3).param("kernel", jax.nn.initializers.zeros, (1,))


def test_initial_values_depend_on_seed_and_path_only():
    x = jnp.ones((2, 3))
    a = Stack().init(jax.random.PRNGKey(0), x)["params"]
    b = Stack().init(jax.random.PRNGKey(0), x, method="twice")["params"]
    c = Stack().init(jax.random.PRNGKey(1), x)["params"]
    np.testing.assert_array_equal(a["Dense_1"]["kernel"],
                                  b["Dense_1"]["kernel"])
    assert not np.allclose(a["Dense_1"]["kernel"], c["Dense_1"]["kernel"])
    assert not np.allclose(a["Dense_0"]["kernel"][:, :2],
                           a["out"]["kernel"][:3])


def test_remat_matches_plain_and_takes_static_args():
    class Scaled(nn.Module):
        @nn.compact
        def __call__(self, x, factor):
            return jnp.tanh(Dense(3, name="d")(x)) * factor

    class Outer(nn.Module):
        remat: bool

        @nn.compact
        def __call__(self, x):
            cls = nn.remat(Scaled, static_argnums=(2,)) if self.remat \
                else Scaled
            return cls(name="inner")(x, 2.0).sum()

    x = jnp.linspace(-1, 1, 6).reshape(2, 3)
    p = Outer(False).init(jax.random.PRNGKey(0), x)
    assert sorted(p["params"]) == ["inner"]
    p2 = Outer(True).init(jax.random.PRNGKey(0), x)
    jax.tree.map(np.testing.assert_array_equal, p, p2)
    g1 = jax.grad(lambda p: Outer(False).apply(p, x))(p)
    g2 = jax.grad(lambda p: Outer(True).apply(p, x))(p)
    jax.tree.map(lambda a, b: np.testing.assert_allclose(a, b, rtol=1e-6),
                 g1, g2)


def test_embed_table():
    class Tokens(nn.Module):
        def setup(self):
            self.tok = nn.Embed(3, 5)

        def __call__(self):
            return self.tok.embedding

    p = Tokens().init(jax.random.PRNGKey(0))
    assert p["params"]["tok"]["embedding"].shape == (3, 5)
    assert Tokens().apply(p).shape == (3, 5)


def test_modules_are_hashable_dataclasses():
    assert Dense(3) == Dense(3) and hash(Dense(3)) == hash(Dense(3))
    assert Dense(3) != Dense(4)


# ----------------------------------------------------- parity with flax

@contextlib.contextmanager
def flax_twin():
    """Within the block, ``vdn`` modules import afresh with flax.linen in
    place of vdn.nn.module (lazy imports inside the models resolve to the
    twin too); afterwards this process's vdn modules are restored."""
    fnn = pytest.importorskip("flax.linen")
    saved = {k: v for k, v in sys.modules.items()
             if k == "vdn" or k.startswith("vdn.")}
    for k in saved:
        del sys.modules[k]
    shim = types.ModuleType("vdn.nn.module")
    shim.Module, shim.compact = fnn.Module, fnn.compact
    shim.remat, shim.Embed = fnn.remat, fnn.Embed
    sys.modules["vdn.nn.module"] = shim
    try:
        yield importlib.import_module
    finally:
        for k in [k for k in sys.modules
                  if k == "vdn" or k.startswith("vdn.")]:
            del sys.modules[k]
        sys.modules.update(saved)


def _assert_same_tree(a, b, exact=True):
    fa = jax.tree_util.tree_flatten_with_path(a)[0]
    fb = jax.tree_util.tree_flatten_with_path(b)[0]
    assert [jax.tree_util.keystr(k) for k, _ in fa] == \
        [jax.tree_util.keystr(k) for k, _ in fb]
    for (k, x), (_, y) in zip(fa, fb):
        assert x.shape == y.shape, jax.tree_util.keystr(k)
        if exact:
            np.testing.assert_array_equal(np.asarray(x), np.asarray(y),
                                          err_msg=jax.tree_util.keystr(k))
        else:
            np.testing.assert_allclose(np.asarray(x), np.asarray(y),
                                       rtol=1e-5, atol=1e-5,
                                       err_msg=jax.tree_util.keystr(k))


TINY_DPT = dict(encoder="vits", features=32, out_channels=(32, 32, 64, 64))
HIERA_TINY = dict(embed_dim=16, num_heads=1, stages=(1, 1, 2, 1),
                  global_att_blocks=(3,), window_spec=(4, 4, 4, 4),
                  window_pos_embed_bkg_spatial_size=(4, 4))


def _video_depth(mod, remat):
    return mod.VideoDepthAnything(remat=remat, num_frames=4, **TINY_DPT), \
        (jax.random.normal(jax.random.PRNGKey(1), (1, 2, 28, 42, 3)),), None


def _image_memory(mod, _):
    def full(m, x):
        depth, mem = m(x, None)
        entry = m.encode_memory(mem, depth)
        return depth, entry
    return mod.DepthAnythingV2(**TINY_DPT), \
        (jax.random.normal(jax.random.PRNGKey(2), (1, 28, 28, 3)),), full


def _metric(mod, _):
    return mod.MetricDepthAnythingV2(**TINY_DPT), \
        (jax.random.normal(jax.random.PRNGKey(3), (1, 28, 28, 3)),), None


def _refine(mod, version):
    kw = dict(TINY_DPT, num_frames=4)
    if version == 5:
        kw["internal_size"] = 28
    return mod.RefineVideoDepth(version=version, **kw), \
        (jax.random.uniform(jax.random.PRNGKey(4), (1, 2, 28, 28)) * 6e4,), \
        None


def _sam2(mod, video):
    cls = mod.Sam2VideoModel if video else mod.Sam2ImageModel
    return cls(trunk_variant="twin_tiny", d_model=64, image_size=128), \
        (jax.random.normal(jax.random.PRNGKey(5), (1, 128, 128, 3)),), None


def _v1(mod, _):
    return mod.VideoDepthEstimationModel(sequence_length=2,
                                         encoder="twin_tiny"), \
        (jax.random.uniform(jax.random.PRNGKey(6), (1, 2, 32, 32)),
         jax.random.normal(jax.random.PRNGKey(7), (1, 2, 32, 32, 3))), None


FAMILIES = {
    "video_depth": ("vdn.models.video_depth_anything", _video_depth, False),
    "video_depth_remat": ("vdn.models.video_depth_anything", _video_depth,
                          True),
    "image_memory": ("vdn.models.depth_anything_v2", _image_memory, None),
    "metric_depth": ("vdn.models.metric_depth", _metric, None),
    "refine_v2": ("vdn.models.refine", _refine, 2),
    "refine_v3": ("vdn.models.refine", _refine, 3),
    "refine_v4": ("vdn.models.refine", _refine, 4),
    "refine_v5": ("vdn.models.refine", _refine, 5),
    "sam2_image": ("vdn.models.sam2_image", _sam2, False),
    "sam2_video": ("vdn.models.sam2_video", _sam2, True),
    "dual_hiera_v1": ("vdn.models.video_depth_v1", _v1, None),
}


@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_same_trees_and_outputs_as_flax(family):
    modname, build, arg = FAMILIES[family]
    importlib.import_module("vdn.nn.hiera").HIERA_CONFIGS.setdefault(
        "twin_tiny", HIERA_TINY)
    model, args, method = build(importlib.import_module(modname), arg)
    key = jax.random.PRNGKey(0)
    p_mine = model.init(key, *args, method=method)
    with flax_twin() as twin_import:
        twin_import("vdn.nn.hiera").HIERA_CONFIGS["twin_tiny"] = HIERA_TINY
        fmodel, _, _ = build(twin_import(modname), arg)
        p_flax = fmodel.init(key, *args, method=method)
        out_flax = fmodel.apply(p_flax, *args, method=method)
    _assert_same_tree(p_mine, p_flax)
    out_mine = model.apply(p_flax, *args, method=method)
    _assert_same_tree(out_mine, out_flax, exact=False)
