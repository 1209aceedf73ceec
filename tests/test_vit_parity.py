"""DINOv2 ViT forward parity: vdn (flax) vs the torch reference.

Strategy: random-init the reference encoder, convert its state_dict with
vdn.core.convert, run both on the same input, compare intermediate layers.
"""

import numpy as np
import pytest
import torch

from tests import _reference

_reference.add_reference_to_path()

from depth_anything_v2.dinov2 import DINOv2  # noqa: E402  (oracle)

from vdn.core.convert import convert_torch_state  # noqa: E402
from vdn.nn.vit import make_vit, INTERMEDIATE_LAYER_IDX  # noqa: E402


@pytest.fixture(scope="module")
def vits_pair():
    torch.manual_seed(0)
    ref = DINOv2("vits").eval()
    params = {"params": convert_torch_state(_reference.state_dict_numpy(ref))}
    model = make_vit("vits")
    return ref, model, params


def _run_pair(ref, model, params, h, w, idx):
    rng = np.random.default_rng(42)
    x = rng.standard_normal((2, h, w, 3)).astype(np.float32)
    with torch.no_grad():
        ref_out = ref.get_intermediate_layers(
            torch.from_numpy(np.moveaxis(x, -1, 1).copy()), idx,
            return_class_token=True)
    got = model.apply(params, np.asarray(x), idx,
                      method=model.get_intermediate_layers)
    return ref_out, got


@pytest.mark.parametrize("hw", [(518, 518), (252, 336)])
def test_intermediate_layers_match(vits_pair, hw):
    ref, model, params = vits_pair
    idx = INTERMEDIATE_LAYER_IDX["vits"]
    ref_out, got = _run_pair(ref, model, params, *hw, idx)
    assert len(ref_out) == len(got) == 4
    for (r_tok, r_cls), (g_tok, g_cls) in zip(ref_out, got):
        np.testing.assert_allclose(np.asarray(g_tok), r_tok.numpy(),
                                   rtol=1e-4, atol=1e-4)
        np.testing.assert_allclose(np.asarray(g_cls), r_cls.numpy(),
                                   rtol=1e-4, atol=1e-4)


def test_param_tree_is_exhaustive(vits_pair):
    """Every converted reference tensor must land on a vdn param slot."""
    import jax
    ref, model, params = vits_pair
    init = model.init(jax.random.PRNGKey(0),
                      np.zeros((1, 56, 56, 3), np.float32))
    init_paths = _paths(init["params"])
    conv_paths = _paths(params["params"])
    assert conv_paths == init_paths


def _paths(tree, prefix=()):
    out = set()
    for k, v in tree.items():
        if isinstance(v, dict):
            out |= _paths(v, prefix + (k,))
        else:
            out.add("/".join(prefix + (k,)) + f":{tuple(np.shape(v))}")
    return out
