"""Refinement models v2..v5 parity vs the torch reference."""

import importlib

import numpy as np
import pytest
import torch

from tests import _reference

_reference.add_reference_to_path()

from vdn.core.convert import convert_torch_state  # noqa: E402
from vdn.models.refine import (RefineVideoDepth,  # noqa: E402
                               match_seq_to_first_median)

CFG = dict(encoder="vits", features=64, out_channels=[48, 96, 192, 384])
VDN_CFG = dict(encoder="vits", features=64, out_channels=(48, 96, 192, 384))


def _depth_input(seed=0, b=1, s=3, h=56, w=56):
    rng = np.random.default_rng(seed)
    return (rng.random((b, s, h, w)) * 65535).astype(np.float32)


@pytest.mark.parametrize("version,module,extra", [
    (2, "models.video_depth_model_v2", {}),
    (3, "models.video_depth_model_v3", {}),
    (4, "models.video_depth_model_v4", {}),
    (5, "models.video_depth_model_v5", {"internal_size": 224}),
])
def test_refine_forward_matches(version, module, extra):
    torch.manual_seed(version)
    ref_mod = importlib.import_module(module)
    ref = ref_mod.VideoDepthAnything(**CFG).eval()
    params = {"params": convert_torch_state(_reference.state_dict_numpy(ref))}
    model = RefineVideoDepth(version=version, **VDN_CFG, **extra)

    x = _depth_input(seed=version)
    with torch.no_grad():
        ref_out = ref(torch.from_numpy(x)).numpy()
    got = np.asarray(model.apply(params, x))
    assert got.shape == ref_out.shape
    scale = max(1.0, np.abs(ref_out).max())
    np.testing.assert_allclose(got / scale, ref_out / scale,
                               rtol=1e-3, atol=2e-4)


def test_match_seq_to_first_median():
    ref_mod = importlib.import_module("models.video_depth_model_v3")
    x = _depth_input(seed=9, s=4) / 65535.0
    with torch.no_grad():
        r = ref_mod.match_seq_to_first_median(torch.from_numpy(x)).numpy()
    g = np.asarray(match_seq_to_first_median(x))
    np.testing.assert_allclose(g, r, rtol=1e-4, atol=1e-6)
