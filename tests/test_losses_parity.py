"""Loss-stack parity vs reference loss/loss.py and utils/normal_utils.py."""

import sys
import types

import numpy as np
import pytest
import torch

from tests import _reference

_reference.add_reference_to_path()

# the reference imports pytorch_msssim at module level; shim it (the SSIM
# term is off by default — ssim_loss_scale=0 in every training config)
if "pytorch_msssim" not in sys.modules:
    mod = types.ModuleType("pytorch_msssim")

    class MS_SSIM:  # pragma: no cover - never called with scale 0
        def __init__(self, **kw):
            pass

    mod.MS_SSIM = MS_SSIM
    sys.modules["pytorch_msssim"] = mod

from loss.loss import (VideoDepthLoss, VideoNormalLoss,  # noqa: E402
                       TrimmedMAELoss, TemporalGradientMatchingLoss,
                       normalize_prediction_robust as ref_norm_robust)
from utils.normal_utils import normal_vector as ref_normal_vector  # noqa

from vdn.ops.normals import normal_vector  # noqa: E402
from vdn.train import losses as L  # noqa: E402


def _clip(seed, b=2, t=4, h=24, w=32):
    rng = np.random.default_rng(seed)
    pred = rng.random((b, t, h, w)).astype(np.float32) * 5
    target = rng.random((b, t, h, w)).astype(np.float32) * 5 + 0.1
    mask = (rng.random((b, t, h, w)) > 0.2)
    return pred, target, mask


def test_video_depth_loss_matches():
    pred, target, mask = _clip(0)
    ref = VideoDepthLoss(alpha=0.5, stable_scale=10.0, ssim_loss_scale=0.0)
    with torch.no_grad():
        ref_out = ref(torch.from_numpy(pred), torch.from_numpy(target),
                      torch.from_numpy(mask))
    got = L.video_depth_loss(pred, target, mask.astype(np.float32),
                             alpha=0.5, stable_scale=10.0)
    for key in ["spatial_loss", "stable_loss", "absRel_loss", "d1",
                "total_loss"]:
        np.testing.assert_allclose(float(got[key]), float(ref_out[key]),
                                   rtol=2e-4, atol=1e-5, err_msg=key)


def test_trimmed_mae_with_trim():
    pred, target, mask = _clip(1)
    ref = TrimmedMAELoss(trim=0.2)
    with torch.no_grad():
        r = ref(torch.from_numpy(pred[0]), torch.from_numpy(target[0]),
                torch.from_numpy(mask[0].astype(np.float32)))
    g = L.trimmed_mae_loss(pred[0], target[0], mask[0].astype(np.float32),
                           trim=0.2)
    np.testing.assert_allclose(float(g), float(r), rtol=1e-5)


def test_normalize_robust_matches():
    pred, _, mask = _clip(2)
    with torch.no_grad():
        r, (rm, rs) = ref_norm_robust(torch.from_numpy(pred[0]),
                                      torch.from_numpy(
                                          mask[0].astype(np.float32)))
    g, (gm, gs) = L.normalize_prediction_robust(pred[0],
                                                mask[0].astype(np.float32))
    np.testing.assert_allclose(np.asarray(gm), rm.numpy(), rtol=1e-5)
    np.testing.assert_allclose(np.asarray(gs), rs.numpy(), rtol=1e-5)
    np.testing.assert_allclose(np.asarray(g), r.numpy(), rtol=1e-4,
                               atol=1e-5)


def test_tgm_multiscale_matches():
    pred, target, mask = _clip(3, t=8)
    ref = TemporalGradientMatchingLoss(trim=0.0, temp_grad_scales=3,
                                       temp_grad_decay=0.5)
    with torch.no_grad():
        r = ref(torch.from_numpy(pred), torch.from_numpy(target),
                torch.from_numpy(mask))
    g = L.temporal_gradient_matching_loss(pred, target,
                                          mask.astype(np.float32),
                                          trim=0.0, scales=3, decay=0.5)
    np.testing.assert_allclose(float(g), float(r), rtol=1e-4)


def test_normal_loss_and_vector_match():
    rng = np.random.default_rng(4)
    depth = rng.random((2, 3, 16, 20)).astype(np.float32)
    mask = rng.random((2, 3, 16, 20)) > 0.1
    with torch.no_grad():
        ref_n = ref_normal_vector(
            torch.from_numpy(depth[:, :, None])).numpy()  # (B,S,3,H,W)
    got_n = np.asarray(normal_vector(depth))  # (B,S,H,W,3)
    np.testing.assert_allclose(np.moveaxis(got_n, -1, 2), ref_n,
                               rtol=1e-4, atol=1e-5)

    ref_loss = VideoNormalLoss()
    with torch.no_grad():
        r = ref_loss(torch.from_numpy(np.ascontiguousarray(
                         np.moveaxis(got_n, -1, 2))),
                     torch.from_numpy(ref_n), torch.from_numpy(mask))
    g = L.video_normal_loss(got_n, np.moveaxis(ref_n, 2, -1),
                            mask.astype(np.float32))
    np.testing.assert_allclose(float(g["normal_loss"]),
                               float(r["normal_loss"]), rtol=1e-4,
                               atol=1e-6)


def test_ssim_cs_loss_separable_conv_blur():
    """The SSIM blur is two VALID depthwise convs ; check the
    whole term against a direct numpy np.convolve implementation of the
    same math (the reference MS_SSIM with weights [1,0,0,0,0],
    loss.py:296-323)."""
    rng = np.random.default_rng(5)
    b, t, h, w = 2, 2, 24, 28
    pred = rng.random((b, t, h, w)).astype(np.float32) * 3
    target = rng.random((b, t, h, w)).astype(np.float32) * 3
    mask = (rng.random((b, t, h, w)) > 0.2).astype(np.float32)

    win_size, sigma = 7, 1.5
    coords = np.arange(win_size, dtype=np.float64) - (win_size - 1) / 2
    g = np.exp(-coords ** 2 / (2 * sigma ** 2))
    g /= g.sum()

    m = mask
    mx = np.clip(np.maximum((pred * m).reshape(b, -1).max(1),
                            (target * m).reshape(b, -1).max(1)),
                 1e-8, None)
    p = (pred / mx[:, None, None, None]).reshape(-1, h, w)
    tt = (target / mx[:, None, None, None]).reshape(-1, h, w)

    def blur(x):
        x = np.apply_along_axis(
            lambda v: np.convolve(v, g, mode="valid"), 1, x)
        return np.apply_along_axis(
            lambda v: np.convolve(v, g, mode="valid"), 2, x)

    mu_p, mu_t = blur(p), blur(tt)
    spp = blur(p * p) - mu_p ** 2
    stt = blur(tt * tt) - mu_t ** 2
    spt = blur(p * tt) - mu_p * mu_t
    c2 = 0.03 ** 2
    cs = (2 * spt + c2) / (spp + stt + c2)
    want = 1.0 - np.maximum(cs, 0).mean()

    got = float(L.ssim_cs_loss(pred, target, mask, win_size=win_size,
                               sigma=sigma))
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5)
