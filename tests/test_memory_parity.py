"""DepthAnythingV2 with memory attention: parity vs the torch reference
across a 3-frame stateful sequence (no-mem branch, 1 memory, 2 memories)."""

import numpy as np
import pytest
import torch

from tests import _reference

_reference.add_reference_to_path()

from depth_anything_v2.depth_anything_v2 import (  # noqa: E402
    DepthAnythingV2 as RefDA2)

from vdn.core.convert import convert_torch_state  # noqa: E402
from vdn.models.depth_anything_v2 import DepthAnythingV2  # noqa: E402
from vdn.nn.memory import (init_memory_state,  # noqa: E402
                           update_memory_state)


@pytest.fixture(scope="module")
def pair():
    torch.manual_seed(0)
    ref = RefDA2(encoder="vits", features=64,
                 out_channels=[48, 96, 192, 384]).eval()
    params = {"params": convert_torch_state(_reference.state_dict_numpy(ref))}
    model = DepthAnythingV2(encoder="vits", features=64,
                            out_channels=(48, 96, 192, 384))
    return ref, model, params


def test_stateful_sequence_matches(pair):
    ref, model, params = pair
    rng = np.random.default_rng(0)
    frames = rng.standard_normal((3, 1, 126, 126, 3)).astype(np.float32)

    # run the reference, also capturing the memory-attended feature
    # (with random weights the relu'd depth can degenerate to zeros, so
    # the feature is the discriminative parity signal)
    ref.clear_memory()
    ref_depths, ref_feats = [], []
    with torch.no_grad():
        for i in range(3):
            t = torch.from_numpy(np.moveaxis(frames[i], -1, 1).copy())
            img_features = ref.pretrained.get_intermediate_layers(
                t, ref.intermediate_layer_idx["vits"],
                return_class_token=True)
            feat_mem = ref.memory_block(img_features[-1][0])
            ref_feats.append(feat_mem.numpy())
            ref_depths.append(ref(t).numpy())
            # note: ref(t) recomputes AND appends to memory; pop the extra
            # entry the feature-capture call above did NOT add
    assert len(ref.memory_block.memory_bank.get_memory()) == 3

    state = None
    got_d, got_f = [], []
    for i in range(3):
        depth, mem_feat = model.apply(params, frames[i], state)
        entry = model.apply(params, mem_feat, depth,
                            method=model.encode_memory)
        if state is None:
            state = init_memory_state(1, mem_feat.shape[1],
                                      mem_feat.shape[2], capacity=6)
        state = update_memory_state(state, *entry)
        got_d.append(np.asarray(depth))
        got_f.append(np.asarray(mem_feat))

    for i in range(3):
        np.testing.assert_allclose(got_f[i], ref_feats[i],
                                   rtol=1e-3, atol=1e-3,
                                   err_msg=f"feature {i}")
        np.testing.assert_allclose(got_d[i], ref_depths[i],
                                   rtol=1e-3, atol=1e-3,
                                   err_msg=f"depth {i}")
    # memory must actually influence later frames
    assert np.abs(got_f[1] - got_f[0]).max() > 1e-3
    assert int(state["count"]) == 3
