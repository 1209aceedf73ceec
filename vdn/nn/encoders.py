"""Standalone encoder adapters (reference models/dinov2_encoder.py:6-61 and
models/hiera_image_encoder.py:5-61).

The reference wrappers pull pretrained weights over the network
(transformers AutoModel / torch.hub); vdn provides the same interfaces over
its own backbones, with weights loaded from converted checkpoints.
"""

from __future__ import annotations

from typing import Any, List, Optional, Tuple

import jax.numpy as jnp

from vdn.nn import module as nn
from vdn.nn.hiera import make_hiera
from vdn.nn.vit import make_vit

Dtype = Any

_DINOV2_SIZES = {
    "dinov2_vits14": "vits", "facebook/dinov2-small": "vits",
    "dinov2_vitb14": "vitb", "facebook/dinov2-base": "vitb",
    "dinov2_vitl14": "vitl", "facebook/dinov2-large": "vitl",
    "dinov2_vitg14": "vitg", "facebook/dinov2-giant": "vitg",
}


class DINOv2Encoder(nn.Module):
    """last_hidden_state minus CLS, like the HF AutoModel wrapper
    (reference models/dinov2_encoder.py:44-60)."""
    model_name: str = "dinov2_vits14"
    param_dtype: Dtype = jnp.float32

    def setup(self):
        self.model = make_vit(_DINOV2_SIZES[self.model_name],
                              self.param_dtype)
        self.feature_dim = self.model.embed_dim

    def __call__(self, x: jnp.ndarray) -> jnp.ndarray:
        """x [B, H, W, 3] -> patch tokens [B, N, C] (CLS dropped)."""
        tokens = self.model(x)
        return tokens[:, 1:]


class HieraImageEncoder(nn.Module):
    """4-level feature pyramid, [B, H_i, W_i, C_i] per level
    (reference models/hiera_image_encoder.py:44-61).

    Hub-style ``model_name``s (``hiera_base_224`` — the reference's own
    mapping keys) use the plain MAE Hiera (`vdn/nn/hiera_mae.py`,
    architecture-exact vs the torch-hub model, checkpoint-convertible);
    ``sam2_`` prefixed names select the SAM2 hieradet variant."""
    model_name: str = "hiera_base_224"
    param_dtype: Dtype = jnp.float32

    def setup(self):
        from vdn.nn.hiera_mae import HIERA_MAE_CONFIGS, make_hiera_mae
        if self.model_name in HIERA_MAE_CONFIGS:
            self.model = make_hiera_mae(self.model_name, self.param_dtype)
            self._mae = True
        else:
            self.model = make_hiera(
                self.model_name.removeprefix("sam2_").replace("_224", ""),
                self.param_dtype)
            self._mae = False

    def __call__(self, x: jnp.ndarray
                 ) -> Tuple[Optional[jnp.ndarray], List[jnp.ndarray]]:
        """Returns (trunk_output, intermediates) mirroring the reference's
        (classifier_logits, intermediates) contract — the reference
        discards the first element; the MAE family returns its pooled
        trunk-norm output there (no 1000-way classifier head)."""
        out = self.model(x)
        if self._mae:
            return out
        return None, out
