"""Patch-based K-way attention fusion, as in the JAX package's
models/attention.py, in its serving form.

Per e³ feature patch, a query MLP (theta) embeds the backbone features and a
key MLP (phi) embeds each of the K co-located retrieved patches; scores are
dot products of the L2-normalised embeddings; selection is the hard
argmax(25·s) (deterministic selection) or a sharp softmax (sharpness
cf_feat·e³·4); a ReLU-of-max switch gates the blend with the backbone
features.

This is the plain path the `base` engine variant runs; the gathered-row
kernel (ops/patch_attention.py) computes the same function. Not ported yet:
Gumbel sampling (training), the g/o output mappings (no_output_mapping=False)
and get_features (the contrastive side loss).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from retrieval_fuse_tpu_torch.ops.fold3d import unfold3d, fold3d


def l2_normalize(x: torch.Tensor, dim: int) -> torch.Tensor:
    """x / ‖x‖ along `dim`; exactly-zero rows stay zero."""
    return x * torch.rsqrt(torch.clamp(torch.sum(x * x, dim=dim, keepdim=True), min=1e-24))


class AttentionFeatureEncoder(nn.Module):
    """MLP in_features -> 128 -> 128 -> 128 -> n_out with LeakyReLU(0.01)."""

    def __init__(self, in_features: int, n_out: int):
        super().__init__()
        self.fc0 = nn.Linear(in_features, 128)
        self.fc1 = nn.Linear(128, 128)
        self.fc2 = nn.Linear(128, 128)
        self.out = nn.Linear(128, n_out)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x.reshape(x.shape[0], -1)
        for fc in (self.fc0, self.fc1, self.fc2):
            x = F.leaky_relu(fc(x), 0.01)
        return self.out(x)


class AttentionBlock(nn.Module):
    """K-way selection attention over co-located patches."""

    def __init__(self, num_output_channels: int, patch_extent: int, K: int,
                 normalize: bool = True, use_switching: bool = True,
                 retrieval_mode: bool = True, no_output_mapping: bool = True,
                 blend: bool = True, cf_feat: int = 32, init_scale: float = 35.0,
                 init_shift: float = -27.0, deterministic_selection: bool = True):
        super().__init__()
        if not no_output_mapping:
            raise NotImplementedError("the g/o output mappings are not ported yet")
        if retrieval_mode and not deterministic_selection:
            raise NotImplementedError(
                "Gumbel selection is not ported yet (training slice)")
        self.patch_extent, self.K = patch_extent, K
        self.normalize, self.retrieval_mode, self.blend = normalize, retrieval_mode, blend
        self.cf_feat = cf_feat
        in_features = num_output_channels * patch_extent ** 3
        self.theta = AttentionFeatureEncoder(in_features, cf_feat)
        self.phi = AttentionFeatureEncoder(in_features, cf_feat)
        # registered for checkpoint parity; the live forward uses the ReLU
        # switch, as the reference does
        self.sig_scale = nn.Parameter(torch.full((1,), init_scale))
        self.sig_shift = nn.Parameter(torch.full((1,), init_shift))

    @property
    def sharpness(self) -> float:
        """Softmax sharpness of the non-retrieval mode: cf_feat·e³·4."""
        return float(self.cf_feat * self.patch_extent ** 3 * 4)

    def forward(self, x: torch.Tensor, p: torch.Tensor) -> torch.Tensor:
        """x: (B, e, e, e, C); p: (B, K, e, e, e, C) -> (B, e, e, e, C)."""
        b, k = p.shape[0], p.shape[1]
        x_feat = self.theta(x)
        p_feat = self.phi(p.reshape(b * k, -1)).reshape(b, k, -1)
        if self.normalize:
            x_feat = l2_normalize(x_feat, 1)
            p_feat = l2_normalize(p_feat, 2)
        g_feat = p.reshape(b, k, -1)
        scores = torch.einsum("bf,bkf->bk", x_feat, p_feat)
        switch = F.relu(torch.amax(scores, dim=1, keepdim=True))
        if self.retrieval_mode:
            scaled = scores * 25.0
            soft = torch.softmax(scaled, dim=-1)
            hard = F.one_hot(torch.argmax(scaled, dim=-1), k).to(scaled.dtype)
            weights = hard + soft - soft.detach()  # straight-through, as in JAX
        else:
            weights = torch.softmax(self.sharpness * scores, dim=1)
        patch_attention = torch.einsum("bk,bkf->bf", weights, g_feat).reshape(x.shape)
        sw = switch.reshape(b, 1, 1, 1, 1)
        if self.blend:
            return x * (1.0 - sw) + patch_attention * sw
        return x + patch_attention * sw


class PatchedAttentionBlock(nn.Module):
    """Unfold (B, S, S, S, F) feature grids into R³ patches, attend per
    location over the K retrieved grids, fold back."""

    def __init__(self, nf: int, num_patch_x: int, patch_extent: int,
                 num_nearest_neighbors: int, attention_kwargs: dict):
        super().__init__()
        self.nf, self.num_patch_x, self.patch_extent = nf, num_patch_x, patch_extent
        self.K = num_nearest_neighbors
        self.attention_blocks_layer = AttentionBlock(
            nf, patch_extent, num_nearest_neighbors, **attention_kwargs)

    def forward(self, x_predicted: torch.Tensor, x_retrieved: torch.Tensor) -> torch.Tensor:
        """x_predicted: (B, S, S, S, F); x_retrieved: (B·K, S, S, S, F)."""
        e, r, k, nf = self.patch_extent, self.num_patch_x, self.K, self.nf
        x_predicted_feat = unfold3d(x_predicted, e)
        x_patch_feat = unfold3d(x_retrieved, e).reshape(-1, k, r ** 3, e, e, e, nf)
        x_patch_feat = x_patch_feat.permute(0, 2, 1, 3, 4, 5, 6).reshape(-1, k, e, e, e, nf)
        return fold3d(self.attention_blocks_layer(x_predicted_feat, x_patch_feat), r, e)
