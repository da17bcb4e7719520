"""Patch-based K-way attention fusion, as in the JAX package's
models/attention.py.

Per e³ feature patch, a query MLP (theta) embeds the backbone features and a
key MLP (phi) embeds each of the K co-located retrieved patches; scores are
dot products of the L2-normalised embeddings; selection is the hard
argmax(25·s) (deterministic selection, as served), a straight-through
Gumbel-softmax over 25·s (training), or a sharp softmax (sharpness
cf_feat·e³·4); a ReLU-of-max switch gates the blend with the backbone
features. With no_output_mapping=False the candidates pass through a 1x1
conv g before the weighted sum and the result through a 1x1 conv o.
`get_features` gives the theta / phi embeddings of the contrastive side loss.

The plain path here is what the `base` engine variant runs; the attention
kernels (ops/patch_attention.py) compute the same function for the shipped
settings.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from retrieval_fuse_tpu_torch.ops.fold3d import unfold3d, fold3d


def l2_normalize(x: torch.Tensor, dim: int) -> torch.Tensor:
    """x / ‖x‖ along `dim`; exactly-zero rows stay zero, with finite
    gradients."""
    return x * torch.rsqrt(torch.clamp(torch.sum(x * x, dim=dim, keepdim=True), min=1e-24))


def gumbel_softmax(logits: torch.Tensor, uniform: torch.Tensor, tau: float = 1.0,
                   hard: bool = True) -> torch.Tensor:
    """Straight-through Gumbel-softmax over the last axis, with the noise's
    uniform draw `uniform` in [1e-20, 1) passed in (shape of logits):
    gumbels = -log(-log(u + 1e-20)); hard returns the one-hot argmax in the
    forward and the soft weights' gradient in the backward."""
    gumbels = -torch.log(-torch.log(uniform + 1e-20))
    y_soft = torch.softmax((logits + gumbels) / tau, dim=-1)
    if not hard:
        return y_soft
    y_hard = F.one_hot(torch.argmax(y_soft, dim=-1), logits.shape[-1]).to(logits.dtype)
    return y_hard + y_soft - y_soft.detach()


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
        self.patch_extent, self.K = patch_extent, K
        self.normalize, self.retrieval_mode, self.blend = normalize, retrieval_mode, blend
        self.no_output_mapping = no_output_mapping
        self.deterministic_selection = deterministic_selection
        self.cf_feat = cf_feat
        in_features = num_output_channels * patch_extent ** 3
        self.theta = AttentionFeatureEncoder(in_features, cf_feat)
        self.phi = AttentionFeatureEncoder(in_features, cf_feat)
        # registered for checkpoint parity; the live forward uses the ReLU
        # switch, as the reference does
        self.sig_scale = nn.Parameter(torch.full((1,), init_scale))
        self.sig_shift = nn.Parameter(torch.full((1,), init_shift))
        if not no_output_mapping:
            c = num_output_channels
            self.g = nn.Conv3d(c, c, 1)
            self.o = nn.Conv3d(c, c, 1)

    @property
    def sharpness(self) -> float:
        """Softmax sharpness of the non-retrieval mode: cf_feat·e³·4."""
        return float(self.cf_feat * self.patch_extent ** 3 * 4)

    @staticmethod
    def _conv1x1(conv: nn.Conv3d, x: torch.Tensor) -> torch.Tensor:
        """A 1x1 conv on channels-last (N, e, e, e, C)."""
        return conv(x.permute(0, 4, 1, 2, 3)).permute(0, 2, 3, 4, 1)

    def get_features(self, x: torch.Tensor, p: torch.Tensor):
        """Query / key embeddings of the contrastive side loss: x, p (B, e,
        e, e, C) -> two (B, cf_feat), L2-normalised with `normalize`."""
        x_feat, p_feat = self.theta(x), self.phi(p)
        if self.normalize:
            x_feat, p_feat = l2_normalize(x_feat, 1), l2_normalize(p_feat, 1)
        return x_feat, p_feat

    def forward(self, x: torch.Tensor, p: torch.Tensor,
                gumbel_uniform_draw: torch.Tensor | None = None) -> torch.Tensor:
        """x: (B, e, e, e, C); p: (B, K, e, e, e, C) -> (B, e, e, e, C).
        With Gumbel selection (retrieval_mode, not deterministic) the noise
        is `gumbel_uniform_draw` (B, K), drawn from torch's generator when
        None."""
        b, k = p.shape[0], p.shape[1]
        x_feat = self.theta(x)
        p_feat = self.phi(p.reshape(b * k, -1)).reshape(b, k, -1)
        if self.normalize:
            x_feat = l2_normalize(x_feat, 1)
            p_feat = l2_normalize(p_feat, 2)
        if self.no_output_mapping:
            g_feat = p.reshape(b, k, -1)
        else:
            g_feat = self._conv1x1(self.g, p.reshape(b * k, *p.shape[2:])).reshape(b, k, -1)
        scores = torch.einsum("bf,bkf->bk", x_feat, p_feat)
        switch = F.relu(torch.amax(scores, dim=1, keepdim=True))
        if self.retrieval_mode:
            scaled = scores * 25.0
            if self.deterministic_selection:
                soft = torch.softmax(scaled, dim=-1)
                hard = F.one_hot(torch.argmax(scaled, dim=-1), k).to(scaled.dtype)
                weights = hard + soft - soft.detach()  # straight-through, as in JAX
            else:
                if gumbel_uniform_draw is None:
                    gumbel_uniform_draw = torch.clamp(
                        torch.rand(scaled.shape, device=scaled.device), min=1e-20)
                weights = gumbel_softmax(scaled, gumbel_uniform_draw)
        else:
            weights = torch.softmax(self.sharpness * scores, dim=1)
        # Gumbel weights are float32 over bf16 scores (the noise is drawn in
        # float32); the sum runs in the features' dtype
        patch_attention = torch.einsum("bk,bkf->bf", weights.to(g_feat.dtype),
                                       g_feat).reshape(x.shape)
        if not self.no_output_mapping:
            patch_attention = self._conv1x1(self.o, patch_attention)
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

    def get_features(self, x_predicted: torch.Tensor, x_target: torch.Tensor,
                     occupancy: torch.Tensor):
        """(B, S, S, S, F) predicted and target features and a (B, S, S, S, ·)
        occupancy -> per-patch theta / phi features (B·R³, cf_feat) and
        whether each patch holds any occupied voxel (B·R³,)."""
        e = self.patch_extent
        x_pred_feat = unfold3d(x_predicted, e)
        x_feat, p_feat = self.attention_blocks_layer.get_features(
            x_pred_feat, unfold3d(x_target, e))
        occupied = torch.any(unfold3d(occupancy, e).reshape(x_pred_feat.shape[0], -1), dim=1)
        return x_feat, p_feat, occupied

    def forward(self, x_predicted: torch.Tensor, x_retrieved: torch.Tensor,
                gumbel_uniform_draw: torch.Tensor | None = None) -> torch.Tensor:
        """x_predicted: (B, S, S, S, F); x_retrieved: (B·K, S, S, S, F);
        gumbel_uniform_draw: (B·R³, K), for Gumbel selection only."""
        e, r, k, nf = self.patch_extent, self.num_patch_x, self.K, self.nf
        x_predicted_feat = unfold3d(x_predicted, e)
        x_patch_feat = unfold3d(x_retrieved, e).reshape(-1, k, r ** 3, e, e, e, nf)
        x_patch_feat = x_patch_feat.permute(0, 2, 1, 3, 4, 5, 6).reshape(-1, k, e, e, e, nf)
        return fold3d(self.attention_blocks_layer(x_predicted_feat, x_patch_feat,
                                                  gumbel_uniform_draw), r, e)
