"""Generic pad + unfold / recompose over batched channels-last volumes, as
in the JAX package's ops/patcher.py (Patcher, get_patch_counts): a helper
for ad-hoc full-scene tiling that the serving and training paths do not
use."""

from __future__ import annotations

import torch
import torch.nn.functional as F

from retrieval_fuse_tpu_torch.ops.fold3d import fold3d, unfold3d


def get_patch_counts(size, patch_size: int) -> int:
    """Patches per axis after padding `size` up to a patch multiple."""
    return -(-size // patch_size)


class Patcher:
    """Pad a (B, D, H, W, C) volume with `pad_val` up to a patch multiple on
    each spatial axis and unfold it into non-overlapping patches;
    `recompose_patches` inverts."""

    def __init__(self, patch_size: int, pad_val: float = 0.0):
        self.patch_size = patch_size
        self.pad_val = pad_val
        self._padded_shape = None

    def __call__(self, x: torch.Tensor) -> torch.Tensor:
        ps = self.patch_size
        extra = [(-x.shape[ax]) % ps for ax in (1, 2, 3)]
        xp = F.pad(x, (0, 0, 0, extra[2], 0, extra[1], 0, extra[0]), value=self.pad_val)
        self._padded_shape = xp.shape
        return unfold3d(xp, ps)

    def recompose_patches(self, patches: torch.Tensor, original_shape=None) -> torch.Tensor:
        """The (B, D', H', W', C) padded volume of the last call's patches,
        cut back to `original_shape`'s spatial extent when given."""
        ps = self.patch_size
        out = fold3d(patches, self._padded_shape[1] // ps, ps)
        if original_shape is not None:
            out = out[:, : original_shape[1], : original_shape[2], : original_shape[3], :]
        return out
