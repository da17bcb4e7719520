"""3-D space <-> patch reshapes (channels-last), as in the JAX package's
ops/fold3d.py: non-overlapping e³ patches in row-major (r1, r2, r3) order,
fold3d the exact inverse of unfold3d, and the padded, strided (possibly
overlapping) unfold3d_pad_stride."""

from __future__ import annotations

import torch


def unfold3d(x: torch.Tensor, patch_extent: int) -> torch.Tensor:
    """(B, S, S, S, C) -> (B*R³, e, e, e, C) with R = S // e.

    Patch p of batch b sits at flat row ((b*R + r1)*R + r2)*R + r3."""
    b, s1, s2, s3, c = x.shape
    e = patch_extent
    r1, r2, r3 = s1 // e, s2 // e, s3 // e
    x = x.reshape(b, r1, e, r2, e, r3, e, c)
    x = x.permute(0, 1, 3, 5, 2, 4, 6, 7)
    return x.reshape(b * r1 * r2 * r3, e, e, e, c)


def fold3d(patches: torch.Tensor, num_patch_x: int, patch_extent: int) -> torch.Tensor:
    """(B*R³, e, e, e, C) -> (B, R*e, R*e, R*e, C); inverse of unfold3d."""
    e, c = patch_extent, patches.shape[-1]
    r = num_patch_x
    x = patches.reshape(-1, r, r, r, e, e, e, c)
    x = x.permute(0, 1, 4, 2, 5, 3, 6, 7)
    return x.reshape(-1, r * e, r * e, r * e, c)


def unfold3d_pad_stride(x: torch.Tensor, patch_extent: int, pad_size: int, pad_val: float,
                        stride: int) -> torch.Tensor:
    """(B, S, S, S, C), padded by pad_size with pad_val on each side of the
    three spatial axes -> (B*n³, e, e, e, C): the e³ windows at `stride`,
    n = (S + 2·pad_size - e) // stride + 1, window (i, j, k) of batch b at
    flat row ((b*n + i)*n + j)*n + k. The windows are views of the padded
    volume until the final reshape copies them."""
    e = patch_extent
    xp = torch.nn.functional.pad(x, (0, 0) + (pad_size, pad_size) * 3, value=pad_val)
    n = (xp.shape[1] - e) // stride + 1
    w = xp.unfold(1, e, stride).unfold(2, e, stride).unfold(3, e, stride)
    # (b, n, n, n, c, e, e, e) -> (b·n³, e, e, e, c)
    return w[:, :n, :n, :n].permute(0, 1, 2, 3, 5, 6, 7, 4).reshape(
        x.shape[0] * n ** 3, e, e, e, x.shape[-1])
