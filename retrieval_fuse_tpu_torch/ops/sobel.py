"""Sobel normals and Laplacian of TSDF volumes (channels-last), as in the
JAX package's ops/sobel.py: fixed 3³ kernels over a VALID convolution of
the volume padded by one voxel of truncation."""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

_SOBEL_X = np.array(
    [[[+1, +2, +1], [+2, +4, +2], [+1, +2, +1]],
     [[0, 0, 0], [0, 0, 0], [0, 0, 0]],
     [[-1, -2, -1], [-2, -4, -2], [-1, -2, -1]]], dtype=np.float32)
_SOBEL_Y = np.array(
    [[[+1, +2, +1], [0, 0, 0], [-1, -2, -1]],
     [[+2, +4, +2], [0, 0, 0], [-2, -4, -2]],
     [[+1, +2, +1], [0, 0, 0], [-1, -2, -1]]], dtype=np.float32)
_SOBEL_Z = np.array(
    [[[-1, 0, +1], [-2, 0, +2], [-1, 0, +1]],
     [[-2, 0, +2], [-4, 0, +4], [-2, 0, +2]],
     [[-1, 0, +1], [-2, 0, +2], [-1, 0, +1]]], dtype=np.float32)
# the reference's Laplacian has one asymmetric entry ([3, 6, 2] at [2, 1, :]),
# kept for value parity
_LAPLACIAN = np.array(
    [[[2, 3, 2], [3, 6, 3], [2, 3, 2]],
     [[3, 6, 3], [6, -88, 6], [3, 6, 3]],
     [[2, 3, 2], [3, 6, 2], [2, 3, 2]]], dtype=np.float32) / 26.0

# F.conv3d weights (C_out, C_in=1, 3, 3, 3)
_SOBEL_BANK = np.stack([_SOBEL_X, _SOBEL_Y, _SOBEL_Z])[:, None]
_LAPLACIAN_K = _LAPLACIAN[None, None]


def _conv3d_valid(target: torch.Tensor, kernel: np.ndarray, trunc_val: float) -> torch.Tensor:
    """(B, D, H, W, 1) padded by one voxel of trunc_val, VALID conv ->
    (B, D, H, W, C_out)."""
    x = F.pad(target.permute(0, 4, 1, 2, 3), (1, 1) * 3, value=trunc_val)
    w = torch.from_numpy(kernel).to(device=target.device, dtype=target.dtype)
    return F.conv3d(x, w).permute(0, 2, 3, 4, 1)


def compute_normals(target: torch.Tensor, trunc_val: float) -> torch.Tensor:
    """Normalised Sobel gradients (B, D, H, W, 3) of a (B, D, H, W, 1) TSDF
    (epsilon 1e-5 inside the square root)."""
    normals = _conv3d_valid(target, _SOBEL_BANK, trunc_val)
    return normals / torch.sqrt(torch.sum(normals * normals, dim=-1, keepdim=True) + 1e-5)


def compute_laplacian(target: torch.Tensor, trunc_val: float) -> torch.Tensor:
    """Laplacian (B, D, H, W, 1) of a (B, D, H, W, 1) TSDF."""
    return _conv3d_valid(target, _LAPLACIAN_K, trunc_val)
