"""Chamfer distance between voxel-occupancy point sets, as in the JAX
package's ops/chamfer.py: squared distances |a|² + |b|² - 2ab, masked
minima both ways, and the sum of the two means. Dynamic point counts become
fixed-capacity buffers with valid counts; exact whenever the occupied-voxel
count fits the capacity.

`chamfer_batch` takes the minima from the chamfer kernel
(ops/streaming_chamfer.py, csrc/chamfer.cu) on CUDA tensors and from the
plain version on CPU tensors; it never falls back from one to the other.
The masked means are one torch reduction either way.
"""

from __future__ import annotations

import torch

from retrieval_fuse_tpu_torch.ops.streaming_chamfer import (
    chamfer_minima, chamfer_minima_plain, masked_pairwise_sqdist)

__all__ = ["occupancy_to_point_buffer", "masked_pairwise_sqdist", "chamfer_masked",
           "chamfer_batch_plain", "chamfer_batch"]


def occupancy_to_point_buffer(occ: torch.Tensor, capacity: int) -> tuple[torch.Tensor, int]:
    """Boolean (D, H, W) grid -> ((capacity, 3) float32 voxel coordinates on
    the grid's device, count). Points beyond `capacity` are dropped in
    raster order."""
    pts = torch.nonzero(occ).to(torch.float32)
    n = min(pts.shape[0], capacity)
    buf = torch.zeros((capacity, 3), dtype=torch.float32, device=occ.device)
    buf[:n] = pts[:n]
    return buf, n


def _masked_mean(minima: torch.Tensor, counts: torch.Tensor) -> torch.Tensor:
    valid = torch.arange(minima.shape[1], device=minima.device)[None, :] < counts[:, None]
    return torch.where(valid, minima, 0.0).sum(dim=1) / counts.clamp(min=1)


def _symmetric(minima: tuple[torch.Tensor, torch.Tensor], n_a: torch.Tensor,
               n_b: torch.Tensor) -> torch.Tensor:
    return _masked_mean(minima[0], n_a) + _masked_mean(minima[1], n_b)


def chamfer_batch_plain(points_a: torch.Tensor, n_a: torch.Tensor, points_b: torch.Tensor,
                        n_b: torch.Tensor) -> torch.Tensor:
    """(B,) symmetric chamfer from the plain minima (tiled over A, so peak
    memory is O(tile · cap_b)), on any device."""
    return _symmetric(chamfer_minima_plain(points_a, n_a, points_b, n_b), n_a, n_b)


def chamfer_masked(points_a: torch.Tensor, n_a, points_b: torch.Tensor, n_b) -> torch.Tensor:
    """Symmetric chamfer of one pair of (cap, 3) buffers with valid counts:
    mean min-sqdist a->b plus b->a over the valid points; 1e30 for a set
    whose other set is empty, 0 if both are. The plain version."""
    counts = lambda n: torch.tensor([int(n)], dtype=torch.int32, device=points_a.device)
    return chamfer_batch_plain(points_a[None], counts(n_a), points_b[None], counts(n_b))[0]


def chamfer_batch(points_a: torch.Tensor, n_a: torch.Tensor, points_b: torch.Tensor,
                  n_b: torch.Tensor) -> torch.Tensor:
    """(B,) symmetric chamfer of B pairs of (B, cap, 3) point buffers with
    (B,) int32 counts: the kernel's minima on CUDA tensors, the plain ones on
    CPU tensors."""
    return _symmetric(chamfer_minima(points_a, n_a, points_b, n_b), n_a, n_b)
