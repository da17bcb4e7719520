"""Masked chamfer minima of a batch of point-set pairs, without the (P, Q)
distance matrix.

Kernel: csrc/chamfer.cu, replacing the Pallas `pallas_chamfer`
(retrieval_fuse_tpu/ops/pallas_chamfer.py:21 `_chamfer_kernel`, :50). Its
bound on the H100 is the float32 operations at 67 TFLOP/s. A block holds
256 points of one set in registers, two a thread, and streams the other
set through shared memory, both directions in one launch; a pair costs three
FMAs and a minimum, |q|² and the clamp being applied once a point, after
the minimum. Where the batch alone does not fill the card (one pair per
call in `evaluate`), the streamed set is cut in up to 8 runs over the
blocks of a thread-block cluster, which merge their minima through
distributed shared memory: still one launch, no atomics, and the same
result whatever the split; tiles stop at the counts by index. The Pallas
kernel takes one pair per call; this one takes the batch that
ops/chamfer.chamfer_batch vmaps over, so one launch serves a whole
Chamfer3D.update.

`chamfer_minima` launches the kernel on CUDA tensors and runs
`chamfer_minima_plain` on CPU tensors; it never falls back from one to the
other. On voxel coordinates (integers) both are exact, so their minima are
bit-equal.
"""

from __future__ import annotations

import torch

from retrieval_fuse_tpu_torch.ops import _build

BIG = 1e30  # the minimum of a point whose other set is empty (the JAX _BIG)


def masked_pairwise_sqdist(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """(P, 3), (Q, 3) -> (P, Q) squared distances |a|² + |b|² - 2ab, clamped
    at 0; the caller masks invalid rows."""
    a2 = (a * a).sum(dim=1)[:, None]
    b2 = (b * b).sum(dim=1)[None, :]
    return torch.clamp(a2 + b2 - 2.0 * (a @ b.T), min=0.0)


def _tile_rows(cap_b: int, cap_a: int) -> int:
    """Rows of A per distance tile: O(tile·cap_b) memory, ~64 MB."""
    return int(min(cap_a, max(128, (1 << 24) // max(cap_b, 1))))


def chamfer_minima_plain(points_a: torch.Tensor, n_a: torch.Tensor, points_b: torch.Tensor,
                         n_b: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """The plain PyTorch version of the kernel: (min_ab (B, cap_a),
    min_ba (B, cap_b)) float32, BIG at and past each count. Tiled over A."""
    bsz, cap_a, cap_b = points_a.shape[0], points_a.shape[1], points_b.shape[1]
    min_ab = torch.full((bsz, cap_a), BIG, dtype=torch.float32, device=points_a.device)
    min_ba = torch.full((bsz, cap_b), BIG, dtype=torch.float32, device=points_a.device)
    counts = torch.stack([n_a, n_b], dim=1).tolist()
    for i, (na, nb) in enumerate(counts):
        na, nb = min(max(na, 0), cap_a), min(max(nb, 0), cap_b)
        if na == 0 or nb == 0:
            continue
        b = points_b[i, :nb].float()
        tile = _tile_rows(nb, na)
        for t0 in range(0, na, tile):
            d = masked_pairwise_sqdist(points_a[i, t0:min(t0 + tile, na)].float(), b)
            min_ab[i, t0:t0 + d.shape[0]] = d.amin(dim=1)
            min_ba[i, :nb] = torch.minimum(min_ba[i, :nb], d.amin(dim=0))
    return min_ab, min_ba


def chamfer_minima(points_a: torch.Tensor, n_a: torch.Tensor, points_b: torch.Tensor,
                   n_b: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """points_* (B, cap_*, 3) float32, n_* (B,) int32 counts ->
    (min_ab (B, cap_a), min_ba (B, cap_b)): each valid point's squared
    distance to the nearest valid point of the other set; BIG at and past
    each count, and where the other set is empty."""
    tensors = (points_a, n_a, points_b, n_b)
    if all(t.device.type == "cpu" for t in tensors):
        return chamfer_minima_plain(*tensors)
    dev = points_a.device
    if dev.type != "cuda" or any(t.device != dev for t in tensors):
        raise ValueError("chamfer_minima: all tensors must be on one CUDA device, got "
                         f"{[str(t.device) for t in tensors]}")
    for name, t in (("points_a", points_a), ("points_b", points_b)):
        if t.dtype != torch.float32 or t.dim() != 3 or t.shape[2] != 3 or not t.is_contiguous():
            raise ValueError(f"chamfer_minima: {name} must be contiguous float32 "
                             f"(B, cap, 3), got {t.dtype} {tuple(t.shape)}")
    bsz, cap_a, cap_b = points_a.shape[0], points_a.shape[1], points_b.shape[1]
    for name, t in (("n_a", n_a), ("n_b", n_b)):
        if t.dtype != torch.int32 or t.shape != (bsz,) or not t.is_contiguous():
            raise ValueError(f"chamfer_minima: {name} must be contiguous int32 ({bsz},), "
                             f"got {t.dtype} {tuple(t.shape)}")
    if points_b.shape[0] != bsz or not 1 <= bsz <= 65535 or cap_a < 1 or cap_b < 1:
        raise ValueError(f"chamfer_minima: the kernel takes 1 <= B <= 65535 pairs of "
                         f"non-empty buffers, got {tuple(points_a.shape)} and "
                         f"{tuple(points_b.shape)}")
    min_ab = torch.empty((bsz, cap_a), dtype=torch.float32, device=dev)
    min_ba = torch.empty((bsz, cap_b), dtype=torch.float32, device=dev)
    _build.launch("chamfer", dev, points_a.data_ptr(), n_a.data_ptr(), points_b.data_ptr(),
                  n_b.data_ptr(), min_ab.data_ptr(), min_ba.data_ptr(), bsz, cap_a, cap_b)
    chamfer_minima.launches += 1
    return min_ab, min_ba


chamfer_minima.launches = 0
