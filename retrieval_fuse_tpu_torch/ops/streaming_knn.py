"""Streaming exact cosine kNN that never materialises the (Q, N) scores.

Kernel: csrc/knn.cu, replacing the Pallas `pallas_exact_knn`
(retrieval_fuse_tpu/ops/pallas_knn.py:49 `_knn_kernel`, :31
`_topk_by_iteration`, :74). Its bound on the H100 is the float32 FMAs
(2·Q·N·64 flops at 67 TFLOP/s, ~0.43 ms at Q=8192, N=27,132); the database
(6.9 MB) stays in L2. A block owns 64 queries and walks the whole database
in shared-memory tiles, so no merge pass across blocks is needed; rows past
N are skipped by index instead of the TPU kernel's -4 sentinel column.
Ties go to the lower row.

`streaming_knn_sims` launches the kernel on CUDA tensors and runs
`streaming_knn_sims_plain` (dense float32 scores + the tie-exact select) on CPU
tensors; it never falls back from one to the other. The two rank by float32
sums taken in different orders, so indices can differ where two
similarities are within float32 rounding of each other.
"""

from __future__ import annotations

import torch

from retrieval_fuse_tpu_torch.ops import _build
from retrieval_fuse_tpu_torch.ops.knn import iterative_topk

EMBED_DIM = 64  # the kernel's query width (latent_dim of the shipped configs)


def streaming_knn_sims_plain(queries: torch.Tensor, database: torch.Tensor, k: int):
    """The plain PyTorch version of the kernel's raw output:
    (similarities (Q, k) float32, indices (Q, k) int32), best first."""
    return iterative_topk(queries.float() @ database.float().T, k)


def streaming_knn_sims(queries: torch.Tensor, database: torch.Tensor, k: int):
    """(similarities (Q, k) float32, indices (Q, k) int32), best first."""
    if queries.device.type == "cpu" and database.device.type == "cpu":
        return streaming_knn_sims_plain(queries, database, k)
    if queries.device.type != "cuda" or database.device != queries.device:
        raise ValueError(f"streaming_knn: tensors on {queries.device} and "
                         f"{database.device}; both must be on one CUDA device")
    for name, t in (("queries", queries), ("database", database)):
        if t.dtype != torch.float32 or t.dim() != 2 or t.shape[1] != EMBED_DIM \
                or not t.is_contiguous():
            raise ValueError(f"streaming_knn: {name} must be contiguous float32 "
                             f"(·, {EMBED_DIM}), got {t.dtype} {tuple(t.shape)}")
    q, n = queries.shape[0], database.shape[0]
    if not 1 <= k <= 8 or n < k:
        raise ValueError(f"streaming_knn: the kernel takes 1 <= k <= 8 and N >= k "
                         f"(k={k}, N={n})")
    sims = torch.empty((q, k), dtype=torch.float32, device=queries.device)
    idx = torch.empty((q, k), dtype=torch.int32, device=queries.device)
    if q == 0:
        return sims, idx
    _build.launch("knn", queries.device, queries.data_ptr(), database.data_ptr(),
                  sims.data_ptr(), idx.data_ptr(), q, n, k)
    streaming_knn_sims.launches += 1
    return sims, idx


streaming_knn_sims.launches = 0


def streaming_knn(queries: torch.Tensor, database: torch.Tensor, k: int):
    """Like ops/knn.exact_knn: (int32 indices, sq_dists = max(2 - 2·cos, 0))."""
    sims, idx = streaming_knn_sims(queries, database, k)
    return idx, torch.clamp(2.0 - 2.0 * sims, min=0.0)
