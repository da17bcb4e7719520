"""Single-pass exact top-k select over a float32 score matrix.

Kernel: csrc/topk.cu, replacing the Pallas `pallas_topk`
(retrieval_fuse_tpu/ops/pallas_topk.py:32 `_topk_kernel`, :59). It reads
the score matrix once; its bound on the H100 is that read (bytes: Q·N·4 at
3.35 TB/s, ~0.13 ms at Q=4096, N=27,132). One warp per row keeps a running
top-k in registers and merges the lanes with shuffles, since CUDA blocks
cannot carry state from one grid step to the next as the TPU grid did.
Ties go to the lower column, exactly as in jax.lax.top_k. It takes every k
from 1 to 32 (TOPK_MAX_K), as the JAX select takes any k the engine is
configured with: k <= 8 (every shipped config's K and `map`'s 2K) launches an
instance of its own, 9 <= k <= 32 the general instance of 16 or 32 slots a
lane, whose first k are the top k under the same tie order.

`topk` launches the kernel on CUDA tensors and runs `topk_plain` on CPU
tensors; it never falls back from one to the other.
"""

from __future__ import annotations

import torch

from retrieval_fuse_tpu_torch.ops import _build
from retrieval_fuse_tpu_torch.ops.knn import iterative_topk

TOPK_MAX_K = 32  # the largest k the kernel takes


def topk_plain(sims: torch.Tensor, k: int) -> tuple[torch.Tensor, torch.Tensor]:
    """The plain PyTorch version: (values float32, indices int32)."""
    return iterative_topk(sims.float(), k)


def topk(sims: torch.Tensor, k: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Exact top-k over the last axis of a (Q, N) float32 score matrix.
    Returns (values (Q, k) float32, indices (Q, k) int32), best first."""
    if sims.device.type == "cpu":
        return topk_plain(sims, k)
    if sims.device.type != "cuda":
        raise ValueError(f"topk: unsupported device {sims.device}")
    if sims.dtype != torch.float32 or sims.dim() != 2 or not sims.is_contiguous():
        raise ValueError(f"topk: needs a contiguous 2-D float32 matrix, got "
                         f"{sims.dtype} {tuple(sims.shape)}")
    q, n = sims.shape
    if not 1 <= k <= TOPK_MAX_K or n < k:
        raise ValueError(f"topk: the kernel takes 1 <= k <= {TOPK_MAX_K} and N >= k "
                         f"(k={k}, N={n})")
    vals = torch.empty((q, k), dtype=torch.float32, device=sims.device)
    idx = torch.empty((q, k), dtype=torch.int32, device=sims.device)
    if q == 0:
        return vals, idx
    _build.launch("topk", sims.device, sims.data_ptr(), vals.data_ptr(), idx.data_ptr(),
                  q, n, k)
    topk.launches += 1
    return vals, idx


topk.launches = 0
