"""Streaming exact cosine kNN that never materialises the (Q, N) scores.

Kernel: csrc/knn.cu, replacing the Pallas `pallas_exact_knn`
(retrieval_fuse_tpu/ops/pallas_knn.py:49 `_knn_kernel`, :31
`_topk_by_iteration`, :74). Scores run on the tensor cores: bf16 rows as
bf16 `mma` with float32 sums (the products are exact, so only the order of
summation differs from the plain version), float32 rows as 3xTF32 (three
TF32 products of split operands, within 9.5e-7 of the exact dot product for
unit rows). Its bound on the H100 is those operations: 2·Q·N·D flops at
989 TFLOP/s in bf16 (0.029 ms at Q=8192, N=27,132, D=64), three times as
many at 495 TFLOP/s in float32 (0.173 ms). The database is split over the
blocks of a thread-block cluster and the partial lists merge in distributed
shared memory: one launch. Rows past N are skipped by index instead of the
TPU kernel's -4 sentinel column. Ties go to the lower row.

Domain: both operands float32 or both bf16, any width 1 <= D <= 256, any
1 <= k <= 32, N >= k; Q and N need not be tile multiples. The kernel reads
the database through a TMA tensor map, whose row pitch must be a multiple
of 16 bytes; it reads the D columns of a row and fills the rest with zeros.
`knn_rows` gives a database that pitch (itself where it has it, else a view
of a zero-padded copy); the engines call it once when they take their
database, so that no call copies it. A database without that pitch is
padded on each call.

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

MAX_DIM = 256  # the kernel's widest rows
MAX_K = 32     # its longest lists
#: the kernel's operand types -> the dtype code of its C entry point
KERNEL_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def kernel_math(dtype: torch.dtype) -> str:
    """The instruction path of csrc/knn.cu for operands of `dtype`: bf16 on
    the bf16 tensor cores, float32 as three TF32 products."""
    if dtype == torch.bfloat16:
        return "mma.bf16"
    if dtype == torch.float32:
        return "mma.3xtf32"
    raise ValueError(f"streaming_knn: no kernel path for {dtype}")


def streaming_knn_sims_plain(queries: torch.Tensor, database: torch.Tensor, k: int):
    """The plain PyTorch version of the kernel's raw output:
    (similarities (Q, k) float32, indices (Q, k) int32), best first."""
    return iterative_topk(queries.float() @ database.float().T, k)


def _check(queries: torch.Tensor, database: torch.Tensor, k: int) -> None:
    for name, t in (("queries", queries), ("database", database)):
        if t.dtype not in KERNEL_DTYPES or t.dim() != 2:
            raise ValueError(f"streaming_knn: {name} must be 2-D float32 or bfloat16, got "
                             f"{t.dtype} {tuple(t.shape)}")
    if queries.dtype != database.dtype or queries.shape[1] != database.shape[1]:
        raise ValueError(f"streaming_knn: queries {queries.dtype} {tuple(queries.shape)} and "
                         f"database {database.dtype} {tuple(database.shape)} must share dtype "
                         f"and width")
    d, n = database.shape[1], database.shape[0]
    if not 1 <= d <= MAX_DIM:
        raise ValueError(f"streaming_knn: width D={d}; the kernel takes 1 <= D <= {MAX_DIM}")
    if not 1 <= k <= MAX_K or n < k:
        raise ValueError(f"streaming_knn: k={k} against N={n} rows; the kernel takes "
                         f"1 <= k <= {MAX_K} and N >= k")


def knn_rows(database: torch.Tensor) -> torch.Tensor:
    """`database` (N, D) as the kernel reads it in place: unit column stride,
    16-byte aligned, a row pitch of a multiple of 16 bytes. Returned as it is
    where it has that layout, else as the first D columns of a copy padded
    with zeros to the next such pitch."""
    n, d = database.shape
    granule = 16 // database.element_size()
    if (database.stride(1) == 1 and database.stride(0) >= d
            and database.stride(0) % granule == 0 and database.data_ptr() % 16 == 0):
        return database
    rows = database.new_zeros((n, -(-d // granule) * granule))
    rows[:, :d] = database
    return rows[:, :d]


def streaming_knn_sims(queries: torch.Tensor, database: torch.Tensor, k: int):
    """(similarities (Q, k) float32, indices (Q, k) int32), best first."""
    _check(queries, database, k)
    if queries.device.type == "cpu" and database.device.type == "cpu":
        return streaming_knn_sims_plain(queries, database, k)
    if queries.device.type != "cuda" or database.device != queries.device:
        raise ValueError(f"streaming_knn: tensors on {queries.device} and "
                         f"{database.device}; both must be on one CUDA device")
    q, n = queries.shape[0], database.shape[0]
    sims = torch.empty((q, k), dtype=torch.float32, device=queries.device)
    idx = torch.empty((q, k), dtype=torch.int32, device=queries.device)
    if q == 0:
        return sims, idx
    queries, database = queries.contiguous(), knn_rows(database)
    _build.launch("knn", queries.device, KERNEL_DTYPES[queries.dtype], queries.data_ptr(),
                  database.data_ptr(), sims.data_ptr(), idx.data_ptr(), q, n,
                  database.shape[1], database.stride(0), k)
    streaming_knn_sims.launches += 1
    streaming_knn_sims.dtype_launches[queries.dtype] += 1
    streaming_knn_sims.math = kernel_math(queries.dtype)
    return sims, idx


streaming_knn_sims.launches = 0
streaming_knn_sims.dtype_launches = dict.fromkeys(KERNEL_DTYPES, 0)  # the same, by dtype
streaming_knn_sims.math = None  # the instruction path of the last launch


def streaming_knn(queries: torch.Tensor, database: torch.Tensor, k: int):
    """Like ops/knn.exact_knn: (int32 indices, sq_dists = max(2 - 2·cos, 0))."""
    sims, idx = streaming_knn_sims(queries, database, k)
    return idx, torch.clamp(2.0 - 2.0 * sims, min=0.0)
