"""Fused gather + K-way patch attention over tile-major rows.

Kernel: csrc/gathered_attention.cu, replacing the Pallas
`pallas_gathered_patch_attention_v2` (retrieval_fuse_tpu/ops/
pallas_attention.py:249 `_gathered_kernel_v2`, :327). For each tile of
T=64 attention patches it reads the tile's K bank rows by index, runs the
theta MLP on x and the phi MLP on every candidate, scores, selects, blends,
and writes only the (T, F) output rows.

Bound on the H100: at batch 128 (Q=8192) 279 GFLOP of MLP GEMMs, ~0.28 ms
at the bf16 tensor-core rate, and ~0.8 GB of bf16 rows, ~0.24 ms. The first
kernel multiplies with float32 FMAs from shared memory, so its floor is the
67 TFLOP/s FMA rate (>= 4.2 ms); tensor cores are later work. The TPU
workarounds are not carried over: the index operand is read by each block
as a (Q, K) array (no SMEM flattening), and Q needs no padding to a group
multiple (no sublane / grid-step constraints).

`gathered_patch_attention` launches the kernel on CUDA tensors and runs
`gathered_patch_attention_plain` on CPU tensors; it never falls back from
one to the other. The kernel takes T=64, F=128, hidden 128, C=32 (the
shipped geometry); the plain version takes any.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from retrieval_fuse_tpu_torch.ops import _build

KERNEL_ROWS, KERNEL_FEATURES, KERNEL_EMBED = 64, 128, 32
_LAYERS = ("fc0", "fc1", "fc2", "out")


def _mlp(x: torch.Tensor, w: nn.Module) -> torch.Tensor:
    """x (R, F) through fc0..fc2 (LeakyReLU 0.01) + out -> (R, C) float32.

    As the JAX `_mlp`: every GEMM multiplies values of x's dtype (weights
    rounded to it) with float32 accumulation and a float32 bias; in bf16 the
    hidden activations are rounded back to bf16 between layers. The products
    are formed in float32, because a bf16 torch.matmul would round its
    result to bf16."""
    dt = x.dtype
    for name in _LAYERS[:3]:
        fc = getattr(w, name)
        h = x.float() @ fc.weight.to(dt).float().T + fc.bias.float()
        x = torch.where(h >= 0, h, 0.01 * h).to(dt)
    return x.float() @ w.out.weight.to(dt).float().T + w.out.bias.float()


def _l2n(v: torch.Tensor) -> torch.Tensor:
    return v / torch.clamp(torch.sqrt(torch.sum(v * v, dim=-1, keepdim=True)), min=1e-12)


def pack_tile_rows(tile_feats: torch.Tensor, e: int) -> torch.Tensor:
    """(N, s, s, s, nf) feature tiles -> (N, (s//e)³, e³·nf) patch-major rows,
    as in the JAX package (pallas_attention.py:139). Run once on the bank."""
    n, s, _, _, nf = tile_feats.shape
    t = s // e
    v = tile_feats.reshape(n, t, e, t, e, t, e, nf)
    v = v.permute(0, 1, 3, 5, 2, 4, 6, 7)
    return v.reshape(n, t ** 3, e ** 3 * nf)


def gathered_patch_attention_plain(xt, bank_rows, top_idx, theta, phi, K: int,
                                   retrieval_mode: bool = True,
                                   sharpness: float = 1024.0):
    """The plain PyTorch version. Returns (out (Q, T, F) in xt's dtype,
    selection (Q, T) int64: the argmax candidate of each row)."""
    q, t, f = xt.shape
    xf = _l2n(_mlp(xt.reshape(q * t, f), theta)).reshape(q, 1, t, -1)
    p = bank_rows[top_idx.long()]                                   # (Q, K, T, F)
    pf = _l2n(_mlp(p.reshape(q * K * t, f), phi)).reshape(q, K, t, -1)
    s = torch.sum(xf * pf, dim=-1).permute(0, 2, 1)                 # (Q, T, K)
    switch = F.relu(torch.amax(s, dim=-1, keepdim=True))
    sel = torch.argmax(s * 25.0, dim=-1)                            # first maximum
    if retrieval_mode:
        weights = F.one_hot(sel, K).float()
    else:
        weights = torch.softmax(sharpness * s, dim=-1)
    weighted = sum(weights[..., k:k + 1] * p[:, k].float() for k in range(K))
    out = xt.float() * (1.0 - switch) + weighted * switch
    return out.to(xt.dtype), sel


def _pack(w: nn.Module, dtype: torch.dtype) -> tuple[torch.Tensor, torch.Tensor]:
    """An attention MLP -> (weights in (in, out) layout, concatenated, in
    `dtype`; biases, concatenated, float32): the kernel's operand layout."""
    weights = torch.cat([getattr(w, n).weight.T.reshape(-1) for n in _LAYERS])
    biases = torch.cat([getattr(w, n).bias.reshape(-1) for n in _LAYERS])
    return weights.to(dtype).contiguous(), biases.float().contiguous()


def gathered_patch_attention(xt: torch.Tensor, bank_rows: torch.Tensor,
                             top_idx: torch.Tensor, theta: nn.Module, phi: nn.Module,
                             K: int, retrieval_mode: bool = True,
                             sharpness: float = 1024.0, return_selection: bool = False):
    """Fused gather + K-way patch attention.

    xt: (Q, T, F) tile-major backbone patch rows; bank_rows: (N, T, F)
    pre-packed bank tiles (pack_tile_rows); top_idx: (Q, K) int32 rows in
    [0, N); theta, phi: the AttentionFeatureEncoder MLPs. Returns the fused
    rows (Q, T, F) in xt's dtype, and with `return_selection` also the
    (Q, T) argmax candidate of each row."""
    if xt.device.type == "cpu" and bank_rows.device.type == "cpu":
        out, sel = gathered_patch_attention_plain(xt, bank_rows, top_idx, theta, phi, K,
                                                  retrieval_mode, sharpness)
        return (out, sel) if return_selection else out
    dev = xt.device
    if dev.type != "cuda" or bank_rows.device != dev or top_idx.device != dev:
        raise ValueError("gathered_patch_attention: xt, bank_rows and top_idx must be "
                         "on one CUDA device")
    if xt.dtype not in (torch.float32, torch.bfloat16) or bank_rows.dtype != xt.dtype:
        raise ValueError(f"gathered_patch_attention: xt and bank_rows must share "
                         f"float32 or bfloat16, got {xt.dtype}, {bank_rows.dtype}")
    rows, feats = KERNEL_ROWS, KERNEL_FEATURES
    q = xt.shape[0]
    if (xt.dim() != 3 or tuple(xt.shape[1:]) != (rows, feats) or bank_rows.dim() != 3
            or tuple(bank_rows.shape[1:]) != (rows, feats)):
        raise ValueError(f"gathered_patch_attention: the kernel takes (·, {rows}, {feats}) "
                         f"rows, got {tuple(xt.shape)} and {tuple(bank_rows.shape)}")
    if top_idx.dtype != torch.int32 or tuple(top_idx.shape) != (q, K) or not 1 <= K <= 8:
        raise ValueError(f"gathered_patch_attention: top_idx must be int32 ({q}, {K}) "
                         f"with 1 <= K <= 8, got {top_idx.dtype} {tuple(top_idx.shape)}")
    if not (xt.is_contiguous() and bank_rows.is_contiguous() and top_idx.is_contiguous()):
        raise ValueError("gathered_patch_attention: inputs must be contiguous")
    for w in (theta, phi):
        if (tuple(w.fc0.weight.shape) != (128, feats) or tuple(w.fc1.weight.shape) != (128, 128)
                or tuple(w.fc2.weight.shape) != (128, 128)
                or tuple(w.out.weight.shape) != (KERNEL_EMBED, 128)):
            raise ValueError("gathered_patch_attention: the kernel takes "
                             f"{feats}->128->128->128->{KERNEL_EMBED} MLPs")
    out = torch.empty_like(xt)
    sel = torch.empty((q, rows), dtype=torch.int32, device=dev) if return_selection else None
    if q == 0:
        return (out, sel) if return_selection else out
    w_theta, b_theta = _pack(theta, xt.dtype)
    w_phi, b_phi = _pack(phi, xt.dtype)
    _build.launch("gathered_attention", dev, 0 if xt.dtype == torch.float32 else 1,
                  xt.data_ptr(), bank_rows.data_ptr(), top_idx.data_ptr(), q, K,
                  w_theta.data_ptr(), b_theta.data_ptr(), w_phi.data_ptr(), b_phi.data_ptr(),
                  int(bool(retrieval_mode)), float(sharpness), out.data_ptr(),
                  None if sel is None else sel.data_ptr())
    gathered_patch_attention.launches += 1
    return (out, sel) if return_selection else out


gathered_patch_attention.launches = 0
