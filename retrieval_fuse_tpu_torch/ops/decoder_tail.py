"""The serving decoder's tail on the packed grid, as in the JAX package's
ops/pallas_decoder.py (token `cdec`).

Kernel: csrc/decoder_tail.cu, replacing the Pallas `packed_decoder_tail`
(retrieval_fuse_tpu/ops/pallas_decoder.py:94 `_decoder_tail_kernel`, :154).
It runs conv2 (3³, nf -> nf) of the 2x grid, ReLU, the 1x1 head, bias and
tanh in one pass over conv1's packed S³ output, so no (2S)³ tensor is
written: the direct 27-tap conv, read through the packed layout. In bf16 at
nf = 16 (the flagship width) and nf = 12 (surface reconstruction, its
channels zero-padded to 16 in shared memory) it is an implicit GEMM on the
tensor cores (`mma.sync.m16n8k16`, bf16 products, float32 sums: one tap is
one k16 step) over a bf16 slab in shared memory, filled once for 2 x 2
packed positions by the copy warps of a persistent block while its compute
warps run the tile before; in float32, and at nf 4 and 8, it multiplies
with float32 FMAs
(float32 on the tensor cores would be TF32). `decoder_tail.math` names the
path of the last launch. Its bound on the H100 at batch 128 (S=32, nf=16)
is 0.47 ms of bf16 tensor-core work (465 GFLOP) against 0.43 ms of bytes
(1.42 GB); the tensor-core body is held by its conv loop of `mma.sync` and
fragment loads, ~2.4x the bound (csrc/decoder_tail.cu; times in PERF.md).
The kernel takes any nf in 1..KERNEL_MAX_NF (64) and S <= KERNEL_MAX_S:
the shipped widths (KERNEL_NF) launch the instances above, every other nf
a general instance: in bf16 up to nf 32 the tensor-core body at one or two
groups of 16 channels (zero-padded, as nf 12 is) where its slab fits
(general_tensor_core: nf <= 16 at any S, nf <= 32 at S <= 32), elsewhere
the FMA body walking the input channels in chunks of 8 with its sums
padded to a multiple of 8 channels (csrc/decoder_tail.cu says why the
tensor-core body stops there).
`decoder_tail.instance` names the instance of the last launch.

`decoder_tail` launches the kernel on CUDA tensors and runs
`decoder_tail_plain` on CPU tensors; it never falls back from one to the
other. The plain version is the JAX kernel's own algorithm: one im2col GEMM
over the 4³ = 64 packed (offset, block) combinations per position, with the
packed weights of `pack_conv2_imcol_kernel` and `pack_head_kernel`.

`CompactPackedDecoder` is the decoder around it: GN1 -> fused conv1 ->
ReLU -> GN2 statistics on the packed layout -> affine + zero pad (the pad
ring is conv2's SAME padding, in normalised space) -> the tail ->
depth-to-space.
"""

from __future__ import annotations

import itertools

import numpy as np
import torch
import torch.nn.functional as F

from retrieval_fuse_tpu_torch.ops import _build
from retrieval_fuse_tpu_torch.ops.fused_decoder import FusedFinalDecoder, _groups, group_moments

KERNEL_NF = (4, 8, 12, 16)  # the shipped conv widths, which have instances of their own
KERNEL_MAX_NF = 64  # every other nf up to this runs the general instance
KERNEL_MAX_S = 80  # the largest coarse grid whose slab fits a block's shared memory
MMA_NF = (12, 16)  # the widths whose bf16 launch runs on the tensor cores


def general_tensor_core(nf: int, s: int) -> bool:
    """Whether the general tensor-core instance of csrc/decoder_tail.cu
    takes conv width nf and coarse grid S: nf <= 32, in G = ceil(nf / 16)
    groups of 16 channels, where the B fragments of every tap (27·G²·512
    bytes), the head and one slab of 6 x 6 rows of (2S rounded up to 32) + 2
    voxels of 32·G bytes fit a block's 232,448 bytes (the kernel's
    `launch_mma_g`)."""
    g = -(-nf // 16)
    pitch = (2 * s + 31) // 32 * 32 + 2
    return g <= 2 and 27 * g * g * 512 + 64 * g + 36 * pitch * 32 * g <= 232448


def kernel_instance(dtype: torch.dtype, nf: int, s: int) -> int:
    """The instance of csrc/decoder_tail.cu that the wrapper launches for an
    input of `dtype`, conv width nf and coarse grid S: 0, the shipped ones
    (nf in KERNEL_NF); 2, the general tensor-core body (bf16 where
    general_tensor_core); 1, the general FMA body (everything else)."""
    if nf in KERNEL_NF:
        return 0
    return 2 if dtype == torch.bfloat16 and general_tensor_core(nf, s) else 1


def kernel_math(dtype: torch.dtype, nf: int, s: int = 32) -> str:
    """The instruction path of csrc/decoder_tail.cu for an input of `dtype`,
    conv width nf and coarse grid S: bf16 at nf 12 and 16 and on the
    general tensor-core instance runs `mma.sync`, everything else a
    float32-FMA body."""
    instance = kernel_instance(dtype, nf, s)
    tensor_core = instance == 2 or (instance == 0 and dtype == torch.bfloat16 and nf in MMA_NF)
    return "mma.bf16" if tensor_core else "fma.f32"

_YS = (-1, 0, 1, 2)  # 2x-grid tap offsets reachable from a packed position
#: the JAX helper's im2col row-block order: y2-major, then y0, y1
_COL_GROUPS = tuple(tuple((y0, y1, y2) for y0 in _YS for y1 in _YS) for y2 in _YS)
_COLS = tuple(y for grp in _COL_GROUPS for y in grp)


def pack_conv2_imcol_kernel(w: np.ndarray) -> np.ndarray:
    """(3,3,3,nf,nf) SAME conv kernel on the 2x grid -> (64·nf, 8·nf) im2col
    GEMM weight on the packed grid: row block y (in _COLS order) maps to
    output block (o_idx, c) with w[k], k = y-o+1, wherever all k_i ∈ {0,1,2}."""
    w = np.asarray(w)
    nf = w.shape[3]
    assert w.shape == (3, 3, 3, nf, nf), w.shape
    packed = np.zeros((64 * nf, 8 * nf), w.dtype)
    for yi, y in enumerate(_COLS):
        for oi, o in enumerate(itertools.product((0, 1), repeat=3)):
            k = tuple(yy - oo + 1 for yy, oo in zip(y, o))
            if all(0 <= kk <= 2 for kk in k):
                packed[yi * nf:(yi + 1) * nf, oi * nf:(oi + 1) * nf] = w[k]
    return packed


def pack_head_kernel(w: np.ndarray) -> np.ndarray:
    """1x1 head kernel (nf,) (or (1,1,1,nf,1)) -> block-diagonal (8·nf, 8):
    packed output sub-voxel o reads channel block o."""
    w = np.asarray(w).reshape(-1)
    nf = w.shape[0]
    packed = np.zeros((8 * nf, 8), w.dtype)
    for o in range(8):
        packed[o * nf:(o + 1) * nf, o] = w
    return packed


def depth_to_space_1ch(x: torch.Tensor) -> torch.Tensor:
    """(B, S, S, S, 8) o_idx-minor packed scalars -> (B, 2S, 2S, 2S, 1)."""
    b, s = x.shape[0], x.shape[1]
    x = x.reshape(b, s, s, s, 2, 2, 2).permute(0, 1, 4, 2, 5, 3, 6)
    return x.reshape(b, 2 * s, 2 * s, 2 * s, 1)


def decoder_tail_plain(hn_pad: torch.Tensor, w2: torch.Tensor, wh: torch.Tensor,
                       bias: float, chunk: int = 8) -> torch.Tensor:
    """The plain PyTorch version: the im2col GEMM of the JAX kernel, `chunk`
    batch items at a time, float32 sums of values of hn_pad's dtype."""
    b, sp = hn_pad.shape[0], hn_pad.shape[1]
    s, nf = sp - 2, hn_pad.shape[-1] // 8
    dev = hn_pad.device
    w2p = torch.from_numpy(pack_conv2_imcol_kernel(w2.detach().float().cpu().numpy())).to(dev)
    whp = torch.from_numpy(pack_head_kernel(wh.detach().float().cpu().numpy())).to(dev)
    outs = []
    for start in range(0, b, chunk):
        h = hn_pad[start:start + chunk].float()
        cols = []
        for y in _COLS:
            d = [(yy - yy % 2) // 2 for yy in y]
            oi = ((y[0] % 2) * 4 + (y[1] % 2) * 2 + y[2] % 2) * nf
            cols.append(h[:, 1 + d[0]:1 + d[0] + s, 1 + d[1]:1 + d[1] + s,
                          1 + d[2]:1 + d[2] + s, oi:oi + nf])
        z = torch.relu(torch.cat(cols, dim=-1) @ w2p).to(hn_pad.dtype).float()
        outs.append(torch.tanh(z @ whp + bias))
    return torch.cat(outs)


def decoder_tail(hn_pad: torch.Tensor, w2: torch.Tensor, wh: torch.Tensor,
                 bias: float) -> torch.Tensor:
    """hn_pad (B, S+2, S+2, S+2, 8·nf): normalised conv1 output, zero-padded
    by one, o_idx-major channel blocks; w2 (3, 3, 3, nf, nf) DHWIO and wh
    (nf,) holding values of hn_pad's dtype; bias a float. Returns (B, S, S,
    S, 8) float32 tanh(head(relu(conv2))) + bias of the 2x grid, o_idx-minor."""
    if hn_pad.device.type == "cpu":
        return decoder_tail_plain(hn_pad, w2, wh, bias)
    dev = hn_pad.device
    if dev.type != "cuda" or w2.device != dev or wh.device != dev:
        raise ValueError("decoder_tail: hn_pad, w2 and wh must be on one CUDA device")
    if hn_pad.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"decoder_tail: hn_pad must be float32 or bfloat16, got {hn_pad.dtype}")
    if hn_pad.dim() != 5 or len(set(hn_pad.shape[1:4])) != 1 or hn_pad.shape[1] < 3:
        raise ValueError(f"decoder_tail: hn_pad must be (B, S+2, S+2, S+2, 8·nf), "
                         f"got {tuple(hn_pad.shape)}")
    b, s, c8 = hn_pad.shape[0], hn_pad.shape[1] - 2, hn_pad.shape[-1]
    nf = c8 // 8
    if c8 % 8 or not 1 <= nf <= KERNEL_MAX_NF:
        raise ValueError(f"decoder_tail: the kernel takes nf in 1..{KERNEL_MAX_NF}, got {c8} "
                         f"channels")
    if s > KERNEL_MAX_S:
        raise ValueError(f"decoder_tail: the kernel takes S <= {KERNEL_MAX_S}, got S = {s}")
    if tuple(w2.shape) != (3, 3, 3, nf, nf) or tuple(wh.shape) != (nf,):
        raise ValueError(f"decoder_tail: w2 must be (3, 3, 3, {nf}, {nf}) and wh ({nf},), "
                         f"got {tuple(w2.shape)}, {tuple(wh.shape)}")
    if not hn_pad.is_contiguous() or hn_pad.data_ptr() % 16:
        raise ValueError("decoder_tail: hn_pad must be contiguous and 16-byte aligned")
    out = torch.empty((b, s, s, s, 8), dtype=torch.float32, device=dev)
    if b == 0:
        return out
    w2f, whf = w2.float().contiguous(), wh.float().contiguous()
    instance = kernel_instance(hn_pad.dtype, nf, s)
    _build.launch("decoder_tail", dev, 0 if hn_pad.dtype == torch.float32 else 1,
                  hn_pad.data_ptr(), w2f.data_ptr(), whf.data_ptr(), float(bias), b, s, nf,
                  instance, out.data_ptr())
    decoder_tail.launches += 1
    decoder_tail.math = kernel_math(hn_pad.dtype, nf, s)
    decoder_tail.instance = "general" if instance else "shipped"
    return out


decoder_tail.launches = 0
decoder_tail.math = None  # the instruction path of the last launch
decoder_tail.instance = None  # "shipped" or "general": the instance of the last launch


class CompactPackedDecoder(FusedFinalDecoder):
    """FusedFinalDecoder whose conv2, head and tanh run as the decoder-tail
    kernel on the packed grid: GN1 -> fused conv1 -> ReLU -> GN2 statistics
    on the packed layout -> affine + pad -> decoder_tail -> depth-to-space.
    No (2S)³ intermediate is written."""

    def __init__(self, state_dict: dict, nf: int, dtype: torch.dtype = torch.float32):
        super().__init__(state_dict, nf, dtype)
        self.register_buffer("w2_dhwio", self.w2.permute(2, 3, 4, 1, 0).contiguous())
        self.bias_h = float(self.b_final)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """x: (B, S, S, S, nf) -> (B, 2S, 2S, 2S, 1) tanh TSDF, float32."""
        return depth_to_space_1ch(decoder_tail(self.tail_input(x), self.w2_dhwio,
                                               self.w_final, self.bias_h))

    def tail_input(self, x: torch.Tensor) -> torch.Tensor:
        """x: (B, S, S, S, nf) -> decoder_tail's hn_pad (B, S+2, S+2, S+2, 8·nf)."""
        nf = self.nf
        h = self.conv1(x)                                   # (B, S³, 8·nf)
        # GroupNorm-on-2x-grid statistics on the packed layout: per (item,
        # group) over (spatial, all 8 sub-voxel blocks, the group's channels)
        b = h.shape[0]
        g = _groups(nf, self.num_groups)
        xg = h.reshape(b, -1, 8, g, nf // g).float()
        mean, var = (m.reshape(b, g) for m in group_moments(xg, (1, 2, 4)))
        rstd = torch.rsqrt(var + 1e-5)
        scale8 = self.gn2_scale.float().repeat(8).reshape(8, g, nf // g)
        bias8 = self.gn2_bias.float().repeat(8).reshape(8, g, nf // g)
        a = (rstd[:, None, :, None] * scale8).reshape(b, 1, 1, 1, 8 * nf)
        c = (bias8 - (mean * rstd)[:, None, :, None] * scale8).reshape(b, 1, 1, 1, 8 * nf)
        return F.pad((h * a + c).to(h.dtype), (0, 0, 1, 1, 1, 1, 1, 1))
