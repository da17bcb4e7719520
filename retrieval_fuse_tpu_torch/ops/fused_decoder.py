"""Serving decoders of the final decoder that every task shares, on the
coarse grid, as in the JAX package's ops/fused_decoder.py.

The final decoder (models/refinement.Superresolution08FinalDecoder) is
GN -> nearest-2x upsample -> 3³ conv -> ReLU -> GN -> 3³ conv -> ReLU ->
1x1 head -> tanh. Its first conv reads nearest-upsampled data, so every 2³
output block reads the same coarse values with different weights: folding
the upsample into the conv gives ONE 3³ conv on the S³ grid with 8·nf output
channels (`fuse_upsample_conv_kernel`), and GroupNorm on the duplicated data
has the source grid's statistics, so the first norm runs on S³ too.

  FusedFinalDecoder        fused conv1, then depth-to-space and the rest
                           unchanged (token `fused`)
  PackedFinalDecoder       conv2 and the head on the space-to-depth-packed
                           S³ grid too (`pack_conv_kernel_2x`, token `packed`)
  DecomposedPackedDecoder  conv2 split into 8 parity sub-grid convs
                           (`decomposed_conv2_kernels`, token `dconv`)

All three compute the plain decoder's function. The weight helpers take and
return DHWIO numpy arrays (the JAX layout), so they read line for line
against the JAX ones; `_oidhw` turns a result into F.conv3d's layout. The
JAX engine casts its params to the compute dtype BEFORE it fuses them, so
in bf16 its fused weights are summed in bf16, rounded after every add in
the helper's loop order. `_round` reproduces that: float32 numpy arrays
carry the values, and each add is rounded to the compute dtype.
"""

from __future__ import annotations

import itertools

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn


def _round(a: np.ndarray, dtype: torch.dtype) -> np.ndarray:
    """float32 values -> the nearest values of `dtype` (to nearest even)."""
    if dtype == torch.float32:
        return a
    return torch.from_numpy(np.ascontiguousarray(a)).to(dtype).float().numpy()


def fuse_upsample_conv_kernel(w: np.ndarray, dtype: torch.dtype = torch.float32) -> np.ndarray:
    """(3,3,3,Cin,Cout) conv kernel meant for nearest-2x-upsampled input ->
    (3,3,3,Cin,8·Cout) kernel on the pre-upsample grid.

    out[2i+o] = Σ_k w[k] · x_up[2i+o+k-1] with x_up[j] = x[j//2], so the
    coarse tap offset is d = (o+k-1)//2 ∈ {-1,0,1}; taps sharing (o, d) are
    pre-summed, each add rounded to `dtype`. Output channel block
    o_idx = o0·4 + o1·2 + o2."""
    w = np.asarray(w, np.float32)
    c_in, c_out = w.shape[3], w.shape[4]
    fused = np.zeros((3, 3, 3, c_in, 8 * c_out), np.float32)
    for o in itertools.product((0, 1), repeat=3):
        o_idx = o[0] * 4 + o[1] * 2 + o[2]
        for k in itertools.product(range(3), repeat=3):
            d = tuple((oo + kk - 1) // 2 for oo, kk in zip(o, k))
            sl = (d[0] + 1, d[1] + 1, d[2] + 1, slice(None),
                  slice(o_idx * c_out, (o_idx + 1) * c_out))
            fused[sl] = _round(fused[sl] + w[k[0], k[1], k[2]], dtype)
    return fused


def _upsample_tap_map() -> np.ndarray:
    """(27 taps k, 27 coarse offsets d, 8 output sub-positions o) 0/1 map:
    fuse_upsample_conv_kernel adds tap k of w into slot (d, o)."""
    m = np.zeros((27, 27, 8), np.float32)
    for o in itertools.product((0, 1), repeat=3):
        o_idx = o[0] * 4 + o[1] * 2 + o[2]
        for k in itertools.product(range(3), repeat=3):
            d = tuple((oo + kk - 1) // 2 + 1 for oo, kk in zip(o, k))
            m[k[0] * 9 + k[1] * 3 + k[2], d[0] * 9 + d[1] * 3 + d[2], o_idx] = 1.0
    return m


_UPSAMPLE_TAP_MAP = _upsample_tap_map()


def fuse_upsample_conv_kernel_torch(w: torch.Tensor) -> torch.Tensor:
    """fuse_upsample_conv_kernel of a DHWIO torch weight (3,3,3,Cin,Cout) ->
    (3,3,3,Cin,8·Cout), differentiable: one fixed linear map of w, so
    gradients reach the canonical weight and checkpoints keep the unfused
    layout (training-time fusion, FusedUpsampleSingleConv)."""
    c_in, c_out = w.shape[3], w.shape[4]
    m = torch.from_numpy(_UPSAMPLE_TAP_MAP).to(device=w.device, dtype=w.dtype)
    fused = torch.einsum("kdo,kic->dioc", m, w.reshape(27, c_in, c_out))
    return fused.reshape(3, 3, 3, c_in, 8 * c_out)


def pack_conv_kernel_2x(w: np.ndarray, dtype: torch.dtype = torch.float32) -> np.ndarray:
    """(3,3,3,Cin,Cout) SAME conv kernel on the 2x grid -> (3,3,3,8·Cin,8·Cout)
    kernel on the space-to-depth-packed coarse grid.

    For output sub-position o ∈ {0,1}³ and tap k ∈ {-1,0,1}³ the 2x-grid read
    2i+o+k lands in packed block o' = (o+k) mod 2 at coarse offset
    d = (o+k-o')//2 ∈ {-1,0,1}; each (o, k) has its own slot, so the packed
    kernel is 1/8 dense."""
    w = np.asarray(w, np.float32)
    c_in, c_out = w.shape[3], w.shape[4]
    packed = np.zeros((3, 3, 3, 8 * c_in, 8 * c_out), np.float32)
    for o in itertools.product((0, 1), repeat=3):
        o_idx = o[0] * 4 + o[1] * 2 + o[2]
        for k in itertools.product((-1, 0, 1), repeat=3):
            y = tuple(oo + kk for oo, kk in zip(o, k))
            op = tuple(yy % 2 for yy in y)
            d = tuple((yy - (yy % 2)) // 2 for yy in y)
            op_idx = op[0] * 4 + op[1] * 2 + op[2]
            sl = (d[0] + 1, d[1] + 1, d[2] + 1, slice(op_idx * c_in, (op_idx + 1) * c_in),
                  slice(o_idx * c_out, (o_idx + 1) * c_out))
            packed[sl] = _round(packed[sl] + w[k[0] + 1, k[1] + 1, k[2] + 1], dtype)
    return packed


def decomposed_conv2_kernels(w: np.ndarray):
    """(3,3,3,Cin,Cout) SAME conv on the 2x grid -> 8 sub-grid kernels
    [(k0,k1,k2,Cin,8·Cout)] and their per-axis (lo, hi) paddings, one per
    input sub-position s.

    The 2x-grid read y = o+k-1 lives in sub-grid s = y mod 2 at coarse offset
    d = (y-s)/2: offsets {0,1} (2 taps, pad (0,1)) for s=0 and {-1,0,1}
    (3 taps, pad (1,1)) for s=1; conv2 = Σ_s conv(x_s, K_s)."""
    w = np.asarray(w, np.float32)
    c_in, c_out = w.shape[3], w.shape[4]
    kernels, paddings = [], []
    for s in itertools.product((0, 1), repeat=3):
        ks = tuple(2 if sd == 0 else 3 for sd in s)
        kern = np.zeros(ks + (c_in, 8 * c_out), np.float32)
        paddings.append(tuple((0, 1) if sd == 0 else (1, 1) for sd in s))
        for o in itertools.product((0, 1), repeat=3):
            o_idx = o[0] * 4 + o[1] * 2 + o[2]
            for k in itertools.product(range(3), repeat=3):
                y = tuple(oo + kk - 1 for oo, kk in zip(o, k))
                if tuple(yy % 2 for yy in y) != s:
                    continue
                d = tuple((yy - (yy % 2)) // 2 for yy in y)
                idx = tuple(dd if sd == 0 else dd + 1 for dd, sd in zip(d, s))
                kern[idx[0], idx[1], idx[2], :,
                     o_idx * c_out:(o_idx + 1) * c_out] = w[k[0], k[1], k[2]]
        kernels.append(kern)
    return kernels, paddings


def depth_to_space_2x(x: torch.Tensor, c_out: int) -> torch.Tensor:
    """(B, D, H, W, 8·C) with o_idx-major channel blocks -> (B, 2D, 2H, 2W, C)."""
    b, d, h, w, _ = x.shape
    x = x.reshape(b, d, h, w, 2, 2, 2, c_out)
    x = x.permute(0, 1, 4, 2, 5, 3, 6, 7)
    return x.reshape(b, 2 * d, 2 * h, 2 * w, c_out)


def _groups(c: int, num_groups: int) -> int:
    return num_groups if (c >= num_groups and c % num_groups == 0) else 1


def group_moments(xg: torch.Tensor, dims: tuple) -> tuple[torch.Tensor, torch.Tensor]:
    """The mean and centred variance of float32 xg over `dims` (kept), as
    flax's GroupNorm takes them, in float32. On the CPU the sums accumulate
    in float64: PyTorch's CPU sum along an axis that is not the innermost
    runs in sequence, and over a group of 10^5-10^6 values (a 64³ decoder
    grid) its float32 error reaches 1e-4 of the normalised values; CUDA's
    tree reductions keep float32's precision, and their float32 sums stay."""
    acc = torch.float64 if xg.device.type == "cpu" else None
    mean = xg.mean(dim=dims, keepdim=True, dtype=acc).float()
    var = ((xg - mean) ** 2).mean(dim=dims, keepdim=True, dtype=acc).float()
    return mean, var


def group_norm(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
               num_groups: int, eps: float = 1e-5) -> torch.Tensor:
    """flax GroupNorm on channels-last x: statistics over the spatial axes
    and the channels of a group, in float32; the result in x's dtype."""
    b, c = x.shape[0], x.shape[-1]
    g = _groups(c, num_groups)
    xg = x.reshape(b, -1, g, c // g).float()
    mean, var = group_moments(xg, (1, 3))
    xn = ((xg - mean) * torch.rsqrt(var + eps)).reshape(x.shape)
    return (xn * scale.float() + bias.float()).to(x.dtype)


def group_norm_packed(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
                      num_groups: int, nf: int, eps: float = 1e-5) -> torch.Tensor:
    """GroupNorm over a packed (B, S, S, S, 8·nf) tensor with the statistics
    of GroupNorm(num_groups) on the unpacked 2x-grid tensor: per group, over
    (spatial, all 8 sub-voxel blocks, the group's channels)."""
    b = x.shape[0]
    g = _groups(nf, num_groups)
    xg = x.reshape(b, -1, 8, g, nf // g).float()
    mean, var = group_moments(xg, (1, 2, 4))
    xn = ((xg - mean) * torch.rsqrt(var + eps)).reshape(x.shape)
    return (xn * scale.float().repeat(8) + bias.float().repeat(8)).to(x.dtype)


def conv3d(x: torch.Tensor, w: torch.Tensor, padding=1) -> torch.Tensor:
    """Channels-last x (B, D, H, W, Cin), F.conv3d weight (O, I, kD, kH, kW)
    -> channels-last (B, D', H', W', O) in x's dtype (float32 sums)."""
    return F.conv3d(x.permute(0, 4, 1, 2, 3), w, padding=padding).permute(0, 2, 3, 4, 1)


def _dhwio(w: torch.Tensor) -> np.ndarray:
    """F.conv3d weight -> DHWIO float32 numpy."""
    return w.detach().float().permute(2, 3, 4, 1, 0).cpu().numpy()


def _oidhw(w: np.ndarray, dtype: torch.dtype) -> torch.Tensor:
    """DHWIO numpy -> F.conv3d weight in `dtype`."""
    return torch.from_numpy(np.ascontiguousarray(w)).permute(4, 3, 0, 1, 2).contiguous().to(dtype)


class FusedFinalDecoder(nn.Module):
    """Superresolution08FinalDecoder (layer order 'gcr') with the upsample
    folded into conv1: GN -> fused conv (8·nf channels) -> ReLU -> d2s ->
    GN -> conv -> ReLU -> 1x1 head -> tanh. Built from the decoder's
    state_dict; weights are cast to `dtype` first, then fused, as the JAX
    engine does."""

    def __init__(self, state_dict: dict, nf: int, dtype: torch.dtype = torch.float32):
        super().__init__()
        p = "up0.basic_module."
        sd = {k: v.detach().to(dtype) for k, v in state_dict.items()}
        self.nf, self.num_groups, self.dtype = nf, nf // 2, dtype
        self.register_buffer("gn1_scale", sd[p + "SingleConv1.groupnorm.weight"])
        self.register_buffer("gn1_bias", sd[p + "SingleConv1.groupnorm.bias"])
        self.register_buffer("w1_fused", _oidhw(fuse_upsample_conv_kernel(
            _dhwio(sd[p + "SingleConv1.conv.weight"]), dtype), dtype))
        self.register_buffer("gn2_scale", sd[p + "SingleConv2.groupnorm.weight"])
        self.register_buffer("gn2_bias", sd[p + "SingleConv2.groupnorm.bias"])
        self.register_buffer("w2", sd[p + "SingleConv2.conv.weight"].contiguous())
        self.register_buffer("w_final", sd["final_conv.weight"].reshape(nf))
        self.register_buffer("b_final", sd["final_conv.bias"].reshape(()))

    def conv1(self, x: torch.Tensor) -> torch.Tensor:
        """GN1 -> fused upsample-conv -> ReLU: (B, S³, nf) -> packed (B, S³, 8·nf)."""
        return F.relu(conv3d(group_norm(x, self.gn1_scale, self.gn1_bias, self.num_groups),
                             self.w1_fused))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """x: (B, S, S, S, nf) -> (B, 2S, 2S, 2S, 1) tanh TSDF, float32."""
        h = depth_to_space_2x(self.conv1(x), self.nf)
        h = group_norm(h, self.gn2_scale, self.gn2_bias, self.num_groups)
        h = F.relu(conv3d(h, self.w2))
        # the 1x1 head: products of the compute-dtype values, float32 sums and bias
        out = h.float() @ self.w_final.float()[:, None] + self.b_final.float()
        return torch.tanh(out)


class PackedFinalDecoder(FusedFinalDecoder):
    """FusedFinalDecoder that never leaves the S³ grid: packed GN2, the
    1/8-dense packed conv2 and a block-diagonal packed head, then one
    depth-to-space at the end."""

    def __init__(self, state_dict: dict, nf: int, dtype: torch.dtype = torch.float32):
        super().__init__(state_dict, nf, dtype)
        self.register_buffer("w2_packed", _oidhw(pack_conv_kernel_2x(
            _dhwio(self.w2), dtype), dtype))
        wf = torch.zeros(8 * nf, 8, dtype=dtype)
        for o_idx in range(8):
            wf[o_idx * nf:(o_idx + 1) * nf, o_idx] = self.w_final
        self.register_buffer("wf_packed", wf)

    def conv2(self, h: torch.Tensor) -> torch.Tensor:
        """Packed (B, S³, 8·nf) -> packed (B, S³, 8·nf), before the ReLU."""
        return conv3d(h, self.w2_packed)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = group_norm_packed(self.conv1(x), self.gn2_scale, self.gn2_bias,
                              self.num_groups, self.nf)
        h = F.relu(self.conv2(h))
        out = h.float() @ self.wf_packed.float() + self.b_final.float()   # (B, S³, 8)
        return depth_to_space_2x(torch.tanh(out), 1)


class DecomposedPackedDecoder(PackedFinalDecoder):
    """PackedFinalDecoder with conv2 as 8 parity sub-grid convs
    (decomposed_conv2_kernels), summed in float32 as the JAX version's
    preferred_element_type=float32 convs are. Each asymmetric padding is an
    explicit F.pad followed by a VALID conv."""

    def __init__(self, state_dict: dict, nf: int, dtype: torch.dtype = torch.float32):
        super().__init__(state_dict, nf, dtype)
        ks, self.w2_pads = decomposed_conv2_kernels(_dhwio(self.w2))
        for s, k in enumerate(ks):
            self.register_buffer(f"w2_dec{s}", _oidhw(k, dtype))

    def conv2(self, h: torch.Tensor) -> torch.Tensor:
        return decomposed_conv(h, [getattr(self, f"w2_dec{s}") for s in range(8)],
                               self.w2_pads, self.nf)


def decomposed_conv(h: torch.Tensor, kernels, pads, nf: int) -> torch.Tensor:
    """Σ_s conv(x_s, K_s) over the 8 sub-position channel blocks of packed h
    (B, S³, 8·nf); products of h's dtype values, float32 sums, the result
    rounded to h's dtype."""
    out = None
    for s, (w, pad) in enumerate(zip(kernels, pads)):
        x_s = h[..., s * nf:(s + 1) * nf]
        # F.pad pads the last axis first: channels, then W, H, D
        x_s = F.pad(x_s, (0, 0) + pad[2] + pad[1] + pad[0])
        y = conv3d(x_s.float(), w.float(), padding=0)
        out = y if out is None else out + y
    return out.to(h.dtype)
