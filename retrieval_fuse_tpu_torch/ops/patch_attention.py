"""K-way patch attention: the engine's three attention kernels.

  patch_attention              over pre-gathered candidates: x (N, F), p
                               (N, K, F). Kernel csrc/patch_attention.cu,
                               replacing the Pallas `pallas_patch_attention`
                               (retrieval_fuse_tpu/ops/pallas_attention.py:46
                               `_attention_kernel`, :87); tokens `pallas`,
                               `pallasp`, `flatg`.
  gathered_patch_attention     fused gather over tile-major rows: xt (Q, T,
                               F), bank rows (N, T, F), top_idx (Q, K).
                               Kernel csrc/gathered_attention.cu, replacing
                               `pallas_gathered_patch_attention_v2` (:249
                               `_gathered_kernel_v2`, :327); token `pallasg2`.
  gathered_patch_attention_v1  the same function; kernel
                               csrc/gathered_attention_v1.cu, which stages
                               candidate tiles in shared memory with bulk
                               asynchronous copies, replacing
                               `pallas_gathered_patch_attention` (:151
                               `_gathered_kernel`, :188); token `pallasg`.

All three compute one function (csrc/attention.cuh): theta MLP on x, phi MLP
on every candidate, normalised scores, ReLU-of-max switch, hard argmax(25 s)
or softmax(sharpness s) selection, blend; only the (T, F) output rows are
written. Rows are F = nf·e³ features: 128 at nf 16 (super-resolution),
96 at nf 12 (surface reconstruction). Bound on the H100 at batch 128 (8192
tiles of 64 rows, K=4, F = 128, bf16):
279 GFLOP of MLP GEMMs, ~0.28 ms at the bf16 tensor-core rate, against
~0.8 GB of rows, ~0.24 ms. In bf16 all three run on the tensor cores
(bf16 products, float32 sums) in persistent blocks, one per SM, that keep
the MLP weights in shared memory for all their tiles with the four-layer
chain in registers (a layer's accumulators are the next layer's A
fragments). `patch_attention` and `gathered_patch_attention` run their
shipped instances on Hopper's warpgroup MMA (csrc/attention_wgmma.cuh): a
warpgroup a 64-row tile, each B tile read from shared memory once for 64
rows, theta's and phi's weights brought in as the exact shared-memory
image that `_pack_wgmma` writes on the host (one bulk copy each), rows read
from global memory. `gathered_patch_attention_v1` and every general
instance run `mma.sync.m16n8k16`, a warp 16 rows (csrc/attention.cuh);
v1 keeps phi resident, runs theta first on all of a block's tiles (the
embeddings wait in a scratch tensor), and then turns theta's bytes into
rings of candidate tiles that one thread a ring fills with
`cp.async.bulk` ahead of the warps (csrc/gathered_attention_v1.cu). The
weights are packed at every launch, or once on MLPs that a serving engine
froze (`freeze_operands`). Times in PERF.md. In float32 (TF32 would cost
~3 decimal digits) the body multiplies with float32 FMAs from shared
memory; v1 then stages a tile's K candidates whole, which its shipped
instance can do for K up to 4 (F = 128), 5 (F = 96) or 8 (F = 64 and
32). Each wrapper's `.math` names the
path of its last launch ("wgmma.bf16", "mma.bf16" or "fma.f32"). The TPU
workarounds are not carried over: the 512-row padding of N, the flattened
index operand, the padding of Q to a group multiple.

Each wrapper launches its kernel on CUDA tensors and runs its plain
PyTorch version on CPU tensors; it never falls back from one to the other.
The kernels take hidden 128 and C = 32 (the attention module's own), any
F in 1..KERNEL_MAX_F (1024), K in 1..KERNEL_MAX_K (32) and, the gathered
ones, T in 1..KERNEL_MAX_T (512) rows a tile, and raise on anything else;
the plain versions take any. The shipped shapes (F in SHIPPED_WIDTHS, K <=
SHIPPED_MAX_K, T = KERNEL_ROWS; v1 in float32 also K <= V1_F32_MAX_K[F])
launch the instances described above; every other shape launches each
kernel's general instance (csrc/attention_general.cuh: layer 0 padded to a
multiple of 32 with zero rows by `_pack` and read from global memory in
fragment order, layers 1-3 resident, masked row loads, K and T sized at run
time). `.instance` names the instance of a wrapper's last launch.
"""

from __future__ import annotations

import functools
import weakref

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from retrieval_fuse_tpu_torch.ops import _build

#: the MLP's hidden and embedding widths, which every kernel instance takes
KERNEL_HIDDEN, KERNEL_EMBED = 128, 32
#: what the kernels take (the plain versions take any): row width F, K
#: candidates, T rows a tile of the gathered kernels
KERNEL_MAX_F, KERNEL_MAX_K, KERNEL_MAX_T = 1024, 32, 512
#: the shipped shapes, which launch instances of their own
#: (csrc/attention.cuh): F = nf·e³ at e = 2 for nf 4, 8, 12 and 16
#: (`with_width`), K <= 8, T = 64
SHIPPED_WIDTHS = (32, 64, 96, 128)
SHIPPED_MAX_K = 8
KERNEL_ROWS = 64
#: shared memory for gathered_patch_attention_v1's shipped float32 staging
#: (K whole tiles), and the K it takes at each width (SHIPPED_MAX_K at
#: most); a larger K launches v1's general instance
V1_STAGE_BYTES = 128 * 1024
V1_F32_MAX_K = {f: min(SHIPPED_MAX_K, V1_STAGE_BYTES // (KERNEL_ROWS * f * 4))
                for f in SHIPPED_WIDTHS}
_LAYERS = ("fc0", "fc1", "fc2", "out")


def _acc(dtype: torch.dtype) -> torch.dtype:
    """The plain versions' arithmetic: float32 for float32 and bf16 values,
    float64 for float64 ones (the reference the float32 holds measure
    their distance from)."""
    return torch.promote_types(dtype, torch.float32)


def _mlp(x: torch.Tensor, w: nn.Module) -> torch.Tensor:
    """x (R, F) through fc0..fc2 (LeakyReLU 0.01) + out -> (R, C) float32
    (float64 for float64 x).

    As the JAX `_mlp`: every GEMM multiplies values of x's dtype (weights
    rounded to it) with float32 accumulation and a float32 bias; in bf16 the
    hidden activations are rounded back to bf16 between layers. The products
    are formed in float32, because a bf16 torch.matmul would round its
    result to bf16."""
    dt, acc = x.dtype, _acc(x.dtype)
    for name in _LAYERS[:3]:
        fc = getattr(w, name)
        h = x.to(acc) @ fc.weight.to(dt).to(acc).T + fc.bias.to(acc)
        x = torch.where(h >= 0, h, 0.01 * h).to(dt)
    return x.to(acc) @ w.out.weight.to(dt).to(acc).T + w.out.bias.to(acc)


def _l2n(v: torch.Tensor) -> torch.Tensor:
    return v / torch.clamp(torch.sqrt(torch.sum(v * v, dim=-1, keepdim=True)), min=1e-12)


def embed(rows: torch.Tensor, w: nn.Module) -> torch.Tensor:
    """L2-normalised MLP embedding of (R, F) rows -> (R, C) float32
    (float64 for float64 rows)."""
    return _l2n(_mlp(rows, w))


def hard_selection(s: torch.Tensor) -> torch.Tensor:
    """argmax over the last axis of 25·s, first maximum first: the JAX
    paths scale the scores before the argmax, so two candidates whose
    scores round to the same 25·s tie, and the lower one wins."""
    return torch.argmax(s * 25.0, dim=-1)


def pack_tile_rows(tile_feats: torch.Tensor, e: int) -> torch.Tensor:
    """(N, s, s, s, nf) feature tiles -> (N, (s//e)³, e³·nf) patch-major rows,
    as in the JAX package (pallas_attention.py:139). Run once on the bank."""
    n, s, _, _, nf = tile_feats.shape
    t = s // e
    v = tile_feats.reshape(n, t, e, t, e, t, e, nf)
    v = v.permute(0, 1, 3, 5, 2, 4, 6, 7)
    return v.reshape(n, t ** 3, e ** 3 * nf)


def patch_attention_plain(x, p, theta, phi, K: int, retrieval_mode: bool = True,
                          sharpness: float = 1024.0):
    """The plain PyTorch version of patch_attention. Returns (out (N, F) in
    x's dtype, selection (N,) int64: the argmax candidate of each row).
    Float32 arithmetic for float32 and bf16 rows, float64 for float64 ones."""
    n, f = x.shape
    xf = embed(x, theta)                                            # (N, C)
    pf = embed(p.reshape(n * K, f), phi).reshape(n, K, -1)          # (N, K, C)
    s = torch.sum(xf[:, None, :] * pf, dim=-1)                      # (N, K)
    switch = F.relu(torch.amax(s, dim=-1, keepdim=True))
    sel = hard_selection(s)
    acc = _acc(x.dtype)
    if retrieval_mode:
        weights = F.one_hot(sel, K).to(acc)
    else:
        weights = torch.softmax(sharpness * s, dim=-1)
    weighted = sum(weights[:, k:k + 1] * p[:, k].to(acc) for k in range(K))
    out = x.to(acc) * (1.0 - switch) + weighted * switch
    return out.to(x.dtype), sel


def gathered_patch_attention_plain(xt, bank_rows, top_idx, theta, phi, K: int,
                                   retrieval_mode: bool = True,
                                   sharpness: float = 1024.0):
    """The plain PyTorch version of both gathered kernels. Returns (out
    (Q, T, F) in xt's dtype, selection (Q, T) int64)."""
    q, t, f = xt.shape
    p = bank_rows[top_idx.long()].transpose(1, 2).reshape(q * t, K, f)   # (Q·T, K, F)
    out, sel = patch_attention_plain(xt.reshape(q * t, f), p, theta, phi, K,
                                     retrieval_mode, sharpness)
    return out.reshape(q, t, f), sel.reshape(q, t)


#: v1 computes v2's function; one plain version serves both
gathered_patch_attention_v1_plain = gathered_patch_attention_plain


def layer0_row(kappa):
    """The fc0 row (input feature) at logical k `kappa` of layer 0 in both
    tensor-core bodies: `load_rows16`'s order, in which a lane's 16-byte run
    of its row is its A fragments of two k16 steps: kappa = 16s + 8u + 2t +
    e -> 32·(s/2) + 8t + 4·(s&1) + 2u + e (ints or numpy arrays)."""
    s, kk = kappa // 16, kappa % 16
    u, j = kk // 8, kk % 8
    return 32 * (s // 2) + 8 * (j // 2) + 4 * (s % 2) + 2 * u + j % 2


@functools.lru_cache(maxsize=None)
def _layer0_fragment_index(fp: int) -> torch.Tensor:
    """Where each bf16 of layer 0's B-fragment order comes from in the
    (fp, 128) row-major fc0: word i (lane (g, t), slot r of k16 step s and
    n8-tile pair jp) holds W[k][n] and W[k+1][n], n = 8·(2jp + r/2) + g,
    k = layer0_row(16s + 8·(r&1) + 2t): the order of csrc/attention.cuh's
    `stage_fragments` for layer 0, whose k is permuted so that a lane's A
    fragments of two k16 steps are one run of 8 columns of its row."""
    i = np.arange(fp * KERNEL_HIDDEN // 2)
    r, lane, sj = i & 3, (i >> 2) & 31, i >> 7
    jp, s = sj % (KERNEL_HIDDEN // 16), sj // (KERNEL_HIDDEN // 16)
    g, t = lane >> 2, lane & 3
    n = 8 * (2 * jp + (r >> 1)) + g
    k = layer0_row(16 * s + 8 * (r & 1) + 2 * t)
    return torch.from_numpy(np.stack([k * KERNEL_HIDDEN + n, (k + 1) * KERNEL_HIDDEN + n],
                                     axis=1).reshape(-1))


def _pack(w: nn.Module, dtype: torch.dtype,
          general: bool = False) -> tuple[torch.Tensor, torch.Tensor]:
    """An attention MLP -> (weights in (in, out) layout, concatenated, in
    `dtype`; biases, concatenated, float32): the kernel's operand layout.

    `general` (the general instances): fc0 gets zero rows up to Fp, F
    rounded up to 32, so that layer 0 runs in whole 32-column chunks (a zero
    row times a zero input column adds an exact 0), and in bf16 it is laid
    out in B-fragment order (_layer0_fragment_index), which the tensor-core
    body reads from global memory."""
    layers = [getattr(w, n).weight.T for n in _LAYERS]
    if general:
        f = layers[0].shape[0]
        fp = -(-f // 32) * 32
        w0 = F.pad(layers[0], (0, 0, 0, fp - f)).to(dtype)
        if dtype == torch.bfloat16:
            w0 = w0.reshape(-1)[_layer0_fragment_index(fp).to(w0.device)]
        layers[0] = w0
    weights = torch.cat([layer.reshape(-1).to(dtype) for layer in layers])
    biases = torch.cat([getattr(w, n).bias.reshape(-1) for n in _LAYERS])
    return weights.contiguous(), biases.float().contiguous()


#: csrc/attention_wgmma.cuh's shared-memory image of an MLP (no swizzle,
#: K-major B): 8x8 bf16 core matrices of WGMMA_CORE_BYTES (`kCoreBytes`),
#: rows of WGMMA_CORE_ROW_BYTES (`kCoreRowBytes`)
WGMMA_CORE_BYTES, WGMMA_CORE_ROW_BYTES = 128, 16


def wgmma_layers(f: int) -> list[tuple[int, int, int]]:
    """(start byte, rows Kin, columns N) of each layer of the image at row
    width f, as `WgImage<F>` lays them out (kL0..kL3); the float32 biases
    follow at 2·(f·128 + 2·128² + 128·32) bytes (kBias)."""
    h, c = KERNEL_HIDDEN, KERNEL_EMBED
    sizes = [(f, h), (h, h), (h, h), (h, c)]
    starts = np.cumsum([0] + [2 * kin * n for kin, n in sizes])
    return [(int(st), kin, n) for st, (kin, n) in zip(starts, sizes)]


def wgmma_step_descriptor(start: int, n: int, s: int) -> tuple[int, int, int]:
    """(start address, LBO, SBO) in bytes of the descriptor of k16 step s of
    a layer N wide whose image starts at `start`: `wg_layer`'s start +
    s·kStepBytes(N), kLbo(N) = N·16 and kCoreBytes."""
    return start + s * n * 32, n * 16, WGMMA_CORE_BYTES


def wgmma_b_address(start: int, lbo: int, sbo: int, kk: int, n: int) -> int:
    """The byte that wgmma reads B[kk][n] of a k16 step from (kk in 0..15),
    for a no-swizzle K-major descriptor (start, LBO, SBO): core matrix
    (kk // 8, n // 8) at start + (kk // 8)·LBO + (n // 8)·SBO, its row n % 8
    WGMMA_CORE_ROW_BYTES on, element kk % 8 two bytes on."""
    return (start + (kk // 8) * lbo + (n // 8) * sbo + (n % 8) * WGMMA_CORE_ROW_BYTES
            + (kk % 8) * 2)


@functools.lru_cache(maxsize=None)
def _wgmma_index(f: int) -> torch.Tensor:
    """For each bf16 of the image's weights, its index in `_pack`'s (in,
    out) concatenation: logical k `kap` and column n of a layer (Kin x N)
    lie at element (kap // 8)·N·8 + (n // 8)·64 + (n % 8)·8 + kap % 8 of the
    layer, and hold W[k][n], k = layer0_row(kap) in layer 0 and kap in the
    others."""
    total = sum(kin * n for _, kin, n in wgmma_layers(f))
    idx = np.full(total, -1, dtype=np.int64)
    for layer, (start, kin, n_out) in enumerate(wgmma_layers(f)):
        kap, n = np.arange(kin)[:, None], np.arange(n_out)[None, :]
        k = layer0_row(kap) if layer == 0 else kap
        pos = (start // 2 + (kap // 8) * n_out * 8 + (n // 8) * 64 + (n % 8) * 8 + kap % 8)
        idx[pos] = start // 2 + k * n_out + n
    return torch.from_numpy(idx)


def _pack_wgmma(w: nn.Module) -> torch.Tensor:
    """An attention MLP -> the shared-memory image that csrc/attention_wgmma.cuh
    copies into a block with one bulk copy: the bf16 weights in wgmma's
    layout (_wgmma_index), then the float32 biases' bytes, as one bf16
    tensor."""
    weights, biases = _pack(w, torch.bfloat16)
    img = weights[_wgmma_index(w.fc0.weight.shape[1]).to(weights.device)]
    return torch.cat([img, biases.view(torch.bfloat16)]).contiguous()


#: frozen MLP -> ([(detached alias, version) of each parameter at the
#: freeze], {(dtype, layout): operands}). The alias keeps the storage, so
#: no other tensor takes its address; inference tensors keep no version
#: (None). A copy of a frozen MLP (copy.deepcopy, then .float()) is not
#: frozen.
_FROZEN: weakref.WeakKeyDictionary = weakref.WeakKeyDictionary()


def freeze_operands(*mlps: nn.Module) -> None:
    """Declare the weights of attention MLPs fixed from now on, as a serving
    engine does for the modules it loads from its own copy of the params:
    their kernel operands are then packed at the first launch in each dtype
    and layout and then kept, so that a serving call packs nothing.
    An MLP that is not frozen packs at every launch, so that any update of
    its weights, `p.data` writes included, reaches the kernel."""
    for w in mlps:
        _FROZEN[w] = ([(p.detach(), None if p.is_inference() else p._version)
                       for p in w.parameters()], {})


def packed(w: nn.Module, dtype: torch.dtype, layout: str):
    """`w`'s kernel operands in `layout`: "in_out" or "general" (`_pack`'s
    (weights, biases)) or "wgmma" (`_pack_wgmma`'s image, bf16); packed
    anew, or once if `w` is frozen (`freeze_operands`). A frozen MLP whose
    parameter has since been given new storage or updated in place (its
    data_ptr or _version moved) raises rather than serve the old weights; a
    write through `p.data` moves neither (PyTorch gives `.data` a version
    counter of its own) and is not seen."""
    with torch.no_grad():
        make = lambda: (_pack_wgmma(w) if layout == "wgmma"  # noqa: E731
                        else _pack(w, dtype, layout == "general"))
        frozen = _FROZEN.get(w)
        if frozen is None:
            return make()
        state, cache = frozen
        params = list(w.parameters())
        if len(params) != len(state) or any(
                a.data_ptr() != p.data_ptr() or (v is not None and v != p._version)
                for (a, v), p in zip(state, params)):
            raise RuntimeError("packed: a weight of an MLP frozen by freeze_operands changed "
                               "after the freeze; build its engine anew")
        if (dtype, layout) not in cache:
            cache[dtype, layout] = make()
        return cache[dtype, layout]


def is_shipped_shape(kernel: str, f: int, k: int, t: int | None = None,
                     dtype: torch.dtype = torch.bfloat16) -> bool:
    """True where attention kernel `kernel` (a `_build.KERNELS` name) runs
    its shipped instance for rows of F = f, K = k, T = t rows a tile (the
    gathered kernels) and `dtype`; every other shape in the kernels' domain
    runs the general instance."""
    shipped = f in SHIPPED_WIDTHS and 1 <= k <= SHIPPED_MAX_K and t in (None, KERNEL_ROWS)
    if kernel == "gathered_attention_v1" and dtype == torch.float32 and shipped:
        shipped = k <= V1_F32_MAX_K[f]
    return shipped


def kernel_math(kernel: str, dtype: torch.dtype, general: bool = False) -> str:
    """The instruction path of attention kernel `kernel` (a `_build.KERNELS`
    name) for rows of `dtype` on its shipped (or, `general`, its general)
    instance: the three kernels send bf16 to the tensor cores, the shipped
    instances of patch_attention and gathered_attention by `wgmma` and the
    others by `mma.sync`, and run float32 on FMAs."""
    if kernel not in ("patch_attention", "gathered_attention", "gathered_attention_v1"):
        raise ValueError(f"kernel_math: {kernel!r} is no attention kernel")
    if dtype != torch.bfloat16:
        return "fma.f32"
    return "mma.bf16" if general or kernel == "gathered_attention_v1" else "wgmma.bf16"


def _check_kernel_operands(name: str, rows: torch.Tensor, cands: torch.Tensor, idx,
                           theta: nn.Module, phi: nn.Module) -> int:
    """Device, dtype, contiguity, width and MLP-shape checks shared by the
    wrappers; returns the row width F."""
    dev = rows.device
    if dev.type != "cuda" or cands.device != dev or (idx is not None and idx.device != dev):
        raise ValueError(f"{name}: the row, candidate and index tensors must be on one "
                         f"CUDA device")
    if rows.dtype not in (torch.float32, torch.bfloat16) or cands.dtype != rows.dtype:
        raise ValueError(f"{name}: rows and candidates must share float32 or bfloat16, "
                         f"got {rows.dtype}, {cands.dtype}")
    if not (rows.is_contiguous() and cands.is_contiguous()
            and (idx is None or idx.is_contiguous())):
        raise ValueError(f"{name}: inputs must be contiguous")
    if rows.data_ptr() % 16 or cands.data_ptr() % 16:
        raise ValueError(f"{name}: rows and candidates must be 16-byte aligned")
    f = rows.shape[-1]
    if not 1 <= f <= KERNEL_MAX_F:
        raise ValueError(f"{name}: the kernel takes rows of F in 1..{KERNEL_MAX_F} "
                         f"features, got F = {f}")
    for w in (theta, phi):
        h = KERNEL_HIDDEN
        if (tuple(w.fc0.weight.shape) != (h, f)
                or tuple(w.fc1.weight.shape) != (h, h)
                or tuple(w.fc2.weight.shape) != (h, h)
                or tuple(w.out.weight.shape) != (KERNEL_EMBED, h)):
            raise ValueError(f"{name}: the kernel takes {f}->{h}->{h}->{h}->"
                             f"{KERNEL_EMBED} MLPs for rows of F = {f}")
    return f


def _launch(kernel: str, rows: torch.Tensor, operands: tuple, general: bool, theta, phi,
            retrieval_mode: bool, sharpness: float, out: torch.Tensor, sel,
            scratch: tuple = ()) -> str:
    """Launch `kernel`'s shipped or general instance (`scratch`: its scratch
    tensors, after the outputs); returns the instruction path it took."""
    math = kernel_math(kernel, rows.dtype, general)
    if math == "wgmma.bf16":  # one image an MLP, its biases inside
        mlps = [(packed(m, rows.dtype, "wgmma"), None) for m in (theta, phi)]
    else:
        mlps = [packed(m, rows.dtype, "general" if general else "in_out") for m in (theta, phi)]
    ptr = lambda t: None if t is None else t.data_ptr()  # noqa: E731
    (w_theta, b_theta), (w_phi, b_phi) = mlps
    _build.launch(kernel, rows.device, 0 if rows.dtype == torch.float32 else 1, *operands,
                  int(general), ptr(w_theta), ptr(b_theta), ptr(w_phi), ptr(b_phi),
                  int(bool(retrieval_mode)), float(sharpness), ptr(out), ptr(sel),
                  *(ptr(t) for t in scratch))
    return math


def patch_attention(x: torch.Tensor, p: torch.Tensor, theta: nn.Module, phi: nn.Module,
                    K: int, retrieval_mode: bool = True, sharpness: float = 1024.0,
                    return_selection: bool = False):
    """K-way patch attention over pre-gathered candidates.

    x: (N, F) patch rows; p: (N, K, F) their candidate rows (candidate k of
    row i is p[i, k]); theta, phi: the AttentionFeatureEncoder MLPs. Returns
    the fused rows (N, F) in x's dtype, and with `return_selection` also
    the (N,) argmax candidate of each row."""
    if x.device.type == "cpu" and p.device.type == "cpu":
        out, sel = patch_attention_plain(x, p, theta, phi, K, retrieval_mode, sharpness)
        return (out, sel) if return_selection else out
    f = _check_kernel_operands("patch_attention", x, p, None, theta, phi)
    n = x.shape[0]
    if x.dim() != 2 or tuple(p.shape) != (n, K, f) or not 1 <= K <= KERNEL_MAX_K:
        raise ValueError(f"patch_attention: the kernel takes x (N, F) and p (N, K, F) with "
                         f"1 <= K <= {KERNEL_MAX_K}, got {tuple(x.shape)} and {tuple(p.shape)}")
    out = torch.empty_like(x)
    sel = torch.empty((n,), dtype=torch.int32, device=x.device) if return_selection else None
    if n > 0:
        general = not is_shipped_shape("patch_attention", f, K, dtype=x.dtype)
        patch_attention.math = _launch("patch_attention", x, (x.data_ptr(), p.data_ptr(), n, K, f),
                                       general, theta, phi, retrieval_mode, sharpness, out, sel)
        patch_attention.instance = "general" if general else "shipped"
        patch_attention.launches += 1
    return (out, sel) if return_selection else out


def _gathered(wrapper, name: str, xt, bank_rows, top_idx, theta, phi, K, retrieval_mode,
              sharpness, return_selection, staged: bool = False):
    """The checks and launch of the two gathered kernels (same operands), for
    `wrapper`, whose launch count and instruction path it updates. `staged`:
    the kernel is v1, whose float32 launch stages K whole tiles and whose
    bf16 launch takes a (Q, T, C) float32 scratch for theta's embeddings."""
    feats = _check_kernel_operands(name, xt, bank_rows, top_idx, theta, phi)
    q, rows = xt.shape[0], xt.shape[1] if xt.dim() == 3 else 0
    if (xt.dim() != 3 or not 1 <= rows <= KERNEL_MAX_T or bank_rows.dim() != 3
            or tuple(bank_rows.shape[1:]) != (rows, feats)):
        raise ValueError(f"{name}: the kernel takes (·, T, F) rows and bank tiles with T in "
                         f"1..{KERNEL_MAX_T}, got {tuple(xt.shape)} and {tuple(bank_rows.shape)}")
    if (top_idx.dtype != torch.int32 or tuple(top_idx.shape) != (q, K)
            or not 1 <= K <= KERNEL_MAX_K):
        raise ValueError(f"{name}: top_idx must be int32 ({q}, {K}) with 1 <= K <= "
                         f"{KERNEL_MAX_K}, got {top_idx.dtype} {tuple(top_idx.shape)}")
    general = not is_shipped_shape(name, feats, K, rows, xt.dtype)
    scratch = ()
    if staged:  # the shipped bf16 instance keeps theta's embeddings here
        scratch = (torch.empty((q, rows, KERNEL_EMBED), dtype=torch.float32, device=xt.device)
                   if xt.dtype == torch.bfloat16 and not general and q > 0 else None,)
    out = torch.empty_like(xt)
    sel = torch.empty((q, rows), dtype=torch.int32, device=xt.device) if return_selection else None
    if q > 0:
        wrapper.math = _launch(name, xt, (xt.data_ptr(), bank_rows.data_ptr(),
                                          top_idx.data_ptr(), q, K, feats, rows),
                               general, theta, phi, retrieval_mode, sharpness, out, sel, scratch)
        wrapper.instance = "general" if general else "shipped"
        wrapper.launches += 1
    return (out, sel) if return_selection else out


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
    return _gathered(gathered_patch_attention, "gathered_attention", xt, bank_rows, top_idx,
                     theta, phi, K, retrieval_mode, sharpness, return_selection)


def gathered_patch_attention_v1(xt: torch.Tensor, bank_rows: torch.Tensor,
                                top_idx: torch.Tensor, theta: nn.Module, phi: nn.Module,
                                K: int, retrieval_mode: bool = True,
                                sharpness: float = 1024.0, return_selection: bool = False):
    """gathered_patch_attention's function, through the kernel that stages
    candidate rows in shared memory: at the shipped shapes whole tiles by
    bulk asynchronous copies (bf16: a ring; float32: a tile's K candidates
    whole, K <= V1_F32_MAX_K[F]), elsewhere in chunks by cp.async."""
    if xt.device.type == "cpu" and bank_rows.device.type == "cpu":
        out, sel = gathered_patch_attention_v1_plain(xt, bank_rows, top_idx, theta, phi, K,
                                                     retrieval_mode, sharpness)
        return (out, sel) if return_selection else out
    return _gathered(gathered_patch_attention_v1, "gathered_attention_v1", xt, bank_rows,
                     top_idx, theta, phi, K, retrieval_mode, sharpness, return_selection,
                     staged=True)


for _wrapper in (patch_attention, gathered_patch_attention, gathered_patch_attention_v1):
    _wrapper.launches = 0
    _wrapper.math = None  # the instruction path of the wrapper's last launch
    _wrapper.instance = None  # "shipped" or "general": the instance of its last launch
