"""The port's seven CUDA kernels against their plain PyTorch versions, on a
CUDA card (skipped elsewhere: the kernels have no CPU mode), the attention
kernels at F = 128, 96, 64 and 32 and the decoder tail at nf 4, 8, 12 and 16
(their shipped instances), and the general instances at the widths past
them (F up to 1024, K up to 32, T other than 64, nf up to 64, topk k up to
32). This file imports
neither JAX nor the JAX package, so it runs where only PyTorch is:

    python -m pytest --noconftest tests/test_torch_port_cuda.py

(--noconftest: tests/conftest.py sets up JAX). chip_smoke.py holds the same
kernels against the same plain versions at the serving shapes. Also on the
card: the retrieval trainer's first steps against the CPU, the BatchNorm
encoders in train mode, and the engine's refusal, at build, of a kernel
path whose limits its config breaks.
"""

import numpy as np
import pytest
import torch

from chip_smoke import knn_index_agreement
from retrieval_fuse_tpu_torch.models.attention import AttentionFeatureEncoder
from retrieval_fuse_tpu_torch.ops import decoder_tail as dt
from retrieval_fuse_tpu_torch.ops import patch_attention as pa
from retrieval_fuse_tpu_torch.ops.chamfer import chamfer_batch, chamfer_batch_plain
from retrieval_fuse_tpu_torch.ops.streaming_chamfer import (
    BIG, chamfer_minima, chamfer_minima_plain)
from retrieval_fuse_tpu_torch.ops.streaming_knn import (
    knn_rows, streaming_knn_sims, streaming_knn_sims_plain)
from retrieval_fuse_tpu_torch.ops.topk import topk, topk_plain


@pytest.fixture
def cuda():
    """A CUDA device, or a skip."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from retrieval_fuse_tpu_torch.device import resolve_device
    return resolve_device("cuda")


def tied_scores(rng, q, n):
    sims = rng.standard_normal((q, n)).astype(np.float32)
    sims[:, 400] = sims[:, 7]   # exact duplicates across tiles
    sims[13, :] = 0.5           # a row of ties
    sims[20, -3:] = 9.0         # ties at the ragged right edge
    return sims


def attention_inputs(rng, q, n, t, f, k, c=32):
    xt = rng.standard_normal((q, t, f)).astype(np.float32)
    bank = rng.standard_normal((n, t, f)).astype(np.float32)
    idx = rng.integers(0, n, (q, k)).astype(np.int32)
    theta, phi = AttentionFeatureEncoder(f, c), AttentionFeatureEncoder(f, c)
    g = np.random.default_rng(7)
    for m in (theta, phi):
        for p in m.parameters():
            bound = 1.0 / np.sqrt(p.shape[-1]) if p.dim() == 2 else 0.1
            p.data = torch.from_numpy(g.uniform(-bound, bound, tuple(p.shape)).astype(np.float32))
    return xt, bank, idx, theta, phi


def test_topk_kernel_matches_plain(cuda):
    sims = torch.from_numpy(tied_scores(np.random.default_rng(5), 300, 4099)).to(cuda)
    for s in (sims, sims[:, :4096].contiguous(), sims.bfloat16().float()):
        before = topk.launches
        v, i = topk(s, 4)
        torch.cuda.synchronize()
        assert topk.launches == before + 1
        pv, pi = topk_plain(s, 4)
        assert torch.equal(i, pi) and torch.equal(v, pv)


def unit_rows(rng, n, d, dtype, device):
    x = rng.standard_normal((n, d)).astype(np.float32)
    x /= np.linalg.norm(x, axis=1, keepdims=True)
    return torch.from_numpy(x).to(device=device, dtype=dtype).contiguous()


@pytest.mark.parametrize("d", [32, 64, 96])
@pytest.mark.parametrize("k", [1, 4, 8, 10, 32])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_knn_kernel_matches_plain(cuda, dtype, k, d):
    """Q and N no tile multiples; N large enough for the kernel to split it
    over a cluster. The top-k rows equal where the k-th and (k+1)-th
    similarities are more than 1e-5 apart, and in order where all of the top
    k+1 are (elsewhere the sums' order decides); similarities within 2e-6;
    one launch, on the dtype's instruction path."""
    rng = np.random.default_rng(6 + k + d)
    q, db = unit_rows(rng, 200, d, dtype, cuda), unit_rows(rng, 3001, d, dtype, cuda)
    before = streaming_knn_sims.launches
    v, i = streaming_knn_sims(q, db, k)
    torch.cuda.synchronize()
    assert streaming_knn_sims.launches == before + 1
    assert streaming_knn_sims.math == {torch.float32: "mma.3xtf32",
                                       torch.bfloat16: "mma.bf16"}[dtype]
    assert v.shape == i.shape == (200, k) and i.dtype == torch.int32
    pv, pi = streaming_knn_sims_plain(q, db, k + 1)
    agree, _, order_clear = knn_index_agreement(i, pv, pi, k)
    assert agree and order_clear > 0.8 * 200
    assert float((v - pv[:, :k]).abs().max()) <= 2e-6


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_knn_kernel_ties_go_to_the_lower_row(cuda, dtype):
    """Duplicated database rows score alike: within one n8 tile (16, 17),
    across tiles (100, 700) and across the cluster's slices (5, 2990). A
    query equal to a duplicated row gets both, the lower row first, as the
    plain version orders them."""
    rng = np.random.default_rng(12)
    db = unit_rows(rng, 3001, 64, dtype, cuda)
    pairs = ((16, 17), (100, 700), (5, 2990))
    for lo, hi in pairs:
        db[hi] = db[lo]
    q = torch.stack([db[lo] for lo, _ in pairs] + [db[hi] for _, hi in pairs]).contiguous()
    v, i = streaming_knn_sims(q, db, 3)
    pv, pi = streaming_knn_sims_plain(q, db, 3)
    torch.cuda.synchronize()
    want = torch.tensor([[lo, hi] for lo, hi in pairs] * 2, dtype=torch.int32, device=cuda)
    assert torch.equal(i[:, :2], want) and torch.equal(pi[:, :2], want)
    assert torch.equal(v[:, 0], v[:, 1])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_knn_kernel_odd_widths_and_edges(cuda, dtype):
    """Widths whose rows lack the tensor map's 16-byte pitch (D = 3, 77),
    given as they are (the wrapper pads a copy) and through knn_rows (read in
    place, the rest of a box zero-filled), the widest (256), one query,
    N = k, and a query batch of Q = 0."""
    rng = np.random.default_rng(13)
    for qn, n, d, k in ((70, 1000, 3, 5), (70, 1000, 77, 16), (33, 700, 256, 32),
                        (1, 9, 64, 9), (0, 100, 64, 4)):
        q, db = unit_rows(rng, qn, d, dtype, cuda), unit_rows(rng, n, d, dtype, cuda)
        pv, pi = streaming_knn_sims_plain(q, db, min(k + 1, n))
        for rows in (db, knn_rows(db)):
            v, i = streaming_knn_sims(q, rows, k)
            torch.cuda.synchronize()
            assert v.shape == (qn, k)
            if qn == 0:
                continue
            assert float((v - pv[:, :k]).abs().max()) <= 2e-6
            if k < n:
                assert knn_index_agreement(i, pv, pi, k)[0]
            else:
                assert torch.equal(torch.sort(i, dim=1).values, torch.sort(pi, dim=1).values)


@pytest.mark.parametrize("k, d, limit", [(33, 64, "1 <= k <= 32"), (4, 257, "1 <= D <= 256")])
def test_knn_kernel_raises_past_its_limits(cuda, k, d, limit):
    rng = np.random.default_rng(14)
    q, db = unit_rows(rng, 8, d, torch.float32, cuda), unit_rows(rng, 100, d, torch.float32, cuda)
    before = streaming_knn_sims.launches
    with pytest.raises(ValueError, match=limit):
        streaming_knn_sims(q, db, k)
    assert streaming_knn_sims.launches == before


@pytest.mark.parametrize("retrieval_mode", [True, False], ids=["hard", "softmax"])
def test_gathered_attention_kernel_matches_plain(cuda, retrieval_mode):
    xt, bank, idx, theta, phi = attention_inputs(np.random.default_rng(8), 37, 50, 64, 128, 4)
    args = [torch.from_numpy(a).to(cuda) for a in (xt, bank, idx)]
    theta, phi = theta.to(cuda), phi.to(cuda)
    with torch.no_grad():
        before = pa.gathered_patch_attention.launches
        out, sel = pa.gathered_patch_attention(*args, theta, phi, 4, retrieval_mode,
                                               return_selection=True)
        torch.cuda.synchronize()
        assert pa.gathered_patch_attention.launches == before + 1
        want, want_sel = pa.gathered_patch_attention_plain(*args, theta, phi, 4,
                                                           retrieval_mode)
    agree = sel.long() == want_sel
    assert float(agree.float().mean()) >= 0.999
    assert float((out - want).abs()[agree].max()) <= 1e-4


def test_gathered_attention_kernel_bf16(cuda):
    """bf16, the serving dtype: the kernel and the plain version round at
    the same places, so they differ only where float32 sums taken in
    another order round to another bf16 value."""
    xt, bank, idx, theta, phi = attention_inputs(np.random.default_rng(9), 37, 50, 64, 128, 4)
    args = [torch.from_numpy(a).to(cuda) for a in (xt, bank)]
    args = [a.bfloat16() for a in args] + [torch.from_numpy(idx).to(cuda)]
    theta, phi = theta.to(cuda).bfloat16(), phi.to(cuda).bfloat16()
    with torch.no_grad():
        out, sel = pa.gathered_patch_attention(*args, theta, phi, 4, return_selection=True)
        want, want_sel = pa.gathered_patch_attention_plain(*args, theta, phi, 4)
    agree = sel.long() == want_sel
    assert out.dtype == torch.bfloat16
    assert float(agree.float().mean()) >= 0.99
    diff = (out.float() - want.float()).abs()[agree]
    assert float(diff.max()) <= 0.04 and float(diff.mean()) <= 1e-3


def _agree(out, sel, want, want_sel, min_share, max_err):
    agree = sel.long() == want_sel
    assert float(agree.float().mean()) >= min_share
    assert float((out.float() - want.float()).abs()[agree].max()) <= max_err


@pytest.mark.parametrize("retrieval_mode", [True, False], ids=["hard", "softmax"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_patch_attention_kernel_matches_plain(cuda, retrieval_mode, dtype):
    """Ragged N (not a multiple of the 64-row block), K=4."""
    xt, bank, idx, theta, phi = attention_inputs(np.random.default_rng(10), 37, 50, 64, 128, 4)
    n = 37 * 64 - 23
    x = torch.from_numpy(xt).reshape(-1, 128)[:n].to(cuda, dtype).contiguous()
    rows = np.random.default_rng(11).integers(0, 50 * 64, (n, 4))
    p = torch.from_numpy(bank).reshape(-1, 128)[torch.from_numpy(rows)].to(cuda, dtype).contiguous()
    theta, phi = theta.to(cuda, dtype), phi.to(cuda, dtype)
    with torch.no_grad():
        before = pa.patch_attention.launches
        out, sel = pa.patch_attention(x, p, theta, phi, 4, retrieval_mode, return_selection=True)
        torch.cuda.synchronize()
        assert pa.patch_attention.launches == before + 1
        want, want_sel = pa.patch_attention_plain(x, p, theta, phi, 4, retrieval_mode)
    assert out.shape == x.shape and out.dtype == dtype and sel.shape == (n,)
    if dtype == torch.float32:
        _agree(out, sel, want, want_sel, 0.999, 1e-4)
    else:
        _agree(out, sel, want, want_sel, 0.99, 0.04)


#: max |diff| in bf16 on rows whose selections agree, by retrieval_mode. Hard:
#: one bf16 step of a blended value below 8. Softmax at sharpness 1024 turns a
#: score difference of 1e-4 (one hidden activation rounded the other way) into
#: a weight difference of up to 2.5%, so on near-ties of up to 8 candidates
#: the blended values (|p| up to ~5) may differ by a few bf16 steps; the mean
#: |diff| is held at 1e-3 beside it.
_BF16_TOL = {True: 0.04, False: 0.15}


@pytest.mark.parametrize("retrieval_mode", [True, False], ids=["hard", "softmax"])
@pytest.mark.parametrize("n, k", [(37, 4), (64 * 3 + 1, 1), (64 * 500 - 23, 8), (15, 8)],
                         ids=["under-a-tile", "K1", "past-the-grid-K8", "under-a-slice-K8"])
def test_patch_attention_tensor_core_body(cuda, retrieval_mode, n, k):
    """The bf16 wgmma body (persistent blocks, a warpgroup a 64-row tile, a
    warp 16 of its rows): N smaller than a tile and than a warp's 16 rows, N
    no multiple of 64, more tiles than one round of the persistent grid
    (three warpgroups on each of an H100's 132 SMs: 396 tiles), K = 1 and
    K = 8."""
    q = -(-n // 64)
    xt, bank, idx, theta, phi = attention_inputs(np.random.default_rng(16), q, 50, 64, 128, k)
    x = torch.from_numpy(xt).reshape(-1, 128)[:n].to(cuda, torch.bfloat16).contiguous()
    rows = np.random.default_rng(17).integers(0, 50 * 64, (n, k))
    p = torch.from_numpy(bank).reshape(-1, 128)[torch.from_numpy(rows)] \
        .to(cuda, torch.bfloat16).contiguous()
    theta, phi = theta.to(cuda, torch.bfloat16), phi.to(cuda, torch.bfloat16)
    with torch.no_grad():
        before = pa.patch_attention.launches
        out, sel = pa.patch_attention(x, p, theta, phi, k, retrieval_mode, return_selection=True)
        torch.cuda.synchronize()
        assert pa.patch_attention.launches == before + 1
        assert pa.patch_attention.math == "wgmma.bf16"
        want, want_sel = pa.patch_attention_plain(x, p, theta, phi, k, retrieval_mode)
    assert out.shape == x.shape and out.dtype == torch.bfloat16 and sel.shape == (n,)
    assert int(sel.min()) >= 0 and int(sel.max()) < k
    _agree(out, sel, want, want_sel, 0.99, _BF16_TOL[retrieval_mode])
    assert float((out.float() - want.float()).abs().mean()) <= 1e-3


@pytest.mark.parametrize("retrieval_mode", [True, False], ids=["hard", "softmax"])
@pytest.mark.parametrize("q, k", [(3, 4), (500, 4), (5, 1), (450, 8)],
                         ids=["under-the-grid", "past-the-grid", "K1", "past-the-grid-K8"])
def test_gathered_attention_tensor_core_body(cuda, retrieval_mode, q, k):
    """The bf16 body over bank rows gathered by index: fewer tiles than the
    persistent grid has blocks and more slices than one round of it, K = 1
    and K = 8."""
    xt, bank, idx, theta, phi = attention_inputs(np.random.default_rng(18), q, 50, 64, 128, k)
    args = [torch.from_numpy(a).to(cuda, torch.bfloat16) for a in (xt, bank)] + [
        torch.from_numpy(idx).to(cuda)]
    theta, phi = theta.to(cuda, torch.bfloat16), phi.to(cuda, torch.bfloat16)
    with torch.no_grad():
        before = pa.gathered_patch_attention.launches
        out, sel = pa.gathered_patch_attention(*args, theta, phi, k, retrieval_mode,
                                               return_selection=True)
        torch.cuda.synchronize()
        assert pa.gathered_patch_attention.launches == before + 1
        assert pa.gathered_patch_attention.math == "wgmma.bf16"
        want, want_sel = pa.gathered_patch_attention_plain(*args, theta, phi, k, retrieval_mode)
    assert out.shape == (q, 64, 128) and sel.shape == (q, 64)
    _agree(out, sel, want, want_sel, 0.99, _BF16_TOL[retrieval_mode])
    assert float((out.float() - want.float()).abs().mean()) <= 1e-3


@pytest.mark.parametrize("retrieval_mode", [True, False], ids=["hard", "softmax"])
@pytest.mark.parametrize("k", [1, 4, 8])
@pytest.mark.parametrize("f", pa.SHIPPED_WIDTHS)
@pytest.mark.parametrize("kernel", ["patch", "gathered"])
def test_wgmma_body_matches_plain_at_every_shipped_shape(cuda, kernel, f, k, retrieval_mode):
    """The wgmma body of both kernels at each shipped F, K 1, 4 and 8, hard
    and softmax: patch_attention at N = 64·401 + 17 (a ragged last tile),
    gathered_attention at Q = 401 tiles (no multiple of the persistent
    grid's warpgroups); one launch each, reported as wgmma.bf16, against the
    plain version under the F = 128 tests' tolerances."""
    q = 401
    xt, bank, idx, theta, phi = attention_inputs(np.random.default_rng(40 + f + k), q, 50, 64,
                                                 f, k)
    theta, phi = theta.to(cuda, torch.bfloat16), phi.to(cuda, torch.bfloat16)
    xt, bank = (torch.from_numpy(a).to(cuda, torch.bfloat16) for a in (xt, bank))
    if kernel == "patch":
        n = 64 * q + 17
        rows = torch.from_numpy(np.random.default_rng(41 + f).integers(0, 50 * 64, (n, k)))
        x = torch.cat([xt.reshape(-1, f), xt[0, :17]]).contiguous()
        args = (x, bank.reshape(-1, f)[rows.to(cuda)].contiguous())
        fn, plain = pa.patch_attention, pa.patch_attention_plain
    else:
        args = (xt, bank, torch.from_numpy(idx).to(cuda))
        fn, plain = pa.gathered_patch_attention, pa.gathered_patch_attention_plain
    with torch.no_grad():
        before = fn.launches
        out, sel = fn(*args, theta, phi, k, retrieval_mode, return_selection=True)
        torch.cuda.synchronize()
        assert fn.launches == before + 1
        assert fn.math == "wgmma.bf16" and fn.instance == "shipped"
        want, want_sel = plain(*args, theta, phi, k, retrieval_mode)
    assert out.shape == args[0].shape and out.dtype == torch.bfloat16
    assert int(sel.min()) >= 0 and int(sel.max()) < k
    _agree(out, sel, want, want_sel, 0.99, _BF16_TOL[retrieval_mode])
    assert float((out.float() - want.float()).abs().mean()) <= 1e-3


def test_attention_float32_keeps_the_fma_body(cuda):
    xt, bank, idx, theta, phi = attention_inputs(np.random.default_rng(19), 3, 9, 64, 128, 4)
    args = [torch.from_numpy(a).to(cuda) for a in (xt, bank, idx)]
    with torch.no_grad():
        pa.gathered_patch_attention(*args, theta.to(cuda), phi.to(cuda), 4)
        pa.gathered_patch_attention_v1(*args, theta.to(cuda), phi.to(cuda), 4)
        assert pa.gathered_patch_attention.math == "fma.f32"
        assert pa.gathered_patch_attention_v1.math == "fma.f32"
        pa.gathered_patch_attention_v1(*[a.bfloat16() for a in args[:2]], args[2],
                                       theta.to(cuda).bfloat16(), phi.to(cuda).bfloat16(), 4)
    assert pa.gathered_patch_attention_v1.math == "mma.bf16"


@pytest.mark.parametrize("retrieval_mode", [True, False], ids=["hard", "softmax"])
@pytest.mark.parametrize("q, k, idx_law", [
    (3, 4, "random"), (500, 4, "random"), (5, 1, "random"), (450, 8, "random"),
    (133, 4, "repeated"), (140, 8, "descending")],
    ids=["under-the-grid", "past-the-grid", "K1", "past-the-grid-K8", "repeated-idx",
         "descending-idx-K8"])
def test_gathered_attention_v1_tensor_core_body(cuda, retrieval_mode, q, k, idx_law):
    """The bf16 body over candidate tiles staged by bulk copies: fewer tiles
    than a block has warp groups, tile counts that are no multiple of the
    persistent grid (132 blocks on an H100) or of its groups, K = 1 and
    K = 8 (more candidates than a ring has slots), a tile whose K candidates
    are one bank row, and indices that run backwards through the bank."""
    xt, bank, idx, theta, phi = attention_inputs(np.random.default_rng(21), q, 50, 64, 128, k)
    if idx_law == "repeated":
        idx[:] = idx[:, :1]
    elif idx_law == "descending":
        idx[:] = (49 - (np.arange(q * k) % 50)).reshape(q, k)
    args = [torch.from_numpy(a).to(cuda, torch.bfloat16) for a in (xt, bank)] + [
        torch.from_numpy(idx).to(cuda)]
    theta, phi = theta.to(cuda, torch.bfloat16), phi.to(cuda, torch.bfloat16)
    with torch.no_grad():
        before = pa.gathered_patch_attention_v1.launches
        out, sel = pa.gathered_patch_attention_v1(*args, theta, phi, k, retrieval_mode,
                                                  return_selection=True)
        torch.cuda.synchronize()
        assert pa.gathered_patch_attention_v1.launches == before + 1
        assert pa.gathered_patch_attention_v1.math == "mma.bf16"
        want, want_sel = pa.gathered_patch_attention_v1_plain(*args, theta, phi, k,
                                                              retrieval_mode)
    assert out.shape == (q, 64, 128) and out.dtype == torch.bfloat16 and sel.shape == (q, 64)
    assert int(sel.min()) >= 0 and int(sel.max()) < k
    _agree(out, sel, want, want_sel, 0.99, _BF16_TOL[retrieval_mode])
    assert float((out.float() - want.float()).abs().mean()) <= 1e-3
    if idx_law == "repeated" and retrieval_mode:
        assert int(sel.max()) == 0  # equal scores: the first candidate wins


@pytest.mark.parametrize("retrieval_mode", [True, False], ids=["hard", "softmax"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_gathered_attention_v1_kernel_matches_plain(cuda, retrieval_mode, dtype):
    xt, bank, idx, theta, phi = attention_inputs(np.random.default_rng(12), 37, 50, 64, 128, 4)
    args = [torch.from_numpy(a).to(cuda, dtype) for a in (xt, bank)] + [
        torch.from_numpy(idx).to(cuda)]
    theta, phi = theta.to(cuda, dtype), phi.to(cuda, dtype)
    with torch.no_grad():
        before = pa.gathered_patch_attention_v1.launches
        out, sel = pa.gathered_patch_attention_v1(*args, theta, phi, 4, retrieval_mode,
                                                  return_selection=True)
        torch.cuda.synchronize()
        assert pa.gathered_patch_attention_v1.launches == before + 1
        want, want_sel = pa.gathered_patch_attention_v1_plain(*args, theta, phi, 4,
                                                              retrieval_mode)
    if dtype == torch.float32:
        _agree(out, sel, want, want_sel, 0.999, 1e-4)
    else:
        _agree(out, sel, want, want_sel, 0.99, 0.04)


def test_gathered_attention_v1_raises_past_its_staging_budget(cuda):
    """K=5 float32 candidate tiles (160 KB) do not fit beside the shipped
    instance's activations: the wrapper sends them to the general instance,
    which stages in chunks; bf16 stages candidate by candidate and takes
    K = 8 on its shipped instance and K = 9 on the general one. Past K = 32
    both raise, before any launch."""
    xt, bank, idx, theta, phi = attention_inputs(np.random.default_rng(13), 3, 9, 64, 128, 5)
    args = [torch.from_numpy(a).to(cuda) for a in (xt, bank, idx)]
    with torch.no_grad():
        out, sel = pa.gathered_patch_attention_v1(*args, theta.to(cuda), phi.to(cuda), 5,
                                                  return_selection=True)
        want, want_sel = pa.gathered_patch_attention_v1_plain(*args, theta.to(cuda),
                                                              phi.to(cuda), 5)
    assert pa.gathered_patch_attention_v1.instance == "general"
    _agree(out, sel, want, want_sel, 0.999, 1e-4)
    xt, bank, idx, theta, phi = attention_inputs(np.random.default_rng(13), 3, 9, 64, 128, 8)
    args = [torch.from_numpy(a).to(cuda).bfloat16() for a in (xt, bank)] + [
        torch.from_numpy(idx).to(cuda)]
    with torch.no_grad():
        out = pa.gathered_patch_attention_v1(*args, theta.to(cuda).bfloat16(),
                                             phi.to(cuda).bfloat16(), 8)
        torch.cuda.synchronize()
    assert out.shape == (3, 64, 128) and pa.gathered_patch_attention_v1.math == "mma.bf16"
    assert pa.gathered_patch_attention_v1.instance == "shipped"
    idx9 = torch.from_numpy(np.random.default_rng(14).integers(0, 9, (3, 9)).astype(np.int32))
    with torch.no_grad():
        pa.gathered_patch_attention_v1(*args[:2], idx9.to(cuda), theta.to(cuda).bfloat16(),
                                       phi.to(cuda).bfloat16(), 9)
    assert pa.gathered_patch_attention_v1.instance == "general"
    before = pa.gathered_patch_attention_v1.launches
    with pytest.raises(ValueError, match="K <= 32"):
        pa.gathered_patch_attention_v1(*args[:2], torch.zeros((3, 33), dtype=torch.int32,
                                                              device=cuda),
                                       theta.to(cuda).bfloat16(), phi.to(cuda).bfloat16(), 33)
    assert pa.gathered_patch_attention_v1.launches == before


@pytest.mark.parametrize("nf, s", [(16, 5), (16, 33), (4, 7), (8, 3)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_decoder_tail_kernel_matches_plain(cuda, nf, s, dtype):
    """S is no multiple of any block tile; the pad ring is zero, as
    CompactPackedDecoder writes it."""
    rng = np.random.default_rng(14)
    b = 2
    hn = torch.zeros((b, s + 2, s + 2, s + 2, 8 * nf))
    hn[:, 1:-1, 1:-1, 1:-1] = torch.from_numpy(
        rng.standard_normal((b, s, s, s, 8 * nf)).astype(np.float32))
    hn = hn.to(cuda, dtype)
    w2 = torch.from_numpy(rng.standard_normal((3, 3, 3, nf, nf)).astype(np.float32)
                          / np.sqrt(27 * nf)).to(cuda, dtype)
    wh = torch.from_numpy(rng.standard_normal(nf).astype(np.float32) / np.sqrt(nf)).to(cuda, dtype)
    before = dt.decoder_tail.launches
    out = dt.decoder_tail(hn, w2, wh, 0.25)
    torch.cuda.synchronize()
    assert dt.decoder_tail.launches == before + 1
    want = dt.decoder_tail_plain(hn, w2, wh, 0.25)
    assert out.shape == (b, s, s, s, 8) and out.dtype == torch.float32
    # bf16: the ReLU output is rounded before the head, so sums taken in
    # another order may round to the neighbouring bf16 value
    assert float((out - want).abs().max()) <= (1e-5 if dtype == torch.float32 else 1e-2)


@pytest.mark.parametrize("b", [1, 3])
@pytest.mark.parametrize("s", [1, 5, 33])
def test_decoder_tail_tensor_core_body(cuda, b, s):
    """bf16 at nf = 16, the implicit GEMM: S below, at an odd count of and
    past the block's 2 x 2 packed tile and the warp's 32-voxel run, on an
    input whose pad ring is zero."""
    rng = np.random.default_rng(20)
    nf = 16
    hn = torch.zeros((b, s + 2, s + 2, s + 2, 8 * nf))
    hn[:, 1:-1, 1:-1, 1:-1] = torch.from_numpy(
        rng.standard_normal((b, s, s, s, 8 * nf)).astype(np.float32))
    hn = hn.to(cuda, torch.bfloat16)
    w2 = torch.from_numpy(rng.standard_normal((3, 3, 3, nf, nf)).astype(np.float32)
                          / np.sqrt(27 * nf)).to(cuda, torch.bfloat16)
    wh = torch.from_numpy(rng.standard_normal(nf).astype(np.float32)
                          / np.sqrt(nf)).to(cuda, torch.bfloat16)
    before = dt.decoder_tail.launches
    out = dt.decoder_tail(hn, w2, wh, -0.1)
    torch.cuda.synchronize()
    assert dt.decoder_tail.launches == before + 1 and dt.decoder_tail.math == "mma.bf16"
    want = dt.decoder_tail_plain(hn, w2, wh, -0.1)
    assert out.shape == (b, s, s, s, 8) and out.dtype == torch.float32
    assert float((out - want).abs().max()) <= 1e-2
    dt.decoder_tail(hn.float(), w2.float(), wh.float(), -0.1)
    assert dt.decoder_tail.math == "fma.f32"


@pytest.mark.parametrize("integer", [True, False], ids=["voxel", "float"])
def test_chamfer_kernel_matches_plain(cuda, integer):
    """B > 1 pairs, ragged counts, capacities that are no multiple of the
    kernel's tiles, one set empty in two pairs and both in one. On voxel
    coordinates the minima are bit-equal (every term an exact integer)."""
    rng = np.random.default_rng(15)
    counts = [(1300, 517), (1, 2), (0, 40), (600, 0), (0, 0), (1301, 1999)]
    cap_a, cap_b = 1301, 2000
    a = np.zeros((len(counts), cap_a, 3), np.float32)
    b = np.zeros((len(counts), cap_b, 3), np.float32)
    for i, (na, nb) in enumerate(counts):
        for buf, n in ((a, na), (b, nb)):
            buf[i, :n] = rng.integers(0, 64, (n, 3)) if integer else rng.standard_normal((n, 3))
    n_a = torch.tensor([c[0] for c in counts], dtype=torch.int32)
    n_b = torch.tensor([c[1] for c in counts], dtype=torch.int32)
    args = [torch.from_numpy(a).to(cuda), n_a.to(cuda), torch.from_numpy(b).to(cuda),
            n_b.to(cuda)]
    before = chamfer_minima.launches
    min_ab, min_ba = chamfer_minima(*args)
    torch.cuda.synchronize()
    assert chamfer_minima.launches == before + 1
    want_ab, want_ba = chamfer_minima_plain(*args)
    assert torch.equal(min_ab == BIG, want_ab == BIG) and torch.equal(min_ba == BIG, want_ba == BIG)
    if integer:
        assert torch.equal(min_ab, want_ab) and torch.equal(min_ba, want_ba)
    else:
        torch.testing.assert_close(min_ab, want_ab, rtol=1e-5, atol=1e-5)
        torch.testing.assert_close(min_ba, want_ba, rtol=1e-5, atol=1e-5)
    got, want = chamfer_batch(*args), chamfer_batch_plain(*args)
    assert chamfer_minima.launches == before + 2
    torch.testing.assert_close(got, want, rtol=1e-6 if integer else 1e-5, atol=0)
    assert float(got[4]) == 0.0 and float(got[2]) == pytest.approx(1e30, rel=1e-5)


@pytest.mark.parametrize("n_b", [20471, 20472, 20473, 3, 0],
                         ids=["below-a-run-boundary", "at-a-run-boundary",
                              "above-a-run-boundary", "fewer-than-splits", "empty"])
def test_chamfer_kernel_splits_one_pair_across_blocks(cuda, n_b):
    """B = 1 with 22,000 points against n_b: the kernel cuts the streamed set
    in up to 8 even runs of ceil(n / 8) points over the blocks of a cluster
    and merges their minima. 20,472 = 8 x 2,559: one point fewer or more
    moves every run's boundary and leaves the last run ragged; 3 points leave
    five runs empty. Voxel coordinates: bit-equal to the plain version."""
    rng = np.random.default_rng(22)
    n_a, cap = 22000, 24576
    a = np.zeros((1, cap, 3), np.float32)
    b = np.zeros((1, cap, 3), np.float32)
    a[0, :n_a] = rng.integers(0, 64, (n_a, 3))
    b[0, :n_b] = rng.integers(0, 64, (n_b, 3))
    args = [torch.from_numpy(a).to(cuda), torch.tensor([n_a], dtype=torch.int32, device=cuda),
            torch.from_numpy(b).to(cuda), torch.tensor([n_b], dtype=torch.int32, device=cuda)]
    before = chamfer_minima.launches
    got = chamfer_minima(*args)
    torch.cuda.synchronize()
    assert chamfer_minima.launches == before + 1
    want = chamfer_minima_plain(*args)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    assert bool((got[0][0, n_a:] == BIG).all()) and bool((got[1][0, n_b:] == BIG).all())
    if n_b == 0:
        assert bool((got[0] == BIG).all())


def test_chamfer_kernel_rejects_what_it_does_not_take(cuda):
    pts = torch.zeros((2, 8, 3), device=cuda)
    n = torch.tensor([3, 4], dtype=torch.int32, device=cuda)
    with pytest.raises(ValueError, match="int32"):
        chamfer_minima(pts, n.long(), pts, n)
    with pytest.raises(ValueError, match="float32"):
        chamfer_minima(pts.double(), n, pts, n)
    with pytest.raises(ValueError, match="one CUDA device"):
        chamfer_minima(pts, n.cpu(), pts, n)


# ------------------------------------------- the widths of nf 12 (F = 96)


def _attention_at(dev, kernel, dtype, retrieval_mode, q, k, seed, f=96, t=64):
    """One launch of attention kernel `kernel` ("v2", "v1" or "patch") at
    F = f (T = t rows a tile) on seeded rows, and its plain version's
    output."""
    xt, bank, idx, theta, phi = attention_inputs(np.random.default_rng(seed), q, 50, t, f, k)
    theta, phi = theta.to(dev, dtype), phi.to(dev, dtype)
    xt, bank = (torch.from_numpy(a).to(dev, dtype) for a in (xt, bank))
    idx = torch.from_numpy(idx).to(dev)
    if kernel == "patch":
        n = max(1, q * t - 23)
        rows = torch.from_numpy(np.random.default_rng(seed + 1).integers(0, 50 * t, (n, k)))
        args = (xt.reshape(-1, f)[:n].contiguous(),
                bank.reshape(-1, f)[rows.to(dev)].contiguous())
        fn, plain = pa.patch_attention, pa.patch_attention_plain
    else:
        args = (xt, bank, idx)
        fn, plain = {"v2": (pa.gathered_patch_attention, pa.gathered_patch_attention_plain),
                     "v1": (pa.gathered_patch_attention_v1,
                            pa.gathered_patch_attention_v1_plain)}[kernel]
    with torch.no_grad():
        before = fn.launches
        out, sel = fn(*args, theta, phi, k, retrieval_mode, return_selection=True)
        torch.cuda.synchronize()
        assert fn.launches == before + 1
        name = {"v2": "gathered_attention", "v1": "gathered_attention_v1",
                "patch": "patch_attention"}[kernel]
        general = not pa.is_shipped_shape(name, f, k, None if kernel == "patch" else t, dtype)
        assert fn.math == pa.kernel_math(name, dtype, general)
        want, want_sel = plain(*args, theta, phi, k, retrieval_mode)
    assert out.shape == args[0].shape and out.dtype == dtype
    return out, sel, want, want_sel


@pytest.mark.parametrize("retrieval_mode", [True, False], ids=["hard", "softmax"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("kernel", ["v2", "v1", "patch"])
def test_attention_kernels_at_f96_match_plain(cuda, kernel, dtype, retrieval_mode):
    """F = 96, the surface-reconstruction width, through each of the three
    kernels: ragged N for patch_attention, more tiles than one round of the
    persistent grid (300), K = 4; the F = 128 tests' tolerances."""
    out, sel, want, want_sel = _attention_at(cuda, kernel, dtype, retrieval_mode, 300, 4, 30)
    if dtype == torch.float32:
        _agree(out, sel, want, want_sel, 0.999, 1e-4)
    else:
        _agree(out, sel, want, want_sel, 0.99, _BF16_TOL[retrieval_mode])
        assert float((out.float() - want.float()).abs().mean()) <= 1e-3


@pytest.mark.parametrize("kernel, q, k", [("v2", 3, 8), ("v1", 5, 1), ("v1", 133, 8),
                                          ("patch", 2, 8)])
def test_attention_tensor_core_body_at_f96(cuda, kernel, q, k):
    """bf16 at F = 96: under one tile, K = 1 and K = 8 (more candidates than
    a v1 ring has slots)."""
    out, sel, want, want_sel = _attention_at(cuda, kernel, torch.bfloat16, True, q, k, 31)
    assert int(sel.min()) >= 0 and int(sel.max()) < k
    _agree(out, sel, want, want_sel, 0.99, _BF16_TOL[True])


def test_v1_float32_staging_at_f96(cuda):
    """Float32 tiles of F = 96 take 24 KB: v1's shipped instance stages
    K = 5 of them (one more than at F = 128); K = 6 runs the general
    instance."""
    assert pa.V1_F32_MAX_K[96] == 5
    out, sel, want, want_sel = _attention_at(cuda, "v1", torch.float32, True, 7, 5, 32)
    assert pa.gathered_patch_attention_v1.instance == "shipped"
    _agree(out, sel, want, want_sel, 0.999, 1e-4)
    out, sel, want, want_sel = _attention_at(cuda, "v1", torch.float32, True, 7, 6, 32)
    assert pa.gathered_patch_attention_v1.instance == "general"
    _agree(out, sel, want, want_sel, 0.999, 1e-4)


@pytest.mark.parametrize("f", [32, 64])
@pytest.mark.parametrize("retrieval_mode", [True, False], ids=["hard", "softmax"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("kernel", ["v2", "v1", "patch"])
def test_attention_kernels_at_f32_and_f64_match_plain(cuda, kernel, dtype, retrieval_mode, f):
    """F = 32 and 64 (nf 4 and 8) through each of the three kernels, as
    the F = 96 test: 300 tiles, K = 4, the F = 128 tests' tolerances."""
    out, sel, want, want_sel = _attention_at(cuda, kernel, dtype, retrieval_mode, 300, 4, 35, f)
    if dtype == torch.float32:
        _agree(out, sel, want, want_sel, 0.999, 1e-4)
    else:
        _agree(out, sel, want, want_sel, 0.99, _BF16_TOL[retrieval_mode])


def test_v1_float32_staging_at_f64(cuda):
    """Float32 tiles of F = 64 take 16 KB: v1 stages K = 8 of them, the
    wrappers' K limit."""
    assert pa.V1_F32_MAX_K[64] == pa.V1_F32_MAX_K[32] == pa.SHIPPED_MAX_K == 8
    out, sel, want, want_sel = _attention_at(cuda, "v1", torch.float32, True, 7, 8, 36, 64)
    _agree(out, sel, want, want_sel, 0.999, 1e-4)


def test_attention_kernels_refuse_other_widths(cuda):
    """F = 1025 (one past the general instance's 1024) and F = 2048 are
    refused by name, before any launch."""
    for f in (1025, 2048):
        xt, bank, idx, theta, phi = attention_inputs(np.random.default_rng(33), 3, 9, 8, f, 2)
        args = [torch.from_numpy(a).to(cuda) for a in (xt, bank, idx)]
        before = pa.gathered_patch_attention.launches
        with pytest.raises(ValueError, match=r"F in 1\.\.1024"):
            pa.gathered_patch_attention(*args, theta.to(cuda), phi.to(cuda), 2)
        assert pa.gathered_patch_attention.launches == before


@pytest.mark.parametrize("b, s", [(1, 1), (3, 5), (2, 32), (1, 33)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_decoder_tail_at_nf12_matches_plain(cuda, dtype, b, s):
    """nf 12: bf16 on the tensor cores with the channels zero-padded to 16
    (S below, at an odd count of and past the 2 x 2 tile, the serving S = 32
    with two slabs and S = 33 with one), float32 on FMAs; the nf 16
    tolerances."""
    rng = np.random.default_rng(34)
    nf = 12
    hn = torch.zeros((b, s + 2, s + 2, s + 2, 8 * nf))
    hn[:, 1:-1, 1:-1, 1:-1] = torch.from_numpy(
        rng.standard_normal((b, s, s, s, 8 * nf)).astype(np.float32))
    hn = hn.to(cuda, dtype)
    w2 = torch.from_numpy(rng.standard_normal((3, 3, 3, nf, nf)).astype(np.float32)
                          / np.sqrt(27 * nf)).to(cuda, dtype)
    wh = torch.from_numpy(rng.standard_normal(nf).astype(np.float32) / np.sqrt(nf)).to(cuda, dtype)
    before = dt.decoder_tail.launches
    out = dt.decoder_tail(hn, w2, wh, 0.3)
    torch.cuda.synchronize()
    assert dt.decoder_tail.launches == before + 1
    assert dt.decoder_tail.math == ("mma.bf16" if dtype == torch.bfloat16 else "fma.f32")
    want = dt.decoder_tail_plain(hn, w2, wh, 0.3)
    assert out.shape == (b, s, s, s, 8) and out.dtype == torch.float32
    assert float((out - want).abs().max()) <= (1e-5 if dtype == torch.float32 else 1e-2)


def test_kernel_limits_at_nf12_and_past_the_widths():
    """Runs on the CPU (a CUDA device is only named): the one set of
    constants takes nf 4, 8, 12, 16 and 20 (F = 32 to 160; nf 12 is the
    3DFront surface-reconstruction config, nf 20 the widest past the
    shipped widths this test names) and the flagship at nf 24, K 12 on
    every attention path with the decoder tail and the topk kernel; nf 65 is
    refused by the decoder tail, F = 1025 (nf 1025 at e = 1), K = 33 and
    T = 513 (9³ = 729 rows a tile past 512; 8³ = 512 is taken) by the
    attention kernels, each named."""
    from chip_smoke import WIDE_K, WIDE_NF, flagship_config, surface_config
    from retrieval_fuse_tpu_torch.inference import check_kernel_limits, variant_engine_kwargs
    cuda_dev = torch.device("cuda")
    kw = variant_engine_kwargs("fused+pallasp+topk1p+cdec")
    wide = dict(flagship_config(), nf=WIDE_NF, K=WIDE_K)  # chip_smoke's phase 4h
    for cfg in [dict(surface_config(), nf=nf) for nf in (4, 8, 12, 16, 20)] + [wide]:
        for attention in ("patches", "packedrows", "gathered", "gathered2"):
            for dtype in (torch.bfloat16, torch.float32):
                check_kernel_limits(cfg, cuda_dev, attention, kw["decoder"], dtype,
                                    "single_pass")
    with pytest.raises(ValueError, match=r"decoder_tail kernel.*1\.\.64.*nf = 65"):
        check_kernel_limits(dict(surface_config(), nf=65), cuda_dev, "modules", "compact")
    with pytest.raises(ValueError, match="patch_attention kernel.*F = nf·e³ = 1025"):
        check_kernel_limits(dict(surface_config(), nf=1025, attn_patch_extent=2), cuda_dev,
                            kw["attention"], "modules")
    with pytest.raises(ValueError, match="gathered_attention_v1 kernel.*K = 33"):
        check_kernel_limits(dict(surface_config(), K=33), cuda_dev, "gathered", "modules",
                            torch.float32)
    check_kernel_limits(dict(surface_config(), attn_num_patch=32), cuda_dev, "gathered2",
                        "modules")
    with pytest.raises(ValueError, match=r"gathered_attention kernel.*T in 1\.\.512.*T = 729"):
        check_kernel_limits(dict(surface_config(), attn_num_patch=36), cuda_dev, "gathered2",
                            "modules")
    assert (pa.KERNEL_MAX_F, pa.KERNEL_MAX_K, pa.KERNEL_MAX_T) == (1024, 32, 512)
    assert pa.SHIPPED_WIDTHS == (32, 64, 96, 128) and dt.KERNEL_NF == (4, 8, 12, 16)
    assert dt.KERNEL_MAX_NF == 64
    assert pa.V1_F32_MAX_K == {32: 8, 64: 8, 96: 5, 128: 4}
    assert dt.kernel_math(torch.bfloat16, 12) == "mma.bf16"
    assert dt.kernel_math(torch.bfloat16, 24) == "mma.bf16"
    assert dt.kernel_math(torch.bfloat16, 24, 33) == dt.kernel_math(torch.bfloat16, 33) == "fma.f32"


# ------------------------------------------------------------ training


def test_retrieval_trainer_steps_on_the_card_match_the_cpu(cuda, tmp_path, monkeypatch):
    """Three train steps on the card against the same steps on the CPU
    (chip_smoke.hold_train_steps: seeded weights, same batches, float32;
    losses within 1e-5 relative), at chip_smoke's config (ShapeNetV2's
    retrieval width, batch 128) on a small synthetic dataset, with the plain
    and the BatchNorm target encoder. TF32 is off by its flags. The step-1
    gradients are held by chip_smoke.TRAIN_GRAD_TOL, set per encoder between
    float32's rounding and TF32's, as tools/torch_port_train_precision.py
    measured them on this data: plain 2.6e-4 (TF32 1.1e-2) -> 1e-3;
    BatchNorm 4.2e-3, the CPU's own float32 as far from float64 (TF32
    4.0e-2) -> 1e-2; the step-1 gradients with TF32 on lie outside."""
    from chip_smoke import TRAIN_GRAD_TOL, hold_train_steps, retrieval_config
    from retrieval_fuse_tpu_torch.data.synthetic import generate_synthetic_dataset
    assert not torch.backends.cudnn.allow_tf32
    assert torch.get_float32_matmul_precision() == "highest"
    monkeypatch.chdir(tmp_path)
    generate_synthetic_dataset(tmp_path / "data", n_train=12, n_val=2, seed=3)
    for target_code in ("16+8", "16+8N"):
        cfg = dict(retrieval_config(tmp_path / "data", ""), seed=5, experiment="card_steps")
        cfg["retrieval_model"]["network_target"] = target_code
        trainer, losses, grad_err, tf32_err = hold_train_steps(cfg, cuda, 3)
        assert len(losses) == 3 and grad_err <= TRAIN_GRAD_TOL[target_code] < tf32_err
        assert trainer.fenc_target.use_batchnorm == target_code.endswith("N")


def test_batchnorm_encoder_train_mode_on_the_card(cuda):
    """PatchNorm32 in train mode (batch statistics, running statistics
    updated) and then eval mode: the card equals the CPU."""
    from retrieval_fuse_tpu_torch.models import init_module_params
    from retrieval_fuse_tpu_torch.models.encoders import make_encoder
    cpu = make_encoder("PatchNorm32", 4, 16)
    cpu.load_state_dict(init_module_params(cpu, np.random.default_rng(3)))
    card = make_encoder("PatchNorm32", 4, 16).to(cuda)
    card.load_state_dict(cpu.state_dict())
    rng = np.random.default_rng(4)
    for i in range(4):
        x = torch.from_numpy(rng.standard_normal((6, 32, 32, 32, 1)).astype(np.float32) * (i + 1))
        if i == 3:
            cpu.eval(), card.eval()
        with torch.no_grad():
            want, got = cpu(x), card(x.to(cuda)).cpu()
        assert float((got - want).abs().max()) <= 1e-5 * max(1.0, float(want.abs().max()))
    for key, value in cpu.state_dict().items():
        assert torch.allclose(card.state_dict()[key].cpu(), value, rtol=1e-5, atol=1e-6), key


@pytest.mark.parametrize("nf, variant, kernel", [
    (129, "fused+pallasg2+topk1p", "gathered_attention"),
    (129, "fused+pallasp+topk1p+cdec", "patch_attention"),
    (65, "cdec", "decoder_tail")])
def test_engine_build_refuses_kernel_limits_on_the_card(cuda, nf, variant, kernel):
    """An engine on the card whose kernel path breaks a kernel's limits
    raises at construction, naming the kernel, before any launch: nf 129
    gives F = 8·129 = 1032 rows, past the attention kernels' 1024; nf 65 is
    past the decoder tail's 64."""
    from chip_smoke import flagship_config
    from retrieval_fuse_tpu_torch.inference import RetrieveRefineEngine, variant_engine_kwargs
    cfg = dict(flagship_config(), nf=nf)
    launches = (pa.gathered_patch_attention.launches, pa.patch_attention.launches,
                dt.decoder_tail.launches)
    with pytest.raises(ValueError, match=kernel):
        RetrieveRefineEngine(cfg, {}, np.zeros((4, 64), np.float32), device=cuda,
                             feature_bank=np.zeros((4, 8, 8, 8, nf), np.float32),
                             **variant_engine_kwargs(variant))
    assert launches == (pa.gathered_patch_attention.launches, pa.patch_attention.launches,
                        dt.decoder_tail.launches)


# ------------------------------- the general instances, past the shipped shapes

#: (F, K, T) of the general instances' card holds: the flagship at nf 24
#: (F = 192, K = 12, T = 64: theta and phi no longer fit a block), the outer
#: corner (nf 16 at attn_patch_extent 6: F = 432, K = 32, T = 27), a narrow
#: unaligned case (F = 12: rows of 24 bytes, K = 1, T = 8), and nf 6 (F = 48,
#: K = 12, T = 27)
GENERAL_SHAPES = [(192, 12, 64), (432, 32, 27), (12, 1, 8), (48, 12, 27)]


@pytest.mark.parametrize("retrieval_mode", [True, False], ids=["hard", "softmax"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("kernel", ["v2", "v1", "patch"])
@pytest.mark.parametrize("f, k, t", GENERAL_SHAPES,
                         ids=[f"F{f}-K{k}-T{t}" for f, k, t in GENERAL_SHAPES])
def test_attention_general_instances_match_plain(cuda, kernel, dtype, retrieval_mode, f, k, t):
    """Each attention kernel's general instance at the shapes past the
    shipped ones: 9 queries (patch_attention: 9·T - 23 rows), the F = 128
    tests' tolerances; selections compared in float32 too."""
    out, sel, want, want_sel = _attention_at(cuda, kernel, dtype, retrieval_mode, 9, k, 40 + f,
                                             f, t)
    fn = {"v2": pa.gathered_patch_attention, "v1": pa.gathered_patch_attention_v1,
          "patch": pa.patch_attention}[kernel]
    assert fn.instance == "general"
    assert int(sel.min()) >= 0 and int(sel.max()) < k
    if dtype == torch.float32:
        _agree(out, sel, want, want_sel, 0.999, 1e-4)
    else:
        _agree(out, sel, want, want_sel, 0.99, _BF16_TOL[retrieval_mode])
        assert float((out.float() - want.float()).abs().mean()) <= 1e-3


@pytest.mark.parametrize("kernel", ["v2", "v1", "patch"])
def test_attention_general_instance_at_a_shipped_shape_matches_the_shipped(cuda, kernel):
    """The general instance launched at a shipped shape (F = 128, K = 4,
    T = 64, through the C entry's flag) computes what the shipped instance
    computes: float32 selections equal, outputs within 1e-5."""
    xt, bank, idx, theta, phi = attention_inputs(np.random.default_rng(50), 5, 20, 64, 128, 4)
    xt, bank = (torch.from_numpy(a).to(cuda) for a in (xt, bank))
    idx = torch.from_numpy(idx).to(cuda)
    theta, phi = theta.to(cuda), phi.to(cuda)
    name = {"v2": "gathered_attention", "v1": "gathered_attention_v1",
            "patch": "patch_attention"}[kernel]
    if kernel == "patch":
        x = xt.reshape(-1, 128)
        p = bank[idx.long()].transpose(1, 2).reshape(-1, 4, 128).contiguous()
        operands = (x.data_ptr(), p.data_ptr(), x.shape[0], 4, 128)
        shipped, _ = pa.patch_attention(x, p, theta, phi, 4, return_selection=True)
        rows = x
    else:
        operands = (xt.data_ptr(), bank.data_ptr(), idx.data_ptr(), 5, 4, 128, 64)
        fn = pa.gathered_patch_attention if kernel == "v2" else pa.gathered_patch_attention_v1
        shipped, _ = fn(xt, bank, idx, theta, phi, 4, return_selection=True)
        rows = xt
    assert (pa.patch_attention if kernel == "patch" else fn).instance == "shipped"
    out = torch.empty_like(rows)
    sel = torch.empty(rows.shape[:-1], dtype=torch.int32, device=cuda)
    with torch.no_grad():
        pa._launch(name, rows, operands, True, theta, phi, True, 1024.0, out, sel,
                   (None,) if kernel == "v1" else ())
        torch.cuda.synchronize()
    assert float((out - shipped).abs().max()) <= 1e-5


def test_topk_kernel_general_instances_match_plain(cuda):
    """k = 9, 12, 16, 17 and 32 (the general instances of 16 and 32 slots)
    on scores with ties inside and across lanes and at the ragged edge (N =
    4,099: the scalar loop), on N = 4,096 and on rows as long as the
    flagship database's (N = 27,132), where the float4 loop's warp-wide
    thresholds filter the lanes (bf16-rounded, tie-rich, too), and a row
    shorter than the list (N = k): values and indices equal, ties included."""
    sims = torch.from_numpy(tied_scores(np.random.default_rng(51), 300, 4099)).to(cuda)
    long = torch.from_numpy(tied_scores(np.random.default_rng(52), 70, 27132)).to(cuda)
    cases = (sims, sims[:, :4096].contiguous(), sims[:, :4096].bfloat16().float(), long,
             long.bfloat16().float())
    for k in (9, 12, 16, 17, 32):
        for s in (*cases, sims[:, :k].contiguous()):
            before = topk.launches
            v, i = topk(s, k)
            torch.cuda.synchronize()
            assert topk.launches == before + 1
            pv, pi = topk_plain(s, k)
            assert torch.equal(i, pi) and torch.equal(v, pv), k


def test_topk_kernel_refuses_k33(cuda):
    sims = torch.zeros((4, 100), device=cuda)
    before = topk.launches
    with pytest.raises(ValueError, match="1 <= k <= 32"):
        topk(sims, 33)
    assert topk.launches == before


@pytest.mark.parametrize("nf, s", [(24, 5), (24, 33), (6, 4), (1, 3), (64, 2), (20, 80),
                                   (30, 32), (13, 17)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_decoder_tail_general_instance_matches_plain(cuda, nf, s, dtype):
    """The general instance (any nf past the shipped 4, 8, 12, 16). bf16 on
    the tensor cores: nf 24 at S = 5 and nf 30 at the serving S = 32 (two
    groups of 16 channels, one slab; copies of 8 and 2 channels), nf 6, 13
    and 1 (one group; copies of 2 channels, and of one for odd nf). On the
    FMA body: every float32, and bf16 where the slab does not fit, nf 24 at
    S = 33 (a block stages its chunks again for a second round of voxels),
    nf 64 (eight chunks of input channels), nf 20 at the largest S, 80. The
    shipped widths' tolerances."""
    rng = np.random.default_rng(52 + nf)
    b = 2 if s < 80 else 1
    hn = torch.zeros((b, s + 2, s + 2, s + 2, 8 * nf))
    hn[:, 1:-1, 1:-1, 1:-1] = torch.from_numpy(
        rng.standard_normal((b, s, s, s, 8 * nf)).astype(np.float32))
    hn = hn.to(cuda, dtype)
    w2 = torch.from_numpy(rng.standard_normal((3, 3, 3, nf, nf)).astype(np.float32)
                          / np.sqrt(27 * nf)).to(cuda, dtype)
    wh = torch.from_numpy(rng.standard_normal(nf).astype(np.float32) / np.sqrt(nf)).to(cuda, dtype)
    before = dt.decoder_tail.launches
    out = dt.decoder_tail(hn, w2, wh, 0.2)
    torch.cuda.synchronize()
    assert dt.decoder_tail.launches == before + 1
    assert dt.decoder_tail.instance == "general"
    assert dt.decoder_tail.math == dt.kernel_math(dtype, nf, s)
    on_fma = (nf, s) in ((24, 33), (64, 2), (20, 80))
    assert (dt.decoder_tail.math == "mma.bf16") == (dtype == torch.bfloat16 and not on_fma)
    want = dt.decoder_tail_plain(hn, w2, wh, 0.2)
    assert out.shape == (b, s, s, s, 8) and out.dtype == torch.float32
    assert float((out - want).abs().max()) <= (1e-5 if dtype == torch.float32 else 1e-2)
