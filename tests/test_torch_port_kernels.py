"""The plain PyTorch versions of the port's six kernels against the JAX
package's Pallas kernels (run with interpret=True, as the JAX tests run
them on the CPU), and the layout helpers around them. The CUDA kernels
themselves are held against these plain versions in test_torch_port_cuda.py.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from retrieval_fuse_tpu.inference import RetrieveRefineEngine as JaxEngine
from retrieval_fuse_tpu.ops.knn import exact_knn as jax_exact_knn
from retrieval_fuse_tpu.ops.pallas_attention import (
    _mlp as jax_mlp, pack_tile_rows as jax_pack_tile_rows, pallas_gathered_patch_attention,
    pallas_gathered_patch_attention_v2, pallas_patch_attention)
from retrieval_fuse_tpu.ops.pallas_decoder import (
    depth_to_space_1ch as jax_depth_to_space_1ch, pack_conv2_imcol_kernel, pack_head_kernel,
    packed_decoder_tail)
from retrieval_fuse_tpu.ops.pallas_knn import pallas_exact_knn
from retrieval_fuse_tpu.ops.pallas_topk import pallas_topk
from retrieval_fuse_tpu_torch.models.attention import AttentionFeatureEncoder
from retrieval_fuse_tpu_torch.ops import decoder_tail as dt
from retrieval_fuse_tpu_torch.ops import patch_attention as pa
from retrieval_fuse_tpu_torch.ops.knn import auto_exact_knn, exact_knn, use_streaming_knn
from retrieval_fuse_tpu_torch.ops.streaming_knn import knn_rows, streaming_knn
from retrieval_fuse_tpu_torch.ops.topk import topk
from retrieval_fuse_tpu_torch.utils.flax_import import flax_to_state_dict
from test_torch_port_cuda import attention_inputs, tied_scores
from test_torch_port_models import torch_threads  # noqa: F401 (autouse fixture)


def test_topk_plain_matches_pallas_topk():
    """Values and indices equal, tie order included, ragged Q and N."""
    sims = tied_scores(np.random.default_rng(0), 70, 1337)
    want_v, want_i = pallas_topk(jnp.asarray(sims), 4, tile_n=512, tile_q=32, interpret=True)
    got_v, got_i = topk(torch.from_numpy(sims), 4)
    assert got_i.dtype == torch.int32
    np.testing.assert_array_equal(got_i.numpy(), np.asarray(want_i))
    np.testing.assert_array_equal(got_v.numpy(), np.asarray(want_v))
    # bf16-rounded scores: many ties
    sims_bf = np.array(jnp.asarray(sims, jnp.bfloat16).astype(jnp.float32))
    want_v, want_i = pallas_topk(jnp.asarray(sims_bf), 3, tile_n=256, tile_q=64, interpret=True)
    got_v, got_i = topk(torch.from_numpy(sims_bf), 3)
    np.testing.assert_array_equal(got_i.numpy(), np.asarray(want_i))
    np.testing.assert_array_equal(got_v.numpy(), np.asarray(want_v))


def test_knn_plain_matches_pallas_knn():
    """N not a multiple of the tile: indices equal, distances within f32."""
    rng = np.random.default_rng(1)
    q = rng.standard_normal((96, 16)).astype(np.float32)
    db = rng.standard_normal((1500, 16)).astype(np.float32)
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    db /= np.linalg.norm(db, axis=1, keepdims=True)
    want_i, want_d = pallas_exact_knn(jnp.asarray(q), jnp.asarray(db), 4, tile_n=1024,
                                      tile_q=32, interpret=True)
    got_i, got_d = streaming_knn(torch.from_numpy(q), torch.from_numpy(db), 4)
    np.testing.assert_array_equal(got_i.numpy(), np.asarray(want_i))
    np.testing.assert_allclose(got_d.numpy(), np.asarray(want_d), atol=1e-5)


def _unit_rows(rng, n, d):
    x = rng.standard_normal((n, d)).astype(np.float32)
    return x / np.linalg.norm(x, axis=1, keepdims=True)


def test_knn_bf16_rows_match_pallas_knn():
    """bf16 rows, as the bf16 serving engine passes them: the float32
    products of the bf16 values, as pallas_exact_knn scores the same values
    cast to float32. Indices equal, distances within 1e-5."""
    rng = np.random.default_rng(11)
    q = torch.from_numpy(_unit_rows(rng, 80, 64)).bfloat16()
    db = torch.from_numpy(_unit_rows(rng, 1300, 64)).bfloat16()
    want_i, want_d = pallas_exact_knn(jnp.asarray(q.float().numpy()),
                                      jnp.asarray(db.float().numpy()), 4, tile_n=512,
                                      tile_q=32, interpret=True)
    got_i, got_d = streaming_knn(q, db, 4)
    np.testing.assert_array_equal(got_i.numpy(), np.asarray(want_i))
    np.testing.assert_allclose(got_d.numpy(), np.asarray(want_d), atol=1e-5)


@pytest.mark.parametrize("k", [5, 10, 16])
@pytest.mark.parametrize("d", [16, 96])
def test_knn_widened_domain_matches_pallas_knn(d, k):
    """Widths other than 64 and k past 8 (k = 10 is what `--K 5` asks of
    `map`), N not a multiple of any tile: indices equal, distances within
    float32."""
    rng = np.random.default_rng(100 + d + k)
    q, db = _unit_rows(rng, 50, d), _unit_rows(rng, 1100, d)
    want_i, want_d = pallas_exact_knn(jnp.asarray(q), jnp.asarray(db), k, tile_n=512,
                                      tile_q=32, interpret=True)
    got_i, got_d = streaming_knn(torch.from_numpy(q), torch.from_numpy(db), k)
    assert got_i.shape == (50, k)
    np.testing.assert_array_equal(got_i.numpy(), np.asarray(want_i))
    np.testing.assert_allclose(got_d.numpy(), np.asarray(want_d), atol=1e-5)


@pytest.mark.parametrize("shape_q, shape_db, db_dtype, k, match", [
    ((4, 257), (40, 257), torch.float32, 4, "1 <= D <= 256"),
    ((4, 64), (40, 64), torch.float32, 33, "1 <= k <= 32"),
    ((4, 64), (3, 64), torch.float32, 4, "N >= k"),
    ((4, 64), (40, 32), torch.float32, 4, "share dtype and width"),
    ((4, 64), (40, 64), torch.bfloat16, 4, "share dtype and width")])
def test_knn_outside_the_kernels_domain_raises(shape_q, shape_db, db_dtype, k, match):
    """The domain is the kernel's on every device: the CPU route raises
    where a launch would, naming the limit."""
    with pytest.raises(ValueError, match=match):
        streaming_knn(torch.zeros(shape_q), torch.zeros(shape_db, dtype=db_dtype), k)


def _tf32(x: np.ndarray) -> np.ndarray:
    """float32 -> TF32 as cvt.rna.tf32.f32 gives it (and the kernel's
    integer rounding of a database value): rounded to 10 mantissa bits,
    ties away from zero, the low 13 bits zero."""
    bits = np.ascontiguousarray(x, dtype=np.float32).view(np.uint32)
    return ((bits + np.uint32(0x1000)) & np.uint32(0xFFFFE000)).view(np.float32)


def _trunc_tf32(x: np.ndarray) -> np.ndarray:
    """What the TF32 mma reads of a float32 register: its top 19 bits."""
    bits = np.ascontiguousarray(x, dtype=np.float32).view(np.uint32)
    return (bits & np.uint32(0xFFFFE000)).view(np.float32)


def test_3xtf32_scores_within_1e6_of_exact():
    """The float32 path of csrc/knn.cu, emulated: each operand split into a
    TF32 hi = tf32(x) and lo = x - hi; a query's lo rounded to TF32, a
    database row's lo truncated by the mma; a score summed from lo·hi +
    hi·lo + hi·hi. On 10,000 pairs of unit rows at D = 64 every product is
    exact in float32, the score is within 2^-20 Σ|a_i b_i| of the exact dot
    product, and within 1e-6 of it (also with float32 sums in the kernel's
    order: k steps of 8, the small terms first)."""
    rng = np.random.default_rng(4)
    a, b = _unit_rows(rng, 10_000, 64), _unit_rows(rng, 10_000, 64)
    ah, bh = _tf32(a), _tf32(b)
    al, bl = _tf32(a - ah), _trunc_tf32(b - bh)
    for part in (ah, bh, al, bl):
        assert not (part.view(np.uint32) & np.uint32(0x1FFF)).any()
    terms = (al * bh, ah * bl, ah * bh)
    for x, y, p in zip((al, ah, ah), (bh, bl, bh), terms):
        np.testing.assert_array_equal(p.astype(np.float64), x.astype(np.float64) * y)
    exact = (a.astype(np.float64) * b).sum(axis=1)
    err = np.abs(sum(p.astype(np.float64) for p in terms).sum(axis=1) - exact)
    assert (err <= 2.0 ** -20 * np.abs(a.astype(np.float64) * b).sum(axis=1)).all()
    assert err.max() < 1e-6
    acc = np.zeros(a.shape[0], np.float32)
    for s in range(0, 64, 8):
        for p in terms:
            acc += p[:, s:s + 8].sum(axis=1, dtype=np.float32)
    assert np.abs(acc.astype(np.float64) - exact).max() < 1e-6


def test_exact_and_auto_knn_match_jax():
    """The dense search and both routes of auto_exact_knn against the JAX
    exact_knn; the crossover picks the streaming path for float32 rows at
    the H100's threshold (4096 queries, batch >= 64 at the flagship
    database; the JAX selector's v5e threshold was batch 128)."""
    rng = np.random.default_rng(5)
    q = rng.standard_normal((64, 16)).astype(np.float32)
    db = rng.standard_normal((1500, 16)).astype(np.float32)
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    db /= np.linalg.norm(db, axis=1, keepdims=True)
    want_i, want_d = map(np.asarray, jax_exact_knn(jnp.asarray(q), jnp.asarray(db), 4))
    tq, tdb = torch.from_numpy(q), torch.from_numpy(db)
    for got_i, got_d in (exact_knn(tq, tdb, 4), auto_exact_knn(tq, tdb, 4, min_rows=10_000),
                         auto_exact_knn(tq, tdb, 4, min_rows=1000)):
        np.testing.assert_array_equal(got_i.numpy(), want_i)
        np.testing.assert_allclose(got_d.numpy(), want_d, atol=1e-5)
    assert use_streaming_knn(27132, n_queries=64 * 64)
    assert not use_streaming_knn(27132, n_queries=32 * 64)
    assert use_streaming_knn(1_000_000) and not use_streaming_knn(27132)


def test_bf16_rows_cross_over_at_the_h100s_query_batch():
    """bf16 rows take the streaming kernel from 1024 queries against
    16,384 rows, float32 rows from 4096 (measured on the H100); the row
    threshold is the same for both."""
    bf16 = torch.bfloat16
    assert use_streaming_knn(27132, n_queries=16 * 64, dtype=bf16)
    assert use_streaming_knn(16384, n_queries=1024, dtype=bf16)
    assert not use_streaming_knn(16383, n_queries=8192, dtype=bf16)
    assert not use_streaming_knn(27132, n_queries=1023, dtype=bf16)
    assert not use_streaming_knn(27132, n_queries=4095, dtype=torch.float32)
    assert use_streaming_knn(16384, n_queries=4096, dtype=torch.float32)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_knn_rows_gives_the_tensor_maps_pitch(dtype):
    """knn_rows returns a database that already has a 16-byte row pitch as
    it is, and otherwise the same values in a zero-padded buffer of that
    pitch, so that the kernel reads them in place."""
    granule = 16 // torch.tensor([], dtype=dtype).element_size()
    rng = np.random.default_rng(15)
    aligned = torch.from_numpy(rng.standard_normal((50, 64)).astype(np.float32)).to(dtype)
    assert knn_rows(aligned) is aligned
    assert knn_rows(aligned[:, :3]).data_ptr() == aligned.data_ptr()  # the pitch is 64
    for db in (aligned[:, 7:], torch.from_numpy(
            rng.standard_normal((50, 77)).astype(np.float32)).to(dtype)):
        rows = knn_rows(db)
        assert torch.equal(rows, db) and rows.stride(1) == 1
        assert rows.stride(0) % granule == 0 and rows.stride(0) < db.shape[1] + granule
        padded = rows.as_strided((50, rows.stride(0)), (rows.stride(0), 1))
        assert not padded[:, db.shape[1]:].any()
        assert knn_rows(rows) is rows


def test_knn_index_agreement_holds_sets_and_order_off_near_ties():
    """chip_smoke's rule for the kernel's indices: a query whose k-th and
    (k+1)-th similarities are apart must have the same k rows, in order too
    where every gap of its top k+1 is; a swap of two near-equal rows inside
    the top k passes, a wrong row does not."""
    from chip_smoke import knn_index_agreement
    pv = torch.tensor([[0.9, 0.8, 0.7], [0.9, 0.9 - 1e-7, 0.5], [0.9, 0.8, 0.8 - 1e-7]])
    pi = torch.tensor([[1, 2, 3], [4, 5, 6], [7, 8, 9]], dtype=torch.int32)
    same = pi[:, :2].clone()
    assert knn_index_agreement(same, pv, pi, 2) == (True, 2, 1)
    swapped = torch.tensor([[1, 2], [5, 4], [9, 7]], dtype=torch.int32)
    assert knn_index_agreement(swapped, pv, pi, 2)[0]
    for wrong in ([[2, 1], [4, 5], [7, 8]], [[1, 2], [4, 6], [7, 8]]):
        assert not knn_index_agreement(torch.tensor(wrong, dtype=torch.int32), pv, pi, 2)[0]


def test_knn_query_crossover_leaves_other_dtypes_dense():
    """The kernel takes float32 and bf16 rows; other dtypes have no query
    crossover and stay on the dense search at any batch."""
    assert not use_streaming_knn(27132, n_queries=8192, dtype=torch.float64)


def _flax_mlp(m):
    """The port's MLP as a flax-layout param dict, the JAX kernel's input."""
    return {k: {"kernel": jnp.asarray(v["kernel"]), "bias": jnp.asarray(v["bias"])}
            for k, v in _to_flax(m).items()}


def _to_flax(m):
    return {n: {"kernel": getattr(m, n).weight.detach().numpy().T,
                "bias": getattr(m, n).bias.detach().numpy()} for n in pa._LAYERS}


def test_flax_bridge_roundtrips_attention_mlp():
    m = AttentionFeatureEncoder(32, 8)
    sd = flax_to_state_dict(_to_flax(m))
    for k, v in m.state_dict().items():
        assert torch.equal(sd[k], v)


@pytest.mark.parametrize("retrieval_mode", [True, False], ids=["hard", "softmax"])
def test_gathered_attention_plain_matches_pallas(retrieval_mode):
    """The plain version against pallas_gathered_patch_attention_v2 (f32,
    atol 1e-5), with Q not a multiple of the Pallas group."""
    xt, bank, idx, theta, phi = attention_inputs(np.random.default_rng(2), 6, 9, 8, 32, 3)
    want = pallas_gathered_patch_attention_v2(
        jnp.asarray(xt), jnp.asarray(bank), jnp.asarray(idx), _flax_mlp(theta),
        _flax_mlp(phi), 3, retrieval_mode=retrieval_mode, sharpness=1024.0, group=4,
        interpret=True)
    with torch.no_grad():
        got, sel = pa.gathered_patch_attention(
            torch.from_numpy(xt), torch.from_numpy(bank), torch.from_numpy(idx), theta, phi, 3,
            retrieval_mode=retrieval_mode, sharpness=1024.0, return_selection=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)
    assert not np.allclose(got.numpy(), xt)  # the switch is open somewhere
    assert sel.shape == (6, 8) and len(np.unique(sel.numpy())) > 1


def test_gathered_attention_plain_bf16_rounds_like_jax():
    """bf16 inputs: the plain version rounds at the JAX `_mlp` places, so
    it stays within bf16 output resolution of the Pallas kernel."""
    xt, bank, idx, theta, phi = attention_inputs(np.random.default_rng(3), 4, 6, 8, 32, 2)
    want = pallas_gathered_patch_attention_v2(
        jnp.asarray(xt, jnp.bfloat16), jnp.asarray(bank, jnp.bfloat16), jnp.asarray(idx),
        _flax_mlp(theta), _flax_mlp(phi), 2, group=4, interpret=True)
    with torch.no_grad():
        got = pa.gathered_patch_attention(
            torch.from_numpy(xt).bfloat16(), torch.from_numpy(bank).bfloat16(),
            torch.from_numpy(idx), theta, phi, 2)
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want.astype(jnp.float32)),
                               atol=2e-2)


def test_layout_helpers_match_jax():
    """pack_tile_rows, _tile_major_rows and _rows_to_volume: exactly equal."""
    from retrieval_fuse_tpu_torch.inference import RetrieveRefineEngine
    rng = np.random.default_rng(4)
    tiles = rng.standard_normal((5, 8, 8, 8, 4)).astype(np.float32)
    np.testing.assert_array_equal(pa.pack_tile_rows(torch.from_numpy(tiles), 2).numpy(),
                                  np.asarray(jax_pack_tile_rows(jnp.asarray(tiles), 2)))
    vol = rng.standard_normal((2, 32, 32, 32, 4)).astype(np.float32)
    geo = dict(attn_extent=2, n_fold=4, nf=4, attn_num_patch=16)
    jax_eng, port_eng = object.__new__(JaxEngine), object.__new__(RetrieveRefineEngine)
    for eng in (jax_eng, port_eng):
        eng.__dict__.update(geo)
    rows = port_eng._tile_major_rows(torch.from_numpy(vol))
    np.testing.assert_array_equal(rows.numpy(),
                                  np.asarray(jax_eng._tile_major_rows(jnp.asarray(vol))))
    back = port_eng._rows_to_volume(rows, 2)
    np.testing.assert_array_equal(
        back.numpy(), np.asarray(jax_eng._rows_to_volume(jnp.asarray(rows.numpy()), 2)))
    np.testing.assert_array_equal(back.numpy(), vol)


def _jax_selection(x, p, theta, phi):
    """argmax(25 s) of the JAX `_mlp` embeddings: the Pallas kernels' choice."""
    def l2n(v):
        return v / jnp.maximum(jnp.sqrt(jnp.sum(v * v, axis=-1, keepdims=True)), 1e-12)
    n, k, f = p.shape
    xf = l2n(jax_mlp(jnp.asarray(x), _flax_mlp(theta)))
    pf = l2n(jax_mlp(jnp.asarray(p.reshape(n * k, f)), _flax_mlp(phi))).reshape(n, k, -1)
    return np.asarray(jnp.argmax(jnp.sum(xf[:, None] * pf, axis=-1) * 25.0, axis=1))


@pytest.mark.parametrize("retrieval_mode", [True, False], ids=["hard", "softmax"])
def test_patch_attention_plain_matches_pallas(retrieval_mode):
    """The plain version against pallas_patch_attention (f32, atol 1e-5),
    N ragged against both the Pallas 512-row tile and the CUDA 64-row
    block; selections equal to the JAX math's."""
    xt, bank, idx, theta, phi = attention_inputs(np.random.default_rng(20), 9, 5, 64, 32, 3)
    n = 9 * 64 - 13
    x = xt.reshape(-1, 32)[:n]
    rows = np.random.default_rng(21).integers(0, 5 * 64, (n, 3))
    p = bank.reshape(-1, 32)[rows]
    want = pallas_patch_attention(jnp.asarray(x), jnp.asarray(p), _flax_mlp(theta),
                                  _flax_mlp(phi), 3, retrieval_mode=retrieval_mode,
                                  sharpness=1024.0, tile=512, interpret=True)
    with torch.no_grad():
        got, sel = pa.patch_attention(torch.from_numpy(x), torch.from_numpy(p), theta, phi, 3,
                                      retrieval_mode=retrieval_mode, sharpness=1024.0,
                                      return_selection=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)
    np.testing.assert_array_equal(sel.numpy(), _jax_selection(x, p, theta, phi))
    assert not np.allclose(got.numpy(), x) and len(np.unique(sel.numpy())) > 1


@pytest.mark.parametrize("retrieval_mode", [True, False], ids=["hard", "softmax"])
def test_gathered_attention_v1_plain_matches_pallas(retrieval_mode):
    """The plain version of the v1 kernel against pallas_gathered_patch_attention
    (f32, atol 1e-5); selections equal to the JAX math's."""
    xt, bank, idx, theta, phi = attention_inputs(np.random.default_rng(22), 5, 7, 8, 32, 3)
    want = pallas_gathered_patch_attention(
        jnp.asarray(xt), jnp.asarray(bank), jnp.asarray(idx), _flax_mlp(theta), _flax_mlp(phi),
        3, retrieval_mode=retrieval_mode, sharpness=1024.0, interpret=True)
    with torch.no_grad():
        got, sel = pa.gathered_patch_attention_v1(
            torch.from_numpy(xt), torch.from_numpy(bank), torch.from_numpy(idx), theta, phi, 3,
            retrieval_mode=retrieval_mode, sharpness=1024.0, return_selection=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)
    p = bank[idx].transpose(0, 2, 1, 3).reshape(5 * 8, 3, 32)
    np.testing.assert_array_equal(sel.numpy().reshape(-1),
                                  _jax_selection(xt.reshape(-1, 32), p, theta, phi))


def test_decoder_tail_plain_matches_pallas():
    """decoder_tail_plain against packed_decoder_tail (interpret) on the
    input and weights of test_pallas_decoder.py:28-49 (atol 2e-5); the JAX
    input carries the TPU's sublane pad of the minor axis, the port's does
    not. The port's layout helpers equal the JAX ones."""
    rng = np.random.default_rng(3)
    nf, s2 = 4, 16
    w2 = rng.standard_normal((3, 3, 3, nf, nf)).astype(np.float32)
    wh = rng.standard_normal((nf, 1)).astype(np.float32)
    x = rng.standard_normal((2, s2, s2, s2, nf)).astype(np.float32)
    h = s2 // 2
    xp = x.reshape(2, h, 2, h, 2, h, 2, nf).transpose(0, 1, 3, 5, 2, 4, 6, 7)
    xp = xp.reshape(2, h, h, h, 8 * nf)
    want = packed_decoder_tail(
        jnp.pad(jnp.asarray(xp), ((0, 0), (1, 1), (1, 1), (1, (-(h + 2)) % 8 + 1), (0, 0))),
        jnp.asarray(pack_conv2_imcol_kernel(w2)), jnp.asarray(pack_head_kernel(wh)), 0.37,
        t0=4, interpret=True)
    hn = torch.nn.functional.pad(torch.from_numpy(xp), (0, 0, 1, 1, 1, 1, 1, 1))
    got = dt.decoder_tail(hn, torch.from_numpy(w2), torch.from_numpy(wh[:, 0]), 0.37)
    assert got.shape == (2, h, h, h, 8) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-5)
    np.testing.assert_array_equal(dt.depth_to_space_1ch(got).numpy(),
                                  np.asarray(jax_depth_to_space_1ch(jnp.asarray(got.numpy()))))


def test_hard_selection_ties_after_scaling_by_25():
    """Scores one float32 ulp apart that round to the same 25·s tie, and the
    first candidate wins, as jnp.argmax(s * 25.0) picks it; argmax(s) would
    pick the second."""
    s = np.array([[0.6402101, 0.64021015]], np.float32)
    assert s[0, 1] > s[0, 0] and (s * np.float32(25.0))[0, 0] == (s * np.float32(25.0))[0, 1]
    assert pa.hard_selection(torch.from_numpy(s)).item() == 0
    assert int(jnp.argmax(jnp.asarray(s) * 25.0, axis=1)[0]) == 0


def test_attention_packing_helpers_match_jax():
    """_pack_feats_for_attention and _pack_volumes_for_attention equal the
    JAX engine's; the first refuses fold tiles x patches per tile that
    differ from attn_num_patch, as the JAX assert does."""
    from retrieval_fuse_tpu_torch.inference import RetrieveRefineEngine
    rng = np.random.default_rng(23)
    geo = dict(attn_extent=2, n_fold=4, nf=4, attn_num_patch=16, K=2)
    jax_eng, port_eng = object.__new__(JaxEngine), object.__new__(RetrieveRefineEngine)
    for eng in (jax_eng, port_eng):
        eng.__dict__.update(geo)
    feats = rng.standard_normal((1 * 64, 2, 8, 8, 8, 4)).astype(np.float32)
    np.testing.assert_array_equal(
        port_eng._pack_feats_for_attention(torch.from_numpy(feats), 1).numpy(),
        np.asarray(jax_eng._pack_feats_for_attention(jnp.asarray(feats), 1)))
    vols = rng.standard_normal((2, 32, 32, 32, 4)).astype(np.float32)
    np.testing.assert_array_equal(
        port_eng._pack_volumes_for_attention(torch.from_numpy(vols)).numpy(),
        np.asarray(jax_eng._pack_volumes_for_attention(jnp.asarray(vols))))
    port_eng.attn_num_patch = 8
    with pytest.raises(ValueError, match="attn_num_patch"):
        port_eng._pack_feats_for_attention(torch.from_numpy(feats), 1)
