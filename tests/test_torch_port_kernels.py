"""The plain PyTorch versions of the port's three kernels against the JAX
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
    pack_tile_rows as jax_pack_tile_rows, pallas_gathered_patch_attention_v2)
from retrieval_fuse_tpu.ops.pallas_knn import pallas_exact_knn
from retrieval_fuse_tpu.ops.pallas_topk import pallas_topk
from retrieval_fuse_tpu_torch.models.attention import AttentionFeatureEncoder
from retrieval_fuse_tpu_torch.ops import patch_attention as pa
from retrieval_fuse_tpu_torch.ops.knn import auto_exact_knn, exact_knn, use_streaming_knn
from retrieval_fuse_tpu_torch.ops.streaming_knn import streaming_knn
from retrieval_fuse_tpu_torch.ops.topk import topk
from retrieval_fuse_tpu_torch.utils.flax_import import flax_to_state_dict
from test_torch_port_cuda import attention_inputs, tied_scores


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


def test_exact_and_auto_knn_match_jax():
    """The dense search and both routes of auto_exact_knn against the JAX
    exact_knn; the crossover picks the streaming path exactly where the
    JAX selector does (batch >= 128 at the flagship database)."""
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
    assert use_streaming_knn(27132, n_queries=128 * 64)
    assert not use_streaming_knn(27132, n_queries=64 * 64)
    assert use_streaming_knn(1_000_000) and not use_streaming_knn(27132)


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
