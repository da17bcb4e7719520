"""The port's serving engine, end to end, against the JAX engine.

Same param tree (numpy values, through the weight bridge), database, patch
bank and inputs for both, at the tiny geometry of tests/test_inference.py.
The JAX side runs its Pallas kernels with interpret=True, as its own tests
do. float32: retrieved indices equal, TSDF atol 1e-4; bf16: MAE < 1e-3
against float32 (the budget of test_bf16_engine_accuracy_within_budget).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from retrieval_fuse_tpu.inference import (
    RetrieveRefineEngine as JaxEngine, variant_engine_kwargs as jax_variant_kwargs)
from retrieval_fuse_tpu.models import (
    get_retrieval_networks, get_unet_backbone, get_decoder, get_retrieval_backbone,
    get_attention_block)
from retrieval_fuse_tpu.ops.knn import exact_knn as jax_exact_knn
from retrieval_fuse_tpu.ops.pallas_knn import pallas_exact_knn
from retrieval_fuse_tpu_torch.inference import (
    FAST_VARIANT, RetrieveRefineEngine, variant_engine_kwargs)
from retrieval_fuse_tpu_torch.serve import serve_directory
from retrieval_fuse_tpu_torch.utils.flax_import import flax_engine_params
from test_torch_port_models import CFG, flax_params
from test_torch_port_models import torch_threads  # noqa: F401 (autouse fixture)


def make_setup():
    nf, k = CFG["nf"], CFG["K"]
    z = np.zeros
    params = {
        "fenc_input": flax_params(get_retrieval_networks(CFG["retrieval_model"])[0],
                                  z((1, 4, 4, 4, 1), np.float32), seed=1),
        "unet_backbone": flax_params(get_unet_backbone(CFG), z((1, 8, 8, 8, 1), np.float32),
                                     seed=2),
        "decoder": flax_params(get_decoder(CFG), z((1, 32, 32, 32, nf), np.float32), seed=3),
        "retrieval_backbone": flax_params(get_retrieval_backbone(CFG),
                                          z((1, 16, 16, 16, 1), np.float32), seed=4),
        "patched_attention_block": flax_params(
            get_attention_block(CFG, deterministic_selection=True),
            z((1, 32, 32, 32, nf), np.float32), z((k, 32, 32, 32, nf), np.float32), seed=5),
    }
    rng = np.random.default_rng(0)
    n = 300
    db = rng.standard_normal((n, 16)).astype(np.float32)
    db /= np.linalg.norm(db, axis=1, keepdims=True)
    bank = rng.random((n, 16, 16, 16)).astype(np.float32) * 0.0625
    x = rng.random((2, 8, 8, 8, 1)).astype(np.float32) * 0.5
    return params, db, bank, x


@pytest.fixture(scope="module")
def setup():
    return make_setup()


@pytest.fixture(scope="module")
def jax_ref(setup):
    """The JAX FAST_VARIANT engine's retrieved indices, feature bank and
    TSDF. One JAX engine serves as the reference of every port variant:
    the JAX tests pin its variants equal to each other (test_inference.py).
    Its feature bank is the JAX retrieval backbone on the normalised tiles,
    passed in, which skips the engine's 4096-row padded precompute."""
    params, db, bank, x = setup
    dtr = CFG["dataset_train"]
    tiles = (bank - dtr["target_mean"]) / dtr["target_std"]
    fb = jax.jit(get_retrieval_backbone(CFG).apply)(
        {"params": params["retrieval_backbone"]}, jnp.asarray(tiles[..., None]))
    eng = JaxEngine(CFG, params, db, None, compute_dtype=jnp.float32, feature_bank=fb,
                    **jax_variant_kwargs(FAST_VARIANT))
    # the engine's retrieval step (its pipeline lines 343-346) + exact kNN
    q = eng.fenc_input.apply({"params": eng.params["fenc_input"]},
                             eng._unfold_input_patches(jnp.asarray(x)))
    q = q.reshape(q.shape[0], -1)
    q = q / jnp.maximum(jnp.linalg.norm(q, axis=1, keepdims=True), 1e-12)
    top_idx = np.asarray(jax_exact_knn(q, jnp.asarray(db), CFG["K"])[0])
    return top_idx, np.asarray(fb), np.asarray(eng(x))


def _port_engine(setup, variant, dtype=torch.float32):
    params, db, bank, _ = setup
    return RetrieveRefineEngine(CFG, flax_engine_params(params), db, bank, compute_dtype=dtype,
                                device="cpu", **variant_engine_kwargs(variant))


@pytest.mark.parametrize("variant", [FAST_VARIANT, FAST_VARIANT + "+streamknn",
                                     FAST_VARIANT + "+denseknn", "base"])
def test_engine_matches_jax(setup, jax_ref, variant):
    _, _, _, x = setup
    want_idx, want_bank, want = jax_ref
    port = _port_engine(setup, variant)
    if variant == "base":  # the feature bank before the attention-row repack
        np.testing.assert_allclose(port.feature_bank.numpy(), want_bank, atol=1e-4)
    top_idx = port.retrieve(torch.from_numpy(x))
    assert top_idx.dtype == torch.int32
    np.testing.assert_array_equal(top_idx.numpy(), want_idx)
    got = port(x).numpy()
    assert got.shape == want.shape == (2, 64, 64, 64, 1)
    np.testing.assert_allclose(got, want, atol=1e-4)


def test_bf16_streaming_retrieve_matches_jax(setup, jax_ref):
    """bf16 rows reach the streaming route: the port's bf16
    FAST_VARIANT+streamknn engine retrieves the rows of the JAX engine of
    the same variant and dtype, whose retrieval step (its pipeline lines
    343-346 in bf16) ends in pallas_exact_knn, here in interpret mode.

    The two frameworks' bf16 encoders round some embedding elements one
    ulp apart, which moves a query's scores by up to m = max over the rows
    of |(z_jax - z_port)·x|. So: on the port's own embeddings the indices
    equal pallas_exact_knn's everywhere; against the JAX engine they are
    equal on every query whose top K+1 scores are more than 2m apart."""
    params, db, _, x = setup
    k, variant = CFG["K"], FAST_VARIANT + "+streamknn"
    eng = JaxEngine(CFG, params, db, None, compute_dtype=jnp.bfloat16,
                    feature_bank=jnp.asarray(jax_ref[1]), **jax_variant_kwargs(variant))
    z = eng.fenc_input.apply({"params": eng.params["fenc_input"]},
                             eng._unfold_input_patches(jnp.asarray(x)).astype(jnp.bfloat16))
    z = z.reshape(z.shape[0], -1)
    z = z / jnp.maximum(jnp.linalg.norm(z.astype(jnp.float32), axis=1, keepdims=True),
                        1e-12).astype(jnp.bfloat16)
    db32 = eng.database.astype(jnp.float32)
    want = np.asarray(pallas_exact_knn(z.astype(jnp.float32), db32, k, tile_n=128, tile_q=64,
                                       interpret=True)[0])
    port = _port_engine(setup, variant, torch.bfloat16)
    assert port._use_streaming(z.shape[0]) and port.database.dtype == torch.bfloat16
    got = port.retrieve(torch.from_numpy(x))
    assert got.dtype == torch.int32

    z_port = port.embed_queries(torch.from_numpy(x))
    own = np.asarray(pallas_exact_knn(jnp.asarray(z_port.float().numpy()), db32, k, tile_n=128,
                                      tile_q=64, interpret=True)[0])
    np.testing.assert_array_equal(got.numpy(), own)

    z_jax = np.asarray(z.astype(jnp.float32))
    margin = np.abs((z_jax - z_port.float().numpy()) @ np.asarray(db32).T).max(axis=1) + 1e-6
    top = -np.sort(-(z_jax @ np.asarray(db32).T), axis=1)[:, :k + 1]
    clear = (np.diff(-top, axis=1) > 2 * margin[:, None]).all(axis=1)
    assert clear.mean() > 0.75  # 106 of 128 queries at this seed
    np.testing.assert_array_equal(got.numpy()[clear], want[clear])


def test_attention_switch_opens_on_engine_features(setup):
    """The fixture's weights give the attention something to do: the fused
    rows differ from the backbone rows, so the selection is exercised."""
    _, _, _, x = setup
    eng = _port_engine(setup, FAST_VARIANT)
    xx = torch.from_numpy(x)
    x_back = eng.unet_backbone((xx - eng.in_mean) / eng.in_std)
    fused = eng.refine(xx, eng.retrieve(xx))
    plain = eng.decoder(x_back)
    assert float((fused - (plain.float() + 1.0) * eng.target_trunc / 2.0).abs().max()) > 1e-4


def test_bf16_engine_within_budget(setup):
    """The port's bf16 FAST_VARIANT engine vs its float32 base engine."""
    _, _, _, x = setup
    o32 = _port_engine(setup, "base")(x)
    o16 = _port_engine(setup, FAST_VARIANT, torch.bfloat16)(x)
    mae = float((o16 - o32).abs().mean())
    assert mae < 1e-3, f"bf16 MAE {mae} blows the 1e-3 TSDF budget"


def _jax_paths(jax_kwargs: dict) -> dict:
    """The JAX engine's keyword options -> the port's names for the same
    decoder, backbone, attention and top-k paths."""
    attention = {False: "modules", True: "patches", "packedrows": "packedrows",
                 "gathered": "gathered", "gathered2": "gathered2", "phibank": "phibank"}
    packed = jax_kwargs["use_packed_decoder"]
    decoder = ({"compact": "compact", "decomposed": "decomposed"}.get(packed, "packed")
               if packed else "fused" if jax_kwargs["use_fused_decoder"] else "modules")
    topk_impl = {"iterative": "iterative", "approx": "approx", "top_k": "top_k",
                 "pallas1p": "single_pass"}
    return dict(attention=attention[jax_kwargs["use_pallas_attention"]],
                flat_gather=jax_kwargs["packedrows_flat_gather"], decoder=decoder,
                fused_backbone=jax_kwargs["use_fused_backbone"],
                streaming_knn=jax_kwargs["streaming_knn"],
                topk_impl=topk_impl[jax_kwargs["topk_impl"]])


@pytest.mark.parametrize("token", ["pallas", "pallasp", "pallasg", "cdec", "dconv", "fbb",
                                   "flatg", "phib", "packed", "approxk"])
def test_unported_variant_tokens_raise(token):
    """The name is that of the check these tokens had while they raised
    NotImplementedError. Each, beside `fused`, now selects the same
    decoder, backbone, attention and top-k paths as the JAX engine."""
    variant = f"fused+{token}"
    assert variant_engine_kwargs(variant) == _jax_paths(jax_variant_kwargs(variant))


@pytest.mark.parametrize("variant", [
    "pallasp+topk1p+dconv+fbb+fused",           # test_inference.py:336-353
    FAST_VARIANT, "cdec", "dconv", "packed", "base+streamknn+denseknn",
    "phib+pallasg2+pallasg+pallasp+pallas+cdec+dconv+packed+approxk+topk1p"])
def test_variant_tokens_select_jax_paths(variant):
    """The JAX tests' combined strings select the same paths as the JAX
    engine, with its substring precedence."""
    assert variant_engine_kwargs(variant) == _jax_paths(jax_variant_kwargs(variant))


def test_variant_tokens():
    assert variant_engine_kwargs(FAST_VARIANT) == dict(
        attention="gathered2", flat_gather=False, decoder="fused", fused_backbone=False,
        streaming_knn=None, topk_impl="single_pass")
    assert variant_engine_kwargs("base+streamknn")["streaming_knn"] is True
    assert variant_engine_kwargs("denseknn")["streaming_knn"] is False
    assert variant_engine_kwargs("packed")["decoder"] == "packed"  # implies fused
    with pytest.raises(ValueError, match="unknown"):
        variant_engine_kwargs("fused+nosuchtoken")


def test_fused_variant_runs_the_fused_decoder(setup):
    from retrieval_fuse_tpu_torch.ops.fused_decoder import FusedFinalDecoder
    assert isinstance(_port_engine(setup, FAST_VARIANT).fused_decoder, FusedFinalDecoder)
    assert _port_engine(setup, "base").fused_decoder is None


def test_trunc_takes_the_float16_round_trip(setup):
    """The reference stores trunc (3 voxels) in float16; both engines keep
    that rounding, which differs from 3·voxel_size in float32."""
    eng = _port_engine(setup, "base")
    dtr = CFG["dataset_train"]
    for got, voxel in ((eng.input_trunc, dtr["voxel_size_input"]),
                       (eng.target_trunc, dtr["voxel_size_target"])):
        assert got == float(np.float16(voxel * 3))
        assert got != float(np.float32(voxel * 3))


def test_serve_directory_pads_tail_batch(setup, tmp_path):
    _, _, _, x = setup
    rng = np.random.default_rng(9)
    vols = rng.random((3, 8, 8, 8)).astype(np.float32) * 0.5
    vols[:2] = x[..., 0]
    for i, v in enumerate(vols):
        np.savez_compressed(tmp_path / f"scene{i}.npz", arr=v)
    eng = _port_engine(setup, FAST_VARIANT)
    done = serve_directory(eng, tmp_path, tmp_path / "out", batch_size=2)
    assert done == ["scene0", "scene1", "scene2"]
    direct = eng(vols[..., None]).numpy()[..., 0]
    for i in range(3):
        pred = np.load(tmp_path / "out" / f"scene{i}_pred.npz")["arr"]
        assert pred.dtype == np.float16 and pred.shape == (64, 64, 64)
        np.testing.assert_allclose(pred.astype(np.float32), direct[i], atol=1e-4)
