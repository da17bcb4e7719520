"""The serving engine on the other tasks' configs, against the JAX engine.

The surface-reconstruction engine at a geometry cut from the 3DFront
config's (64³ occupancy inputs -> 16³ backbone -> 32³ TSDF; `pc_32+8`
retrieval windows, 2³ a chunk; 16³ target tiles, two a chunk axis;
attn_num_patch 8, so T = 64 rows a tile as at full width; nf 12, so F = 96;
five U-Net levels; soft selection) and the 16³ super-resolution engine of
the Matterport3D config (16³ -> 64³, `4+2` inputs, soft selection) at
narrow widths. Both packages get the same param trees (numpy values, the
port's through the weight bridge), database, patch bank and inputs; the
port's kernel paths run their plain versions (held against the Pallas
kernels at these widths in test_torch_port_tasks.py).

The reference is the JAX `base` engine in float64 (jax.enable_x64): at these
depths the JAX engine's own float32 output lies 1.4e-4 (surface, of a 0.1625
truncation) and 5.2e-4 (16³, of 11.25) from it, beyond the 1e-4 df units
tests/test_torch_port_engine.py holds the 8³ engine to, while the port's
float32 engines lie within 1.0e-6 and 1.2e-4 of it (6e-6 and 1.1e-5 of the
truncations). So the port's float32 engines
are held to it: query embeddings atol 1e-5, retrieved indices equal, the
feature bank atol 1e-4, the TSDF within TSDF_TOL of the target truncation.
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
from retrieval_fuse_tpu_torch.inference import (
    FAST_VARIANT, RetrieveRefineEngine, variant_engine_kwargs)
from retrieval_fuse_tpu_torch.utils.flax_import import flax_engine_params
from test_torch_port_models import flax_params
from test_torch_port_models import torch_threads  # noqa: F401 (autouse fixture)

ATTENTION = {"attn_normalize": True, "attn_use_switching": True, "attn_retrieval_mode": False,
             "attn_no_output_mapping": True, "attn_blend": True, "attn_patch_extent": 4}

SURFACE = dict(
    ATTENTION, task="surface_reconstruction", K=4, nf=12, unet_num_level=5, layer_order="gcr",
    retrieval_fmaps=12, retrieval_num_level=4, attn_num_patch=8,
    retrieval_patch_size_input=32, retrieval_patch_context_input=8,
    retrieval_patch_size_target=16,
    retrieval_model={"network_input": "pc_32+8", "network_target": "16+4", "nf_input": 4,
                     "nf_target": 4, "latent_dim": 16},
    dataset_train={"input_chunk_size": 64, "target_chunk_size": 32, "input_mean": 0,
                   "input_std": 1, "target_mean": 0.15015658121788053,
                   "target_std": 0.03573221820637578, "voxel_size_input": 0,
                   "voxel_size_target": 0.054167})

SUPERRES16 = dict(
    ATTENTION, task="superresolution", K=2, nf=4, unet_num_level=4, layer_order="gcr",
    retrieval_fmaps=4, retrieval_num_level=4, attn_num_patch=16,
    retrieval_patch_size_input=4, retrieval_patch_context_input=2,
    retrieval_patch_size_target=16,
    retrieval_model={"network_input": "4+2", "network_target": "16+8", "nf_input": 4,
                     "nf_target": 4, "latent_dim": 16},
    dataset_train={"input_chunk_size": 16, "target_chunk_size": 64,
                   "input_mean": 35.62394659115317, "input_std": 14.58642912987053,
                   "target_mean": 10.502049923464249, "target_std": 2.3319665041587627,
                   "voxel_size_input": 15.0, "voxel_size_target": 3.75})

CONFIGS = {"surface": SURFACE, "superres16": SUPERRES16}
#: max |TSDF - JAX float64| as a share of the target truncation (the TSDF's
#: range); the 8³ engine's 1e-4 df units are 1.6e-3 of its truncation
TSDF_TOL = 1e-4


def make_setup(cfg: dict) -> tuple:
    """Flax param trees of numpy values for the engine's five modules, a
    database of random unit rows, a bank of 16³ tiles in the target's units
    and two input chunks (occupancy grids, or distance fields)."""
    nf, k = cfg["nf"], cfg["K"]
    dtr = cfg["dataset_train"]
    ics, tcs = dtr["input_chunk_size"], dtr["target_chunk_size"]
    side = cfg["retrieval_patch_size_input"] + 2 * cfg["retrieval_patch_context_input"]
    coarse = tcs // 2
    z = np.zeros
    params = {
        "fenc_input": flax_params(get_retrieval_networks(cfg["retrieval_model"])[0],
                                  z((1, side, side, side, 1), np.float32), seed=1),
        "unet_backbone": flax_params(get_unet_backbone(cfg), z((1, ics, ics, ics, 1), np.float32),
                                     seed=2),
        "decoder": flax_params(get_decoder(cfg), z((1, coarse, coarse, coarse, nf), np.float32),
                               seed=3),
        "retrieval_backbone": flax_params(get_retrieval_backbone(cfg),
                                          z((1, 16, 16, 16, 1), np.float32), seed=4),
        "patched_attention_block": flax_params(
            get_attention_block(cfg, deterministic_selection=True),
            z((1, coarse, coarse, coarse, nf), np.float32),
            z((k, coarse, coarse, coarse, nf), np.float32), seed=5),
    }
    rng = np.random.default_rng(0)
    n = 300
    db = rng.standard_normal((n, cfg["retrieval_model"]["latent_dim"])).astype(np.float32)
    db /= np.linalg.norm(db, axis=1, keepdims=True)
    trunc = float(np.float16(dtr["voxel_size_target"] * 3))
    bank = (rng.random((n, 16, 16, 16)) * trunc).astype(np.float32)
    if cfg["task"] == "surface_reconstruction":
        x = (rng.random((2, ics, ics, ics, 1)) < 0.01).astype(np.float32)
    else:
        x = (rng.random((2, ics, ics, ics, 1)) * dtr["voxel_size_input"] * 3).astype(np.float32)
    return params, db, bank, x


@pytest.fixture(scope="module", params=list(CONFIGS))
def task(request):
    """(config, setup, JAX reference) of one task: the JAX `base` engine in
    float64, its query embeddings and their exact kNN, its feature bank (the
    JAX retrieval backbone on the normalised tiles, passed in) and its TSDF.
    The JAX tests pin the JAX variants equal to each other
    (test_inference.py), so one JAX engine is the reference of every port
    variant."""
    cfg = CONFIGS[request.param]
    params, db, bank, x = setup = make_setup(cfg)
    dtr = cfg["dataset_train"]
    tiles = (bank - dtr["target_mean"]) / dtr["target_std"]
    with jax.enable_x64():
        p64 = jax.tree_util.tree_map(lambda a: jnp.asarray(a, jnp.float64), params)
        fb = jax.jit(get_retrieval_backbone(cfg).apply)(
            {"params": p64["retrieval_backbone"]}, jnp.asarray(tiles[..., None], jnp.float64))
        eng = JaxEngine(cfg, p64, jnp.asarray(db, jnp.float64), None,
                        compute_dtype=jnp.float64, feature_bank=fb,
                        **jax_variant_kwargs("base"))
        x64 = jnp.asarray(x, jnp.float64)
        want = np.asarray(eng(x64))
        q = eng.fenc_input.apply({"params": eng.params["fenc_input"]},
                                 eng._unfold_input_patches(x64))
        q = q.reshape(q.shape[0], -1)
        q = q / jnp.maximum(jnp.linalg.norm(q, axis=1, keepdims=True), 1e-12)
        top_idx = np.asarray(jax_exact_knn(q, jnp.asarray(db, jnp.float64), cfg["K"])[0])
    return cfg, setup, (np.asarray(fb, np.float32), want, np.asarray(q, np.float32), top_idx)


@pytest.mark.parametrize("variant", ["base", FAST_VARIANT, "fused+pallasp+topk1p+cdec",
                                     "fused+pallasg+topk1p+packed"])
def test_task_engine_matches_jax(task, variant):
    """The port's float32 engine (the plain versions of the kernel paths on
    the CPU) against the JAX engine in float64: the same bank rows for every
    query, the TSDF within TSDF_TOL of the truncation; `base` also builds the
    feature bank itself."""
    cfg, (params, db, bank, x), (want_bank, want, want_q, want_idx) = task
    kw = dict(compute_dtype=torch.float32, device="cpu", **variant_engine_kwargs(variant))
    if variant == "base":
        port = RetrieveRefineEngine(cfg, flax_engine_params(params), db, bank, **kw)
        np.testing.assert_allclose(port.feature_bank.numpy(), want_bank, atol=1e-4)
    else:
        port = RetrieveRefineEngine(cfg, flax_engine_params(params), db,
                                    feature_bank=want_bank, **kw)
    z = port.embed_queries(torch.from_numpy(x))
    chunks = x.shape[0] * (cfg["dataset_train"]["input_chunk_size"]
                           // cfg["retrieval_patch_size_input"]) ** 3
    assert z.shape == (chunks, cfg["retrieval_model"]["latent_dim"])
    np.testing.assert_allclose(z.numpy(), want_q, atol=1e-5)
    np.testing.assert_array_equal(port.retrieve(torch.from_numpy(x)).numpy(), want_idx)
    got = port(x).numpy()
    tcs = cfg["dataset_train"]["target_chunk_size"]
    assert got.shape == want.shape == (2, tcs, tcs, tcs, 1)
    trunc = float(np.float16(cfg["dataset_train"]["voxel_size_target"] * 3))
    assert float(np.abs(got - want).max()) <= TSDF_TOL * trunc


def test_surface_queries_are_encoded_a_few_items_at_a_time(task, monkeypatch):
    """embed_queries splits a batch by QUERY_VOXELS; the split changes no
    embedding."""
    from retrieval_fuse_tpu_torch import inference
    cfg, (params, db, bank, x), (want_bank, _, want_q, _) = task
    port = RetrieveRefineEngine(cfg, flax_engine_params(params), db, feature_bank=want_bank,
                                compute_dtype=torch.float32, device="cpu")
    monkeypatch.setattr(inference, "QUERY_VOXELS", 1)
    np.testing.assert_allclose(port.embed_queries(torch.from_numpy(x)).numpy(), want_q,
                               atol=1e-5)
