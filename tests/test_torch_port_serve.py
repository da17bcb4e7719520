"""Serving from training artifacts: the port's serve.py against the JAX
package's, on the CPU, at the tiny geometry (nf 4, latent 16, K = 2) of
the session fixture `synth_superres_root`.

The artifacts are made once by the JAX package: flax-initialised retrieval
and refinement networks saved with the JAX `save_checkpoint`, the
dictionary built by the JAX retrieval CLI's `map`. The checkpoints are
converted with tools/torch_port_ckpt_from_jax.py under the same experiment
and epoch names, so both packages read the same dictionary. Held: the
patch size and the patch bank bit-equal; the alignment guard passes on the
dictionary and raises on one whose embeddings were shuffled across rows;
the port's engine from artifacts (float32, the plain and the shipped
variant) and the port's CLI give the TSDFs the JAX CLI writes (float32,
1e-4 against its float16 files); the CLI's --obj meshes are the JAX
package's marching cubes of the predictions it served.
"""

import contextlib
import io
import json
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

from retrieval_fuse_tpu import native as jnative
from retrieval_fuse_tpu import serve as jserve
from retrieval_fuse_tpu.data import PatchedSceneDataset as JaxDataset, SceneHandler as JaxHandler
from retrieval_fuse_tpu.data.synthetic import make_synthetic_config
from retrieval_fuse_tpu.models import get_retrieval_networks
from retrieval_fuse_tpu.retrieval import cli as jcli
from retrieval_fuse_tpu.train.checkpoint import save_checkpoint as jax_save_checkpoint
from retrieval_fuse_tpu.utils.misc import get_tree_path
from retrieval_fuse_tpu_torch import serve
from retrieval_fuse_tpu_torch.data import PatchedSceneDataset, SceneHandler
from retrieval_fuse_tpu_torch.inference import FAST_VARIANT
from retrieval_fuse_tpu_torch.train.checkpoint import load_checkpoint
from test_torch_port_engine import make_setup
from test_torch_port_models import flax_params
from test_torch_port_retrieval import copy_dataset, load_converter, working_dir
from test_torch_port_models import torch_threads  # noqa: F401 (autouse fixture)

K = 2


def serving_config(data) -> dict:
    cfg = make_synthetic_config(data)
    cfg["retrieval_model"].update(nf_input=4, nf_target=4, latent_dim=16)
    cfg.update(nf=4, K=K, unet_num_level=4, retrieval_fmaps=4, retrieval_num_level=4)
    cfg["query"]["K"] = K
    cfg["dictionary"]["batch_size"] = 64
    return cfg


@pytest.fixture(scope="module")
def artifacts(synth_superres_root, tmp_path_factory):
    work = tmp_path_factory.mktemp("serve_artifacts")
    cfg = serving_config(copy_dataset(synth_superres_root, work / "data"))
    engine_params = make_setup()[0]
    # zero biases: with flax_params' bias draws every embedding lies within
    # 0.996 cosine of every other, and a shuffle of them passes the guard
    rparams = {key: jax.tree_util.tree_map_with_path(
        lambda path, leaf: 0 * leaf if path[-1].key == "bias" else leaf,
        flax_params(net, jnp.zeros((1, side, side, side, 1)), seed=len(key)))
        for key, net, side in zip(("fenc_input", "fenc_target"),
                                  get_retrieval_networks(cfg["retrieval_model"]), (4, 32))}
    out = {"work": work, "cfg": cfg}
    conv = load_converter()
    with working_dir(work):
        jr = jax_save_checkpoint(Path("runs/rt"), 0, rparams)
        jf = jax_save_checkpoint(Path("runs/ref"), 0, {
            k: v for k, v in engine_params.items() if k != "fenc_input"})
        out["jax_ckpts"] = (jr, jf)
        out["ckpts"] = (conv.convert(jr, work / "port_runs" / "rt"),
                        conv.convert(jf, work / "port_runs" / "ref"))
        (work / "cfg.yaml").write_text(yaml.safe_dump(cfg))
        with contextlib.redirect_stdout(io.StringIO()):
            jcli.main(["--config", str(work / "cfg.yaml"), "--retrieval_ckpt", str(jr),
                       "--mode", "map", "--K", str(K)])
        out["tree"] = work / get_tree_path(dict(cfg, retrieval_ckpt=str(jr)))
        inputs = sorted((work / "data" / "sdf_008" / "SynthSet").glob("*.npz"))
        out["x"] = np.stack([np.load(f)["arr"] for f in inputs])[..., None].astype(np.float32)
        jserve.main(["--config", str(work / "cfg.yaml"), "--retrieval_ckpt", str(jr),
                     "--refinement_ckpt", str(jf), "--input", str(inputs[0].parent),
                     "--output", str(work / "served_jax"), "--batch_size", "4", "--f32",
                     "--K", str(K)])
        out["want"] = np.stack([np.load(work / "served_jax" / f"{f.stem}_pred.npz")["arr"]
                                for f in inputs])[..., None].astype(np.float32)
    return out


def datasets(cfg):
    return (PatchedSceneDataset("train", cfg["dataset_train"], SceneHandler("train", cfg)),
            JaxDataset("train", cfg["dataset_train"], JaxHandler("train", cfg)))


def test_patch_size_and_bank_match_jax(artifacts):
    db = np.load(artifacts["tree"] / "database.npy")
    scenes = json.loads((artifacts["tree"] / "index.json").read_text())
    assert serve.dictionary_patch_size(db) == jserve.dictionary_patch_size(db) == 16
    with working_dir(artifacts["work"]):
        ds, jds = datasets(artifacts["cfg"])
        got = serve.build_patch_bank_from_database(db, scenes, ds)
        want = jserve.build_patch_bank_from_database(db, scenes, jds)
        with pytest.raises(ValueError, match="RETRIEVAL patch geometry"):
            serve.build_patch_bank_from_database(db, scenes, ds, patch_size=64)
    assert got.dtype == want.dtype and got.shape == want.shape == (db.shape[0], 16, 16, 16)
    np.testing.assert_array_equal(got, want)
    with pytest.raises(ValueError, match="empty"):
        serve.dictionary_patch_size(db[:0])


def test_alignment_guard_passes_and_catches_shuffled_rows(artifacts):
    """The real dictionary passes with the JAX guard's least cosine; the
    same dictionary with its embeddings shuffled across rows (extents
    kept) is refused."""
    cfg, db = artifacts["cfg"], np.load(artifacts["tree"] / "database.npy")
    scenes = json.loads((artifacts["tree"] / "index.json").read_text())
    tgt = load_checkpoint(artifacts["ckpts"][0])["params"]["fenc_target"]
    jtgt = jserve.load_checkpoint(artifacts["jax_ckpts"][0])["params"]["fenc_target"]
    with working_dir(artifacts["work"]):
        ds, jds = datasets(cfg)
        worst = serve.verify_bank_database_alignment(cfg, tgt, db, scenes, ds, device="cpu")
        jworst = jserve.verify_bank_database_alignment(cfg, jtgt, db, scenes, jds)
        assert worst >= 0.999 and abs(worst - jworst) < 1e-5
        real = np.flatnonzero(db[:, 0] >= 0)
        shuffled = db.copy()
        shuffled[real, 7:] = db[real[np.random.default_rng(0).permutation(real.size)], 7:]
        with pytest.raises(ValueError, match="alignment check FAILED"):
            serve.verify_bank_database_alignment(cfg, tgt, shuffled, scenes, ds, device="cpu")


@pytest.mark.parametrize("variant", ["base", FAST_VARIANT])
def test_engine_from_artifacts_matches_jax(artifacts, variant):
    rc, fc = artifacts["ckpts"]
    with working_dir(artifacts["work"]):
        eng = serve.build_engine_from_artifacts(artifacts["cfg"], rc, fc,
                                                compute_dtype=torch.float32, device="cpu",
                                                variant=variant)
        got = eng(artifacts["x"]).numpy()
    assert got.shape == artifacts["want"].shape == (8, 64, 64, 64, 1)
    np.testing.assert_allclose(got, artifacts["want"], atol=1e-4)


def test_engine_flags_select_the_variant(artifacts):
    """The two boolean options are the `fused` and `pallas` tokens."""
    rc, fc = artifacts["ckpts"]
    with working_dir(artifacts["work"]):
        eng = serve.build_engine_from_artifacts(
            artifacts["cfg"], rc, fc, compute_dtype=torch.float32, device="cpu",
            use_fused_decoder=True, use_pallas_attention=True, verify_alignment=False)
    assert eng.attention_path == "patches" and eng.fused_decoder is not None


def test_serve_main_matches_jax_cli(artifacts, monkeypatch):
    """serve.main's TSDFs are the JAX CLI's; with --obj it also writes each
    chunk's mesh: the JAX package's marching cubes + OBJ of the float32
    prediction it served, at the val SceneHandler's level."""
    work = artifacts["work"]
    rc, fc = artifacts["ckpts"]
    argv = ["--config", str(work / "cfg.yaml"), "--retrieval_ckpt", str(rc),
            "--refinement_ckpt", str(fc), "--input", str(work / "data" / "sdf_008" / "SynthSet"),
            "--output", str(work / "served_port"), "--batch_size", "4", "--f32", "--fast",
            "--K", str(K), "--device", "cpu"]
    meshed, visualize = {}, SceneHandler.visualize_target_chunk

    def recording(self, chunk_df, output_path, device=None):
        meshed[Path(output_path).name] = (chunk_df.copy(), float(self.target_voxel_size * 0.75))
        return visualize(self, chunk_df, output_path, device=device)

    monkeypatch.setattr(SceneHandler, "visualize_target_chunk", recording)
    with working_dir(work):
        done = serve.main(argv)
        assert not meshed and not list((work / "served_port").glob("*.obj"))
        with_obj = serve.main([*argv[:9], str(work / "served_obj"), *argv[10:], "--obj"])
    assert with_obj == done and sorted(meshed) == [f"{n}_pred.obj" for n in done]
    for name in done:
        vol, level = meshed[f"{name}_pred.obj"]
        assert vol.dtype == np.float32 and vol.shape == (64, 64, 64)
        np.testing.assert_array_equal(
            vol.astype(np.float16), np.load(work / "served_obj" / f"{name}_pred.npz")["arr"])
        jnative.export_obj(*jnative.marching_cubes(vol, level), work / "want.obj")
        assert (work / "served_obj" / f"{name}_pred.obj").read_text() == \
            (work / "want.obj").read_text()
    assert len(done) == 8
    for name in done:
        got = np.load(work / "served_port" / f"{name}_pred.npz")["arr"]
        want = np.load(work / "served_jax" / f"{name}_pred.npz")["arr"]
        assert got.dtype == want.dtype == np.float16 and got.shape == (64, 64, 64)
        np.testing.assert_allclose(got.astype(np.float32), want.astype(np.float32), atol=1e-4)
