"""The other tasks' training and retrieval pipeline in the port against the
JAX package, on the CPU: the 3DFront surface-reconstruction configs
(`pc_32+8` / `16+4` retrieval networks on point-cloud occupancy grids, the
five-level surface backbone) and the Matterport3D 16³ super-resolution
configs (`4+2` / `16+8` with IoU scaling, the 16³ backbone), at the tiny
geometry of test_torch_port_task_engines.py (surface: 64³ occupancy grids
of 500 points -> 32³ targets, nf 12, attn_num_patch 8, K 4; 16³: nf 4, K 2)
with latent 16 and encoders of nf 4.

- One retrieval train step of each: the JAX RetrievalTrainer's flax
  encoders through the weight bridge into the port's trainer; on one batch
  the loss within RTOL and every gradient within RETRIEVAL_GRAD_TOL of its
  encoder's largest (float32 both; one jit of the JAX loss's
  value_and_grad a config).
- One refinement phase-3 step of each (all four sub-networks and every loss
  term) against JAX's float64 (jax.enable_x64, one jit of value_and_grad of
  `_phase_loss` a config), on the port's initial weights, as
  test_torch_port_refinement_trainer.py holds the 8³ config: the port's
  float64 within F64_TOL of each tensor's largest, its float32 within
  F32_GRAD_TOL of the sub-network's largest. The data: targets with seeded
  N(0, NOISE) and composed retrievals of other scenes on disk.
- The retrieval CLI's map -> compose -> evaluate round trip on the surface
  config: both CLIs on copies of the dataset with the same encoders (the
  voxeliser's point subsets seeded alike), the dictionary, the mappings,
  the composed volumes (the port composes from the JAX mappings) and the
  metrics.
- chip_smoke.py's phase-12 configs pinned to their YAMLs, and the rows its
  dataset writer counts equal to the data layer's.
"""

import contextlib
import io
import os
import random
import shutil
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

import chip_smoke
import retrieval_fuse_tpu.train.retrieval_trainer as jrt
from retrieval_fuse_tpu.data import synthetic as jsynth
from retrieval_fuse_tpu.retrieval import cli as jcli
from retrieval_fuse_tpu.train.checkpoint import save_checkpoint as jax_save_checkpoint
from retrieval_fuse_tpu.train.retrieval_trainer import RetrievalTrainer as JaxTrainer
from retrieval_fuse_tpu.utils import misc as jmisc
from retrieval_fuse_tpu_torch import config as tconfig
from retrieval_fuse_tpu_torch.data import PatchedSceneDataset, SceneHandler, batch_iterator
from retrieval_fuse_tpu_torch.data.loader import collate
from retrieval_fuse_tpu_torch.retrieval import cli as tcli
from retrieval_fuse_tpu_torch.train import refinement_trainer as rt
from retrieval_fuse_tpu_torch.train import retrieval_trainer as trt
from retrieval_fuse_tpu_torch.utils.flax_import import flax_engine_params, flax_to_state_dict
from test_torch_port_refinement_trainer import (
    F64_TOL, flat, float64, jax_trainer, largest_share, port_batch)
from test_torch_port_retrieval import load_converter, printed_metrics, working_dir
from test_torch_port_trainer import _JitInit, port_grads
from test_torch_port_models import torch_threads  # noqa: F401 (autouse fixture)

MODEL = {"nf_input": 4, "nf_target": 4, "latent_dim": 16}
RTOL = 1e-5
#: a retrieval gradient (float32 both): the largest |port - JAX| over a
#: tensor, as a share of its encoder's largest gradient (read: surface
#: 1.3e-7, 16³ 3.2e-7)
RETRIEVAL_GRAD_TOL = 1e-6
#: the port's float32 phase-3 gradients against JAX's float64: the largest
#: |difference| over a tensor as a share of its sub-network's largest (read:
#: surface 2.3e-4, 16³ 1.3e-3; the 8³ config's bound is 1e-2). The port's
#: float64 reads at most 1.7e-7 of a tensor's largest (F64_TOL 1e-5)
F32_GRAD_TOL = 1e-2
#: the contrastive term (and the total it enters) of a float64 step: JAX
#: sums it in float32 under jax.enable_x64 (its float64 reading, 87.03803253
#: on the 16³ data, is a float32 value), so the port's float64 lies its
#: float32 rounding away (read: 4.4e-8 / 5.6e-8 relative on the 16³ /
#: surface data, the total 1.2e-8 / 2.7e-8; the other parts 1e-14)
CONTRASTIVE_RTOL = 1e-6
#: the targets' seeded perturbation (normalised units), as in
#: test_torch_port_refinement_trainer.py: no 16³ patch is constant
NOISE = 0.05
RETRIEVAL_CKPT = "runs/synthetic_retrieval/ckpt_epoch=0"
#: the 16³ inputs' voxel size: 4 target voxels (64³ targets, 16³ inputs)
VS16 = 0.083336
K_SURFACE, K16 = 4, 2


def dataset_dirs(cfg: dict) -> tuple:
    d = cfg["dataset_train"]
    return d["input_dir"], d["target_dir"], "splits"


def copy_task_dataset(src, dst, cfg) -> Path:
    for sub in dataset_dirs(cfg):
        shutil.copytree(Path(src) / sub, Path(dst) / sub)
    return Path(dst)


def retrieval_config(task: str, data) -> dict:
    """The task's retrieval config at the tiny geometry, on `data`."""
    if task == "surface":
        cfg = jsynth.make_synthetic_config(data, task="surface_reconstruction")
        for d in ("dataset_train", "dataset_val"):
            cfg[d].update(num_points=500, input_chunk_size=64, target_chunk_size=32,
                          voxel_size_target=0.054167)
        cfg["retrieval_model"].update(network_input="pc_32+8", network_target="16+4")
    else:
        cfg = jsynth.make_synthetic_config(data)
        for d in ("dataset_train", "dataset_val"):
            cfg[d].update(input_dir="sdf_016", input_chunk_size=16, patch_size_input=4,
                          patch_context_input=2, voxel_size_input=VS16)
        cfg["retrieval_model"].update(network_input="4+2", network_target="16+8")
        cfg["retrieval_training"]["iou_scaling"] = True
    cfg["retrieval_model"].update(MODEL)
    cfg["retrieval_training"].update(batch_size=8, lr=0.5, scheduler=[1, 2])
    cfg["dictionary"]["batch_size"] = cfg["query"]["batch_size"] = 32
    cfg.update(seed=3, experiment=f"task_training_{task}")
    return cfg


def refinement_config(task: str, data, **extra) -> dict:
    """The task's refinement config at the tiny geometry, on `data`, with
    retrievals on."""
    cfg = retrieval_config(task, data)
    if task == "surface":
        cfg.update(nf=12, K=K_SURFACE, unet_num_level=5, retrieval_fmaps=12, attn_num_patch=8)
        geometry = dict(patch_size_input=64, patch_size_target=32, patch_stride=32)
    else:
        cfg.update(nf=4, K=K16, unet_num_level=4, retrieval_fmaps=4, attn_num_patch=16)
        geometry = dict(patch_size_input=16, patch_size_target=64, patch_stride=64)
    cfg.update(batch_size=1, retrieval_num_level=4, attn_retrieval_mode=False,
               experiment=f"task_refine_{task}", no_retrievals=False,
               retrieval_ckpt=RETRIEVAL_CKPT, **extra)
    for d in ("dataset_train", "dataset_val"):
        cfg[d].update(patch_context_input=0, patch_context_target=0, **geometry)
    return cfg


@pytest.fixture(scope="module")
def datasets(tmp_path_factory):
    """The two tasks' synthetic datasets, written by the JAX generator:
    surface point clouds of 32³ target chunks (pc_20K), 16³ inputs of 64³
    targets (sdf_016)."""
    root = tmp_path_factory.mktemp("task_data")
    jsynth.generate_synthetic_dataset(root / "surface", n_train=4, n_val=2, seed=5,
                                      target_res=32, voxel_size_target=0.054167,
                                      task="surface_reconstruction", input_dir="pc_20K",
                                      target_dir="sdf_064")
    jsynth.generate_synthetic_dataset(root / "superres16", n_train=6, n_val=2, seed=7,
                                      input_res=16, input_dir="sdf_016", voxel_size_input=VS16)
    return root


# ------------------------------------------------------------ chip_smoke.py


@pytest.mark.parametrize("task, retrieval, refinement", [
    ("surface", "surface_reconstruction/3DFront/retrieval_128_064.yaml",
     "surface_reconstruction/3DFront/refinement_128_064.yaml"),
    ("superres16", "super_resolution/Matterport3D/retrieval_016_064.yaml",
     "super_resolution/Matterport3D/refinement_016_064.yaml")])
def test_chip_smoke_phase12_configs_are_the_yamls(tmp_path, task, retrieval, refinement):
    """chip_smoke.py builds phase 12's configs in code: each equals its
    packaged YAML pointed at the data, the retrieval one as the retrieval
    CLI resolves it with --K 4, the refinement one with retrievals on for
    the given retrieval checkpoint."""
    root = str(tmp_path) + "/"
    ckpt = "runs/x/ckpt_epoch=0"
    for rel, got, extra in (
            (retrieval, chip_smoke.task_retrieval_config(task, tmp_path, ckpt),
             {"retrieval_ckpt": ckpt, "K": 4}),
            (refinement, chip_smoke.task_refinement_config(task, tmp_path, ckpt),
             {"retrieval_ckpt": ckpt, "no_retrievals": False})):
        want = tconfig.read_config(tconfig.CONFIG_ROOT / rel)
        for d in ("dataset_train", "dataset_val"):
            want[d].update(data_dir=root, scene_dir=root, retrieval_dir=root)
        del want["inherit_from"]  # the YAML's pointer to its base, read by nothing
        want.update(extra)
        if "query" in want and rel == retrieval:
            want["query"]["K"] = 4
        assert got == want, rel


@pytest.mark.parametrize("task", ["surface", "superres16"])
def test_chip_smoke_task_dataset_counts_dictionary_rows(tmp_path, task):
    """write_task_dataset's row count equals the data layer's train patches
    (the surface config's occupancy rule on 16+4 patches; every 16+8 patch
    of the 16³ config, which skips the rule); its files are what the
    config's SceneHandler reads."""
    made = chip_smoke.write_task_dataset(task, tmp_path, np.random.default_rng(2), 40, 1, "cpu",
                                         per_draw=8)
    cfg = chip_smoke.task_retrieval_config(task, tmp_path, "runs/x/ckpt_epoch=0")
    ds = PatchedSceneDataset("train", cfg["dataset_train"], SceneHandler("train", cfg))
    assert len(made["train"]) % 8 == 0 and len(made["val"]) == 1 and ds.scenes == made["train"]
    assert made["rows"] == len(ds) and 40 <= len(ds) <= 64 * len(ds.scenes)
    if task == "surface":
        random.seed(0)
        items = [ds[i] for i in range(0, len(ds), max(1, len(ds) // 16))]
        assert all(it["input"].shape == (48, 48, 48, 1) and it["target"].shape == (24,) * 3 + (1,)
                   for it in items)
        occupied = [float(it["input"].sum()) for it in items]
        assert max(occupied) <= 500 and sum(occupied) > 0, occupied


# ------------------------------------------------------------ retrieval step


@pytest.mark.parametrize("task", ["surface", "superres16"])
def test_retrieval_train_step_matches_jax(datasets, tmp_path, task):
    """One train step's loss and gradients (the JAX trainer's encoders in
    the port's trainer; the same batch, the surface windows drawn once)."""
    mp = pytest.MonkeyPatch()
    networks = jrt.get_retrieval_networks
    mp.setattr(jrt, "get_retrieval_networks", lambda cfg: tuple(map(_JitInit, networks(cfg))))
    trainers = {}
    try:
        for tag in ("jax", "port"):
            cfg = retrieval_config(task, tmp_path / tag / "data")
            copy_task_dataset(datasets / task, tmp_path / tag / "data", cfg)
            with working_dir(tmp_path / tag):
                trainers[tag] = (JaxTrainer(cfg, enable_vis=False) if tag == "jax"
                                 else trt.RetrievalTrainer(cfg, device="cpu"))
    finally:
        mp.undo()
    jtr, tr = trainers["jax"], trainers["port"]
    tr.load_params({name: flax_to_state_dict(jtr.state.params[name]) for name in trt.ENCODERS})
    random.seed(1)
    batch = next(batch_iterator(tr.train_dataset, 8, shuffle=True, drop_last=True, seed=5,
                                prefetch=0))
    assert batch["input"].shape[1:] == ((48,) * 3 if task == "surface" else (8,) * 3) + (1,)
    jb = {k: jnp.asarray(batch[k]) for k in ("input", "target")}
    loss = jax.jit(jax.value_and_grad(jtr._loss_fn, has_aux=True), static_argnums=(2,))
    (jtotal, _), jgrads = loss(jtr.state.params, jb, True, jax.random.PRNGKey(0),
                               jtr.state.batch_stats)
    for net in tr.encoders.values():
        net.train().zero_grad(set_to_none=True)
    total, _ = tr._loss_fn(tr._device_batch(batch), train=True)
    total.backward()
    np.testing.assert_allclose(float(total.detach()), float(jtotal), rtol=RTOL)
    got = port_grads(tr.encoders)
    for name in trt.ENCODERS:
        want = flax_to_state_dict(jgrads[name])
        scale = max(float(w.abs().max()) for w in want.values())
        assert sorted(got[name]) == sorted(want)
        for key, w in want.items():
            share = largest_share(got[name][key].numpy(), w.numpy(), scale)
            assert share <= RETRIEVAL_GRAD_TOL, f"{task} {name}.{key}: {share:.2e} of {scale:.2e}"


# ------------------------------------------------------------ refinement step


@pytest.fixture(scope="module", params=["surface", "superres16"])
def refine(request, datasets, tmp_path_factory):
    """The port's refinement trainer (its seeded weights) and the JAX
    trainer on them, on a perturbed copy of the task's dataset with composed
    retrievals, one train item, and JAX's float64 phase-3 loss and
    gradients on it."""
    task = request.param
    tmp = tmp_path_factory.mktemp(f"task_refine_{task}")
    rng = np.random.default_rng(31)
    data = copy_task_dataset(datasets / task, tmp / "data", refinement_config(task, tmp / "data"))
    cfg = refinement_config(task, data)
    std, target_dir = cfg["dataset_train"]["target_std"], data / cfg["dataset_train"]["target_dir"]
    for path in target_dir.glob("*/*.npz"):
        arr = np.load(path)["arr"]
        np.savez(path, arr=(arr + rng.normal(0, NOISE * std, arr.shape)).astype(np.float32))
    chip_smoke.write_composed_retrievals(cfg, rng, cfg["K"])
    mp = pytest.MonkeyPatch()
    with working_dir(tmp):
        tr = rt.RefinementTrainer(dict(cfg), device="cpu")
        jtr = jax_trainer(dict(cfg), tr.params(), mp)
    tr.load_params(flax_engine_params(jtr.state.params))
    random.seed(2)
    batch = collate([tr.train_dataset[0]], 1)

    def run(params, b):
        (total, aux), grads = jax.value_and_grad(
            lambda p, aug: jtr._phase_loss(3, p, aug, jax.random.PRNGKey(0)), has_aux=True)(
                params, jtr.augment_batch_data(b))
        return total, aux, grads

    with jax.enable_x64(True):
        params = jax.tree_util.tree_map(lambda a: jnp.asarray(np.asarray(a, np.float64)),
                                        jtr.state.params)
        jb = {k: jnp.asarray(np.asarray(batch[k], np.float64))
              for k in ("input", "target", "retrieval")}
        want = jax.device_get(jax.jit(run)(params, jb))
    return dict(task=task, port=tr, batch=batch, want=want)


@pytest.mark.parametrize("x64", [True, False], ids=["float64", "float32"])
def test_refinement_phase3_step_matches_jax_float64(refine, x64):
    """Phase 3's loss, its parts and the four sub-networks' gradients of the
    port's train step (compute_gradients) against JAX's float64: the port
    in float64 (losses 1e-8 relative, gradients F64_TOL of each tensor's
    largest) and in float32 (losses RTOL, gradients F32_GRAD_TOL of the
    sub-network's largest)."""
    tr, (jtotal, jaux, jgrads) = refine["port"], refine["want"]
    tr.set_phase(3)
    ctx = float64(tr) if x64 else contextlib.nullcontext()
    with ctx:
        total, aux = tr.compute_gradients(port_batch(
            tr, refine["batch"], torch.float64 if x64 else torch.float32))
        grads = tr.gradients()
    rtol = 1e-8 if x64 else RTOL
    np.testing.assert_allclose(float(total), float(jtotal), rtol=CONTRASTIVE_RTOL if x64 else rtol)
    assert sorted(aux) == sorted(jaux)
    for k in jaux:
        np.testing.assert_allclose(float(aux[k]), float(jaux[k]), err_msg=k, rtol=(
            CONTRASTIVE_RTOL if x64 and k == "contrastive" else rtol))
    assert sorted(grads) == sorted(rt.SUBNETS)
    for name in grads:
        want = flat(jgrads[name])
        net_scale = max(float(np.abs(w).max(initial=0.0)) for w in want.values())
        for key, w in want.items():
            label = f"{refine['task']} {name}.{key}"
            if key not in grads[name]:  # off the loss's path in the port: zero in JAX
                assert not np.any(w), label
                continue
            g = grads[name][key].numpy()
            if x64:
                np.testing.assert_allclose(g, w, rtol=0, atol=F64_TOL * float(np.abs(w).max()),
                                           err_msg=label)
            else:
                share = largest_share(g, w, net_scale)
                assert share <= F32_GRAD_TOL, f"{label}: {share:.2e} of {net_scale:.2e}"


# ------------------------------------------------------------ the round trip


@pytest.fixture(scope="module")
def surface_roundtrip(datasets, tmp_path_factory):
    """Both CLIs' map -> compose -> evaluate on copies of the surface
    dataset, with the same flax-initialised encoders; each map after
    random.seed(0), so that both voxelise the same point subsets. The port
    composes from the JAX mappings."""
    tmp = tmp_path_factory.mktemp("task_roundtrip")
    nets = jrt.get_retrieval_networks(dict(retrieval_config("surface", tmp)["retrieval_model"]))
    params = {key: jax.jit(net.init)(jax.random.PRNGKey(i), jnp.zeros((1, side, side, side, 1))
                                     )["params"]
              for i, (key, net, side) in enumerate(zip(("fenc_input", "fenc_target"), nets,
                                                      (48, 24)))}
    out = {}
    for tag in ("jax", "port"):
        work = tmp / tag
        cfg = retrieval_config("surface", work / "data")
        copy_task_dataset(datasets / "surface", work / "data", cfg)
        (work / "cfg.yaml").write_text(yaml.safe_dump(cfg))
        with working_dir(work):
            jax_ckpt = jax_save_checkpoint(Path("runs/rt"), 0, params)
            cfg.update(K=2, retrieval_ckpt=str(work / "runs/rt/ckpt_epoch=0"))
            rec = out[tag] = dict(tree=work / jmisc.get_tree_path(cfg),
                                  retrievals=jmisc.get_retrievals_dir(cfg))
            argv = ["--config", str(work / "cfg.yaml"), "--K", "2"]
            buf = io.StringIO()
            random.seed(0)
            if tag == "jax":
                with contextlib.redirect_stdout(buf):
                    jcli.main(argv + ["--retrieval_ckpt", str(jax_ckpt),
                                      "--mode", "map", "compose", "evaluate"])
            else:
                ckpt = load_converter().convert(jax_ckpt, work / "port_runs" / "rt")
                argv += ["--retrieval_ckpt", str(ckpt), "--device", "cpu"]
                tcli.main(argv + ["--mode", "map"])
                for split in ("train", "val"):
                    name = f"map_{split}.npy"
                    os.replace(rec["retrievals"] / name, rec["retrievals"] / f"port_{name}")
                    shutil.copy(out["jax"]["retrievals"] / name, rec["retrievals"] / name)
                with contextlib.redirect_stdout(buf):
                    tcli.main(argv + ["--mode", "compose", "evaluate"])
            rec["metrics"] = printed_metrics(buf.getvalue())
    return out


def test_surface_roundtrip_matches_jax(surface_roundtrip):
    """The dictionary (atol 1e-5, scene and extent columns equal), both
    mappings (scene and extent columns equal, distances 1e-5), the composed
    volumes (equal) and the metrics (1e-6 relative) of the surface config."""
    j, p = (surface_roundtrip[t] for t in ("jax", "port"))
    want, got = np.load(j["tree"] / "database.npy"), np.load(p["tree"] / "database.npy")
    assert got.shape == want.shape and len(got) > 8
    np.testing.assert_array_equal(got[:, :7], want[:, :7])
    np.testing.assert_allclose(got, want, atol=1e-5)
    for split in ("train", "val"):
        wm = np.load(j["retrievals"] / f"map_{split}.npy", allow_pickle=True)[()]
        gm = np.load(p["retrievals"] / f"port_map_{split}.npy", allow_pickle=True)[()]
        assert gm.keys() == wm.keys() and len(gm) > 0
        for name, w in wm.items():
            np.testing.assert_array_equal(gm[name][:, :7], w[:, :7], err_msg=name)
            np.testing.assert_allclose(gm[name][:, 7], w[:, 7], atol=1e-5, err_msg=name)
    files = sorted(f.name for f in (j["retrievals"] / "compose").glob("*.npz"))
    assert files == sorted(f.name for f in (p["retrievals"] / "compose").glob("*.npz"))
    assert len(files) == 6
    for f in files:
        np.testing.assert_array_equal(np.load(p["retrievals"] / "compose" / f)["arr_0"],
                                      np.load(j["retrievals"] / "compose" / f)["arr_0"])
    assert len(p["metrics"]) == 4 and all(np.isfinite(p["metrics"]))
    np.testing.assert_allclose(p["metrics"], j["metrics"], rtol=1e-6)



# ------------------------------------------------------------ phase 2's hold


@contextlib.contextmanager
def opened_gate(tr):
    """The trainer's decoder output bias at chip_smoke's gate-opening value
    in the block (hold_refine_steps' weights), restored after."""
    bias = tr.decoder.final_conv.bias.detach().clone()
    chip_smoke.open_occupancy_gate(tr)
    try:
        yield
    finally:
        with torch.no_grad():
            tr.decoder.final_conv.bias.copy_(bias)


@pytest.fixture(scope="module")
def phase2(refine):
    """The refine fixture's item through chip_smoke's phase-2 readings on
    the CPU (the held weights): the frozen features and df in float64 and
    float32 (frozen_phase2), and phase 2's float64 gradients of the
    uncached train step and of the cached step on the float64 frozen
    features and gate."""
    tr = refine["port"]
    with opened_gate(tr):
        batch = tr._device_batch(refine["batch"])
        f64, df64 = chip_smoke.frozen_phase2(tr, batch, float64=True)
        f32, df32 = chip_smoke.frozen_phase2(tr, batch)
        uncached = chip_smoke.step_gradients(tr, 2, batch, float64=True)
        cached = chip_smoke.step_gradients(tr, 2, f64, cached=True, float64=True)
    return dict(task=refine["task"], tr=tr, thr=tr.target_voxel_size * 0.75, df64=df64,
                occ64=f64["occ"], df32=df32, occ32=f32["occ"], f64=f64, f32=f32,
                uncached=uncached, cached=cached)


def test_cached_phase2_step_matches_uncached_float64(phase2):
    """The trainer's cached phase-2 step (compute_gradients(cached=True))
    on its own frozen features and gate gives the loss and the attention
    gradients of the uncached step, in float64, to 1e-12 of each tensor's
    largest: the path on which hold_refine_steps compares phase 2."""
    (total, _, want), (got_total, _, got) = phase2["uncached"], phase2["cached"]
    assert float(total) > 0, "the contrastive gate is shut"
    np.testing.assert_allclose(float(got_total), float(total), rtol=1e-12)
    assert sorted(got) == sorted(want) == ["patched_attention_block"]
    want, got = want["patched_attention_block"], got["patched_attention_block"]
    assert sorted(got) == sorted(want)
    for key, w in want.items():
        scale = float(w.abs().max())
        assert scale > 0 and float((got[key] - w).abs().max()) <= 1e-12 * scale, key


def gate_read(p: dict, card_df, card_occ, df64=None, worse_df=None) -> dict:
    """phase2_read's gate record of one draw (gate_summary by arithmetic):
    the CPU's float32 as read, the card's given (card_df, card_occ, against
    df64: float64's df, as read unless given, its gate recomputed), and a
    known-worse arithmetic in TF32's place (float64's df rounded to bf16
    unless given)."""
    tr, thr = p["tr"], p["thr"]
    df64 = p["df64"] if df64 is None else df64
    occ64 = tr.occupancy_from_prediction(df64)
    worse_df = df64.bfloat16().double() if worse_df is None else worse_df
    return {"gate": {
        "card": chip_smoke.gate_summary(card_occ, card_df, occ64, df64, thr),
        "cpu": chip_smoke.gate_summary(p["occ32"], p["df32"], p["occ64"], p["df64"], thr),
        "tf32": chip_smoke.gate_summary(tr.occupancy_from_prediction(worse_df), worse_df,
                                        occ64, df64, thr)}}


@pytest.mark.parametrize("case", ["as-read", "flip-within-bound", "far-flip", "df-past-bound",
                                  "worse-inside"])
def test_phase2_gate_hold(phase2, case):
    """chip_smoke.hold_branch on the occupancy gate, from the CPU's float32
    and float64 readings: the readings as they are pass with a known-worse
    arithmetic outside the df bound; a float32 gate flip where float64's df
    lies within the bound of the threshold passes; a flip forced at the gate
    voxel farthest from the threshold fails (a mutation of the gate); a df
    one voxel off by twice the bound fails; a known-worse arithmetic inside
    the bound fails."""
    p = phase2
    tr, thr, df32 = p["tr"], p["thr"], p["df32"]
    bound_ = chip_smoke.hold_branch([gate_read(p, df32, p["occ32"])], "gate", p["task"])
    assert p["df64"].min() < thr < p["df64"].max() and bound_ < 1e-4 * thr
    fails = {"far-flip": "other way", "df-past-bound": "the card's gate lie",
             "worse-inside": "cannot tell TF32"}
    card_df, card_occ, df64, worse = df32, p["occ32"], None, None
    if case == "flip-within-bound":  # float64 just above the threshold, the card just below
        shut = ~p["occ64"]  # at the nearest voxel of a gate voxel that float64 leaves shut
        for dim in (1, 2, 3):
            shut = shut.repeat_interleave(2, dim=dim)
        v = int(torch.where(shut, (p["df64"] - thr).abs(), torch.inf).argmin())
        df64, card_df = p["df64"].clone(), df32.clone()
        df64.view(-1)[v], card_df.view(-1)[v] = thr + bound_ / 4, thr - bound_ / 4
        card_occ = tr.occupancy_from_prediction(card_df)
    elif case == "far-flip":
        card_occ = p["occ32"].clone()
        far = chip_smoke.gate_summary(~p["occ64"], p["df64"], p["occ64"], p["df64"], thr)
        near = (p["df64"].double() - thr).abs().permute(0, 4, 1, 2, 3)
        near = -torch.nn.functional.max_pool3d(-near, 2, 2).permute(0, 2, 3, 4, 1)
        card_occ.view(-1)[int(near.argmax())] ^= True
        assert far["far"] == float(near.max())
    elif case == "df-past-bound":
        card_df = df32.clone()
        card_df.view(-1)[0] += 2 * bound_
    elif case == "worse-inside":
        worse = df32
    read = gate_read(p, card_df, card_occ, df64, worse)
    if case == "flip-within-bound":
        assert read["gate"]["card"]["flips"] >= 1
    if case in fails:
        with pytest.raises(chip_smoke.Failed, match=fails[case]):
            chip_smoke.hold_branch([read], "gate", p["task"])
    else:
        assert chip_smoke.hold_branch([read], "gate", p["task"]) == bound_


def test_branch_replay_of_its_own_run_is_exact(phase2):
    """Branches: a float64 phase-2 cached step replayed on its own recorded
    LeakyReLU branches gives the recorded step's loss and gradients exactly,
    reads no distance and no flip, and recorded one call a LeakyReLU of
    theta and phi (three each)."""
    tr, f64 = phase2["tr"], phase2["f64"]
    branches = chip_smoke.Branches()
    with opened_gate(tr):
        with branches.record():
            total, _, want = chip_smoke.step_gradients(tr, 2, f64, cached=True, float64=True)
        with branches.replay() as reading:
            got_total, _, got = chip_smoke.step_gradients(tr, 2, f64, cached=True, float64=True)
    assert len(branches.calls) == 6 and float(got_total) == float(total)
    assert reading["dist"] == 0.0 and reading["flips"] == 0
    for key, w in want["patched_attention_block"].items():
        assert torch.equal(got["patched_attention_block"][key], w), key


@pytest.mark.parametrize("case", ["as-read", "far-flip", "worse-inside"])
def test_phase2_activation_branch_hold(phase2, case):
    """chip_smoke.hold_branch on the theta / phi LeakyReLU inputs of the
    cached phase-2 step, each float32 run replayed on the float64 step's
    branches: the CPU's float32 as read passes, with a known-worse arithmetic
    (the frozen features rounded to bf16) outside the bound; the card's
    replay with the recorded branch of the unit of phi's last LeakyReLU
    farthest from its kink turned over fails (a mutation: a decision that does not follow its
    value); a known-worse arithmetic inside the bound fails."""
    tr, f64, f32 = phase2["tr"], phase2["f64"], phase2["f32"]
    worse = {k: (v.bfloat16().float() if v.is_floating_point() else v) for k, v in f32.items()}
    branches = chip_smoke.Branches()
    with opened_gate(tr):
        with branches.record():
            chip_smoke.step_gradients(tr, 2, f64, cached=True, float64=True)
        reads = {}
        for key, fz in (("cpu", f32), ("tf32", worse), ("card", f32)):
            if key == "card" and case == "far-flip":
                call = len(branches.calls) - 1  # phi's last LeakyReLU: no unit above it
                branch, x_rec, scale = branches.calls[call]
                flipped = branch.clone()
                flipped.view(-1)[int(x_rec.abs().argmax())] ^= True
                branches.calls[call] = (flipped, x_rec, scale)
            with branches.replay() as reads[key]:
                chip_smoke.step_gradients(tr, 2, dict(fz, occ=f64["occ"]), cached=True)
    if case == "worse-inside":
        reads["tf32"] = reads["card"]
    assert reads["cpu"]["dist"] < 1e-4 < reads["tf32"]["dist"] or case == "worse-inside"
    fails = {"far-flip": "other way", "worse-inside": "cannot tell TF32"}
    if case in fails:
        with pytest.raises(chip_smoke.Failed, match=fails[case]):
            chip_smoke.hold_branch([{"activations": reads}], "activations", phase2["task"])
    else:
        chip_smoke.hold_branch([{"activations": reads}], "activations", phase2["task"])


@pytest.mark.parametrize("task", ["surface", "superres16"])
def test_retrieval_step_branch_replay(datasets, tmp_path, task):
    """Branches on the retrieval trainer's step as hold_task_train_step
    runs it (chip_smoke.retrieval_step_gradients): the float64 step
    replayed on its own (Leaky)ReLU branches gives its loss and gradients
    exactly, with no distance and no flip; the float32 step replayed on
    them reads its activations' inputs within 1e-5 of float64's (as a share
    of each call's largest) and its gradients within 1e-5 of float64's
    (grad_share)."""
    cfg = retrieval_config(task, tmp_path / "data")
    copy_task_dataset(datasets / task, tmp_path / "data", cfg)
    with working_dir(tmp_path):
        tr = trt.RetrievalTrainer(cfg, device="cpu")
    random.seed(1)
    batch = tr._device_batch(chip_smoke.first_batches(tr.train_dataset, 8, 1)[0])
    branches = chip_smoke.Branches()
    with branches.record():
        loss, want = chip_smoke.retrieval_step_gradients(tr, batch, torch.float64)
    with branches.replay() as own:
        loss64, got64 = chip_smoke.retrieval_step_gradients(tr, batch, torch.float64)
    with branches.replay() as f32:
        _, got32 = chip_smoke.retrieval_step_gradients(tr, batch, torch.float32)
    assert len(branches.calls) > 0 and loss64 == loss
    assert own["dist"] == 0.0 and own["flips"] == 0
    assert all(torch.equal(got64[n][k], w) for n, sd in want.items() for k, w in sd.items())
    assert f32["dist"] < 1e-5 and chip_smoke.grad_share(got32, want)[0] < 1e-5
