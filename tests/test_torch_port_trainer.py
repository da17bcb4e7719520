"""The port's retrieval trainer and its CLI pieces against the JAX
package's, on the CPU (the training-time parts of the models are held in
test_torch_port_train_parts.py).

- The trainers: the JAX RetrievalTrainer's flax-initialised encoders go
  through the weight bridge into the port's trainer; on one equal batch
  the loss and every gradient agree (float32, rtol 1e-5; the JAX side
  through jax.value_and_grad(trainer._loss_fn, has_aux=True)), with the
  IoU scaling on and off. Three `fit` steps (one an epoch, so that each is
  logged) give equal losses (rtol 1e-4), then equal val losses and
  retrieval-validation metrics (1e-6 relative, or, where the two packages'
  float32 kNN scores rank two near-equal neighbours otherwise, equal
  composed volumes on every patch but those).
- The port's `main` writes metrics.jsonl with the JAX keys and a
  checkpoint that the port's retrieval CLI maps with; the experiment names
  and parsed configs equal the JAX ones.
- The validation's visualisations (enable_vis): the val_vis meshes equal
  the JAX SceneHandler's, and one PNG a scene.

The synthetic dataset is the session fixture `synth_superres_root` at nf 4,
latent 16, batch 8. One JAX train step and one eval step are compiled.
"""

import contextlib
import datetime as dt
import json
import os
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

import retrieval_fuse_tpu.config.arguments as jargs
import retrieval_fuse_tpu.train.retrieval_trainer as jrt
from retrieval_fuse_tpu.data.synthetic import make_synthetic_config
from retrieval_fuse_tpu.train.retrieval_trainer import RetrievalTrainer as JaxTrainer
import retrieval_fuse_tpu_torch.config.arguments as targs
from retrieval_fuse_tpu_torch.data import batch_iterator
from retrieval_fuse_tpu_torch.retrieval import cli as tcli
from retrieval_fuse_tpu_torch.train import retrieval_trainer as trt
from retrieval_fuse_tpu_torch.utils.flax_import import flax_to_state_dict
from test_torch_port_retrieval import copy_dataset, working_dir
from test_torch_port_models import torch_threads  # noqa: F401 (autouse fixture)

MODEL = {"nf_input": 4, "nf_target": 4, "latent_dim": 16}
RTOL = 1e-5


def synthetic_config(data) -> dict:
    cfg = make_synthetic_config(data)
    cfg["retrieval_model"].update(MODEL)
    cfg["retrieval_training"].update(batch_size=8, lr=0.5, scheduler=[1, 2])
    cfg["dictionary"]["batch_size"] = 64  # ~300 patches: less padding for XLA's CPU convs
    cfg["query"]["batch_size"] = 64
    cfg.update(seed=3, experiment="trainer_parity")
    return cfg


def port_grads(modules: dict) -> dict:
    return {name: {k: p.grad.clone() for k, p in m.named_parameters()}
            for name, m in modules.items()}


def assert_close_trees(got: dict, want: dict, rtol=RTOL, atol=0.0, rel_to_max=0.0):
    """Each tensor within rtol, atol, and rel_to_max times the largest
    magnitude of the wanted tensor (float32 sums over a batch, in another
    order, for gradients)."""
    assert sorted(got) == sorted(want)
    for key in want:
        w = np.asarray(want[key])
        tol = atol + rel_to_max * float(np.abs(w).max(initial=0.0))
        np.testing.assert_allclose(np.asarray(got[key]), w, rtol=rtol, atol=tol, err_msg=key)


# ------------------------------------------------------------- trainers


class _JitInit:
    """A flax module whose `init` is one jit (the trainer's eager init
    compiles every operation on its own); everything else is the module's."""

    def __init__(self, module):
        self._module, self.init = module, jax.jit(module.init)

    def __getattr__(self, name):
        return getattr(self._module, name)


@pytest.fixture(scope="module")
def trainers(synth_superres_root, tmp_path_factory):
    """The JAX trainer and the port's, on two copies of the dataset, the
    port's loaded with the JAX trainer's initial encoders; each in its own
    working directory (runs/, data caches)."""
    tmp = tmp_path_factory.mktemp("trainer_parity")
    out = {}
    mp = pytest.MonkeyPatch()
    networks = jrt.get_retrieval_networks
    mp.setattr(jrt, "get_retrieval_networks", lambda cfg: tuple(map(_JitInit, networks(cfg))))
    try:
        for tag in ("jax", "port"):
            work = tmp / tag
            cfg = synthetic_config(copy_dataset(synth_superres_root, work / "data"))
            with working_dir(work):
                out[tag] = (JaxTrainer(cfg, enable_vis=False) if tag == "jax"
                            else trt.RetrievalTrainer(cfg, device="cpu"))
            out[f"{tag}_dir"] = work
    finally:
        mp.undo()
    jtr, tr = out["jax"], out["port"]
    tr.load_params({name: flax_to_state_dict(jtr.state.params[name]) for name in trt.ENCODERS})
    out["batch"] = next(batch_iterator(tr.train_dataset, 8, shuffle=True, drop_last=True,
                                       seed=5))
    return out


@pytest.mark.parametrize("iou_scaling", [True, False], ids=["iou", "plain"])
def test_trainer_loss_and_gradients_match_jax(trainers, iou_scaling):
    jtr, tr, batch = trainers["jax"], trainers["port"], trainers["batch"]
    jtr._loss_cfg["iou_scaling"] = tr.iou_scaling = iou_scaling
    try:
        jb = {k: jnp.asarray(batch[k]) for k in ("input", "target")}
        loss = jax.jit(jax.value_and_grad(jtr._loss_fn, has_aux=True), static_argnums=(2,))
        (jtotal, (jcontrastive, _)), jgrads = loss(
            jtr.state.params, jb, True, jax.random.PRNGKey(0), jtr.state.batch_stats)
        for net in tr.encoders.values():
            net.train().zero_grad(set_to_none=True)
        total, contrastive = tr._loss_fn(tr._device_batch(batch), train=True)
        total.backward()
    finally:
        jtr._loss_cfg["iou_scaling"] = tr.iou_scaling = True
    np.testing.assert_allclose(float(total.detach()), float(jtotal), rtol=RTOL)
    np.testing.assert_allclose(float(contrastive.detach()), float(jcontrastive), rtol=RTOL)
    got = port_grads(tr.encoders)
    for name in trt.ENCODERS:
        want = flax_to_state_dict(jgrads[name])
        scale = max(float(np.abs(w.numpy()).max()) for w in want.values())
        assert_close_trees({k: g.numpy() for k, g in got[name].items()}, want,
                           atol=1e-6 * scale)


def mapping_near_ties(tr, ds, tree) -> set:
    """Patch names of `ds` whose top two kNN distances (port mapping) are
    within 1e-5: where float32 scores summed in another order may swap."""
    from retrieval_fuse_tpu_torch.retrieval.dictionary import extract_input_features
    from retrieval_fuse_tpu_torch.retrieval.engine import query_dictionary_using_features
    encode_in, _ = tr.encoder_apply_fns()
    names, feats = extract_input_features(encode_in, tr.config["query"], tr.latent_dim, ds)
    m = query_dictionary_using_features(dict(tr.config["query"], K=2), names, feats, ds, tree,
                                        False, device="cpu")
    return {n for n, rows in m.items() if rows[1, 7] - rows[0, 7] <= 1e-5}


def test_fit_validation_and_retrieval_validation_match_jax(trainers):
    """Three steps (fit over three epochs of one step: lr 0.5 · warm-up,
    halved at epochs 1 and 2), then the val loss and the retrieval
    validation's metrics of both trainers."""
    jtr, tr = trainers["jax"], trainers["port"]
    records, val, metrics = {}, {}, {}
    for tag, trainer in (("jax", jtr), ("port", tr)):
        with working_dir(trainers[f"{tag}_dir"]):
            trainer.fit(max_epochs=3, val_check_interval=100, save_epoch=100,
                        max_steps_per_epoch=1)
            path = Path("runs", trainer.config["experiment"], "metrics.jsonl")
            records[tag] = [json.loads(line) for line in path.read_text().splitlines()]
            val[tag] = trainer.validate(0, run_retrieval_validation=False)
            metrics[tag] = trainer.retrieval_validation(0)
    assert [sorted(r) for r in records["port"]] == [sorted(r) for r in records["jax"]]
    assert [r["_step"] for r in records["port"]] == [1, 2, 3]
    for key in ("train/total_loss", "train/contrastive_loss", "learning_rate", "epoch"):
        np.testing.assert_allclose([r[key] for r in records["port"]],
                                   [r[key] for r in records["jax"]], rtol=1e-4, err_msg=key)
    assert len({r["train/total_loss"] for r in records["port"]}) == 3
    np.testing.assert_allclose(val["port"], val["jax"], rtol=1e-4)
    assert sorted(metrics["port"]) == ["train", "traingt", "val"]
    # a swap of two near-equal neighbours moves the metrics: none may occur here
    tree = trainers["port_dir"] / "runs" / tr.config["experiment"] / "visualization" / \
        "epoch_0000"
    with working_dir(trainers["port_dir"]):
        ties = mapping_near_ties(tr, tr.dataset("val"), tree)
    assert not ties, f"near-tie val patches {sorted(ties)[:4]}: choose another seed"
    for key in metrics["jax"]:
        np.testing.assert_allclose(metrics["port"][key], metrics["jax"][key], rtol=1e-6,
                                   err_msg=key)


def test_trainer_refuses_visualisation(synth_superres_root, tmp_path):
    """enable_vis (refused before the meshes were ported; the name stays):
    the retrieval validation's _visualize writes each val_vis scene's
    _gt/_pred/_input OBJs, identical to the JAX SceneHandler's of the same
    stitched volumes, and one PNG of the three panels. One val_vis scene,
    its 1-NN retrieval another val scene's target."""
    from PIL import Image
    from retrieval_fuse_tpu.data import PatchedSceneDataset as JaxDataset, SceneHandler as JaxScenes
    data = copy_dataset(synth_superres_root, tmp_path / "data")
    split = data / "splits" / "SynthSet" / "main"
    (split / "val_vis.txt").write_text((split / "val.txt").read_text().split()[0])
    cfg = synthetic_config(data)
    with working_dir(tmp_path):
        tr = trt.RetrievalTrainer(cfg, device="cpu", enable_vis=True)
        ds_val = tr.dataset("val")
        targets = np.stack([ds_val.get_scene_target(s) for s in ds_val.scenes])
        tr._visualize(tmp_path / "vis", ds_val, np.roll(targets, 1, axis=0)[:, None])
        jds = JaxDataset("val_vis", cfg["dataset_val"], JaxScenes("val", cfg))
    assert tr.enable_vis and jds.scenes == [ds_val.scenes[0]]
    scene = jds.scenes[0]
    want = tmp_path / "want"
    want.mkdir()
    handler = JaxScenes("val", cfg)
    handler.visualize_target_chunk(jds.combine_targets()[scene].astype(np.float32),
                                   want / f"{scene}_gt.obj")
    handler.visualize_target_chunk(targets[-1].astype(np.float32), want / f"{scene}_pred.obj")
    handler.visualize_input_chunk(jds.combine_inputs()[scene].astype(np.float32),
                                  want / f"{scene}_input.obj")
    mesh_dir = tmp_path / "vis" / "visualization_val_vis"
    assert sorted(p.name for p in mesh_dir.iterdir()) == sorted(p.name for p in want.iterdir())
    for f in want.iterdir():
        assert (mesh_dir / f.name).read_text() == f.read_text(), f.name
    pngs = sorted((tmp_path / "vis" / "render_val_vis").iterdir())
    assert [p.name for p in pngs] == [f"{scene}.png"]
    img = np.asarray(Image.open(pngs[0]).convert("RGB"))
    assert img.shape == (480, 1440, 3)
    assert all((img[:, 480 * i: 480 * (i + 1)] < 255).any() for i in range(3))


def test_save_load_round_trip(trainers, tmp_path):
    tr = trainers["port"]
    ckpt = tr.save(tmp_path / "rt", 4)
    before = {n: {k: v.clone() for k, v in sd.items()} for n, sd in tr.params().items()}
    step = tr.global_step
    for p in tr.fenc_input.parameters():
        p.data.zero_()
    tr.global_step = 0
    tr.load(ckpt)
    assert tr.global_step == step and ckpt.name == "ckpt_epoch=4"
    for name, sd in tr.params().items():
        for k, v in sd.items():
            assert torch.equal(v, before[name][k]), (name, k)
    assert not tr.optimizer.state  # a new optimizer


# ------------------------------------------------------------------ CLI


@contextlib.contextmanager
def frozen_time_and_env():
    """Both packages' arguments modules see one fixed time; the
    `experiment` environment variable is cleared before and after."""
    fixed = dt.datetime(2026, 3, 4, 5, 6)

    class Frozen(dt.datetime):
        @classmethod
        def now(cls, tz=None):
            return fixed

    saved = (jargs.datetime, targs.datetime)
    jargs.datetime = targs.datetime = Frozen
    os.environ.pop("experiment", None)
    try:
        yield
    finally:
        jargs.datetime, targs.datetime = saved
        os.environ.pop("experiment", None)


@pytest.mark.parametrize("extra, env, want", [
    ([], None, "04030506_superresolution_SynthSet_e"),
    (["--resume", "runs/old_exp/ckpt_epoch=3"], None, "old_exp"),
    (["--resume", "runs/old_exp/ckpt_epoch=3", "--new_exp_for_resume"], None,
     "04030506_superresolution_SynthSet_e"),
    ([], "given_name", "given_name")], ids=["new", "resume", "resume-new", "env"])
def test_parse_arguments_matches_jax(synth_superres_root, tmp_path, extra, env, want):
    cfg = synthetic_config(synth_superres_root)
    path = tmp_path / "cfg.yaml"
    path.write_text(yaml.safe_dump(cfg))
    argv = ["--config", str(path), "--seed", "7", "--max_epoch", "2", "--experiment", "e"]
    out = {}
    for tag, mod in (("jax", jargs), ("port", targs)):
        with frozen_time_and_env():
            if env:
                os.environ["experiment"] = env
            out[tag] = mod.parse_arguments(argv + extra)
            assert os.environ["experiment"] == want
    assert out["port"].pop("device") is None
    assert out["port"] == out["jax"]
    assert out["port"]["experiment"] == want


def test_main_writes_metrics_and_a_checkpoint_that_maps(synth_superres_root, tmp_path):
    """The port's CLI: one epoch of 2 steps' worth of data, no validation,
    then `map` with its checkpoint."""
    work = tmp_path
    cfg = synthetic_config(copy_dataset(synth_superres_root, work / "data"))
    path = work / "cfg.yaml"
    path.write_text(yaml.safe_dump(cfg))
    with working_dir(work), frozen_time_and_env():
        trainer = trt.main(["--config", str(path), "--max_epoch", "1", "--val_check_interval",
                            "100", "--seed", "1", "--experiment", "cli", "--device", "cpu"])
        exp = trainer.config["experiment"]
        assert exp == "04030506_superresolution_SynthSet_cli"
        run = Path("runs", exp)
        recs = [json.loads(line) for line in (run / "metrics.jsonl").read_text().splitlines()]
        assert sorted(recs[0]) == ["_step", "_time", "epoch", "learning_rate",
                                   "train/contrastive_loss", "train/total_loss"]
        assert (run / "config.yaml").exists()
        assert (run / "code" / "train" / "retrieval_trainer.py").exists()
        ckpt = run / "ckpt_epoch=0"
        assert json.loads((ckpt / "meta.json").read_text())["global_step"] == trainer.global_step
        tcli.main(["--config", str(path), "--retrieval_ckpt", str(ckpt), "--mode", "map",
                   "--K", "2", "--device", "cpu"])
        map_cfg = dict(cfg, K=2, retrieval_ckpt=str(ckpt))
        from retrieval_fuse_tpu_torch.utils.misc import get_retrievals_dir
        mapping = np.load(get_retrievals_dir(map_cfg) / "map_val.npy", allow_pickle=True)[()]
        assert len(mapping) > 0 and all(v.shape == (2, 8) for v in mapping.values())
    assert trainer.enable_vis  # as the JAX CLI's trainer
