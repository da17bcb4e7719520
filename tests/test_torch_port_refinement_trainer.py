"""The port's refinement trainer against the JAX package's, on the CPU, at
the JAX tests' tiny geometry (tests/test_refinement_trainer.py: nf 4, K 2,
batch 1, four U-Net levels, retrieval f_maps 4, 64³ targets) on a copy of
the dataset fixture `synth_superres_root`.

The port's trainer initialises its four sub-networks from its seed; the
JAX trainer is built on the same weights (its flax param trees filled from
the port's state_dicts on the shapes of jax.eval_shape of each init, which
compiles nothing), and the port's trainer then loads the JAX trainer's
params through the weight bridge. The data: the fixture's scenes with
seeded N(0, NOISE) on the targets and, in place of the trunc-filled dummy,
seeded composed retrievals on disk (other scenes' perturbed targets), so
that the attention fuses real candidates. On a constant 16³ patch the
retrieval U-Net's GroupNorm chain (variance far below eps 1e-5) turns
float32 rounding into O(1) features, different in each package; with the
noise every patch varies. Both attentions select with the same Gumbel
uniform draw: the JAX `gumbel_softmax` is replaced by one with that draw.

Held against JAX's float64 (jax.enable_x64; one jit a phase of
jax.value_and_grad of `_phase_loss`, never a train step): forward_full's six
outputs and each phase's loss, parts and gradients, with the port in
float64 (F64_TOL: this holds the backward pass) and in float32 (RTOL,
F32_OUT_TOL, F32_GRAD_TOL). The port's gradients are its train step's
(compute_gradients, without the Adam update). Held against JAX in float32:
augment_batch_data, loss_shape with n_valid and occupancy_from_prediction;
the sliced contrastive loss where the 1280 cap skips slices; validate's
metrics and val losses with deterministic selection on both sides, at batch
3 so that the collate pads; a step resumed from a converted JAX checkpoint
(optax Adam state) against the same step resumed from the port's own.

Port-only: which sub-networks a step changes, the Adam reset of set_phase,
phase-3-only milestones, remat, mixed precision (MIXED_TOL), the frozen
phase-2 cache on the device and on the host, the checkpoint round trip with
the optimizer state, train_refinement_phases' checkpoints and metrics keys, the
CLI's validation-only resume, the refused visualisations, the Gumbel
default, and chip_smoke.py's refinement config against the YAML.
"""

import contextlib
import copy
import importlib.util
import json
import os
from collections.abc import Mapping
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import retrieval_fuse_tpu.evaluation.metrics as jmetrics
import retrieval_fuse_tpu.models.attention as jattn
from retrieval_fuse_tpu.data.synthetic import make_synthetic_config
from retrieval_fuse_tpu.train import refinement_trainer as jrt
from retrieval_fuse_tpu_torch.data.loader import collate
from retrieval_fuse_tpu_torch.models import get_attention_block
from retrieval_fuse_tpu_torch.models.losses import nt_xent_loss_masked
from retrieval_fuse_tpu_torch.train import refinement_trainer as rt
from retrieval_fuse_tpu_torch.train.checkpoint import OPTIM_FILE, load_checkpoint
from retrieval_fuse_tpu_torch.utils.flax_import import flax_engine_params
from test_torch_port_retrieval import copy_dataset, working_dir
from test_torch_port_train_parts import _gumbel_with
from test_torch_port_models import torch_threads  # noqa: F401 (autouse fixture)

MODEL = dict(nf=4, K=2, batch_size=1, unet_num_level=4, retrieval_fmaps=4,
             retrieval_num_level=4)
RTOL = 1e-5
#: float64 on both sides: the largest |port - JAX| over a tensor, as a share
#: of its largest magnitude
F64_TOL = 1e-5
#: the port's float32 against JAX's float64 (the same weights, batch and
#: Gumbel draw), beside RTOL for a loss or a part (read: at most 5.3e-7):
#: the largest |difference| over one of forward_full's outputs, as a share of
#: its largest magnitude, and over a gradient tensor, as a share of its
#: sub-network's largest gradient, by phase. About 3x the readings on this
#: data: outputs 5.4e-6 to 3.0e-5; gradients 2.5e-3, 3.8e-3, 2.5e-3 and
#: 2.0e-6 (phases 3, 0, 1, 2: float32 rounding amplified in the first
#: convolutions; JAX's own float32 lies 1.2e-2, 5.0e-3, 1.8e-2 and 6.9e-6
#: from its float64). The port's float64 reads at most 1.1e-6 of a
#: tensor's largest (F64_TOL) and 2.3e-9 relative on a loss (1e-8).
F32_OUT_TOL = 1e-4
F32_GRAD_TOL = {3: 1e-2, 0: 1e-2, 1: 1e-2, 2: 1e-5}
#: float32 losses over perturbed 64³ fields whose normals divide a Sobel sum
#: by sqrt(|sum|² + 1e-5) (value algebra), or reduced over three volumes in
#: another order (validation)
LOSS_RTOL = 1e-4
#: the seeded perturbation of targets and retrievals (normalised units):
#: every 16³ patch then has a variance far above GroupNorm's eps 1e-5
NOISE = 0.05
#: where the perturbed dataset's composed retrievals live
RETRIEVAL_CKPT = "runs/synthetic_retrieval/ckpt_epoch=0"
#: mixed precision against float32: the relative difference of the loss and
#: its parts, and the least cosine similarity of the decoder's gradient (at nf
#: 4 the backbones' GroupNorm gradients are bf16 rounding: only finite)
MIXED_TOL = {"loss": 5e-2, "grad_cos": 0.98}


def refinement_config(data, **extra) -> dict:
    cfg = make_synthetic_config(data, task="superresolution")
    cfg.update(MODEL, experiment="refine_parity", seed=3, **extra)
    for d in ("dataset_train", "dataset_val"):
        cfg[d].update(patch_size_input=8, patch_context_input=0, patch_size_target=64,
                      patch_context_target=0, patch_stride=64)
    return cfg


def flax_tree(template: Mapping, sd: dict, prefix: str = "") -> dict:
    """A flax param tree of `template`'s structure from the port's
    state_dict `sd` (the inverse of flax_to_state_dict)."""
    out = {}
    for name, leaf in template.items():
        if isinstance(leaf, Mapping):
            out[name] = flax_tree(leaf, sd, f"{prefix}{name}.")
            continue
        a = sd[prefix + {"kernel": "weight", "scale": "weight"}.get(name, name)].numpy()
        if name == "kernel":
            a = a.transpose(2, 3, 4, 1, 0) if a.ndim == 5 else a.T
        assert a.shape == leaf.shape, (prefix, name)
        out[name] = jnp.asarray(a)
    return out


def jax_trainer(cfg: dict, port_params: dict, monkeypatch, **kw):
    """The JAX RefinementTrainer with the port's initial weights."""
    def init_params(self, config):
        ics = config["dataset_train"]["input_chunk_size"]
        fg = config["dataset_train"]["target_chunk_size"] // 2
        key, nf = jax.random.PRNGKey(0), config["nf"]
        shapes = {
            "unet_backbone": (self.unet_backbone.init, key, jnp.zeros((1, ics, ics, ics, 1))),
            "decoder": (self.decoder.init, key, jnp.zeros((1, fg, fg, fg, nf))),
            "retrieval_backbone": (self.retrieval_backbone.init, key,
                                   jnp.zeros((1, 16, 16, 16, 1))),
            "patched_attention_block": (
                self.patched_attention_block.init, {"params": key, "gumbel": key},
                jnp.zeros((1, fg, fg, fg, nf)), jnp.zeros((self.K, fg, fg, fg, nf))),
        }
        return {name: flax_tree(jax.eval_shape(*args)["params"], port_params[name])
                for name, args in shapes.items()}

    with monkeypatch.context() as m:
        m.setattr(jrt.RefinementTrainer, "_init_params", init_params)
        return jrt.RefinementTrainer(cfg, enable_vis=False, **kw)


def jax_batch(batch: dict) -> dict:
    return {k: jnp.asarray(batch[k]) for k in ("input", "target", "retrieval")}




def flat(tree: Mapping, prefix: str = "") -> dict:
    """A flax tree as {port state_dict key: array in the port's layout},
    keeping its dtype."""
    out = {}
    for name, leaf in tree.items():
        if isinstance(leaf, Mapping):
            out.update(flat(leaf, f"{prefix}{name}."))
            continue
        a = np.asarray(leaf)
        if name == "kernel":
            a = a.transpose(4, 3, 0, 1, 2) if a.ndim == 5 else a.T
        out[prefix + {"kernel": "weight", "scale": "weight"}.get(name, name)] = a
    return out


def perturbed_dataset(src, dst, rng) -> Path:
    """A copy of the synthetic dataset whose targets carry N(0, NOISE)
    (normalised units), with composed retrievals for RETRIEVAL_CKPT on disk
    (chip_smoke.write_composed_retrievals: 4 other scenes' targets)."""
    import chip_smoke
    dst = copy_dataset(src, dst)
    cfg = refinement_config(dst, retrieval_ckpt=RETRIEVAL_CKPT)
    std = cfg["dataset_train"]["target_std"]
    for path in (dst / "sdf_064" / "SynthSet").glob("*.npz"):
        arr = np.load(path)["arr"]
        np.savez(path, arr=(arr + rng.normal(0, NOISE * std, arr.shape)).astype(np.float32))
    chip_smoke.write_composed_retrievals(cfg, rng)
    return dst


@contextlib.contextmanager
def float64(tr):
    """The port trainer's sub-networks in float64 for the block."""
    for net in tr.nets.values():
        net.double()
    try:
        yield
    finally:
        for net in tr.nets.values():
            net.float()


# --------------------------------------------------------------- fixtures


@pytest.fixture(scope="module")
def trainers(synth_superres_root, tmp_path_factory):
    """The port's trainer (its own weights from its seed) and the JAX
    trainer on the same weights, each in its own working directory, on one
    perturbed copy of the dataset with retrievals; a train batch and its
    Gumbel uniform draw, which the JAX attention then uses."""
    tmp = tmp_path_factory.mktemp("refine_parity")
    mp = pytest.MonkeyPatch()
    out = {"jax_results": {}, "port_results": {}, "stepped": {}}
    try:
        data = perturbed_dataset(synth_superres_root, tmp / "data", np.random.default_rng(21))
        cfg = refinement_config(data, no_retrievals=False, retrieval_ckpt=RETRIEVAL_CKPT)
        for tag in ("port", "jax"):
            work = tmp / tag
            work.mkdir()
            out[f"{tag}_dir"], out[f"{tag}_cfg"] = work, dict(cfg)
            with working_dir(work):
                out[tag] = (rt.RefinementTrainer(out["port_cfg"], device="cpu") if tag == "port"
                            else jax_trainer(out["jax_cfg"], out["port"].params(), mp))
        jtr, tr = out["jax"], out["port"]
        out["init"] = copy.deepcopy(tr.params())
        tr.load_params(flax_engine_params(jtr.state.params))
        out["batch"] = collate([tr.train_dataset[0]], 1)
        rows = tr.batch_size * tr.patched_attention_block.num_patch_x ** 3
        u = np.random.default_rng(22).uniform(1e-20, 1.0, (rows, tr.K)).astype(np.float32)
        out["u"] = u
        mp.setattr(jattn, "gumbel_softmax", lambda logits, rng_, tau=1.0, hard=True:
                   _gumbel_with(logits, u, tau, hard))
        yield out
    finally:
        mp.undo()


def port_batch(tr, batch: dict, dtype=torch.float32) -> dict:
    return {k: torch.from_numpy(np.asarray(batch[k])).to(dtype)
            for k in ("input", "target", "retrieval")}


def jax_phase(trainers, phase: int):
    """(loss, aux, gradients, forward_full's outputs for phase 3) of the JAX
    trainer on the fixture's batch in float64 (jax.enable_x64); one jit a
    phase, cached. Phase 3's forward_full outputs are those its loss
    computed (returned as value_and_grad's aux), so the forward is traced
    once."""
    cache = trainers["jax_results"]
    if phase not in cache:
        jtr = trainers["jax"]
        key = jax.random.PRNGKey(0)

        def loss(p, aug):
            outs, forward_full = [], jtr.forward_full

            def recorded(*args):
                outs.append(forward_full(*args))
                return outs[-1]

            jtr.forward_full = recorded
            try:
                total, aux = jtr._phase_loss(phase, p, aug, key)
            finally:
                del jtr.forward_full  # the class's method again
            return total, (aux, tuple(outs[0]) if outs else ())

        def run(params, batch):
            (total, (aux, outs)), grads = jax.value_and_grad(loss, has_aux=True)(
                params, jtr.augment_batch_data(batch))
            return total, aux, grads, outs

        with jax.enable_x64(True):
            params = jax.tree_util.tree_map(lambda a: jnp.asarray(np.asarray(a, np.float64)),
                                            jtr.state.params)
            batch = {k: jnp.asarray(np.asarray(trainers["batch"][k], np.float64))
                     for k in ("input", "target", "retrieval")}
            cache[phase] = jax.device_get(jax.jit(run)(params, batch))
    return cache[phase]


def port_phase(tr, phase: int, batch: dict, u: np.ndarray, dtype=torch.float32):
    """(loss, aux, gradients of the phase's trainable sub-networks) of the
    port's train step in `dtype` without its Adam update (compute_gradients,
    what train_step runs before optimizer.step())."""
    tr.set_phase(phase)
    total, aux = tr.compute_gradients(port_batch(tr, batch, dtype), torch.from_numpy(u))
    return total, aux, tr.gradients()


def port_f32(trainers, phase: int):
    """port_phase in float32 on the fixture's weights, batch and draw: once
    a phase for the module (the fixture's trainer holds the weights that
    `fresh` loads)."""
    cache = trainers["port_results"]
    if phase not in cache:
        cache[phase] = port_phase(trainers["port"], phase, trainers["batch"], trainers["u"])
    return cache[phase]


def largest_share(got, want, scale: float) -> float:
    """max |got - want| as a share of `scale`."""
    diff = np.abs(np.asarray(got, np.float64) - np.asarray(want, np.float64))
    return float(diff.max(initial=0.0)) / scale


# ----------------------------------------------------------- parity tests


def test_forward_full_matches_jax(trainers):
    """forward_full's six outputs against JAX's float64: the port's float64
    within F64_TOL of each output's largest magnitude, its float32 within
    F32_OUT_TOL."""
    tr, u = trainers["port"], torch.from_numpy(trainers["u"])
    want = jax_phase(trainers, 3)[3]
    with torch.no_grad():
        got32 = tr.forward_full(port_batch(tr, trainers["batch"]), u)
        with float64(tr):
            got64 = tr.forward_full(port_batch(tr, trainers["batch"], torch.float64), u)
    names = ("pred_shape", "pred_shape_back", "pred_shape_retr", "fpred", "ftgt", "occupancy")
    for name, g32, g64, w in zip(names, got32, got64, want):
        w = np.asarray(w)
        assert tuple(g32.shape) == w.shape, name
        if w.dtype == bool:
            assert np.array_equal(g32.numpy(), w) and np.array_equal(g64.numpy(), w), name
            continue
        assert g64.dtype == torch.float64 and w.dtype == np.float64
        scale = float(np.abs(w).max())
        np.testing.assert_allclose(g64.numpy(), w, rtol=0, atol=F64_TOL * scale, err_msg=name)
        share = largest_share(g32.numpy(), w, scale)
        assert share <= F32_OUT_TOL, f"{name}: the port's float32 lies {share:.2e} from JAX's"
    assert 0 < int(got32[5].sum()) < got32[5].numel()


def check_phase(trainers, phase: int, x64: bool) -> None:
    """The port's loss, its parts and the gradients of the phase's trainable
    sub-networks against JAX's float64 ones on the same weights, batch and
    Gumbel draw: the port in float64 with x64 (losses 1e-8 relative,
    gradients F64_TOL of each tensor's largest), else in float32 (losses
    RTOL relative, gradients F32_GRAD_TOL[phase] of the sub-network's
    largest)."""
    tr, u = trainers["port"], trainers["u"]
    jtotal, jaux, jgrads, _ = jax_phase(trainers, phase)
    if x64:
        with float64(tr):
            total, aux, grads = port_phase(tr, phase, trainers["batch"], u, torch.float64)
    else:
        total, aux, grads = port_f32(trainers, phase)
    rtol = 1e-8 if x64 else RTOL
    np.testing.assert_allclose(float(total), float(jtotal), rtol=rtol)
    assert sorted(aux) == sorted(jaux)
    for k in jaux:
        np.testing.assert_allclose(float(aux[k]), float(jaux[k]), rtol=rtol, err_msg=k)
    assert sorted(grads) == sorted(rt.PHASE_TRAINABLE[phase])
    for name in grads:
        want = flat(jgrads[name])
        net_scale = max(float(np.abs(w).max(initial=0.0)) for w in want.values())
        for key, w in want.items():
            label = f"phase {phase} {name}.{key}"
            if key not in grads[name]:  # off the loss's path in the port: zero in JAX
                assert not np.any(w), label
                continue
            g = grads[name][key].numpy()
            assert g.dtype == (np.float64 if x64 else np.float32), label
            if x64:
                np.testing.assert_allclose(g, w, rtol=0, atol=F64_TOL * float(np.abs(w).max()),
                                           err_msg=label)
            else:
                share = largest_share(g, w, net_scale)
                assert share <= F32_GRAD_TOL[phase], f"{label}: {share:.2e} of {net_scale:.2e}"


@pytest.mark.parametrize("phase", [3, 0, 1, 2])
def test_phase_loss_and_gradients_match_jax(trainers, phase):
    """Each phase, the port in float32 (phase 3: all four sub-networks and
    the Gumbel path): check_phase."""
    check_phase(trainers, phase, x64=False)


@pytest.mark.parametrize("phase", [3, 0, 1, 2])
def test_phase_float64_matches_jax(trainers, phase):
    """Each phase, the port in float64 (phase 3: all four sub-networks, the
    Gumbel straight-through and every loss term): check_phase. This holds
    the backward pass: a gradient computed another way than JAX's lies far
    outside F64_TOL."""
    check_phase(trainers, phase, x64=True)


def test_value_algebra_matches_jax(trainers):
    """augment_batch_data, loss_shape with n_valid (the second row padded)
    and occupancy_from_prediction, on two items and a seeded prediction."""
    jtr, tr = trainers["jax"], trainers["port"]
    batch = collate([tr.train_dataset[i] for i in range(2)], 2)
    pred = np.random.default_rng(23).uniform(-1, 1, batch["target"].shape).astype(np.float32)
    pred[:, :32] = -0.95  # occupied voxels for the occupancy

    def jfn(b, p):
        aug = jtr.augment_batch_data(b)
        return (aug["weights"], aug["empty"], aug["normals"],
                jtr.loss_shape(p, aug, n_valid=jnp.asarray(1)),
                jtr.occupancy_from_prediction(jtr.network_pred_to_df(p)))

    want = jax.device_get(jax.jit(jfn)(jax_batch(batch), jnp.asarray(pred)))
    aug = tr.augment_batch_data(port_batch(tr, batch))
    pt = torch.from_numpy(pred)
    got = (aug["weights"], aug["empty"], aug["normals"],
           tr.loss_shape(pt, aug, n_valid=torch.tensor(1)),
           tr.occupancy_from_prediction(tr.network_pred_to_df(pt)))
    # normals divide a float32 Sobel sum by sqrt(|sum|² + 1e-5): where the
    # perturbed field is near flat, float32 rounding of the sum moves them
    for name, g, w, atol in zip(("weights", "empty", "normals"), got[:3], want[:3],
                                (0, 0, 1e-3)):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=RTOL, atol=atol, err_msg=name)
    for name, g, w in zip(("total", "l1", "normal"), got[3], want[3]):
        np.testing.assert_allclose(float(g), float(w), rtol=LOSS_RTOL, err_msg=name)
    assert got[4].dtype == torch.bool and tuple(got[4].shape) == (2, 32, 32, 32, 1)
    assert np.array_equal(got[4].numpy(), np.asarray(want[4])) and 0 < int(got[4].sum())


def test_sliced_contrastive_loss_cap_matches_jax(trainers):
    """8 slices of 512 patches with occupied counts [0, 500, 512, 300, 512,
    100, 400, 20]: in slice order the cap of 1280 counts slices 2, 3, 6 and
    8 (500 + 512 + 100 + 20) and skips 4, 5 and 7."""
    jtr, tr = trainers["jax"], trainers["port"]
    rng = np.random.default_rng(24)
    fpred, ftgt = (rng.standard_normal((8 * 512, 32)).astype(np.float32) for _ in range(2))
    occ = np.zeros((8, 512), bool)
    for i, c in enumerate([0, 500, 512, 300, 512, 100, 400, 20]):
        occ[i, rng.permutation(512)[:c]] = True
    counts = occ.sum(1)
    want = float(jax.jit(lambda a, b, o: jtr.compute_sliced_attn_nt_xent_loss(8, a, b, o))(
        fpred, ftgt, occ.reshape(-1)))
    got = float(tr.compute_sliced_attn_nt_xent_loss(
        8, *(torch.from_numpy(a) for a in (fpred, ftgt, occ.reshape(-1)))))
    np.testing.assert_allclose(got, want, rtol=RTOL)
    # the cap's rule, slice by slice, against the loss of every occupied slice
    per_slice = [float(nt_xent_loss_masked(torch.from_numpy(fpred[i * 512:(i + 1) * 512]),
                                           torch.from_numpy(ftgt[i * 512:(i + 1) * 512]),
                                           torch.from_numpy(occ[i]), tr.attn_temperature))
                 for i in range(8)]
    taken, total = [], 0
    for c in counts:
        taken.append(bool(c > 0 and total + c <= 1280))
        total += c if taken[-1] else 0
    assert taken == [False, True, True, False, False, True, False, True]
    np.testing.assert_allclose(got, sum(v for v, t in zip(per_slice, taken) if t), rtol=RTOL)
    assert float(tr.compute_sliced_attn_nt_xent_loss(
        8, torch.from_numpy(fpred), torch.from_numpy(ftgt),
        torch.zeros(8 * 512, dtype=torch.bool))) == 0.0


def test_validate_matches_jax_with_deterministic_attention(trainers, monkeypatch):
    """validate() of both trainers with deterministic selection, at batch 3
    and one batch a split (val: 2 items and a padded row; train_eval: 3
    items): the four metric sets and the logged val losses within LOSS_RTOL
    relative. JAX's Chamfer3D runs its chamfer_batch on each side's buffers
    cut to the next power of two at or above that side's largest point
    count, in place of its 16,384-point capacity: the points past a count
    are masked, so only the order of its tiled sum changes (and the test's
    time)."""
    chamfer_batch = jmetrics.chamfer_batch

    def cut(points, counts):
        most = max(int(np.max(counts)), 1)
        return points[:, :min(1 << (most - 1).bit_length(), points.shape[1])]

    def trimmed(points_a, n_a, points_b, n_b):
        return chamfer_batch(cut(points_a, n_a), n_a, cut(points_b, n_b), n_b)

    monkeypatch.setattr(jmetrics, "chamfer_batch", trimmed)
    records, results = {}, {}
    for tag in ("port", "jax"):
        cfg = dict(trainers[f"{tag}_cfg"], batch_size=3, experiment=f"validate_{tag}")
        with working_dir(trainers[f"{tag}_dir"]):
            if tag == "port":
                tr = rt.RefinementTrainer(cfg, device="cpu", deterministic_attention=True)
                tr.load_params(trainers["init"])
                logger = rt.MetricsLogger(cfg["experiment"])
            else:
                tr = jax_trainer(cfg, trainers["init"], monkeypatch, deterministic_attention=True)
                logger = jrt.MetricsLogger(cfg["experiment"])
            results[tag] = tr.validate(logger, max_batches=1)
            logger.close()
            path = Path("runs", cfg["experiment"], "metrics.jsonl")
            records[tag] = [json.loads(line) for line in path.read_text().splitlines()]
    assert sorted(results["port"]) == ["train_fuse", "train_nn1", "val_fuse", "val_nn1"]
    for key, want in results["jax"].items():
        for m, w in want.items():
            np.testing.assert_allclose(results["port"][key][m], w, rtol=LOSS_RTOL,
                                       err_msg=f"{key}/{m}")
    assert [sorted(r) for r in records["port"]] == [sorted(r) for r in records["jax"]]
    for got, want in zip(records["port"], records["jax"]):
        for k, w in want.items():
            if not k.startswith("_"):
                np.testing.assert_allclose(got[k], w, rtol=LOSS_RTOL, err_msg=k)
    assert np.isfinite(results["port"]["val_fuse"]["cd"])


# ------------------------------------------------------------ port only


def fresh(trainers, **extra) -> rt.RefinementTrainer:
    """A new port trainer on the fixture's weights and data (config
    `extra`), in the port's working directory."""
    cfg = dict(trainers["port_cfg"], **extra)
    with working_dir(trainers["port_dir"]):
        tr = rt.RefinementTrainer(cfg, device="cpu")
    tr.load_params(trainers["init"])
    return tr


def changed_subnets(before: dict, after: dict) -> set:
    return {name for name, sd in after.items()
            if any(not torch.equal(v, before[name][k]) for k, v in sd.items())}


def stepped(trainers, phase: int):
    """(a fresh trainer after one train_step of `phase` on the fixture's
    batch and draw, its parameters before the step, the step's loss and
    parts): the step runs once a phase for the module, and each caller gets
    its own copy of the trainer."""
    cache = trainers["stepped"]
    if phase not in cache:
        tr = fresh(trainers)
        tr.set_phase(phase)
        before = copy.deepcopy(tr.params())
        total, aux = tr.train_step(port_batch(tr, trainers["batch"]), tr.base_lr,
                                   torch.from_numpy(trainers["u"]))
        cache[phase] = (tr, before, total, aux)
    tr, before, total, aux = cache[phase]
    return copy.deepcopy(tr), before, total, aux


@pytest.mark.parametrize("phase", range(4))
def test_step_changes_exactly_the_phase_subnets(trainers, phase):
    tr, before, total, aux = stepped(trainers, phase)
    assert torch.isfinite(total) and all(torch.isfinite(v) for v in aux.values())
    assert changed_subnets(before, tr.params()) == set(rt.PHASE_TRAINABLE[phase])
    trainable = {id(p) for p in tr.trainable_parameters()}
    assert tr.optimizer.state and {id(p) for p in tr.optimizer.state} <= trainable
    for name, net in tr.nets.items():
        assert all(p.requires_grad == (name in rt.PHASE_TRAINABLE[phase])
                   for p in net.parameters())


def test_set_phase_starts_a_fresh_adam(trainers):
    tr = stepped(trainers, 3)[0]
    assert len(tr.optimizer.state) > 0
    for phase in (3, 1):
        tr.set_phase(phase)
        assert not tr.optimizer.state and tr.phase == phase == tr.config["current_phase"]
        group = tr.optimizer.param_groups[0]
        assert group["weight_decay"] == 0.0 and group["lr"] == tr.base_lr
        assert len(group["params"]) == len(tr.trainable_parameters())


def test_lr_milestones_apply_in_phase_3_only(trainers):
    tr = fresh(trainers, scheduler=[1, 2])
    for phase, want in ((0, [1e-4] * 3), (3, [1e-4, 5e-5, 2.5e-5])):
        tr.set_phase(phase)
        assert [tr._current_lr(epoch) for epoch in range(3)] == pytest.approx(want)


def test_remat_gives_the_same_loss_and_gradients(trainers):
    u, batch = trainers["u"], trainers["batch"]
    plain = port_f32(trainers, 3)
    remat = port_phase(fresh(trainers, remat=True), 3, batch, u)
    assert float(remat[0]) == pytest.approx(float(plain[0]), rel=1e-6)
    for name, sd in plain[2].items():
        for k, g in sd.items():
            torch.testing.assert_close(remat[2][name][k], g, rtol=1e-5, atol=1e-7)


def test_mixed_precision_stays_near_float32(trainers):
    """bf16 parameters and batch inside the step: the phase-3 loss and its
    parts within MIXED_TOL["loss"] relative of float32, the decoder's
    gradient at a cosine similarity of at least MIXED_TOL["grad_cos"] to
    float32's, every gradient finite and float32; the parameters stay
    float32 after the step."""
    u, batch = trainers["u"], trainers["batch"]
    f32 = port_f32(trainers, 3)
    tr = fresh(trainers, mixed_precision=True)
    mixed = port_phase(tr, 3, batch, u)
    assert mixed[0].dtype == torch.float32
    assert float(mixed[0]) == pytest.approx(float(f32[0]), rel=MIXED_TOL["loss"])
    for k, v in f32[1].items():
        assert float(mixed[1][k]) == pytest.approx(float(v), rel=MIXED_TOL["loss"]), k
    for name, sd in f32[2].items():
        b = torch.cat([mixed[2][name][k].flatten() for k in sd])
        assert b.dtype == torch.float32 and torch.isfinite(b).all(), name
    a = torch.cat([g.flatten() for g in f32[2]["decoder"].values()])
    b = torch.cat([g.flatten() for g in mixed[2]["decoder"].values()])
    assert float(a @ b / (a.norm() * b.norm())) >= MIXED_TOL["grad_cos"]
    tr.set_phase(3)
    before = copy.deepcopy(tr.params())
    total, _ = tr.train_step(port_batch(tr, batch), tr.base_lr, torch.from_numpy(u))
    assert total.dtype == torch.float32 and changed_subnets(before, tr.params()) == set(rt.SUBNETS)
    assert all(p.dtype == torch.float32 for net in tr.nets.values() for p in net.parameters())


def test_frozen_phase2_cache_step_equals_the_direct_step(trainers):
    """The cache of two train items (on the device, and on the host when it
    exceeds its budget) holds the frozen features; a cached phase-2 step
    equals the direct phase-2 step on the same items: the same loss and the
    same attention parameters after it."""
    cached, direct = fresh(trainers, batch_size=2), fresh(trainers, batch_size=2)
    for tr in (cached, direct):
        tr.set_phase(2)
    cache = cached.build_phase2_cache()
    host = cached.build_phase2_cache(budget_bytes=0)
    n = len(cached.train_dataset)
    assert isinstance(cache, dict) and cache["occ"].shape[0] == n and len(host) == n
    for k, v in cache.items():
        assert np.array_equal(v.numpy(), np.stack([it[k] for it in host])), k
    raw = collate([direct.train_dataset[i] for i in range(2)], 2)
    total_c, _ = cached.train_step({k: v[:2] for k, v in cache.items()}, 1e-4, cached=True)
    total_d, _ = direct.train_step(port_batch(direct, raw), 1e-4)
    assert float(total_c) == pytest.approx(float(total_d), rel=1e-6)
    for name in rt.SUBNETS:
        for k, v in cached.nets[name].state_dict().items():
            torch.testing.assert_close(v, direct.nets[name].state_dict()[k], rtol=1e-6,
                                       atol=1e-8, msg=f"{name}.{k}")


def test_checkpoint_round_trip_with_optimizer_state(trainers, tmp_path):
    tr = stepped(trainers, 3)[0]
    tr.global_step = 7
    with working_dir(tmp_path):
        path = tr.save(5)
        assert {p.name for p in path.iterdir()} == {"params.pt", OPTIM_FILE, "meta.json"}
        for params_only in (False, True):
            other = fresh(trainers)
            other.set_phase(3)
            other.load(path, params_only=params_only)
            assert other.global_step == 7
            assert not changed_subnets(tr.params(), other.params())
            if params_only:
                assert not other.optimizer.state
                continue
            want = tr.optimizer_state()["state"]
            got = other.optimizer_state()["state"]
            assert sorted(got) == sorted(want) and len(got) > 0
            for key, st in want.items():
                for k, v in st.items():
                    assert torch.equal(got[key][k], v), (key, k)
        # a checkpoint without the optimizer file (older port checkpoints)
        old = rt.save_checkpoint(tmp_path / "old", 0, tr.params())
        other.load(old)
        with pytest.raises(FileNotFoundError, match="no optimizer state"):
            other.load(old, params_only=False)
        other.set_phase(1)  # the optimizer state brings its phase along
        other.load(path, params_only=False)
        assert other.phase == 3 and len(other.optimizer.state) == len(want)


def test_resume_from_a_converted_jax_checkpoint(trainers, tmp_path):
    """One Adam step in each package on the same gradients (JAX's phase-3
    gradients), saved (JAX: orbax with its optax state, converted by
    tools/torch_port_ckpt_from_jax.py; port: its own checkpoint), loaded with
    params_only=False, and one more step from each on the same second
    gradients: parameters and moments agree within 1e-6 of each tensor's
    largest magnitude (parameters: plus 1e-5 of the learning rate, Adam's
    first update rounded in another order in each package)."""
    import optax
    from retrieval_fuse_tpu.train import schedule as jsched
    from retrieval_fuse_tpu.train.checkpoint import save_checkpoint as jax_save
    spec = importlib.util.spec_from_file_location(
        "torch_port_ckpt_from_jax", Path(__file__).parents[1] / "tools" /
        "torch_port_ckpt_from_jax.py")
    converter = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(converter)

    jtr, lr = trainers["jax"], 1e-4
    jgrads = jax.tree_util.tree_map(lambda g: jnp.asarray(np.asarray(g, np.float32)),
                                    jax_phase(trainers, 3)[2])
    tx = jtr._tx_by_phase[3]

    @jax.jit
    def jax_step(params, grads):
        updates, opt_state = tx.update(grads, tx.init(params), params)
        return optax.apply_updates(params, jsched.scale_updates_by_lr(updates, lr)), opt_state

    params1, opt1 = jax_step(jtr.state.params, jgrads)
    jpath = jax_save(tmp_path / "jax_run", 0, params1, opt1,
                     extra={"global_step": 1, "phase": 3})
    converted = converter.convert(jpath, tmp_path / "converted")
    assert (converted / OPTIM_FILE).exists()

    def set_grads(tr, tree):
        for name, sd in flax_engine_params(tree).items():
            for k, p in tr.nets[name].named_parameters():
                p.grad = sd[k].clone()

    port = fresh(trainers)
    port.set_phase(3)
    set_grads(port, jax.device_get(jgrads))
    rt.sched.set_lr(port.optimizer, lr)
    port.optimizer.step()
    port.global_step = 1
    with working_dir(tmp_path):
        port_path = port.save(0)
    grads2 = jax.tree_util.tree_map(
        lambda g: np.asarray(g) * 0.5 + 1e-3 * np.sign(np.asarray(g)), jax.device_get(jgrads))
    resumed = {}
    for tag, path in (("converted", converted), ("port", port_path)):
        tr = fresh(trainers)
        tr.set_phase(3)
        tr.load(path, params_only=False)
        assert tr.global_step == 1
        set_grads(tr, grads2)
        rt.sched.set_lr(tr.optimizer, lr)
        tr.optimizer.step()
        resumed[tag] = (tr.params(), tr.optimizer_state()["state"])
    for name, sd in resumed["port"][0].items():
        for k, want in sd.items():
            got = resumed["converted"][0][name][k]
            torch.testing.assert_close(got, want, rtol=0,
                                       atol=1e-6 * float(want.abs().max()) + 1e-5 * lr,
                                       msg=f"{name}.{k}")
    for key, st in resumed["port"][1].items():
        for k, want in st.items():
            got = resumed["converted"][1][key][k]
            torch.testing.assert_close(got, want, rtol=0,
                                       atol=1e-6 * float(want.abs().max()) + 1e-30,
                                       msg=f"{key}.{k}")


def test_phase_chain_writes_checkpoints_and_the_jax_metric_keys(trainers):
    """train_refinement_phases with one epoch a phase and one step an epoch
    (the frozen phase-2 cache on, a 1-batch sanity validation): four
    checkpoints with the optimizer state of their phase (ckpt_epoch=0 is
    each phase's fit's epoch 0, so phase 3's last), metrics.jsonl with the
    JAX trainer's keys; then the CLI's validation-only resume."""
    cfg = dict(trainers["port_cfg"], experiment="phases", current_phase=0,
               phase_change_epochs=[1, 1, 1],
               max_epoch=1, val_check_interval=100, sanity_steps=1, frozen_phase_cache=True)
    with working_dir(trainers["port_dir"]):
        tr = rt.train_refinement_phases(cfg, max_steps_per_epoch=1, device="cpu")
        run = Path("runs", "phases").resolve()
        recs = [json.loads(line) for line in (run / "metrics.jsonl").read_text().splitlines()]
        metas = {e: json.loads((run / f"ckpt_epoch={e}" / "meta.json").read_text())
                 for e in range(4)}
        optims = {e: load_checkpoint(run / f"ckpt_epoch={e}")["opt_state"]["phase"]
                  for e in range(4)}
    assert tr.global_step == 4 and tr.phase == 3
    assert sorted(p.name for p in run.glob("ckpt_epoch=*")) == [
        f"ckpt_epoch={e}" for e in range(4)]
    assert {e: m["phase"] for e, m in metas.items()} == {0: 3, 1: 1, 2: 2, 3: 3} == optims
    assert metas[3]["global_step"] == 4
    train = [r for r in recs if "train/total_loss" in r]
    assert [r["phase"] for r in train] == [0, 1, 2, 3]
    for r in train:
        jaux = jax_phase(trainers, int(r["phase"]))[1]
        assert sorted(r) == sorted(["_time", "_step", "train/total_loss", "phase", "lr",
                                    "epoch", *(f"train/{k}" for k in jaux)])
        assert np.isfinite(r["train/total_loss"])
    val = [r for r in recs if "val_full/shape" in r]
    assert len(val) == 1 and sorted(val[0]) == ["_step", "_time", "val_full/attn_contrastive",
                                                "val_full/l1", "val_full/normal",
                                                "val_full/shape"]


def test_cli_validation_only_resume(trainers, capsys):
    """main --resume <ckpt> --sanity_steps -1: one full validation of the
    checkpoint's weights, no training, with the visualisations."""
    import yaml
    os.environ.pop("experiment", None)
    work = trainers["port_dir"]
    with working_dir(work):
        ckpt = (Path("runs") / "resume_src").resolve()
        src = fresh(trainers, experiment="resume_src")
        path = src.save(0)
        cfg_path = work / "refine.yaml"
        cfg_path.write_text(yaml.safe_dump(trainers["port_cfg"]))
        try:
            tr = rt.main(["--config", str(cfg_path), "--resume", str(path), "--sanity_steps",
                          "-1", "--seed", "3", "--device", "cpu"])
        finally:
            os.environ.pop("experiment", None)
    out = capsys.readouterr().out
    assert "| val   | fuse" in out
    assert tr.global_step == 0 and tr.config["experiment"] == ckpt.name
    # the visualisations are on, as in the JAX CLI: the val_vis meshes (and
    # train_vis's unless disable_train_vis)
    vis = work / "runs" / ckpt.name
    train_vis = not trainers["port_cfg"].get("disable_train_vis", True)
    assert (vis / "vis_train").exists() == train_vis
    meshes = sorted(p.name for p in (vis / "vis_val" / "00000").iterdir())
    assert len(meshes) == 6 and all(m.endswith(("_gt.obj", "_fuse.obj", "_input.obj"))
                                    for m in meshes), meshes
    assert not changed_subnets(src.params(), tr.params())


def test_visualisation_is_refused(trainers):
    """enable_vis (refused before the meshes were ported; the name stays):
    run_visualization("val") writes each val_vis scene's _gt, _fuse and
    _input OBJs under runs/<experiment>/vis_val/<step // 1000>/, identical
    to the JAX SceneHandler's meshes of the JAX dataset's stitched targets,
    inputs and (by its combine_retrievals) the trainer's forward_full
    predictions under VIS_SEED's Gumbel draws."""
    from retrieval_fuse_tpu.data import PatchedSceneDataset as JaxDataset, SceneHandler as JaxScenes
    from retrieval_fuse_tpu_torch.data import batch_iterator
    cfg, tr = trainers["port_cfg"], trainers["port"]
    with working_dir(trainers["port_dir"]):
        assert rt.RefinementTrainer(cfg, device="cpu", enable_vis=True).enable_vis
        out = tr.run_visualization("val")
        assert out == (Path("runs") / cfg["experiment"] / "vis_val"
                       / f"{tr.global_step // 1000:05d}").resolve().relative_to(Path.cwd())
        out = trainers["port_dir"] / out
        jds = JaxDataset("val_vis", cfg["dataset_val"], JaxScenes("val", cfg))
        handler = JaxScenes("val", cfg)
    ds, gen, preds = tr.dataset("val_vis"), tr._generator(rt.VIS_SEED), []
    with torch.no_grad():
        for batch in batch_iterator(ds, tr.batch_size, shuffle=False):
            pred = tr.forward_full(tr._device_batch(batch), tr.gumbel_draw(tr.batch_size, gen))[0]
            preds.append(tr.network_pred_to_df(pred)[: batch["valid"], ..., 0].numpy())
    fused = jds.combine_retrievals(np.concatenate(preds).astype(np.float16)[:, None], 0)
    want = trainers["port_dir"] / "vis_want"
    want.mkdir()
    for scene in jds.scenes:
        handler.visualize_target_chunk(jds.combine_targets()[scene].astype(np.float32),
                                       want / f"{scene}_gt.obj")
        handler.visualize_target_chunk(fused[scene].astype(np.float32), want / f"{scene}_fuse.obj")
        handler.visualize_input_chunk(jds.combine_inputs()[scene].astype(np.float32),
                                      want / f"{scene}_input.obj")
    names = sorted(p.name for p in want.iterdir())
    assert len(names) == 3 * len(jds.scenes) == 6
    assert sorted(p.name for p in out.iterdir()) == names
    for n in names:
        assert (out / n).read_text() == (want / n).read_text(), n


def test_training_selects_by_gumbel_and_serving_deterministically(trainers):
    """The trainer's attention block selects with Gumbel noise, as the JAX
    trainer's does, unless deterministic_attention=True; the serving
    default of models.get_attention_block is deterministic."""
    cfg = trainers["port_cfg"]
    assert not trainers["port"].patched_attention_block.attention_blocks_layer \
        .deterministic_selection
    assert get_attention_block(cfg).attention_blocks_layer.deterministic_selection
    with working_dir(trainers["port_dir"]):
        det = rt.RefinementTrainer(cfg, device="cpu", deterministic_attention=True)
    assert det.patched_attention_block.attention_blocks_layer.deterministic_selection
    assert det.gumbel_draw(1) is None and trainers["port"].gumbel_draw(1).shape == (4096, 2)


def test_chip_smoke_refinement_config_is_the_shapenet_yaml(tmp_path):
    """chip_smoke.py builds its refinement config in code (no YAML on the
    card): it equals the packaged ShapeNetV2 refinement config pointed at
    the data, with retrievals on for the given retrieval checkpoint."""
    import chip_smoke
    from retrieval_fuse_tpu_torch import config as tconfig
    root = str(tmp_path) + "/"
    want = tconfig.read_config(
        tconfig.CONFIG_ROOT / "super_resolution" / "ShapeNetV2" / "refinement_008_064.yaml")
    for d in ("dataset_train", "dataset_val"):
        want[d].update(data_dir=root, scene_dir=root, retrieval_dir=root,
                       dataset_name="SynthSet")
    del want["inherit_from"]  # the YAML's pointer to its base, read by nothing
    want.update(retrieval_ckpt="runs/x/ckpt_epoch=0", no_retrievals=False)
    assert chip_smoke.refinement_config(tmp_path, "runs/x/ckpt_epoch=0") == want
