"""The port's real-data parity harness (retrieval_fuse_tpu_torch/
parity_real.py) on synthetic data, on the CPU, without the reference
implementation: against the JAX package's harness (the root
parity_real.py) where its functions need no reference.

Reference-layout checkpoints are made from the port's seeded weights by
utils/reference_import's export_* (pinned to the JAX package's import:
importing an export gives the weights back). Gate 1: the port's loader and
import against JAX's. Gate 2: the port's dictionary and mapping against the
JAX harness's build_mapping_with_imported_encoder on the same checkpoint,
and compare_mappings against JAX's; the CLI passes on the JAX mapping and
fails on a copy with one neighbour's scene index changed. Gate 3: the JAX
package's forward_full (deterministic attention, on the imported weights)
injected as `reference_forward` passes, and fails when one weight of it is
moved. Gate 4: the metric table equals the JAX package's
batch_occupancy_metrics of the same predictions. Without a reference and
without REFERENCE_ROOT, the forward gate raises, naming the path. The
package's reference_loader.py is the tests' copy.
"""

import json
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

import chip_smoke
import parity_real as jpr
from retrieval_fuse_tpu.config import read_config as jax_read_config
from retrieval_fuse_tpu.data.synthetic import make_synthetic_config
from retrieval_fuse_tpu.evaluation.metrics import batch_occupancy_metrics as jax_metrics
from retrieval_fuse_tpu.utils import torch_import as jti
from retrieval_fuse_tpu_torch import models as tm
from retrieval_fuse_tpu_torch import parity_real as tpr
from retrieval_fuse_tpu_torch.config import read_config
from retrieval_fuse_tpu_torch.models import get_retrieval_networks, init_module_params
from retrieval_fuse_tpu_torch.train.refinement_trainer import SUBNETS
from retrieval_fuse_tpu_torch.utils import reference_import as ri
from test_torch_port_refinement_trainer import flat, jax_trainer
from test_torch_port_retrieval import copy_dataset, working_dir
from test_torch_port_models import torch_threads  # noqa: F401 (autouse fixture)

ROOT = Path(__file__).resolve().parents[1]
K = 2
#: gate 3 against the JAX forward in float32 on the same weights (read:
#: 2.4e-7 df units over the 2 val chunks, of a 0.0625 truncation); the
#: harness's budget is 1e-3
FORWARD_TOL = 1e-6
#: the move of the injected reference's decoder output bias (tanh space):
#: its TSDF moves by up to trunc / 2 · 0.5, far past the 1e-3 budget
BIAS_MOVE = 0.5


def test_reference_loader_is_the_tests_copy():
    """The package's stubs of the reference's native dependencies are
    tests/reference_loader.py, byte for byte."""
    assert (ROOT / "retrieval_fuse_tpu_torch" / "utils" / "reference_loader.py").read_bytes() \
        == (ROOT / "tests" / "reference_loader.py").read_bytes()
    assert str(tpr.REFERENCE_ROOT) == "/root/reference"


@pytest.mark.parametrize("name", ["flagship_config", "superres16_config", "surface_config"])
def test_refinement_export_is_the_reference_layout(name):
    """The port's refinement weights exported to the reference layout: the
    JAX package's import gives them back (each of the three backbones)."""
    cfg = getattr(chip_smoke, name)()
    params = {n: sd for n, sd in tm.init_params(cfg, 1).items() if n in SUBNETS}
    sd = ri.export_refinement_state_dict(params, cfg["task"], cfg["attn_patch_extent"])
    tree = jti.import_refinement_checkpoint(sd, cfg["task"],
                                            cfg["dataset_train"]["input_chunk_size"],
                                            cfg["attn_patch_extent"])
    for n in SUBNETS:
        got = flat(tree[n])
        assert sorted(got) == sorted(params[n]), n
        for key, value in params[n].items():
            np.testing.assert_array_equal(got[key], value.numpy(), err_msg=f"{n}.{key}")


@pytest.mark.parametrize("codes", [("2+1", "16+8"), ("pc_32+8", "16+4"), ("4+2N", "16+8N")])
def test_retrieval_export_is_the_reference_layout(codes):
    """The port's retrieval encoders (MLP, conv, BatchNorm with running
    statistics) exported: the JAX import gives the parameters back, the
    port's import all of it."""
    nets = get_retrieval_networks({"network_input": codes[0], "network_target": codes[1],
                                   "nf_input": 4, "nf_target": 4, "latent_dim": 8})
    rng = np.random.default_rng(3)
    params = {}
    for name, net in zip(("fenc_input", "fenc_target"), nets):
        params[name] = init_module_params(net, rng)
        for key in params[name]:
            if "running" in key:
                params[name][key] = torch.from_numpy(rng.uniform(0.5, 1.5, params[name][key]
                                                                 .shape).astype(np.float32))
    sd = ri.export_retrieval_state_dict(params)
    tree = jti.import_retrieval_checkpoint_auto(sd)
    back = ri.import_retrieval_checkpoint_auto(sd)
    for name, want in params.items():
        got = flat(tree[name])
        assert set(got) == {k for k in want if "running" not in k}, name
        assert sorted(back[name]) == sorted(want), name
        for key, value in want.items():
            if key in got:
                np.testing.assert_array_equal(got[key], value.numpy(), err_msg=key)
            assert torch.equal(back[name][key], value), key


# ------------------------------------------------------------------ fixtures


@pytest.fixture(scope="module")
def harness(synth_superres_root, tmp_path_factory):
    """A copy of the synthetic dataset; the refinement config (nf 4, K 2,
    8³ -> 64³, retrievals off: the val items carry the trunc-filled dummy)
    and the retrieval config (its own 16/8/16 patch geometry); reference
    checkpoints exported from seeded weights; the JAX harness's mapping of
    the val split on them."""
    work = tmp_path_factory.mktemp("port_parity_real")
    data = copy_dataset(synth_superres_root, work / "data")
    cfg = make_synthetic_config(data, task="superresolution")
    cfg.update(nf=4, K=K, batch_size=2, unet_num_level=4, retrieval_fmaps=4,
               retrieval_num_level=4, experiment="parity_real")
    cfg["retrieval_model"].update(nf_input=4, nf_target=4, latent_dim=16)
    cfg["query"]["K"] = K
    cfg["dictionary"]["batch_size"] = cfg["query"]["batch_size"] = 64
    (work / "retrieval.yaml").write_text(yaml.safe_dump(cfg))
    for d in ("dataset_train", "dataset_val"):
        cfg[d].update(patch_size_input=8, patch_context_input=0, patch_size_target=64,
                      patch_context_target=0, patch_stride=64)
    (work / "refinement.yaml").write_text(yaml.safe_dump(cfg))
    rng = np.random.default_rng(4)
    retrieval = {name: init_module_params(net, rng) for name, net in zip(
        ("fenc_input", "fenc_target"), get_retrieval_networks(cfg["retrieval_model"]))}
    refinement = {n: sd for n, sd in tm.init_params(cfg, 5).items() if n in SUBNETS}
    for name, sd in (("retrieval", ri.export_retrieval_state_dict(retrieval)),
                     ("refinement", ri.export_refinement_state_dict(refinement))):
        torch.save({"state_dict": {k: torch.from_numpy(v) for k, v in sd.items()}},
                   work / f"{name}.ckpt")
    rcfg = jax_read_config(work / "retrieval.yaml")
    rcfg["K"] = rcfg["query"]["K"] = K
    with working_dir(work):
        jax_map = jpr.build_mapping_with_imported_encoder(
            rcfg, jti.import_retrieval_checkpoint_auto(jpr.load_torch_state_dict(
                work / "retrieval.ckpt")), "val", work / "jax_tree")
    np.save(work / "jax_map_val.npy", jax_map)
    return dict(work=work, cfg=cfg, refinement=refinement, jax_map=jax_map)


def argv(h: dict, *extra) -> list:
    w = h["work"]
    return ["--config", str(w / "refinement.yaml"), "--retrieval_config",
            str(w / "retrieval.yaml"), "--retrieval_ckpt", str(w / "retrieval.ckpt"),
            "--K", str(K), "--device", "cpu", "--tree_path", str(w / "tree"), *extra]


@pytest.fixture(scope="module")
def jax_forward(harness):
    """The JAX trainer on the harness's refinement weights, deterministic
    attention: (its params, forward(params) -> a reference_forward)."""
    mp = pytest.MonkeyPatch()
    with working_dir(harness["work"]):
        jtr = jax_trainer(dict(harness["cfg"]), harness["refinement"], mp,
                          deterministic_attention=True)
    fwd = jax.jit(lambda p, b: jtr.network_pred_to_df(
        jtr.forward_full(p, b, jax.random.PRNGKey(0))[0]))

    def make(params, record=None):
        def forward(batch):
            out = np.asarray(fwd(params, {k: jnp.asarray(batch[k])
                                          for k in ("input", "target", "retrieval")}))
            if record is not None:
                record.append((out, batch))
            return out
        return forward

    return jtr.state.params, make


# --------------------------------------------------------------------- gates


def test_loader_and_import_match_jax(harness):
    """Gate 1: the checkpoint loader is JAX's, the port's import equals the
    JAX import bridged (flax_to_state_dict) and gives the exported weights
    back."""
    w = harness["work"]
    for name in ("retrieval", "refinement"):
        got, want = tpr.load_torch_state_dict(w / f"{name}.ckpt"), \
            jpr.load_torch_state_dict(w / f"{name}.ckpt")
        assert sorted(got) == sorted(want)
        for key in want:
            np.testing.assert_array_equal(got[key], want[key])
    sd = tpr.load_torch_state_dict(w / "refinement.ckpt")
    params = ri.import_refinement_checkpoint(sd)
    for n in SUBNETS:
        for key, value in harness["refinement"][n].items():
            assert torch.equal(params[n][key], value), f"{n}.{key}"


def test_mapping_and_compare_match_jax(harness):
    """Gate 2: the port's dictionary and val mapping on the imported
    encoder equal the JAX harness's (scene and extent columns, distances
    1e-5); compare_mappings gives JAX's statistics, on the pair and on a
    copy with one row's scene index changed."""
    w, jax_map = harness["work"], harness["jax_map"]
    cfg = read_config(w / "retrieval.yaml")
    cfg["K"] = cfg["query"]["K"] = K
    params = ri.import_retrieval_checkpoint_auto(tpr.load_torch_state_dict(w / "retrieval.ckpt"))
    with working_dir(w):
        ours = tpr.build_mapping_with_imported_encoder(cfg, params, "val", w / "port_tree", "cpu")
    assert sorted(ours) == sorted(jax_map) and len(ours) > 0
    np.testing.assert_allclose(np.load(w / "port_tree" / "database.npy"),
                               np.load(w / "jax_tree" / "database.npy"), atol=1e-5)
    altered = dict(jax_map)
    first = sorted(jax_map)[0]
    altered[first] = jax_map[first].copy()
    altered[first][0, 0] += 1
    for ref in (jax_map, altered):
        got = tpr.compare_mappings(ours, ref, K, 1e-4)
        want = jpr.compare_mappings(ours, ref, K, 1e-4)
        for key, value in want.items():
            if isinstance(value, float):
                np.testing.assert_allclose(got[key], value, rtol=1e-12, err_msg=key)
            else:
                assert got[key] == value, key
    assert tpr.compare_mappings(ours, jax_map, K, 1e-4)["topk_match_rate"] == 1.0
    assert tpr.compare_mappings(ours, altered, K, 1e-4)["first_mismatch_patch"] == first


def test_compare_mappings_gates_distances():
    """A row whose scene and extent columns agree but whose distance lies
    beyond dist_atol does not match (the JAX harness only reports the
    distances)."""
    row = np.array([[1, 0, 16, 0, 16, 0, 16, 0.25], [2, 0, 16, 0, 16, 0, 16, 0.5]])
    moved = row.copy()
    moved[1, 7] += 1e-3
    stats = tpr.compare_mappings({"a": row}, {"a": moved}, 2, 1e-4)
    assert stats["topk_match_rate"] == 0.5 and stats["first_mismatch_patch"] == "a"
    assert jpr.compare_mappings({"a": row}, {"a": moved}, 2, 1e-4)["topk_match_rate"] == 1.0


def test_cli_passes_with_the_jax_forward_and_map(harness, jax_forward):
    """Every gate on: the JAX mapping as the reference map (match rate 1.0)
    and the JAX forward as the reference (TSDF MAE within FORWARD_TOL);
    gate 4's table is the JAX batch_occupancy_metrics of the same
    predictions; exit 0."""
    params, make = jax_forward
    w, seen = harness["work"], []
    with working_dir(w):
        rc = tpr.main(argv(harness, "--refinement_ckpt", str(w / "refinement.ckpt"),
                           "--reference_map", str(w / "jax_map_val.npy"), "--n_chunks", "4",
                           "--out", str(w / "report.json")), reference_forward=make(params, seen))
    report = json.loads((w / "report.json").read_text())
    assert rc == 0 and report["ok"] and report["topk"]["topk_match_rate"] == 1.0
    # the val split's two chunks, one batch of the CLI's batch size 2
    assert report["forward"]["chunks"] == 2 == sum(b["valid"] for _, b in seen)
    assert report["forward"]["tsdf_mae"] <= FORWARD_TOL, report["forward"]
    thr = float(np.float16(harness["cfg"]["dataset_val"]["voxel_size_target"])) * 0.75
    sums = np.zeros(6)
    for out, batch in seen:
        target = np.asarray(batch["target"]) * harness["cfg"]["dataset_val"]["target_std"] \
            + harness["cfg"]["dataset_val"]["target_mean"]
        m = jax.device_get(jax_metrics(jnp.asarray(out[:batch["valid"]]),
                                       jnp.asarray(target[:batch["valid"]]), thr))
        for j, key in enumerate(("iou", "precision", "recall")):
            sums[2 * j: 2 * j + 2] += np.asarray(m[key], np.float64)
    for j, key in enumerate(("iou", "precision", "recall")):
        want = sums[2 * j] / max(sums[2 * j + 1], 1e-9)
        np.testing.assert_allclose(report["forward"]["metrics"]["reference"][key], want,
                                   rtol=1e-6, err_msg=key)


def test_forward_gate_fails_on_a_moved_reference_weight(harness, jax_forward):
    """Gate 3 with the injected JAX forward whose decoder output bias is
    moved by BIAS_MOVE: the MAE passes the budget and the CLI exits 1."""
    params, make = jax_forward
    moved = jax.tree_util.tree_map(lambda a: a, params)
    bias = moved["decoder"]["final_conv"]["bias"]
    moved["decoder"]["final_conv"]["bias"] = bias + BIAS_MOVE
    w = harness["work"]
    with working_dir(w):
        rc = tpr.main(argv(harness, "--refinement_ckpt", str(w / "refinement.ckpt"),
                           "--out", str(w / "report_moved.json")),
                      reference_forward=make(moved))
    report = json.loads((w / "report_moved.json").read_text())
    assert rc == 1 and not report["ok"] and report["forward"]["tsdf_mae"] > 1e-3
    assert "topk" not in report  # no --reference_map: the identity gate is off


def test_topk_gate_fails_on_a_swapped_index(harness):
    """Gate 2 alone: the JAX mapping with one neighbour's scene index
    changed; the CLI exits 1 and names the patch."""
    w, jax_map = harness["work"], harness["jax_map"]
    altered = dict(jax_map)
    first = sorted(jax_map)[0]
    altered[first] = jax_map[first].copy()
    altered[first][0, 0] += 1
    np.save(w / "altered.npy", altered)
    with working_dir(w):
        rc = tpr.main(argv(harness, "--reference_map", str(w / "altered.npy"),
                           "--out", str(w / "report_altered.json")))
    report = json.loads((w / "report_altered.json").read_text())
    assert rc == 1 and not report["ok"]
    assert report["topk"]["topk_match_rate"] < 1.0
    assert report["topk"]["first_mismatch_patch"] == first


def test_forward_gate_without_a_reference_raises_naming_it(harness, monkeypatch, tmp_path):
    """No reference_forward and no reference implementation: the forward
    gate raises FileNotFoundError naming the path; it neither skips nor
    passes."""
    missing = tmp_path / "absent_reference"
    monkeypatch.setattr(tpr, "REFERENCE_ROOT", missing)
    w = harness["work"]
    with working_dir(w), pytest.raises(FileNotFoundError, match=str(missing)):
        tpr.main(argv(harness, "--refinement_ckpt", str(w / "refinement.ckpt"),
                      "--out", str(tmp_path / "report.json")))
    assert not (tmp_path / "report.json").exists()


def test_cli_flags_are_the_jax_harness_and_device(capsys):
    """The same flags as the JAX harness's CLI, and --device."""
    def flags(fn) -> set:
        with pytest.raises(SystemExit):
            fn(["--help"])
        text = capsys.readouterr().out
        return {t.strip("[],") for t in text.split() if t.startswith(("--", "[--"))}

    assert flags(tpr.parse_arguments) == flags(jpr.main) | {"--device"}


def test_harness_imports_without_jax():
    """With jax, flax and PyYAML blocked, the harness and its reference
    loader import, and no module of the JAX package is loaded."""
    code = ("import sys\n"
            "sys.modules['jax'] = sys.modules['flax'] = sys.modules['yaml'] = None\n"
            "import retrieval_fuse_tpu_torch.parity_real\n"
            "import retrieval_fuse_tpu_torch.utils.reference_loader\n"
            "bad = [m for m in sys.modules if m.split('.')[0] == 'retrieval_fuse_tpu']\n"
            "assert not bad, bad\n"
            "print('ok')\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         env=dict(os.environ, PYTHONPATH=str(ROOT)), cwd=ROOT, timeout=120)
    assert out.returncode == 0 and out.stdout.strip() == "ok", out.stderr
