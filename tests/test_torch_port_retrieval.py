"""The port's retrieval pipeline (config, data layer, conv encoders,
checkpoint, dictionary, kNN map, compose, evaluate) against the JAX
package's, on the CPU, at the tiny synthetic geometry of the session
fixture `synth_superres_root` (nf 4, latent 16, K = 2).

The round trip initialises both encoders in flax, saves them with the JAX
`save_checkpoint`, converts them with tools/torch_port_ckpt_from_jax.py and
runs both CLIs' `map compose evaluate` on two copies of the dataset. It
holds database.npy to atol 1e-5 and index.json equal; the mappings' scene
and extent columns exactly and their distances to 1e-5, where a patch whose
neighbours differ must be a near-tie (its distances agree to 1e-5 all the
same: float32 scores in another summation order can swap two neighbours
1e-6 apart). So that such a swap does not reach the later stages, the
port's `compose evaluate` runs on the JAX mappings: the composed volumes
must then be equal, and the metrics agree to 1e-6 relative (float32
reductions in another order).
"""

import ast
import contextlib
import importlib.util
import io
import json
import os
import shutil
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

from retrieval_fuse_tpu import config as jconfig
from retrieval_fuse_tpu.data import loader as jloader
from retrieval_fuse_tpu.data import synthetic as jsynth
from retrieval_fuse_tpu.data.patched_dataset import PatchedSceneDataset as JaxDataset
from retrieval_fuse_tpu.data.scene import SceneHandler as JaxSceneHandler
from retrieval_fuse_tpu.models import get_retrieval_networks as jax_retrieval_networks
from retrieval_fuse_tpu.models.encoders import CONV_SPECS, make_encoder as jax_make_encoder
from retrieval_fuse_tpu.ops.knn import demote_same_scene as jax_demote
from retrieval_fuse_tpu.retrieval import cli as jcli
from retrieval_fuse_tpu.train.checkpoint import save_checkpoint as jax_save_checkpoint
from retrieval_fuse_tpu.utils import misc as jmisc
from retrieval_fuse_tpu_torch import config as tconfig
from retrieval_fuse_tpu_torch import models as tm
from retrieval_fuse_tpu_torch.data import loader as tloader
from retrieval_fuse_tpu_torch.data import synthetic as tsynth
from retrieval_fuse_tpu_torch.data.patched_dataset import PatchedSceneDataset
from retrieval_fuse_tpu_torch.data.scene import SceneHandler
from retrieval_fuse_tpu_torch.ops.knn import demote_same_scene
from retrieval_fuse_tpu_torch.retrieval import cli as tcli
from retrieval_fuse_tpu_torch.retrieval.engine import RetrievalInterface
from retrieval_fuse_tpu_torch.train import checkpoint as tckpt
from retrieval_fuse_tpu_torch.utils import misc as tmisc
from retrieval_fuse_tpu_torch.utils.flax_import import flax_to_state_dict
from test_torch_port_models import flax_apply, flax_params
from test_torch_port_models import torch_threads  # noqa: F401 (autouse fixture)

ROOT = Path(__file__).resolve().parents[1]
YAMLS = sorted(str(p.relative_to(jconfig.CONFIG_ROOT))
               for p in jconfig.CONFIG_ROOT.rglob("*.yaml"))
MODEL = {"nf_input": 4, "nf_target": 4, "latent_dim": 16}
K = 2


def copy_dataset(src, dst) -> Path:
    """The scenes and splits of a synthetic dataset, without the caches and
    artifacts that other runs wrote beside them."""
    for sub in ("sdf_008", "sdf_064", "splits"):
        shutil.copytree(Path(src) / sub, Path(dst) / sub)
    return Path(dst)


@contextlib.contextmanager
def working_dir(path):
    old = os.getcwd()
    os.chdir(path)
    try:
        yield
    finally:
        os.chdir(old)


def load_converter():
    spec = importlib.util.spec_from_file_location(
        "torch_port_ckpt_from_jax", ROOT / "tools" / "torch_port_ckpt_from_jax.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def printed_metrics(text: str) -> list:
    """The [iou, cd, precision, recall] line that `evaluate` prints."""
    for line in reversed(text.splitlines()):
        if line.startswith("[") and not line.startswith("[np_"):
            return ast.literal_eval(line)
    raise AssertionError(f"no metric line in {text!r}")


# ------------------------------------------------------------ config, data


@pytest.mark.parametrize("rel", YAMLS)
def test_read_config_matches_jax(rel):
    """Each package reads its own YAML tree, the port's a byte-for-byte
    copy, to the same config."""
    assert tconfig.CONFIG_ROOT != jconfig.CONFIG_ROOT
    mine, theirs = tconfig.CONFIG_ROOT / rel, jconfig.CONFIG_ROOT / rel
    assert mine.read_bytes() == theirs.read_bytes()
    args = {"K": 3, "seed": -100, "experiment": None, "new_key": 1}
    assert tconfig.read_config(mine) == jconfig.read_config(theirs)
    assert tconfig.read_config(mine, args) == jconfig.read_config(theirs, args)


@pytest.mark.parametrize("task", ["superresolution", "surface_reconstruction"])
def test_make_synthetic_config_matches_jax(task, tmp_path):
    over = {"dataset": {"patch_stride": 8}, "K": 3}
    assert tsynth.make_synthetic_config(tmp_path, task, base_overrides=over) == \
        jsynth.make_synthetic_config(tmp_path, task, base_overrides=over)


def test_synthetic_dataset_matches_jax(tmp_path):
    kw = dict(n_train=2, n_val=1, target_res=16, input_res=4, seed=5)
    want = jsynth.generate_synthetic_dataset(tmp_path / "j", **kw)
    got = tsynth.generate_synthetic_dataset(tmp_path / "t", **kw)
    assert {k: v for k, v in got.items() if k != "root"} == \
        {k: v for k, v in want.items() if k != "root"}
    files = sorted(p.relative_to(tmp_path / "j") for p in (tmp_path / "j").rglob("*.*"))
    assert files == sorted(p.relative_to(tmp_path / "t") for p in (tmp_path / "t").rglob("*.*"))
    for f in files:
        if f.suffix == ".npz":
            np.testing.assert_array_equal(np.load(tmp_path / "t" / f)["arr"],
                                          np.load(tmp_path / "j" / f)["arr"])
        else:
            assert (tmp_path / "t" / f).read_text() == (tmp_path / "j" / f).read_text()


def test_misc_helpers_match_jax(tmp_path):
    cfg = jsynth.make_synthetic_config(tmp_path)
    cfg["retrieval_ckpt"] = "runs/exp_a/ckpt_epoch=3"
    cfg["K"] = 4
    assert tmisc.get_retrievals_dir(cfg) == jmisc.get_retrievals_dir(cfg)
    assert tmisc.get_tree_path(cfg) == jmisc.get_tree_path(cfg)
    (tmp_path / "l.txt").write_text("a\n\n b \nc\n")
    assert tmisc.read_list(tmp_path / "l.txt") == jmisc.read_list(tmp_path / "l.txt")
    rng = np.random.default_rng(0)
    mask = rng.random((5, 6, 7)) < 0.3
    np.testing.assert_array_equal(tmisc.to_point_list(mask), jmisc.to_point_list(mask))
    pc = rng.uniform(-1, 40, (200, 3)).astype(np.float32)
    np.testing.assert_array_equal(tmisc.point_cloud_to_grid(pc, 16, 0.5, 2),
                                  jmisc.point_cloud_to_grid(pc, 16, 0.5, 2))


@pytest.mark.parametrize("split", ["train", "val"])
def test_scene_handler_and_dataset_match_jax(split, synth_superres_root, tmp_path):
    """Caches, extents, items and batch order, each package on its own copy
    of the data so that each computes its own caches."""
    cfgs = []
    for tag in ("j", "t"):
        cfg = jsynth.make_synthetic_config(copy_dataset(synth_superres_root, tmp_path / tag))
        cfgs.append(cfg)
    jsh, tsh = JaxSceneHandler(split, cfgs[0]), SceneHandler(split, cfgs[1])
    assert tsh.scene_size == jsh.scene_size and tsh.scene_occupancy == jsh.scene_occupancy
    for attr in ("input_trunc", "target_trunc", "input_voxel_size", "target_voxel_size",
                 "patch_stride_input", "scale_factor"):
        assert getattr(tsh, attr) == getattr(jsh, attr)
    for sub in ("size", "occupancy"):
        jfiles = sorted((tmp_path / "j" / sub).iterdir())
        assert [f.name for f in jfiles] == [f.name for f in sorted((tmp_path / "t" / sub).iterdir())]
        for f in jfiles:
            assert json.loads((tmp_path / "t" / sub / f.name).read_text()) == \
                json.loads(f.read_text())
    scene = jsh.scenes[0]
    for a, b in zip(tsh.get_scene_patches(scene), jsh.get_scene_patches(scene)):
        np.testing.assert_array_equal(a, b)
    for a, b in zip(tsh.create_scene_volume_from_extents(scene),
                    jsh.create_scene_volume_from_extents(scene)):
        np.testing.assert_array_equal(a, b)

    jds = JaxDataset(split, cfgs[0][f"dataset_{split}"], jsh)
    tds = PatchedSceneDataset(split, cfgs[1][f"dataset_{split}"], tsh)
    assert len(tds) == len(jds) and tds.scenes == jds.scenes
    assert [(d[0], list(d[1]), list(d[2])) for d in tds.data] == \
        [(d[0], list(d[1]), list(d[2])) for d in jds.data]
    assert tds.patch_from_scene_lookup == jds.patch_from_scene_lookup
    for i in np.random.default_rng(1).choice(len(jds), 6, replace=False):
        want, got = jds[int(i)], tds[int(i)]
        assert got.keys() == want.keys()
        for key in want:
            if isinstance(want[key], np.ndarray):
                assert got[key].dtype == want[key].dtype
                np.testing.assert_array_equal(got[key], want[key])
            else:
                assert got[key] == want[key]
    want = jds.combine_targets()
    for ss, arr in tds.combine_targets().items():
        np.testing.assert_array_equal(arr, want[ss])

    for kw in (dict(), dict(shuffle=True, seed=3, drop_last=True),
               dict(shuffle=True, seed=4, process_index=1, process_count=3)):
        want = [(b["name"], b["valid"], b["extent"]) for b in
                jloader.batch_iterator(jds, 7, prefetch=0, **kw)]
        got = [(b["name"], b["valid"], b["extent"]) for b in
               tloader.batch_iterator(tds, 7, **kw)]
        assert [g[:2] for g in got] == [w[:2] for w in want]
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g[2], w[2])


# -------------------------------------------------------- encoders, kNN


#: the patch side each conv spec collapses to 1³ (its reference patch size)
CONV_SIDES = {"Patch32": 32, "Patch08": 8, "Patch16": 16, "Patch24": 24, "Patch24V2": 24,
              "Patch12": 12, "PCPatch32": 32, "PCPatch48": 48, "PCPatch64": 64}


@pytest.mark.parametrize("name", sorted(CONV_SPECS))
def test_conv_encoder_matches_flax(name):
    side = CONV_SIDES[name]
    x = np.random.default_rng(2).standard_normal((2, side, side, side, 1)).astype(np.float32)
    flax_mod = jax_make_encoder(name, 4, 16)
    params = flax_params(flax_mod, x)
    want = flax_apply(flax_mod, params, x)
    port = tm.make_encoder(name, 4, 16)
    port.load_state_dict(flax_to_state_dict(params))
    with torch.no_grad():
        got = port.eval()(torch.from_numpy(x)).numpy()
    assert got.shape == want.shape == (2, 1, 1, 1, 16)
    np.testing.assert_allclose(got, want, atol=1e-5)


def test_retrieval_networks_match_jax_factory():
    cfg = {"network_input": "2+1", "network_target": "16+8", **MODEL}
    fi, ft = tm.get_retrieval_networks(cfg)
    assert isinstance(fi, tm.MLPPatchEncoder) and isinstance(ft, tm.ConvPatchEncoder)
    ji, jt = jax_retrieval_networks(cfg)
    assert ji.name == "Patch04" and jt.name == "Patch32"
    assert tm.get_retrieval_networks({**cfg, "network_target": "none"})[1] is None
    # the BatchNorm code: Patch32 with BatchNorm, as JAX's PatchNorm32
    bn = tm.get_retrieval_networks({**cfg, "network_target": "16+8N"})[1]
    assert isinstance(bn, tm.ConvPatchEncoder) and bn.use_batchnorm
    assert jax_retrieval_networks({**cfg, "network_target": "16+8N"})[1].name == "PatchNorm32"


def test_demote_same_scene_matches_jax():
    """Stable: same-scene hits go behind the others in distance order, ties
    (equal distances) keep their order."""
    rng = np.random.default_rng(3)
    q, k2, n = 50, 8, 40
    top_idx = np.stack([rng.choice(n, k2, replace=False) for _ in range(q)]).astype(np.int32)
    sq_d = np.sort(np.round(rng.uniform(0, 2, (q, k2)), 1), axis=1).astype(np.float32)
    db_scene = rng.integers(-1, 5, n).astype(np.int32)
    q_scene = rng.integers(-2, 5, q).astype(np.int32)
    want = jax_demote(jnp.asarray(top_idx), jnp.asarray(sq_d), jnp.asarray(db_scene),
                      jnp.asarray(q_scene), k2 // 2)
    got = demote_same_scene(*(torch.from_numpy(a) for a in (top_idx, sq_d, db_scene, q_scene)),
                            k2 // 2)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def test_retrieval_entry_points_default_to_cuda(synth_superres_root, tmp_path):
    """The retrieval CLI, the retrieval trainer and its CLI, and serving
    from artifacts and its CLI raise without CUDA unless the CPU is asked
    for, before they read or write anything else."""
    if torch.cuda.is_available():
        pytest.skip("this host has CUDA: the default device is the card")
    from retrieval_fuse_tpu_torch import serve as tserve
    from retrieval_fuse_tpu_torch.train import retrieval_trainer as trt
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        RetrievalInterface({"K": 2, "batch_size": 8}, 16)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tcli.retrievals_to_disk("evaluate", {})
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        trt.RetrievalTrainer({})
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tserve.build_engine_from_artifacts({}, "runs/x/ckpt_epoch=0", "runs/y/ckpt_epoch=0")
    cfg_path = tmp_path / "cfg.yaml"
    cfg_path.write_text(yaml.safe_dump(jsynth.make_synthetic_config(synth_superres_root)))
    os.environ.pop("experiment", None)
    with working_dir(tmp_path), pytest.raises(RuntimeError, match="CUDA is not available"):
        trt.main(["--config", str(cfg_path), "--seed", "1"])
    os.environ.pop("experiment", None)
    assert not (tmp_path / "runs").exists()
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tserve.main(["--config", str(cfg_path), "--retrieval_ckpt", "runs/x/ckpt_epoch=0",
                     "--refinement_ckpt", "runs/y/ckpt_epoch=0", "--input", str(tmp_path),
                     "--output", str(tmp_path / "out")])


# ------------------------------------------------------------ round trip


@pytest.fixture(scope="module")
def roundtrip(synth_superres_root, tmp_path_factory):
    """Both CLIs' `map compose evaluate` on two copies of the dataset, with
    the same flax-initialised encoders."""
    tmp = tmp_path_factory.mktemp("port_roundtrip")
    out = {}
    params = {}
    for key, net in zip(("fenc_input", "fenc_target"),
                        jax_retrieval_networks({"network_input": "2+1",
                                                "network_target": "16+8", **MODEL})):
        side = 4 if key == "fenc_input" else 32
        params[key] = jax.jit(net.init)(jax.random.PRNGKey(len(key)),
                                        jnp.zeros((1, side, side, side, 1)))["params"]
    for tag in ("jax", "port"):
        work = tmp / tag
        data = copy_dataset(synth_superres_root, work / "data")
        cfg = jsynth.make_synthetic_config(data)
        cfg["retrieval_model"].update(MODEL)
        cfg["dictionary"]["batch_size"] = 64  # ~300 patches: less padding for XLA's CPU convs
        (work / "cfg.yaml").write_text(yaml.safe_dump(cfg))
        with working_dir(work):
            jax_ckpt = jax_save_checkpoint(Path("runs/rt"), 0, params)
            cfg.update(K=K, retrieval_ckpt=str(work / "runs/rt/ckpt_epoch=0"))
            rec = out[tag] = dict(tree=work / jmisc.get_tree_path(cfg),
                                  retrievals=jmisc.get_retrievals_dir(cfg), cfg=cfg)
            argv = ["--config", str(work / "cfg.yaml"), "--K", str(K)]
            buf = io.StringIO()
            if tag == "jax":
                with contextlib.redirect_stdout(buf):
                    jcli.main(argv + ["--retrieval_ckpt", str(jax_ckpt),
                                      "--mode", "map", "compose", "evaluate"])
            else:
                ckpt = load_converter().convert(jax_ckpt, work / "port_runs" / "rt")
                out["jax_ckpt"], out["ckpt"] = jax_ckpt, ckpt
                argv += ["--retrieval_ckpt", str(ckpt), "--device", "cpu"]
                tcli.main(argv + ["--mode", "map"])
                for split in ("train", "val"):  # keep the port's maps, compose from JAX's
                    name = f"map_{split}.npy"
                    os.replace(rec["retrievals"] / name, rec["retrievals"] / f"port_{name}")
                    shutil.copy(out["jax"]["retrievals"] / name, rec["retrievals"] / name)
                with contextlib.redirect_stdout(buf):
                    tcli.main(argv + ["--mode", "compose", "evaluate"])
            rec["metrics"] = printed_metrics(buf.getvalue())
    return out


def test_roundtrip_checkpoint_conversion(roundtrip):
    """The converted checkpoint keeps the experiment and epoch names, loads
    into the port's encoders, and the orbax original is refused with the
    converter named."""
    ckpt = roundtrip["ckpt"]
    assert ckpt.name == "ckpt_epoch=0" and ckpt.parent.name == "rt"
    assert tckpt.latest_checkpoint(ckpt.parent) == ckpt
    fi, ft = tm.get_retrieval_networks({"network_input": "2+1", "network_target": "16+8",
                                        **MODEL})
    fi.load_state_dict(tckpt.load_subnet_params(ckpt, "fenc_input"))
    ft.load_state_dict(tckpt.load_subnet_params(ckpt, "fenc_target"))
    with pytest.raises(KeyError):
        tckpt.load_subnet_params(ckpt, "unet_backbone")
    with pytest.raises(ValueError, match="torch_port_ckpt_from_jax"):
        tckpt.load_checkpoint(roundtrip["jax_ckpt"])


def test_roundtrip_dictionary_matches_jax(roundtrip):
    j, p = roundtrip["jax"]["tree"], roundtrip["port"]["tree"]  # the JAX addressing
    want, got = np.load(j / "database.npy"), np.load(p / "database.npy")
    assert got.shape == want.shape and got.dtype == want.dtype
    np.testing.assert_array_equal(got[:, :7], want[:, :7])
    np.testing.assert_allclose(got, want, atol=1e-5)
    for name in ("index.json", "params.json"):
        assert json.loads((p / name).read_text()) == json.loads((j / name).read_text())


def near_ties(roundtrip) -> dict:
    """{split: patch names whose K neighbours differ between the packages}."""
    out = {}
    for split in ("train", "val"):
        want = np.load(roundtrip["jax"]["retrievals"] / f"map_{split}.npy", allow_pickle=True)[()]
        got = np.load(roundtrip["port"]["retrievals"] / f"port_map_{split}.npy",
                      allow_pickle=True)[()]
        assert got.keys() == want.keys()
        out[split] = []
        for name, w in want.items():
            g = got[name]
            assert g.shape == w.shape == (K, 8) and g.dtype == w.dtype == np.float64
            np.testing.assert_allclose(g[:, 7], w[:, 7], atol=1e-5)
            if not np.array_equal(g[:, :7], w[:, :7]):
                out[split].append(name)
    return out


def test_roundtrip_mapping_matches_jax(roundtrip):
    ties = near_ties(roundtrip)
    n = sum(len(np.load(roundtrip["jax"]["retrievals"] / f"map_{s}.npy",
                        allow_pickle=True)[()]) for s in ties)
    assert sum(len(v) for v in ties.values()) <= max(2, n // 100), ties


def test_roundtrip_compose_matches_jax(roundtrip):
    jdir, pdir = (roundtrip[t]["retrievals"] / "compose" for t in ("jax", "port"))
    files = sorted(f.name for f in jdir.glob("*.npz"))
    assert files == sorted(f.name for f in pdir.glob("*.npz")) and len(files) == 8
    for f in files:
        want, got = np.load(jdir / f)["arr_0"], np.load(pdir / f)["arr_0"]
        assert got.shape == want.shape == (K, 64, 64, 64) and got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)


def test_roundtrip_retrieval_interface_matches_jax_compose(roundtrip):
    cfg = roundtrip["port"]["cfg"]
    ds_train = PatchedSceneDataset("train", cfg["dataset_train"], SceneHandler("train", cfg))
    ds_val = PatchedSceneDataset("val", cfg["dataset_val"], SceneHandler("val", cfg))
    mapping = np.load(roundtrip["jax"]["retrievals"] / "map_val.npy", allow_pickle=True)[()]
    got = RetrievalInterface.retrieve_nearest_scenes_for_all(
        mapping, ds_val.scenes, K, roundtrip["port"]["tree"], ds_train, ds_val)
    jdir = roundtrip["jax"]["retrievals"] / "compose"
    np.testing.assert_array_equal(
        got, np.stack([np.load(jdir / f"{s}.npz")["arr_0"] for s in ds_val.scenes]))


def test_roundtrip_metrics_match_jax(roundtrip):
    want, got = roundtrip["jax"]["metrics"], roundtrip["port"]["metrics"]
    assert len(got) == len(want) == 4 and all(np.isfinite(got))
    np.testing.assert_allclose(got, want, rtol=1e-6)


# ------------------------------------------------------------ chip_smoke.py


def test_chip_smoke_retrieval_config_is_the_shapenet_yaml(tmp_path):
    """chip_smoke.py builds its config in code (no YAML on the card): it
    equals the packaged ShapeNetV2 retrieval config pointed at the data, as
    the retrieval CLI resolves it with --K 4."""
    import chip_smoke
    root = str(tmp_path) + "/"
    want = tconfig.read_config(
        tconfig.CONFIG_ROOT / "super_resolution" / "ShapeNetV2" / "retrieval_008_064.yaml")
    for d in ("dataset_train", "dataset_val"):
        want[d].update(data_dir=root, scene_dir=root, retrieval_dir=root,
                       dataset_name="SynthSet", splits_dir="main")
    want.update(retrieval_ckpt="runs/x/ckpt_epoch=0", K=4)
    del want["inherit_from"]  # the YAML's pointer to its base, read by nothing
    want["query"]["K"] = 4
    assert chip_smoke.retrieval_config(tmp_path, "runs/x/ckpt_epoch=0") == want


def test_chip_smoke_patch_occupancy_counts_dictionary_rows(synth_superres_root, tmp_path):
    """The rows chip_smoke.py expects each train chunk to give equal the
    train patches of the data layer."""
    import chip_smoke
    cfg = jsynth.make_synthetic_config(copy_dataset(synth_superres_root, tmp_path))
    ds = PatchedSceneDataset("train", cfg["dataset_train"], SceneHandler("train", cfg))
    targets = torch.stack([torch.from_numpy(np.load(
        tmp_path / "sdf_064" / "SynthSet" / f"{s}.npz")["arr"]) for s in ds.scenes])
    got = chip_smoke.patch_occupancy(targets, cfg["dataset_train"]["voxel_size_target"])
    assert got.tolist() == [len(ds.patch_from_scene_lookup[s]) for s in ds.scenes]
    assert 0 < int(got.sum()) < 64 * len(ds.scenes)


def test_chip_smoke_serving_config_is_the_shapenet_yamls(tmp_path):
    """chip_smoke.py's serving config: its retrieval config with the
    refinement networks of the packaged ShapeNetV2 refinement config, merged
    as data/synthetic.make_synthetic_config merges the two YAMLs."""
    import chip_smoke
    got = chip_smoke.serving_config(tmp_path, "runs/x/ckpt_epoch=0")
    refine = tconfig.read_config(
        tconfig.CONFIG_ROOT / "super_resolution" / "ShapeNetV2" / "refinement_008_064.yaml")
    retrieval = chip_smoke.retrieval_config(tmp_path, "runs/x/ckpt_epoch=0")
    added = {k: v for k, v in got.items() if k not in retrieval}
    assert added and all(refine[k] == v for k, v in added.items())
    assert {k: got[k] for k in retrieval} == retrieval
    assert refine["retrieval_model"] == got["retrieval_model"] and refine["K"] == got["K"]
    from retrieval_fuse_tpu_torch.models import build_modules
    assert set(build_modules(got)) == {"fenc_input", "unet_backbone", "decoder",
                                       "retrieval_backbone", "patched_attention_block"}
