"""Meshes and mesh metrics of the port against the JAX package, on the CPU:
the native C++ (marching cubes, voxelizer, compose paste), evaluation/
(Mesh, the mesh metrics, their CLI), utils/visualization.py,
SceneHandler.visualize_*, serve_directory(write_obj=True), the native
compose, and the small ports (Patcher, truncate_sdf, rename_state_dict,
prep.sample_scene_point_clouds, trace_profile, log_images).

Inputs are seeded numpy TSDFs of spheres and boxes at small sizes (24³ to
40³ grids), and the synthetic dataset fixture. The native code, the OBJ
writers, the metrics sweep's CSV and the composed volumes are held equal to
the JAX package's; float64 mesh arithmetic to 1e-12; the trilinear upsample
(float32) to 1e-6.
"""

import contextlib
import io
import json
import random
import shutil
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from retrieval_fuse_tpu import native as jnative
from retrieval_fuse_tpu.data import PatchedSceneDataset as JaxDataset, SceneHandler as JaxScenes
from retrieval_fuse_tpu.data.synthetic import make_synthetic_config
from retrieval_fuse_tpu.evaluation import cli as jeval_cli
from retrieval_fuse_tpu.evaluation import mesh as jmesh
from retrieval_fuse_tpu.evaluation import mesh_metrics as jmm
from retrieval_fuse_tpu.retrieval import engine as jengine
from retrieval_fuse_tpu.utils import misc as jmisc
from retrieval_fuse_tpu.utils import visualization as jvis
from retrieval_fuse_tpu_torch import native
from retrieval_fuse_tpu_torch.data import PatchedSceneDataset, SceneHandler
from retrieval_fuse_tpu_torch.evaluation import cli as eval_cli
from retrieval_fuse_tpu_torch.evaluation import mesh
from retrieval_fuse_tpu_torch.evaluation import mesh_metrics as mm
from retrieval_fuse_tpu_torch.retrieval import engine
from retrieval_fuse_tpu_torch.utils import logger as tlogger
from retrieval_fuse_tpu_torch.utils import misc
from retrieval_fuse_tpu_torch.utils import visualization as vis
from test_torch_port_retrieval import copy_dataset, working_dir
from test_torch_port_models import torch_threads  # noqa: F401 (autouse fixture)

ROOT = Path(__file__).resolve().parents[1]
F64_TOL = 1e-12


def primitives_tsdf(seed: int, side: int, trunc: float = 3.0) -> np.ndarray:
    """A (side³) float32 truncated distance field of 2-3 random spheres and
    boxes, in voxel units."""
    rng = np.random.default_rng(seed)
    g = np.stack(np.meshgrid(*[np.arange(side, dtype=np.float64)] * 3, indexing="ij"), -1)
    d = np.full((side,) * 3, np.inf)
    for _ in range(2 + seed % 2):
        c = rng.uniform(0.3, 0.7, 3) * side
        r = rng.uniform(0.12, 0.25) * side
        if rng.random() < 0.5:
            d = np.minimum(d, np.linalg.norm(g - c, axis=-1) - r)
        else:
            q = np.abs(g - c) - r
            d = np.minimum(d, np.linalg.norm(np.maximum(q, 0), axis=-1)
                           + np.minimum(q.max(-1), 0))
    return np.clip(np.abs(d), 0, trunc).astype(np.float32)


def write_mesh_pair(tmp_path, seed: int, side: int = 24):
    """(pred, target) OBJ paths from marching cubes of two perturbations of
    one TSDF (the JAX writer)."""
    base = primitives_tsdf(seed, side)
    noise = np.random.default_rng(seed + 50).normal(0, 0.15, base.shape).astype(np.float32)
    paths = []
    for tag, vol in (("pred", base + noise), ("gt", base)):
        v, t = jnative.marching_cubes(vol, 1.0)
        path = tmp_path / f"{tag}_{seed}.obj"
        jnative.export_obj(v, t, path)
        paths.append(path)
    return paths


# ------------------------------------------------------------------ native


@pytest.mark.parametrize("name", ["marching_cubes.cpp", "voxelize.cpp", "compose.cpp"])
def test_native_sources_are_the_jax_copies(name):
    assert (ROOT / "retrieval_fuse_tpu_torch" / "native" / name).read_bytes() == \
        (ROOT / "retrieval_fuse_tpu" / "native" / name).read_bytes()


def test_native_library_is_the_ports_own():
    path = native.library_path()
    assert path.parent == ROOT / "build" / "retrieval_fuse_tpu_torch"
    assert Path(native.get_lib()._name) == path and path.exists()
    assert "retrieval_fuse_tpu/native" not in native.get_lib()._name


@pytest.mark.parametrize("method", ["mc", "tets"])
@pytest.mark.parametrize("seed", [0, 1])
def test_marching_cubes_and_obj_match_jax(method, seed, tmp_path):
    sdf = primitives_tsdf(seed, 28)
    got, want = native.marching_cubes(sdf, 1.0, method), jnative.marching_cubes(sdf, 1.0, method)
    assert len(got[1]) > 100
    for g, w in zip(got, want):
        assert g.dtype == w.dtype
        np.testing.assert_array_equal(g, w)
    native.export_obj(*got, tmp_path / "port.obj")
    jnative.export_obj(*want, tmp_path / "jax.obj")
    assert (tmp_path / "port.obj").read_bytes() == (tmp_path / "jax.obj").read_bytes()
    empty = native.marching_cubes(np.ones((5, 5, 5), np.float32), 0.0, method)
    assert empty[0].shape == (0, 3) and empty[1].shape == (0, 3)
    with pytest.raises(ValueError, match="'mc' or 'tets'"):
        native.marching_cubes(sdf, 1.0, "dual")


def test_voxelize_mesh_matches_jax():
    v, t = jnative.marching_cubes(primitives_tsdf(2, 24), 1.0)
    for pitch in (1.1875, 0.7):
        lo = np.floor(v.min(0) / pitch).astype(np.int64) - 1
        dims = tuple(int(d) for d in np.floor(v.max(0) / pitch).astype(np.int64) - lo + 2)
        got = native.voxelize_mesh(v, t, pitch, lo, dims)
        np.testing.assert_array_equal(got, jnative.voxelize_mesh(v, t, pitch, lo, dims))
        assert got.sum() > 100


@pytest.mark.parametrize("no_overlap", [True, False])
def test_compose_paste_matches_jax(no_overlap):
    rng = np.random.default_rng(5)
    ps, p = 8, 40
    vol = rng.random((24, 20, 28)).astype(np.float32)
    dist = np.full(vol.shape, 100.0, np.float32)
    crops = rng.random((p, ps, ps, ps)).astype(np.float32)
    lo = np.stack([rng.integers(0, s - ps + 1, p) for s in vol.shape], 1)
    extents = np.stack([lo[:, 0], lo[:, 0] + ps, lo[:, 1], lo[:, 1] + ps, lo[:, 2],
                        lo[:, 2] + ps], 1).astype(np.int32)
    dists = rng.random(p).astype(np.float32)
    got = (vol.copy(), dist.copy())
    want = (vol.copy(), dist.copy())
    native.compose_paste(*got, crops, extents, dists, no_overlap)
    jnative.compose_paste(*want, crops, extents, dists, no_overlap)
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(got[1], want[1])
    assert not np.array_equal(got[0], vol)
    bad = extents.copy()
    bad[0, 1] += 1
    with pytest.raises(ValueError, match="extent"):
        native.compose_paste(vol.copy(), dist.copy(), crops, bad, dists, no_overlap)


@pytest.mark.parametrize("how", ["no compiler", "compiler error"])
def test_exact_voxelization_raises_when_the_build_fails(how, tmp_path, monkeypatch):
    """exact=True (the default) raises with the compiler's words; only
    exact=False samples. Nothing falls back."""
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "build")
    if how == "no compiler":
        monkeypatch.setattr(native, "CXX", str(tmp_path / "no-such-g++"))
        match = "needs a C\\+\\+ compiler"
    else:
        monkeypatch.setattr(native, "CXX_FLAGS", native.CXX_FLAGS + ("-fno-such-option",))
        match = "failed to build(.|\n)*no-such-option"
    v, t = jnative.marching_cubes(primitives_tsdf(3, 20), 1.0)
    m = mesh.Mesh(v, t)
    with pytest.raises(RuntimeError, match=match):
        m.voxelize_surface(1.1875)
    with pytest.raises(RuntimeError, match=match):
        mm.compute_iou(m, m)
    assert m.voxelize_surface(1.1875, exact=False) == \
        jmesh.Mesh(v, t).voxelize_surface(1.1875, exact=False)
    assert not list((tmp_path / "build").glob("*.so"))


# ------------------------------------------------------------ mesh metrics


def test_mesh_operations_match_jax(tmp_path):
    pred, gt = write_mesh_pair(tmp_path, 4)
    got, want = mesh.Mesh.load(pred), jmesh.Mesh.load(pred)
    np.testing.assert_array_equal(got.vertices, want.vertices)
    np.testing.assert_array_equal(got.faces, want.faces)
    got.export(tmp_path / "port.obj")
    want.export(tmp_path / "jax.obj")
    assert (tmp_path / "port.obj").read_text() == (tmp_path / "jax.obj").read_text()
    off = tmp_path / "m.off"
    off.write_text("OFF\n4 2 0\n0 0 0\n1 0 0\n1 1 0\n0 1 0\n4 0 1 2 3\n3 0 2 3\n")
    np.testing.assert_array_equal(mesh.Mesh.load(off).faces, jmesh.Mesh.load(off).faces)
    for (a, ia), (b, ib) in [(got.sample(5000, return_index=True, seed=s),
                              want.sample(5000, return_index=True, seed=s)) for s in (0, 7)]:
        np.testing.assert_array_equal(a, b)
        np.testing.assert_array_equal(ia, ib)
    areas, normals = got.face_areas_normals()
    jareas, jnormals = want.face_areas_normals()
    np.testing.assert_allclose(areas, jareas, rtol=0, atol=F64_TOL)
    np.testing.assert_allclose(normals, jnormals, rtol=0, atol=F64_TOL)
    for pitch in (1.1875, 2.0):
        assert got.voxelize_surface(pitch) == want.voxelize_surface(pitch)
        assert got.voxelize_surface(pitch, exact=False) == \
            want.voxelize_surface(pitch, exact=False)
    other = mesh.Mesh.load(gt)
    cat = mesh.Mesh.concatenate([got, other.apply_translation([30, 0, 0])])
    jcat = jmesh.Mesh.concatenate([want, jmesh.Mesh.load(gt).apply_translation([30, 0, 0])])
    np.testing.assert_array_equal(cat.vertices, jcat.vertices)
    np.testing.assert_array_equal(cat.faces, jcat.faces)
    assert mesh.Mesh.concatenate([]).is_empty()
    for normal, origin in (([1, 0, 0], [11.3, 0, 0]), ([0.3, -1, 0.2], [10, 12.5, 9])):
        s_got = mesh.slice_faces_plane(got, normal, origin)
        s_want = jmesh.slice_faces_plane(want, normal, origin)
        assert 0 < len(s_got.faces) < len(got.faces)
        np.testing.assert_array_equal(s_got.faces, s_want.faces)
        np.testing.assert_allclose(s_got.vertices, s_want.vertices, rtol=0, atol=F64_TOL)
    box = mesh.slice_mesh_box(got, [5, 6, 4], [15, 14.5, 17])
    jbox = jmesh.slice_mesh_box(want, [5, 6, 4], [15, 14.5, 17])
    np.testing.assert_array_equal(box.faces, jbox.faces)
    np.testing.assert_allclose(box.vertices, jbox.vertices, rtol=0, atol=F64_TOL)
    assert mesh.slice_mesh_box(got, [100] * 3, [101] * 3).is_empty()


@pytest.mark.parametrize("seed", [6, 7])
def test_compute_metrics_and_iou_match_jax(seed, tmp_path):
    pred, gt = write_mesh_pair(tmp_path, seed)
    got = mm.compute_metrics(pred, gt, n_points=20000)
    want = jmm.compute_metrics(pred, gt, n_points=20000)
    assert len(got) == 5 and 0 < got[0] < 1 and got[1] > 0
    np.testing.assert_allclose(got, want, rtol=0, atol=F64_TOL)
    same = mm.compute_metrics(gt, gt, n_points=20000)
    assert same == [1.0, 0.0, 1.0, 1.0, 1.0]
    a, b = mesh.Mesh.load(pred), mesh.Mesh.load(gt)
    assert mm.compute_iou(a, b) == jmm.compute_iou(jmesh.Mesh.load(pred), jmesh.Mesh.load(gt))
    assert mm.compute_metrics_only_iou(pred, gt) == jmm.compute_metrics_only_iou(pred, gt)
    pts = np.random.default_rng(seed).random((300, 3))
    for g, w in zip(mm.distance_p2p(pts, None, pts[::-1] * 2, None),
                    jmm.distance_p2p(pts, None, pts[::-1] * 2, None)):
        np.testing.assert_array_equal(g, w)


def chunk_meshes(tmp_path, tag: str, suffix: str) -> Path:
    """OBJ meshes of 2 scenes x 2 chunks, named <scene>__<x>_<y>_<z><suffix>
    (the recompose naming), from the JAX writer."""
    out = tmp_path / tag
    out.mkdir()
    for s, scene in enumerate(("synth__a", "synth__b")):
        for c, xyz in enumerate(("0_0_0", "24_0_0")):
            v, t = jnative.marching_cubes(primitives_tsdf(10 + 2 * s + c, 24), 1.0)
            jnative.export_obj(v, t, out / f"{scene}__{xyz}{suffix}")
    (out / "synth__a__48_0_0" f"{suffix}").write_text("")  # an empty chunk mesh
    return out


def test_recompose_and_clean_match_jax(tmp_path):
    src = chunk_meshes(tmp_path, "chunks", "_fuse.obj")
    assert mm.get_scenes_chunk_dict(src, "_fuse.obj") == jmm.get_scenes_chunk_dict(
        src, "_fuse.obj")
    chunks = sorted(x.name[:-len("_fuse.obj")] for x in src.glob("synth__a*"))
    got = mm.recompose_scene(src, chunks, "_fuse.obj", [1, 2, 3])
    want = jmm.recompose_scene(src, chunks, "_fuse.obj", [1, 2, 3])
    np.testing.assert_array_equal(got.vertices, want.vertices)
    np.testing.assert_array_equal(got.faces, want.faces)
    for tag, mod in (("port", eval_cli), ("jax", jeval_cli)):
        mod.main(["recompose", "--base_path", str(src), "--suffix", "_fuse.obj",
                  "--output_path", str(tmp_path / tag / "scenes"), "--shift", "1", "2", "3"])
        mod.main(["clean", "--target_dir", str(tmp_path / tag / "scenes")])
    for sub in ("scenes", "scenes_clean"):
        names = sorted(p.name for p in (tmp_path / "jax" / sub).iterdir())
        assert names == ["synth__a.obj", "synth__b.obj"]
        assert names == sorted(p.name for p in (tmp_path / "port" / sub).iterdir())
        for n in names:
            assert (tmp_path / "port" / sub / n).read_text() == \
                (tmp_path / "jax" / sub / n).read_text()


def test_baseline_converters_match_jax(tmp_path):
    """convert_ifnet, convert_spsr, rescale_conv_occ and copy_crop_psr write
    the JAX package's files."""
    src = tmp_path / "src"
    (src / "s0").mkdir(parents=True)
    v, t = jnative.marching_cubes(primitives_tsdf(40, 16), 1.0)
    jmesh.Mesh(v / 16 - 0.5, t).export(src / "s0.obj")
    off = "OFF\n{} {} 0\n".format(len(v), len(t)) + "".join(
        f"{a:.5f} {b:.5f} {c:.5f}\n" for a, b, c in v / 16 - 0.5) + "".join(
        f"3 {a} {b} {c}\n" for a, b, c in t)
    (src / "s0" / "surface_reconstruction.off").write_text(off)
    (src / "s0.off").write_text(off)
    jmesh.Mesh(v, t).export(src / "s0___poisson.ply.obj")
    for tag, mod in (("port", mm), ("jax", jmm)):
        out = tmp_path / tag
        mod.convert_ifnet(src, out / "ifnet", ["s0"])
        mod.convert_spsr(src, out / "spsr", ["s0.obj"])
        mod.rescale_conv_occ(src, out / "convocc", ["s0"])
        mod.copy_crop_psr([src / "s0___poisson.ply.obj"], out / "psr")
    for sub in ("ifnet", "spsr", "convocc", "psr"):
        names = sorted(p.name for p in (tmp_path / "jax" / sub).iterdir())
        assert names and names == sorted(p.name for p in (tmp_path / "port" / sub).iterdir())
        for n in names:
            assert (tmp_path / "port" / sub / n).read_text() == \
                (tmp_path / "jax" / sub / n).read_text(), (sub, n)


def test_metrics_cli_writes_the_jax_csv(tmp_path):
    """`metrics` over <dir>/ours against <dir>/gt: the same CSV and summary."""
    for tag in ("ours", "gt"):
        (tmp_path / tag).mkdir()
    for seed in (20, 21, 22):
        pred, gt = write_mesh_pair(tmp_path, seed, side=20)
        shutil.move(pred, tmp_path / "ours" / f"scene{seed}.obj")
        shutil.move(gt, tmp_path / "gt" / f"scene{seed}.obj")
    printed = {}
    for tag, mod in (("port", eval_cli), ("jax", jeval_cli)):
        (tmp_path / tag).mkdir()
        buf = io.StringIO()
        with working_dir(tmp_path / tag), contextlib.redirect_stdout(buf):
            mod.main(["metrics", "--pred_dir", str(tmp_path / "ours"), "--dataset", "Synth",
                      "--task", "superresolution", "--limit", "2"])
        printed[tag] = buf.getvalue()
    name = "metrics_Synth_superresolution_ours_00.csv"
    csv = (tmp_path / "port" / name).read_text()
    assert csv == (tmp_path / "jax" / name).read_text() and len(csv.splitlines()) == 2
    assert printed["port"] == printed["jax"] and "iou:" in printed["port"]


# ------------------------------------------------------------ visualisation


@pytest.mark.parametrize("side", [13])
def test_trilinear_upsample_matches_jax(side):
    vol = np.random.default_rng(side).random((side,) * 3).astype(np.float32)
    got = vis.trilinear_upsample_2x(torch.from_numpy(vol))
    want = jvis.trilinear_upsample_2x(vol)
    assert got.shape == want.shape == (2 * side,) * 3 and got.device.type == "cpu"
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-6)
    np.testing.assert_array_equal(got[::2 * side - 1, ::2 * side - 1, ::2 * side - 1].numpy(),
                                  vol[::side - 1, ::side - 1, ::side - 1])


def test_jet_is_matplotlibs():
    from matplotlib import colormaps
    v = np.concatenate([np.linspace(-0.2, 1.2, 3001), [0.0, 1.0, 1 / 256, np.nan]])
    np.testing.assert_array_equal(vis.jet(v), colormaps["jet"](v))
    np.testing.assert_array_equal(vis.jet(0.3), colormaps["jet"](0.3))


def test_obj_writers_match_jax(tmp_path):
    rng = np.random.default_rng(8)
    sdf = primitives_tsdf(8, 12, trunc=1.0)
    grid = (rng.random((6, 7, 5)) > 0.7).astype(np.float32)
    weight = rng.uniform(0.5, 4.5, (6, 5, 7)).astype(np.float32)
    normals = rng.uniform(-1, 1, (3, 5, 4, 6)).astype(np.float32)
    normals[:, 1] = 0
    points = rng.random((50, 3)) * 10
    for tag, mod in (("port", vis), ("jax", jvis)):
        d = tmp_path / tag
        d.mkdir()
        mod.visualize_sdf_as_mesh(sdf * 2, d / "mesh.obj", level=1.0, scale_factor=2)
        mod.visualize_sdf_as_voxels(sdf, d / "sdf_vox.obj", level=0.5)
        mod.visualize_grid_as_voxels(grid, d / "grid_vox.obj")
        mod.visualize_grid_as_voxels(np.zeros((3, 3, 3)), d / "none.obj")
        mod.visualize_pointcloud(points, d / "points.obj")
        mod.visualize_float_grid(weight, 1, 1, 4, d / "weight.obj")
        mod.visualize_normals(normals, d / "normals.obj")
    names = sorted(p.name for p in (tmp_path / "jax").iterdir())
    assert names == sorted(p.name for p in (tmp_path / "port").iterdir()) and len(names) == 6
    for n in names:
        assert (tmp_path / "port" / n).read_text() == (tmp_path / "jax" / n).read_text(), n


def test_render_panel_and_png_match_jax(tmp_path):
    from PIL import Image
    v, t = jnative.marching_cubes(primitives_tsdf(9, 16), 1.0)
    got = vis._render_mesh_panel(v, t, res=96)
    np.testing.assert_array_equal(got, jvis._render_mesh_panel(v, t, res=96))
    assert (got < 255).any()
    np.testing.assert_array_equal(vis._render_mesh_panel(v[:0], t[:0], res=8), 255)
    vis.write_png(tmp_path / "a.png", got)
    np.testing.assert_array_equal(np.asarray(Image.open(tmp_path / "a.png").convert("RGB")), got)
    with pytest.raises(ValueError, match="H, W, 3"):
        vis.write_png(tmp_path / "b.png", got[..., :2])


def test_render_visualizations_writes_the_jax_panels(tmp_path):
    """One PNG a scene whose pixels are the JAX package's panels (its JPEG
    is lossy, so the panels are compared before encoding); a missing panel
    is white."""
    from PIL import Image
    src = tmp_path / "meshes"
    src.mkdir()
    for i, suffix in enumerate(("_input", "_pred", "_gt")):
        v, t = jnative.marching_cubes(primitives_tsdf(30 + i, 12), 1.0)
        jnative.export_obj(v, t, src / f"s0{suffix}.obj")
    shutil.copy(src / "s0_pred.obj", src / "s1_pred.obj")  # s1 has no input and no gt
    vis.render_visualizations_to_image(src, tmp_path / "out")
    assert sorted(p.name for p in (tmp_path / "out").iterdir()) == ["s0.png", "s1.png"]
    img = np.asarray(Image.open(tmp_path / "out" / "s0.png").convert("RGB"))
    assert img.shape == (480, 1440, 3)
    for i, suffix in enumerate(("_input", "_pred", "_gt")):
        want = jvis._render_mesh_panel(*jvis._load_obj(src / f"s0{suffix}.obj"))
        np.testing.assert_array_equal(img[:, 480 * i: 480 * (i + 1)], want)
    blank = np.asarray(Image.open(tmp_path / "out" / "s1.png").convert("RGB"))
    assert (blank[:, :480] == 255).all() and (blank[:, 960:] == 255).all()
    assert (blank[:, 480:960] < 255).any()


def test_scene_handler_visualisations_match_jax(synth_superres_root, tmp_path):
    cfg = make_synthetic_config(synth_superres_root)
    scene = "synth__0006"
    ports, jaxs = {}, {}
    for fast in (True, False):
        c = dict(cfg, fast_visualization=fast)
        with working_dir(tmp_path):
            ports[fast], jaxs[fast] = SceneHandler("val", c), JaxScenes("val", c)
    target = JaxDataset("val", cfg["dataset_val"], jaxs[True]).get_scene_target(scene)
    inp = np.load(Path(synth_superres_root) / "sdf_008" / "SynthSet" / f"{scene}.npz")["arr"]
    rng = np.random.default_rng(3)
    weight = rng.uniform(0.5, 4.5, (8, 8, 8)).astype(np.float32)
    normal = rng.uniform(-1, 1, (3, 6, 6, 6)).astype(np.float32)
    for tag, h in (("port", ports), ("jax", jaxs)):
        d = tmp_path / tag
        d.mkdir()
        kw = {"device": "cpu"} if tag == "port" else {}
        h[True].visualize_target_chunk(target.astype(np.float32), d / "target.obj", **kw)
        h[False].visualize_target_chunk(target.astype(np.float32), d / "target_2x.obj", **kw)
        h[True].visualize_input_chunk(inp.astype(np.float32), d / "input.obj")
        h[True].visualize_weight(weight, d / "weight.obj")
        h[True].visualize_normal(normal, d / "normal.obj")
    for n in ("target.obj", "input.obj", "weight.obj", "normal.obj"):
        assert (tmp_path / "port" / n).read_text() == (tmp_path / "jax" / n).read_text(), n
    # the 2x upsample is float32 torch against float32 JAX (1e-6 apart):
    # the same triangles, vertices within the upsample's difference
    got, want = (mesh.Mesh.load(tmp_path / t / "target_2x.obj") for t in ("port", "jax"))
    assert len(got.faces) > 100
    np.testing.assert_array_equal(got.faces, want.faces)
    np.testing.assert_allclose(got.vertices, want.vertices, rtol=0, atol=1e-4)


# ------------------------------------------------------------ serving


def test_serve_directory_writes_the_meshes_of_its_predictions(tmp_path):
    """serve_directory(write_obj=True) at the tiny serving geometry (nf 4,
    K 2, 300 bank rows): each <chunk>_pred.obj is the JAX package's marching
    cubes + OBJ of the float32 prediction the engine returned for it."""
    from retrieval_fuse_tpu_torch.inference import FAST_VARIANT, RetrieveRefineEngine, \
        variant_engine_kwargs
    from retrieval_fuse_tpu_torch.serve import serve_directory
    from retrieval_fuse_tpu_torch.utils.flax_import import flax_engine_params
    from test_torch_port_engine import CFG, make_setup
    params, db, bank, x = make_setup()
    eng = RetrieveRefineEngine(CFG, flax_engine_params(params), db, bank,
                               compute_dtype=torch.float32, device="cpu",
                               **variant_engine_kwargs(FAST_VARIANT))
    preds = []

    class Recording:
        device = eng.device

        def __call__(self, batch):
            out = eng(batch)
            preds.append(out[..., 0].numpy())
            return out

    indir = tmp_path / "in"
    indir.mkdir()
    rng = np.random.default_rng(11)
    for j in range(3):
        np.savez_compressed(indir / f"c{j}.npz", arr=rng.random((8, 8, 8)).astype(np.float32) * 0.5)
    cfg = dict(make_synthetic_config(tmp_path / "data"), task="superresolution")
    handler = SceneHandler.__new__(SceneHandler)  # the level and the flag only
    handler.target_voxel_size = np.float16(cfg["dataset_val"]["voxel_size_target"]).astype(
        np.float32)
    handler.fast_visualization = True
    done = serve_directory(Recording(), indir, tmp_path / "out", batch_size=2, write_obj=True,
                           scene_handler=handler)
    assert done == ["c0", "c1", "c2"]
    pred = np.concatenate(preds)[:3]
    for j, name in enumerate(done):
        v, t = jnative.marching_cubes(pred[j], float(handler.target_voxel_size * 0.75))
        jnative.export_obj(v, t, tmp_path / "want.obj")
        assert (tmp_path / "out" / f"{name}_pred.obj").read_text() == \
            (tmp_path / "want.obj").read_text()
        np.testing.assert_array_equal(
            np.load(tmp_path / "out" / f"{name}_pred.npz")["arr"], pred[j].astype(np.float16))
    with pytest.raises(ValueError, match="scene_handler"):
        serve_directory(Recording(), indir, tmp_path / "out2", write_obj=True)


# ------------------------------------------------------------ compose


@pytest.fixture(scope="module")
def overlap_datasets(synth_superres_root, tmp_path_factory):
    """The synthetic scenes with overlapping target patches (stride 8 <
    patch 16), a tree with their index, and a seeded random mapping of K = 2
    rows a patch (some zero-patch rows)."""
    tmp = tmp_path_factory.mktemp("compose_overlap")
    data = copy_dataset(synth_superres_root, tmp / "data")
    cfg = make_synthetic_config(data)
    for d in ("dataset_train", "dataset_val"):
        cfg[d].update(patch_stride=8, patch_context_target=0, patch_context_input=0,
                      patch_size_input=2, occupancy_threshold=-1)
    out = {"tree": tmp / "tree", "cfg": cfg}
    out["tree"].mkdir()
    with working_dir(tmp):
        out["jax"] = [JaxDataset(s, cfg[f"dataset_{s}"], JaxScenes(s, cfg))
                      for s in ("train", "val")]
        out["port"] = [PatchedSceneDataset(s, cfg[f"dataset_{s}"], SceneHandler(s, cfg))
                       for s in ("train", "val")]
    train = out["jax"][0]
    (out["tree"] / "index.json").write_text(json.dumps(train.scenes))
    rng = np.random.default_rng(13)
    mapping = {}
    for ds in out["jax"]:
        for scene in ds.scenes:
            for p in ds.patch_from_scene_lookup[scene]:
                rows = []
                for _ in range(2):
                    x0, y0, z0 = rng.integers(0, 64 - 16 + 1, 3)
                    idx = -1 if rng.random() < 0.1 else int(rng.integers(len(train.scenes)))
                    rows.append([idx, x0, x0 + 16, y0, y0 + 16, z0, z0 + 16, rng.random()])
                mapping[p] = np.array(rows, np.float64)
    out["mapping"] = mapping
    return out


@pytest.mark.parametrize("split", [0, 1], ids=["train", "val"])
def test_native_compose_matches_numpy_and_jax(overlap_datasets, split):
    o = overlap_datasets
    tds, ds = o["port"][0], o["port"][split]
    jtds, jds = o["jax"][0], o["jax"][split]
    assert not ds.no_overlap
    for scene in ds.scenes[:2]:
        want = jengine.create_retrieval_from_mapping(scene, o["mapping"], 2, jtds, jds, o["tree"])
        jnat = jengine.create_retrieval_from_mapping(scene, o["mapping"], 2, jtds, jds,
                                                     o["tree"], use_native=True)
        nat = engine.create_retrieval_from_mapping(scene, o["mapping"], 2, tds, ds, o["tree"],
                                                   use_native=True)
        plain = engine.create_retrieval_from_mapping(scene, o["mapping"], 2, tds, ds, o["tree"])
        assert nat.shape == want.shape == (2, 64, 64, 64) and nat.dtype == want.dtype
        np.testing.assert_array_equal(jnat, want)
        np.testing.assert_array_equal(nat, want)
        np.testing.assert_array_equal(plain, want)


# ------------------------------------------------------------ small ports


def test_patcher_matches_jax():
    from retrieval_fuse_tpu.ops.patcher import Patcher as JaxPatcher, \
        get_patch_counts as jax_counts
    from retrieval_fuse_tpu_torch.ops.patcher import Patcher, get_patch_counts
    x = np.random.default_rng(14).standard_normal((2, 10, 10, 10, 3)).astype(np.float32)
    p, jp = Patcher(4, pad_val=7.0), JaxPatcher(4, pad_val=7.0)
    got, want = p(torch.from_numpy(x)), jp(jnp.asarray(x))
    assert got.shape == want.shape == (2 * 27, 4, 4, 4, 3)
    np.testing.assert_array_equal(got[-1, -1, -1, -1].numpy(), 7.0)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_array_equal(p.recompose_patches(got, original_shape=x.shape).numpy(), x)
    assert [get_patch_counts(s, 4) for s in (8, 9, 10)] == [jax_counts(s, 4) for s in (8, 9, 10)]


def test_misc_additions_match_jax():
    x = np.random.default_rng(15).normal(0, 2, 50)
    np.testing.assert_array_equal(misc.truncate_sdf(x, 1.5), jmisc.truncate_sdf(x, 1.5))
    sd = {"a.b.weight": 1, "a.bias": 2, "ab.c": 3, "b.a.x": 4}
    assert misc.rename_state_dict(sd, "a") == jmisc.rename_state_dict(sd, "a") == \
        {"b.weight": 1, "bias": 2}


def test_sample_scene_point_clouds_matches_jax(synth_superres_config, tmp_path):
    from retrieval_fuse_tpu.data.prep import sample_scene_point_clouds as jax_sample
    from retrieval_fuse_tpu_torch.data.prep import sample_scene_point_clouds
    cfg = synth_superres_config
    dtr = cfg["dataset_train"]
    val = jmisc.read_list(Path(dtr["data_dir"], "splits", dtr["dataset_name"],
                               dtr["splits_dir"], "val.txt"))
    scenes = tmp_path / "full"
    scenes.mkdir()
    g = np.stack(np.meshgrid(*([np.arange(40)] * 3), indexing="ij"), -1).astype(np.float32)
    df = np.abs(np.linalg.norm(g - 19.5, axis=-1) - 8) * dtr["voxel_size_target"]
    np.save(scenes / f"{'__'.join(val[0].split('__')[:3])}.npy", df)
    out = {}
    for tag, fn in (("port", sample_scene_point_clouds), ("jax", jax_sample)):
        np.random.seed(0)
        random.seed(0)
        fn(cfg, scenes, 100, tmp_path / tag, visualize=True, split="val")
        out[tag] = sorted((tmp_path / tag).iterdir())
    assert [p.name for p in out["port"]] == [p.name for p in out["jax"]]
    assert len(out["port"]) == 2
    for a, b in zip(out["port"], out["jax"]):
        assert a.read_bytes() == b.read_bytes() if a.suffix == ".obj" else np.array_equal(
            np.load(a)["arr_0"], np.load(b)["arr_0"])


def test_trace_profile_and_log_images(tmp_path):
    with working_dir(tmp_path):
        with tlogger.trace_profile(tmp_path / "trace") as prof:
            torch.ones(64).sum()
        assert (tmp_path / "trace" / "trace.json").exists() and prof.key_averages()
        with tlogger.trace_profile(tmp_path / "off", enabled=False) as prof:
            pass
        assert prof is None and not (tmp_path / "off").exists()
        log = tlogger.MetricsLogger("exp")
        (tmp_path / "img").mkdir()
        assert tlogger.log_images(log, tmp_path / "img", step=3) == 0
        for name in ("a.png", "b.png", "c.jpg"):
            (tmp_path / "img" / name).write_bytes(b"")
        assert tlogger.log_images(log, tmp_path / "img", step=4) == 2
        log.close()
        rec = json.loads((tmp_path / "runs" / "exp" / "metrics.jsonl").read_text())
    assert rec["_step"] == 4 and rec["visualization/count"] == 2.0
    assert rec["visualization/dir"] == str(tmp_path / "img")
