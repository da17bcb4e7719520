"""Offline mesh-level evaluation, as in the JAX package's
evaluation/mesh_metrics.py: the metrics of the paper's tables.

  * voxelized-shell IoU at pitch 1.1875 (compute_iou; the exact native
    voxelizer, evaluation/mesh.py);
  * 100K-point area-weighted surface samples with their face normals,
    point-to-point distances by scipy's cKDTree, Chamfer-L1, normal
    correctness and the F-score over 1000 thresholds at thresholds 9 and 14
    (compute_metrics);
  * scene sweeps to CSV, shardable over processes (--num_proc / --proc);
  * converters of baseline outputs (IFNet, SPSR, ConvOcc rescalers) and the
    recomposition of chunk meshes into scene meshes;
  * mesh cropping by box-plane slicing (clean_mesh, copy_crop_psr).

Host numpy and scipy: no Pallas kernel stands behind these in the JAX
package, and none in the port.
"""

from __future__ import annotations

import multiprocessing
import shutil
from collections import defaultdict
from pathlib import Path

import numpy as np
from scipy.spatial import cKDTree

from retrieval_fuse_tpu_torch.evaluation.mesh import Mesh, slice_mesh_box


def compute_iou(mesh_pred: Mesh, mesh_target: Mesh, pitch: float = 1.1875) -> float:
    v_pred = mesh_pred.voxelize_surface(pitch)
    v_target = mesh_target.voxelize_surface(pitch)
    union = v_pred | v_target
    if not union:
        return 0.0
    return len(v_pred & v_target) / len(union)


def distance_p2p(points_src, normals_src, points_tgt, normals_tgt):
    """Min distances of each src point to the tgt set (+ |normal dot|)."""
    kdtree = cKDTree(points_tgt)
    dist, idx = kdtree.query(points_src)
    if normals_src is not None and normals_tgt is not None:
        ns = normals_src / np.linalg.norm(normals_src, axis=-1, keepdims=True)
        nt = normals_tgt / np.linalg.norm(normals_tgt, axis=-1, keepdims=True)
        normals_dot = np.abs((nt[idx] * ns).sum(axis=-1))
    else:
        normals_dot = np.full(points_src.shape[0], np.nan, np.float32)
    return dist, normals_dot


def get_threshold_percentage(dist, thresholds):
    return [(dist <= t).mean() for t in thresholds]


def compute_metrics(path_pred, path_target, n_points: int = 100000):
    """[iou, chamfer-L1, normal correctness, F@thresholds[9], F@thresholds[14]]."""
    mesh_pred = Mesh.load(path_pred)
    mesh_target = Mesh.load(path_target)
    iou = compute_iou(mesh_pred, mesh_target)

    pc_pred, idx_p = mesh_pred.sample(n_points, return_index=True)
    _, fn_pred = mesh_pred.face_areas_normals()
    normals_pred = fn_pred[idx_p]
    pc_tgt, idx_t = mesh_target.sample(n_points, return_index=True)
    _, fn_tgt = mesh_target.face_areas_normals()
    normals_tgt = fn_tgt[idx_t]

    thresholds = np.linspace(64.0 / 1000, 64, 1000)

    completeness, completeness_normals = distance_p2p(pc_tgt, normals_tgt, pc_pred, normals_pred)
    recall = get_threshold_percentage(completeness, thresholds)
    completeness2 = (completeness ** 2).mean()
    completeness_n = completeness_normals.mean()
    completeness = completeness.mean()

    accuracy, accuracy_normals = distance_p2p(pc_pred, normals_pred, pc_tgt, normals_tgt)
    precision = get_threshold_percentage(accuracy, thresholds)
    accuracy2 = (accuracy ** 2).mean()
    accuracy_n = accuracy_normals.mean()
    accuracy = accuracy.mean()

    chamfer_l2 = 0.5 * (completeness2 + accuracy2)
    normals_correctness = 0.5 * completeness_n + 0.5 * accuracy_n
    chamfer_l1 = 0.5 * (completeness + accuracy)
    F = [2 * precision[i] * recall[i] / (precision[i] + recall[i])
         if precision[i] + recall[i] > 0 else 0.0 for i in range(len(precision))]
    del chamfer_l2  # computed, not reported, as in the JAX package
    return [iou, chamfer_l1, normals_correctness, F[9], F[14]]


def compute_metrics_only_iou(path_pred, path_target):
    return [compute_iou(Mesh.load(path_pred), Mesh.load(path_target))]


# ------------------------------------------------------------- scene sweeps

def compute_all_metrics_for_scene(base_path: Path, scene: str, num_chunks: int):
    path_to_target = base_path.parents[0] / "gt" / (scene + ".obj")
    path_to_ours = base_path / (scene + ".obj")
    return [scene] + compute_metrics(path_to_ours, path_to_target) + [num_chunks]


def compute_all_metrics_for_scenes(dataset, task, method_name, base_path: Path,
                                   scene_chunk_dict, num_proc: int, proc: int, limit=None):
    """Shardable sweep writing metrics_<ds>_<task>_<method>_<proc>.csv in
    the working directory; a scene that raises is reported and skipped."""
    scenes = sorted(x.name.split(".")[0] for x in base_path.iterdir())[:limit]
    worker_items = [x for i, x in enumerate(scenes) if i % num_proc == proc]
    result_list = []
    for s in worker_items:
        try:
            result_list.append(compute_all_metrics_for_scene(base_path, s, 1))
        except Exception as e:
            print("Exception for", s, ":", e)
    Path(f"metrics_{dataset}_{task}_{method_name}_{proc:02d}.csv").write_text(
        "\n".join(",".join(str(x) for x in row) for row in result_list))
    return result_list


# --------------------------------------------- baseline-format converters

def convert_ifnet(base_dir: Path, target_dir: Path, samples, limit=None):
    target_dir.mkdir(exist_ok=True, parents=True)
    for s in samples[:limit]:
        Mesh.load(base_dir / s / "surface_reconstruction.off").export(target_dir / (s + ".obj"))


def convert_spsr(base_dir: Path, target_dir: Path, samples, limit=None):
    target_dir.mkdir(exist_ok=True, parents=True)
    for s in samples[:limit]:
        try:
            mesh = Mesh.load(base_dir / s)
            mesh.apply_scale(64).apply_translation([32, 32, 32])
            mesh.export(target_dir / (str(s).split(".")[0] + ".obj"))
        except Exception as err:
            print(s, err)


def rescale_conv_occ(base_dir: Path, target_dir: Path, samples, limit=None):
    target_dir.mkdir(exist_ok=True, parents=True)
    for s in samples[:limit]:
        mesh = Mesh.load(base_dir / (s + ".off"))
        mesh.apply_scale(64).apply_translation([32, 32, 32])
        mesh.export(target_dir / (s + ".obj"))


def rescale_parallel(func, base_dir, target_dir, samples, limit=None, num_processes: int = 8):
    items = samples[:limit]
    per = len(items) // num_processes + 1
    procs = [multiprocessing.Process(target=func, args=(base_dir, target_dir,
                                                        items[p * per:(p + 1) * per]))
             for p in range(num_processes)]
    for p in procs:
        p.start()
    for p in procs:
        p.join()


def copy_scenes_for_visual_inspection(target_scenes_dir: Path, all_methods, samples):
    outdir = Path("inspect")
    outdir.mkdir(exist_ok=True)
    for s in samples:
        for x in all_methods:
            src = target_scenes_dir / f"{x}" / (s + ".obj")
            if src.exists():
                shutil.copyfile(src, outdir / (s + f"_{x}.obj"))
            else:
                print("NotFound:", src)


# ----------------------------------------------------- scene recomposition

def get_scenes_chunk_dict(base_path: Path, suffix: str):
    scenes_chunk_dict = defaultdict(list)
    for x in base_path.iterdir():
        if x.name.endswith(suffix):
            chunk = x.name.split(suffix)[0]
            scene = "__".join(chunk.split("__")[:2])
            scenes_chunk_dict[scene].append(chunk)
    return scenes_chunk_dict


def recompose_scene(base_path: Path, chunks, suffix: str, shift):
    """Translate each chunk mesh by its grid position and concatenate."""
    meshes = []
    for chunk in chunks:
        try:
            m = Mesh.load(base_path / (chunk + suffix))
            if not m.is_empty():
                xyz = [int(y) for y in chunk.split("__")[-1].split("_")]
                m.apply_translation(xyz)
                meshes.append(m)
        except Exception as e:
            print("Exception load_mesh:", e)
    if not meshes:
        return None
    out = Mesh.concatenate(meshes)
    out.apply_translation(shift)
    return out


def recompose_chunks_to_scenes(base_path: Path, suffix: str, output_path: Path, shift):
    output_path.mkdir(exist_ok=True, parents=True)
    scenes_chunk_dict = get_scenes_chunk_dict(base_path, suffix)
    for scene in sorted(scenes_chunk_dict):
        rescene = recompose_scene(base_path, scenes_chunk_dict[scene], suffix, shift)
        if rescene is not None:
            rescene.export(output_path / (scene + ".obj"))


# ------------------------------------------------------------ mesh cropping

def clean_mesh(target_dir: Path):
    """Crop every mesh to the centered 62³ box."""
    out = target_dir.parents[0] / (target_dir.name + "_clean")
    out.mkdir(exist_ok=True)
    lo = np.array([64, 64, 64]) / 2 - np.array([62, 62, 62]) / 2
    hi = lo + np.array([62, 62, 62])
    for x in sorted(target_dir.iterdir()):
        mesh = Mesh.load(x)
        slice_mesh_box(mesh, lo, hi).export(out / x.name)


def copy_crop_psr(all_samples, target_dir: Path):
    """Crop PSR meshes below height 60 within a doubled-footprint box."""
    target_dir.mkdir(exist_ok=True, parents=True)
    for s in all_samples:
        mesh = Mesh.load(s)
        bbox = mesh.bounds
        ext = np.array([(bbox[1] - bbox[0])[0] * 2, 64 - 4, (bbox[1] - bbox[0])[2] * 2])
        cropped = slice_mesh_box(mesh, [0, 0, 0], ext)
        cropped.export(target_dir / f"{Path(s).name.split('___poisson.ply')[0]}.obj")
