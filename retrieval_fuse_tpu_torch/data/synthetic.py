"""Synthetic dataset generation, as in the JAX package's data/synthetic.py.

Writes a complete dataset in the on-disk layout the data layer reads
(`<root>/<input_dir>/<dataset>/<scene>.npz` with key "arr", splits under
`<root>/splits/<dataset>/<splits_dir>/*.txt`). Scenes are truncated
distance fields of random unions of spheres and boxes, sampled at the
target (64³) and input (8³) resolutions; surface-reconstruction inputs are
near-surface point samples of the same geometry.
"""

from __future__ import annotations

from pathlib import Path

import numpy as np


def _primitive_sdf(points: np.ndarray, rng: np.random.Generator, n_prims: int = 3) -> np.ndarray:
    """Unsigned distance to a union of random spheres/boxes; points in [0,1]³."""
    d = np.full(points.shape[0], np.inf, dtype=np.float32)
    for _ in range(n_prims):
        kind = rng.integers(0, 2)
        center = rng.uniform(0.25, 0.75, size=3)
        if kind == 0:
            radius = rng.uniform(0.08, 0.22)
            di = np.linalg.norm(points - center, axis=1) - radius
        else:
            half = rng.uniform(0.06, 0.2, size=3)
            q = np.abs(points - center) - half
            di = np.linalg.norm(np.maximum(q, 0), axis=1) + np.minimum(np.max(q, axis=1), 0)
        d = np.minimum(d, di)
    return np.abs(d).astype(np.float32)


def _sample_grid(res: int, voxel_size: float, rng_geom: np.random.Generator,
                 n_prims: int) -> np.ndarray:
    """The analytic df on a res³ grid in the dataset's distance units
    (voxel_size * res spans the chunk), truncated."""
    coords = (np.arange(res, dtype=np.float32) + 0.5) / res
    g = np.stack(np.meshgrid(coords, coords, coords, indexing="ij"), axis=-1).reshape(-1, 3)
    df = _primitive_sdf(g, rng_geom, n_prims) * (voxel_size * res)
    trunc = np.float16(voxel_size * 3).astype(np.float32)
    return np.minimum(df, trunc).reshape(res, res, res).astype(np.float32)


def _sample_surface_points(rng_geom_seed: int, n_points: int, res: int, n_prims: int) -> np.ndarray:
    """Rejection-sample near-surface points in [0, res) coordinates."""
    rng = np.random.default_rng(rng_geom_seed)
    pts = rng.uniform(0, 1, size=(n_points * 20, 3)).astype(np.float32)
    d = _primitive_sdf(pts, np.random.default_rng(rng_geom_seed), n_prims)
    return pts[np.argsort(d)[: n_points]] * res


def write_splits(root, dataset_name: str, splits_dir: str, train: list[str],
                 val: list[str]) -> None:
    """The split lists the data layer reads (train, val, and the eval and
    visualisation subsets)."""
    split_root = Path(root) / "splits" / dataset_name / splits_dir
    split_root.mkdir(parents=True, exist_ok=True)
    (split_root / "train.txt").write_text("\n".join(train))
    (split_root / "val.txt").write_text("\n".join(val))
    (split_root / "train_eval.txt").write_text("\n".join(train[: min(4, len(train))]))
    (split_root / "train_vis.txt").write_text("\n".join(train[: min(2, len(train))]))
    (split_root / "val_vis.txt").write_text("\n".join(val[: min(2, len(val))]))
    (split_root / "test.txt").write_text("\n".join(val))


def generate_synthetic_dataset(
    root,
    dataset_name: str = "SynthSet",
    splits_dir: str = "main",
    n_train: int = 12,
    n_val: int = 4,
    target_res: int = 64,
    input_res: int = 8,
    voxel_size_target: float = 0.020834,
    voxel_size_input: float = 0.166667,
    input_dir: str = "sdf_008",
    target_dir: str = "sdf_064",
    task: str = "superresolution",
    num_pc_points: int = 20000,
    seed: int = 0,
) -> dict:
    """Write a synthetic dataset; returns its scene lists and root."""
    root = Path(root)
    (root / target_dir / dataset_name).mkdir(parents=True, exist_ok=True)
    (root / input_dir / dataset_name).mkdir(parents=True, exist_ok=True)
    names = [f"synth__{i:04d}" for i in range(n_train + n_val)]
    for i, name in enumerate(names):
        geom_seed = seed * 100003 + i
        n_prims = 2 + (i % 3)
        tgt = _sample_grid(target_res, voxel_size_target, np.random.default_rng(geom_seed), n_prims)
        np.savez_compressed(root / target_dir / dataset_name / f"{name}.npz", arr=tgt)
        if task == "superresolution":
            inp = _sample_grid(input_res, voxel_size_input, np.random.default_rng(geom_seed),
                               n_prims)
            np.savez_compressed(root / input_dir / dataset_name / f"{name}.npz", arr=inp)
        else:
            pc = _sample_surface_points(geom_seed, num_pc_points, target_res, n_prims)
            np.savez_compressed(root / input_dir / dataset_name / f"{name}.npz", pc)
    train, val = names[:n_train], names[n_train:]
    write_splits(root, dataset_name, splits_dir, train, val)
    return {"train": train, "val": val, "dataset_name": dataset_name, "root": str(root)}


def make_synthetic_config(
    root,
    task: str = "superresolution",
    dataset_name: str = "SynthSet",
    base_overrides: dict | None = None,
) -> dict:
    """A resolved config pointing at a synthetic dataset, from the packaged
    ShapeNetV2 YAMLs (retrieval config, plus the refinement keys it lacks).
    Reads YAML."""
    from retrieval_fuse_tpu_torch.config import (
        read_config, CONFIG_ROOT, update_recursive, update_dataset_configs)

    if task == "superresolution":
        cfg = read_config(CONFIG_ROOT / "super_resolution" / "ShapeNetV2" / "retrieval_008_064.yaml")
        refine = read_config(
            CONFIG_ROOT / "super_resolution" / "ShapeNetV2" / "refinement_008_064.yaml")
    else:
        cfg = read_config(CONFIG_ROOT / "surface_reconstruction" / "ShapeNetV2" / "retrieval_500.yaml")
        refine = read_config(
            CONFIG_ROOT / "surface_reconstruction" / "ShapeNetV2" / "refinement_500.yaml")
    for k, v in refine.items():
        if k not in cfg:
            cfg[k] = v
    root = str(root) if str(root).endswith("/") else str(root) + "/"
    ds_over = {
        "dataset_name": dataset_name,
        "data_dir": root,
        "scene_dir": root,
        "retrieval_dir": root,
        "splits_dir": "main",
        "preload_scenes": True,
        "input_mean": 0.05 if task == "superresolution" else 0,
        "input_std": 0.02 if task == "superresolution" else 1,
        "target_mean": 0.05,
        "target_std": 0.02,
        "random_indices_pool_size": 64,
    }
    for d in ("dataset_train", "dataset_val"):
        cfg[d].update(ds_over)
    cfg["no_retrievals"] = True
    cfg["retrieval_ckpt"] = None
    cfg["experiment"] = "synthetic_test"
    if base_overrides:
        update_recursive(cfg, base_overrides)
        update_dataset_configs(cfg)
        cfg.pop("dataset", None)
    return cfg
