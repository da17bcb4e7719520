"""Helpers (list IO, grids, artifact paths, the batch IoU matrix, SDF
truncation, state_dict prefixes), as in the JAX package's utils/misc.py,
with the same artifact addressing."""

from __future__ import annotations

from pathlib import Path

import numpy as np


def read_list(path) -> list[str]:
    """Read a newline-separated scene list."""
    return [x.strip() for x in Path(path).read_text().split("\n") if x.strip() != ""]


def to_point_list(mask: np.ndarray) -> np.ndarray:
    """Boolean grid -> (N, 3) int coordinates of set voxels, raster order."""
    return np.concatenate([c[:, np.newaxis] for c in np.where(mask)], axis=1)


def point_cloud_to_grid(point_cloud: np.ndarray, grid_res: int, scale_factor: float,
                        pad: int) -> np.ndarray:
    """Voxelize a point cloud into a padded occupancy grid: scale, clamp to
    [0, grid_res-1], truncate to integer cells, set occupancy 1."""
    grid = np.zeros([grid_res + 2 * pad] * 3, dtype=np.float32)
    point_cloud = point_cloud * scale_factor
    points_grid = np.clip(point_cloud, 0, grid_res - 1).astype(np.uint32)
    grid[pad + points_grid[:, 0], pad + points_grid[:, 1], pad + points_grid[:, 2]] = 1
    return grid


def _checkpoint_tag(config: dict) -> tuple[str, str]:
    """(experiment, epoch) names of the retrieval checkpoint directory."""
    ckpt = Path(config["retrieval_ckpt"])
    return ckpt.parents[0].name, ckpt.name.split(".")[0]


def get_retrievals_dir(config: dict) -> Path:
    """Directory of composed retrievals and mappings, keyed by retrieval
    checkpoint experiment, epoch, task + num_points, dataset, splits and K."""
    ckpt_experiment, ckpt_epoch = _checkpoint_tag(config)
    num_points = config["dataset_train"]["num_points"]
    task_dir = f"{config['task']}_{num_points:04d}"
    return Path(
        config["dataset_train"]["retrieval_dir"], "retrieval", task_dir,
        config["dataset_train"]["dataset_name"], config["dataset_train"]["splits_dir"],
        ckpt_experiment, ckpt_epoch, str(config["K"]),
    )


def get_tree_path(config: dict) -> Path:
    """Dictionary scratch path (database.npy, index.json, params.json),
    relative to the working directory."""
    ckpt_experiment, ckpt_epoch = _checkpoint_tag(config)
    task_dir = f"{config['task']}_{config['dataset_train']['num_points']:04d}"
    return Path(
        "runs", "retrieval_scratch", task_dir, config["dataset_train"]["dataset_name"],
        config["dataset_train"]["splits_dir"], ckpt_experiment, ckpt_epoch, str(config["K"]),
    )


def get_iou_matrix(batch_occupancy):
    """(N, N) pairwise IoU of a batch of boolean occupancy grids (N, D, H, W)
    or (N, D, H, W, 1): intersection / (union + 1e-5), in float32."""
    occ = batch_occupancy.float().reshape(batch_occupancy.shape[0], -1)
    inter = occ @ occ.T
    sums = occ.sum(dim=1)
    union = sums[:, None] + sums[None, :] - inter
    return inter / (union + 1e-5)


def truncate_sdf(sdf, truncation_val: float):
    """Symmetric clamp of a signed distance field to ±truncation_val."""
    return np.clip(sdf, -truncation_val, truncation_val)


def rename_state_dict(state_dict: dict, key: str) -> dict:
    """The entries of a flat checkpoint under `key.`, with the prefix
    stripped (the sub-network's own state_dict)."""
    return {k[len(key) + 1:]: v for k, v in state_dict.items() if k.startswith(key + ".")}
