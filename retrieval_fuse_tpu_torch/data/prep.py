"""Offline data-preparation utilities, as in the JAX package's data/prep.py:

  * sample_scene_point_clouds: surface points plus jittered near-surface
    points (those that land in empty space rejected) from full-scene
    distance fields, the inputs of the surface-reconstruction task;
  * create_combined_point_clouds: per-chunk point clouds merged into
    multi-resolution full-scene clouds (2000 / 1000 / 500 points a chunk);
  * visualize_retrievals: composed retrieval chunks stitched into scenes and
    written as meshes.

Meshing is the native marching cubes, sampling evaluation.mesh's. The mesh
-> SDF conversion that makes the distance fields stays outside the repo.
Host numpy; the draws come from numpy's and `random`'s global generators.
"""

from __future__ import annotations

import random
from pathlib import Path

import numpy as np

from retrieval_fuse_tpu_torch.utils.misc import read_list


def sample_scene_point_clouds(config: dict, full_scene_dir, num_points: int, output_dir,
                              visualize: bool = False, sigma: float = 0.25,
                              split: str = "val") -> None:
    """Per scene: mesh the scene df, sample surface points (half) plus
    jittered near-surface points filtered by df occupancy (half), save npz.
    """
    from retrieval_fuse_tpu_torch.native import marching_cubes
    from retrieval_fuse_tpu_torch.evaluation.mesh import Mesh
    from retrieval_fuse_tpu_torch.utils.visualization import visualize_pointcloud

    dtr = config["dataset_train"]
    split_shapes = read_list(Path(dtr["data_dir"], "splits", dtr["dataset_name"],
                                  dtr["splits_dir"], f"{split}.txt"))
    split_shapes = list(set(split_shapes))
    all_scenes = list(set("__".join(s.split("__")[:3]) for s in split_shapes))
    level = 0.75 * dtr["voxel_size_target"]

    for scene in sorted(all_scenes):
        scene_path = Path(full_scene_dir, scene + ".npy")
        if not scene_path.exists():
            print(full_scene_dir, scene + ".npy")
            continue
        out_path = Path(output_dir) / (scene + ".npz")
        if out_path.exists():
            continue
        scene_df = np.load(scene_path)
        num_chunks = len([x for x in split_shapes if x.startswith(scene)])
        num_points_to_sample = num_chunks * num_points
        verts, tris = marching_cubes(scene_df.astype(np.float32), level)
        if len(tris) == 0:
            continue
        mesh = Mesh(verts, tris)
        points_surface = mesh.sample(num_points_to_sample // 2, seed=0)
        points_jittered = mesh.sample(num_points_to_sample * 4, seed=1)
        points_jittered = points_jittered + sigma * np.random.randn(*points_jittered.shape)
        points_grid = np.clip(points_jittered, 0, scene_df.shape[0] - 1).astype(np.uint32)
        occupied = scene_df[points_grid[:, 0], points_grid[:, 1], points_grid[:, 2]] <= level
        points_jittered = points_jittered[occupied]
        want = num_points_to_sample - num_points_to_sample // 2
        if points_jittered.shape[0] > want:
            keep = random.sample(range(points_jittered.shape[0]), want)
            points_jittered = points_jittered[keep, :]
        all_points = np.concatenate([points_surface, points_jittered], axis=0)
        Path(output_dir).mkdir(exist_ok=True, parents=True)
        np.savez_compressed(out_path, all_points)
        if visualize:
            visualize_pointcloud(all_points, Path(output_dir) / f"{scene}.obj")


def create_combined_point_clouds(config: dict, visualize: bool = False,
                                 num_points=(2000, 1000, 500)) -> None:
    """Merge per-chunk 20K point clouds into full-scene multi-resolution
    clouds, shifting by the chunk's encoded position.
    """
    from retrieval_fuse_tpu_torch.utils.visualization import visualize_pointcloud

    dtr = config["dataset_train"]
    split_shapes = read_list(Path(dtr["data_dir"], "splits", dtr["dataset_name"],
                                  dtr["splits_dir"], "train.txt"))
    split_shapes += read_list(Path(dtr["data_dir"], "splits", dtr["dataset_name"],
                                   dtr["splits_dir"], "val.txt"))
    pc_dir = Path(dtr["data_dir"], dtr["input_dir"], dtr["dataset_name"])
    all_point_clouds = list(pc_dir.iterdir())
    all_scenes = set("__".join(s.split("__")[:2]) for s in split_shapes)
    for scene in sorted(all_scenes):
        scene_point_clouds = {n: [] for n in num_points}
        for p in all_point_clouds:
            if p.name.split(".npz")[0].startswith(scene):
                point_cloud = np.load(str(p))["arr_0"]
                for n in num_points:
                    rand_indices = random.sample(range(min(20000, len(point_cloud))), n)
                    sub = point_cloud[rand_indices, :].copy()
                    shift = [int(x) for x in p.name.split(".npz")[0].split("__")[-1].split("_")]
                    sub[:, 0] += shift[0]
                    sub[:, 1] += shift[1]
                    sub[:, 2] += shift[2]
                    scene_point_clouds[n].append(sub)
        for n in num_points:
            output_dir = Path(dtr["data_dir"]) / dtr["dataset_name"] / f"pc_{n}"
            output_dir.mkdir(exist_ok=True, parents=True)
            if scene_point_clouds[n]:
                pc = np.vstack(scene_point_clouds[n])
                np.savez_compressed(output_dir / scene, pc)
                if visualize:
                    visualize_pointcloud(pc, output_dir / f"{scene}.obj")


def visualize_retrievals(path_to_retrievals, sample_name: str, voxel_size: float,
                         k_max: int = 8, chunk: int = 64) -> None:
    """Stitch composed retrieval chunks of one super-scene and dump per-k
    meshes."""
    from retrieval_fuse_tpu_torch.utils.visualization import visualize_sdf_as_mesh

    positions, chunks = [], []
    for x in Path(path_to_retrievals).iterdir():
        if x.name.startswith(sample_name):
            positions.append([int(y) for y in x.name.split(".")[0].split("__")[-1].split("_")])
            chunks.append(np.load(x)["arr_0"])
    if not chunks:
        return
    pos = np.array(positions)
    shape = [k_max, pos[:, 0].max() + chunk, pos[:, 1].max() + chunk, pos[:, 2].max() + chunk]
    combined = np.ones(shape) * voxel_size * 3
    for k in range(min(k_max, chunks[0].shape[0])):
        for i, c in enumerate(chunks):
            combined[k, pos[i][0]:pos[i][0] + chunk, pos[i][1]:pos[i][1] + chunk,
                     pos[i][2]:pos[i][2] + chunk] = c[k]
        visualize_sdf_as_mesh(combined[k], f"{sample_name}_nn{k + 1}.obj", voxel_size * 0.75)
