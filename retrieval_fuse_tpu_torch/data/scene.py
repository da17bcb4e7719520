"""Per-split scene IO and patch-geometry bookkeeping, as in the JAX
package's data/scene.py (SceneHandler):

  * TSDF scenes are .npz files (key "arr"), kept as float16 and padded by
    patch_context with the truncation value; voxel sizes and truncation
    (3 x voxel size) take a float16 round-trip;
  * point-cloud scenes are voxelized into padded occupancy grids through a
    precomputed pool of random index subsets;
  * scene sizes are cached to data/size/<ds>.json and per-patch occupancy
    counts (voxels with df <= 0.75 * 2 * voxel_size) to
    data/occupancy/<ds>_<chunk>_<psize>_<pctx>.json;
  * patch extents lie on a regular stride grid; patch names are
    "scene--x0_x1_y0_y1_z0_z1".

Host-side numpy; the visualisation methods write OBJ files through the
native marching cubes and utils/visualization.py.
"""

from __future__ import annotations

import json
import os
import random
import tempfile
from pathlib import Path

import numpy as np

from retrieval_fuse_tpu_torch.utils.misc import (
    read_list, point_cloud_to_grid, get_retrievals_dir)


def _write_atomic(path: Path, write) -> None:
    """write(file) into a temporary file beside `path`, then rename it onto
    `path`: processes that share a working directory (the ranks of a mesh)
    never read a cache file half written."""
    path.parents[0].mkdir(exist_ok=True, parents=True)
    with tempfile.NamedTemporaryFile(dir=path.parents[0], prefix=path.name, suffix=".part",
                                     delete=False) as f:
        write(f)
    os.replace(f.name, path)


class SceneHandler:
    """Owns scene loading, padding, caches, and patch-extent math for one split."""

    def __init__(self, split: str, config: dict):
        self.task = config["task"]
        self.scene_size: dict = {}
        self.scene_occupancy: dict = {}
        self.preloaded_scenes_input: dict = {}
        self.preloaded_scenes_target: dict = {}
        self.preloaded_retrievals: dict = {}
        self.random_indices_list = None
        self.retrievals_dir = None
        self.fast_visualization = config.get("fast_visualization", True)
        dataset_config = config[f"dataset_{split}"] if f"dataset_{split}" in config \
            else config["dataset_train"]
        self.dataset_config = dataset_config
        self.input_chunk_size = dataset_config["input_chunk_size"]
        self.target_chunk_size = dataset_config["target_chunk_size"]
        self.number_point_samples = dataset_config["num_points"]
        # float16 round-trip of voxel sizes and truncation
        self.input_voxel_size = np.float16(dataset_config["voxel_size_input"]).astype(np.float32)
        self.target_voxel_size = np.float16(dataset_config["voxel_size_target"]).astype(np.float32)
        self.input_trunc = np.float16(dataset_config["voxel_size_input"] * 3).astype(np.float32)
        self.target_trunc = np.float16(dataset_config["voxel_size_target"] * 3).astype(np.float32)
        self.patch_size_target = dataset_config["patch_size_target"]
        self.patch_context_target = dataset_config["patch_context_target"]
        self.patch_stride_target = dataset_config["patch_stride"]
        self.patch_size_input = dataset_config["patch_size_input"]
        self.patch_context_input = dataset_config["patch_context_input"]
        self.patch_stride_input = int(
            dataset_config["patch_stride"] * dataset_config["patch_size_input"]
            / dataset_config["patch_size_target"])
        self.scale_factor = dataset_config["patch_size_target"] / dataset_config["patch_size_input"]
        self.input_ext = dataset_config["input_ext"]
        self.target_ext = dataset_config["target_ext"]
        self.input_path = Path(dataset_config["scene_dir"], dataset_config["input_dir"],
                               dataset_config["dataset_name"])
        self.target_path = Path(dataset_config["scene_dir"], dataset_config["target_dir"],
                                dataset_config["dataset_name"])
        surface = self.task == "surface_reconstruction"
        self.input_loader = self.pc_loader if surface else self.df_loader
        self.get_scene_input = self.get_pc_scene_input if surface else self.get_df_scene_input
        split_file = Path(dataset_config["data_dir"], "splits", dataset_config["dataset_name"],
                          dataset_config["splits_dir"], f"{split}.txt")
        self.split_shapes = read_list(split_file)
        self.scenes = list(self.split_shapes)
        self.use_retrievals = not config.get("no_retrievals", False)
        if self.use_retrievals:
            self.retrievals_dir = get_retrievals_dir(config)
        self.load_to_memory(dataset_config["preload_scenes"], dataset_config["preload_retrievals"])
        if surface:  # the index pool only matters for point-cloud inputs
            pool_size = dataset_config.get("random_indices_pool_size", 20000 * 10)
            self.initialize_random_indices_list(
                Path(dataset_config["data_dir"], "random_indices",
                     f"{self.number_point_samples}.npz"), pool_size)
        self.initialize_scene_sizes(
            Path(dataset_config["data_dir"], "size", dataset_config["dataset_name"] + ".json"))
        if not dataset_config["skip_occupancy"]:
            self.initialize_scene_occupancy(Path(
                dataset_config["data_dir"], "occupancy",
                f"{dataset_config['dataset_name']}_{self.target_chunk_size:03d}_"
                f"{self.patch_size_target:02d}_{self.patch_context_target:02d}.json"))

    # ---------------------------------------------------------------- loaders

    def df_loader(self, scene: str) -> np.ndarray:
        return np.pad(
            np.load(self.input_path / (scene + self.input_ext))["arr"].astype(np.float16),
            self.patch_context_input, mode="constant", constant_values=self.input_trunc)

    def pc_loader(self, scene: str) -> np.ndarray:
        return np.load(self.input_path / (scene + self.input_ext))["arr_0"]

    def target_loader(self, scene: str) -> np.ndarray:
        return np.pad(
            np.load(self.target_path / (scene + self.target_ext))["arr"].astype(np.float16),
            self.patch_context_target, mode="constant", constant_values=self.target_trunc)

    def load_to_memory(self, preload_scenes: bool, preload_retrievals: bool) -> None:
        if preload_scenes:
            for s in self.scenes:
                self.preloaded_scenes_input[s] = self.input_loader(s)
                self.preloaded_scenes_target[s] = self.target_loader(s)
        if self.use_retrievals and preload_retrievals:
            for s in self.scenes:
                self.preloaded_retrievals[s] = np.pad(
                    np.load(self.retrievals_dir / "compose" / (s + ".npz"))["arr_0"]
                    .astype(np.float16),
                    [(0, 0)] + [(self.patch_context_target, self.patch_context_target)] * 3,
                    mode="constant", constant_values=self.target_trunc)

    def get_df_scene_input(self, scene: str) -> np.ndarray:
        if scene not in self.preloaded_scenes_input:
            return self.df_loader(scene).astype(np.float32)
        return self.preloaded_scenes_input[scene].astype(np.float32)

    def get_pc_scene_input(self, scene: str) -> np.ndarray:
        if scene not in self.preloaded_scenes_input:
            pc = self.pc_loader(scene)
        else:
            pc = self.preloaded_scenes_input[scene]
        if pc.shape[0] < 20000:
            pc = np.vstack([pc, pc])
        pt_indices = self.random_indices_list[
            random.randint(0, self.random_indices_list.shape[0] - 1)]
        pc = pc[pt_indices, :]
        return point_cloud_to_grid(pc, self.input_chunk_size, 1 / self.scale_factor,
                                   self.patch_context_input)

    def get_scene_target_raw(self, scene: str) -> np.ndarray:
        """The padded target scene as stored (float16). Its crops cast to
        float32 equal the crops of get_scene_target, without converting the
        whole scene for each patch."""
        if scene not in self.preloaded_scenes_target:
            return self.target_loader(scene)
        return self.preloaded_scenes_target[scene]

    def get_scene_target(self, scene: str) -> np.ndarray:
        return self.get_scene_target_raw(scene).astype(np.float32)

    def get_scene_retrieval(self, scene: str) -> np.ndarray:
        if scene not in self.preloaded_retrievals:
            return np.pad(
                np.load(self.retrievals_dir / "compose" / (scene + ".npz"))["arr_0"]
                .astype(np.float32),
                [(0, 0)] + [(self.patch_context_target, self.patch_context_target)] * 3,
                mode="constant", constant_values=self.target_trunc)
        return self.preloaded_retrievals[scene].astype(np.float32)

    # ----------------------------------------------------------------- caches

    def initialize_random_indices_list(self, filepath: Path, pool_size: int) -> None:
        if filepath.exists():
            self.random_indices_list = np.load(filepath)["arr"]
        else:
            rng = np.random.default_rng(0)
            pool = np.empty((pool_size, self.number_point_samples), dtype=np.int32)
            for i in range(pool_size):
                pool[i] = rng.choice(20000, size=self.number_point_samples, replace=False)
            self.random_indices_list = pool
            _write_atomic(filepath, lambda f: np.savez_compressed(f, arr=self.random_indices_list))

    def initialize_scene_sizes(self, filepath: Path) -> None:
        needs_recreation = not filepath.exists()
        if filepath.exists():
            self.scene_size = json.loads(filepath.read_text())
            needs_recreation = any(scene not in self.scene_size for scene in self.scenes)
        if needs_recreation:
            for scene in self.scenes:
                self.scene_size[scene] = [s - 2 * self.patch_context_target
                                          for s in self.get_scene_target_raw(scene).shape]
            _write_atomic(filepath, lambda f: f.write(json.dumps(self.scene_size).encode()))

    def initialize_scene_occupancy(self, filepath: Path) -> None:
        needs_recreation = not filepath.exists()
        if filepath.exists():
            self.scene_occupancy = json.loads(filepath.read_text())
            for scene in self.scenes:
                _, target_extents = self.get_scene_patches(scene)
                if any(SceneHandler.get_name_from_extent(scene, e) not in self.scene_occupancy
                       for e in target_extents):
                    needs_recreation = True
                    break
        if needs_recreation:
            for scene in self.scenes:
                target_scene = self.get_scene_target(scene)
                _, target_extents = self.get_scene_patches(scene)
                for e in target_extents:
                    name = SceneHandler.get_name_from_extent(scene, e)
                    self.scene_occupancy[name] = int(
                        (target_scene[e[0]:e[1], e[2]:e[3], e[4]:e[5]]
                         <= 0.75 * 2 * self.target_voxel_size).sum())
            _write_atomic(filepath, lambda f: f.write(json.dumps(self.scene_occupancy).encode()))

    def calculate_occupancy_for_name(self, patch_identifier: str) -> int:
        scene, extent = SceneHandler.get_extent_from_name(patch_identifier)
        return int((self.get_scene_target(scene)[extent[0]:extent[1], extent[2]:extent[3],
                                                 extent[4]:extent[5]]
                    <= 0.75 * 2 * self.target_voxel_size).sum())

    # --------------------------------------------------------- extent algebra

    @staticmethod
    def get_extents_for_size(size, patch_size: int, patch_context: int,
                             patch_stride: int) -> np.ndarray:
        """Padded patch extents on a regular stride grid: linspace endpoints,
        so the last patch ends exactly at the scene boundary, then the
        symmetric context added to the end coordinates."""
        def starts(n):
            end = n - patch_size
            return np.linspace(0, end, end // patch_stride + 1).astype(np.int32)

        x_start, y_start, z_start = np.meshgrid(starts(size[0]), starts(size[1]),
                                                starts(size[2]), indexing="ij")
        span = patch_size + 2 * patch_context
        cols = [x_start, x_start + span, y_start, y_start + span, z_start, z_start + span]
        return np.hstack([c.flatten()[:, np.newaxis] for c in cols])

    def get_scene_patches(self, scene: str):
        size_target = self.scene_size[scene]
        size_input = [int(s / self.scale_factor) for s in self.scene_size[scene]]
        extents_target = self.get_extents_for_size(
            size_target, self.patch_size_target, self.patch_context_target,
            self.patch_stride_target)
        extents_input = self.get_extents_for_size(
            size_input, self.patch_size_input, self.patch_context_input, self.patch_stride_input)
        return extents_input, extents_target

    @staticmethod
    def get_name_from_extent(scene: str, extent_target) -> str:
        return (f"{scene}--{extent_target[0]:04d}_{extent_target[1]:04d}_{extent_target[2]:04d}_"
                f"{extent_target[3]:04d}_{extent_target[4]:04d}_{extent_target[5]:04d}")

    @staticmethod
    def get_extent_from_name(identifier: str):
        scene, rest = identifier.split("--")
        return scene, [int(r) for r in rest.split("_")]

    def create_scene_volume_from_extents(self, scene: str, occupancy_threshold: int = 0):
        """Reassemble a scene from its patches and check the round trip."""
        size = [x + 2 * self.patch_context_target for x in self.scene_size[scene]]
        df_volume_input = np.ones([int(x / self.scale_factor) for x in size],
                                  dtype=np.float32) * self.input_trunc
        df_volume_target = np.ones(size, dtype=np.float32) * self.target_trunc
        patches_input, patches_target = self.get_scene_patches(scene)
        input_scene = self.get_scene_input(scene)
        target_scene = self.get_scene_target(scene)
        for pidx in range(patches_input.shape[0]):
            name = SceneHandler.get_name_from_extent(scene, patches_target[pidx, :])
            if self.scene_occupancy[name] >= occupancy_threshold:
                pi, pt = patches_input[pidx], patches_target[pidx]
                df_volume_input[pi[0]:pi[1], pi[2]:pi[3], pi[4]:pi[5]] = \
                    input_scene[pi[0]:pi[1], pi[2]:pi[3], pi[4]:pi[5]]
                df_volume_target[pt[0]:pt[1], pt[2]:pt[3], pt[4]:pt[5]] = \
                    target_scene[pt[0]:pt[1], pt[2]:pt[3], pt[4]:pt[5]]
        if np.abs(df_volume_input - input_scene).mean() >= 1e-5 \
                or np.abs(df_volume_target - target_scene).mean() >= 1e-5:
            raise ValueError(f"{scene}: patches do not reassemble the scene")
        return df_volume_input, df_volume_target

    def get_all_patches_of_size(self, size: int) -> dict:
        pruned = {}
        for patch in self.scene_occupancy:
            _, extent = SceneHandler.get_extent_from_name(patch)
            if (extent[1] - extent[0]) == size and (extent[3] - extent[2]) == size \
                    and (extent[5] - extent[4]) == size:
                pruned[patch] = self.scene_occupancy[patch]
        return pruned

    def get_patch_occupancy(self, scene: str, target_extent) -> int:
        return self.scene_occupancy.get(SceneHandler.get_name_from_extent(scene, target_extent), 1)

    # ----------------------------------------------------------- visualization

    def visualize_target_chunk(self, chunk_df: np.ndarray, output_path, device=None) -> None:
        """A target-resolution TSDF as an OBJ mesh at 0.75 target voxel.
        Unless fast_visualization, the TSDF is first upsampled 2x
        (trilinear, on `device`: the CUDA card unless "cpu" is asked for)
        and the mesh scaled back."""
        from retrieval_fuse_tpu_torch.utils import visualization
        scale_factor = 1
        if not self.fast_visualization:
            import torch
            from retrieval_fuse_tpu_torch.device import resolve_device
            vol = torch.from_numpy(np.ascontiguousarray(chunk_df, np.float32))
            chunk_df = visualization.trilinear_upsample_2x(
                vol.to(resolve_device(device))).cpu().numpy()
            scale_factor = 2
        visualization.visualize_sdf_as_mesh(chunk_df, output_path, self.target_voxel_size * 0.75,
                                            scale_factor=scale_factor)

    def visualize_input_chunk(self, chunk, output_path) -> None:
        """An input chunk as voxel boxes: occupied cells of a point-cloud
        grid, or cells at or below 0.675 input voxel of a TSDF."""
        from retrieval_fuse_tpu_torch.utils import visualization
        if self.task == "surface_reconstruction":
            visualization.visualize_grid_as_voxels(chunk, output_path)
        else:
            visualization.visualize_sdf_as_voxels(chunk, output_path, self.input_voxel_size * 0.675)

    @staticmethod
    def visualize_weight(chunk_weight, output_path):
        from retrieval_fuse_tpu_torch.utils import visualization
        visualization.visualize_float_grid(chunk_weight, 1, 1, 4, output_path)

    @staticmethod
    def visualize_normal(chunk_normal, output_path):
        from retrieval_fuse_tpu_torch.utils import visualization
        visualization.visualize_normals(chunk_normal, output_path)
