"""Patch-triple dataset (input patch, target patch, retrieval patches), as
in the JAX package's data/patched_dataset.py:

  * scenes missing on disk are filtered out;
  * patches are kept only above `occupancy_threshold` (val uses -1: all);
  * `train_multiplier` repeats the train list;
  * __getitem__ slices the padded scenes by extent and normalizes by the
    config mean/std; with retrievals off it emits a K=4 trunc-filled dummy;
  * chunks recombine into super-scenes by `name__position` parsing.

Items are numpy dicts, channels-last (D, H, W, 1), as in JAX.
"""

from __future__ import annotations

from collections import defaultdict
from pathlib import Path

import numpy as np

from retrieval_fuse_tpu_torch.data.scene import SceneHandler
from retrieval_fuse_tpu_torch.utils.misc import read_list


class PatchedSceneDataset:

    def __init__(self, split: str, dataset_config: dict, scene_handler: SceneHandler):
        self.scene_handler = scene_handler
        self.dataset_name = dataset_config["dataset_name"]
        self.input_mean, self.input_std = dataset_config["input_mean"], dataset_config["input_std"]
        self.target_mean, self.target_std = dataset_config["target_mean"], dataset_config["target_std"]
        self.use_retrievals = scene_handler.use_retrievals
        self.scenes = read_list(Path(dataset_config["data_dir"], "splits",
                                     dataset_config["dataset_name"], dataset_config["splits_dir"],
                                     f"{split}.txt"))
        for kind in ("target", "input"):
            folder = Path(dataset_config["data_dir"], dataset_config[f"{kind}_dir"],
                          dataset_config["dataset_name"])
            self.scenes = [x for x in self.scenes
                           if (folder / (x + dataset_config[f"{kind}_ext"])).exists()]
        self.data = []
        for s in self.scenes:
            input_extent, target_extent = self.scene_handler.get_scene_patches(s)
            for ii in range(len(input_extent)):
                if self.scene_handler.get_patch_occupancy(s, target_extent[ii]) \
                        > dataset_config["occupancy_threshold"]:
                    self.data.append([s, input_extent[ii], target_extent[ii]])
        self.patch_from_scene_lookup = defaultdict(list)
        for d in self.data:
            self.patch_from_scene_lookup[d[0]].append(SceneHandler.get_name_from_extent(d[0], d[2]))
        if split == "train":
            self.data = self.data * dataset_config["train_multiplier"]

    def use_subset(self, subset) -> None:
        subset_extent = [self.scene_handler.get_extent_from_name(x) for x in subset]
        self.data = [[d[0], [int(e // self.scene_handler.scale_factor) for e in d[1]], d[1]]
                     for d in subset_extent]

    @property
    def target_trunc(self):
        return self.scene_handler.target_trunc

    @property
    def target_voxel_size(self):
        return self.scene_handler.target_voxel_size

    @property
    def input_trunc(self):
        return self.scene_handler.input_trunc

    @property
    def input_voxel_size(self):
        return self.scene_handler.input_voxel_size

    @property
    def target_patch_size(self):
        return self.scene_handler.patch_size_target

    @property
    def target_patch_context(self):
        return self.scene_handler.patch_context_target

    @property
    def input_chunk_size(self):
        return self.scene_handler.input_chunk_size

    @property
    def target_chunk_size(self):
        return self.scene_handler.target_chunk_size

    def get_scene_size(self, scene):
        return self.scene_handler.scene_size[scene]

    def get_scene_indices(self, scenes):
        return np.array([self.scenes.index(s) for s in scenes])

    def get_scene_names_from_patches(self, patch_names):
        return [self.scene_handler.get_extent_from_name(x)[0] for x in patch_names]

    def __len__(self):
        return len(self.data)

    @staticmethod
    def get_scene_unpadded(scene, scene_handler_func, patch_context):
        scene_padded = scene_handler_func(scene)
        return scene_padded[
            patch_context: scene_padded.shape[0] - patch_context,
            patch_context: scene_padded.shape[1] - patch_context,
            patch_context: scene_padded.shape[2] - patch_context,
        ]

    def get_scene_input(self, scene):
        return PatchedSceneDataset.get_scene_unpadded(
            scene, self.scene_handler.get_scene_input, self.scene_handler.patch_context_input)

    def get_scene_target(self, scene):
        return PatchedSceneDataset.get_scene_unpadded(
            scene, self.scene_handler.get_scene_target, self.scene_handler.patch_context_target)

    def get_scene_target_crop(self, scene, x0, x1, y0, y1, z0, z1) -> np.ndarray:
        """get_scene_target(scene)[x0:x1, y0:y1, z0:z1], converting only the crop."""
        c = self.scene_handler.patch_context_target
        raw = self.scene_handler.get_scene_target_raw(scene)
        unpadded = raw[c: raw.shape[0] - c, c: raw.shape[1] - c, c: raw.shape[2] - c]
        return unpadded[x0:x1, y0:y1, z0:z1].astype(np.float32)

    def unpad(self, *extents):
        if len(extents) == 2:
            return [extents[0], extents[1] - 2 * self.scene_handler.patch_context_target]
        return self.unpad(extents[0], extents[1]) + self.unpad(extents[2], extents[3]) \
            + self.unpad(extents[4], extents[5])

    def pad(self, *extents):
        if len(extents) == 2:
            return [extents[0], extents[1] + 2 * self.scene_handler.patch_context_target]
        return self.pad(extents[0], extents[1]) + self.pad(extents[2], extents[3]) \
            + self.pad(extents[4], extents[5])

    @property
    def no_overlap(self):
        return self.scene_handler.patch_stride_target == self.scene_handler.patch_size_target

    def __getitem__(self, index: int) -> dict:
        scene, ei, et = self.data[index]
        scene_shape_input = self.scene_handler.get_scene_input(scene)
        patch_input = scene_shape_input[ei[0]:ei[1], ei[2]:ei[3], ei[4]:ei[5]]
        # the crop of the stored float16 scene, cast: equal to slicing
        # get_scene_target(scene), without converting the whole scene
        patch_target = self.scene_handler.get_scene_target_raw(scene)[
            et[0]:et[1], et[2]:et[3], et[4]:et[5]].astype(np.float32)
        return_dict = {
            "name": SceneHandler.get_name_from_extent(scene, et),
            "scene": scene,
            "extent": np.asarray(et, dtype=np.int32),
            "input": ((patch_input[..., np.newaxis] - self.input_mean)
                      / self.input_std).astype(np.float32),
            "target": ((patch_target[..., np.newaxis] - self.target_mean)
                       / self.target_std).astype(np.float32),
        }
        if self.use_retrievals:
            scene_shape_retrieval = self.scene_handler.get_scene_retrieval(scene)
            patch_retrieval = scene_shape_retrieval[:, et[0]:et[1], et[2]:et[3], et[4]:et[5]]
            return_dict["retrieval"] = ((patch_retrieval - self.target_mean)
                                        / self.target_std).astype(np.float32)
        else:
            return_dict["retrieval"] = np.ones(
                (4, et[1] - et[0], et[3] - et[2], et[5] - et[4]),
                dtype=np.float32) * self.target_trunc
        return return_dict

    # ------------------------------------------------- scene recomposition

    def get_superscene_name_and_position_from_chunk(self, chunk_name: str):
        if self.dataset_name.startswith("Matterport3D") or self.dataset_name.startswith("3DFront"):
            name = "__".join(chunk_name.split("__")[:2])
            position = [int(x) for x in chunk_name.split("__")[-1].split("_")]
            return name, np.array(position)
        return chunk_name, np.array([0, 0, 0])

    def combine_chunks(self, scale_factor, chunk_size, trunc_val, scene_accessor, container_obj):
        result = {}
        superscene_chunks = defaultdict(list)
        for s in self.scenes:
            name, position = self.get_superscene_name_and_position_from_chunk(s)
            superscene_chunks[name].append((s, (position / scale_factor).astype(np.int32)))
        for ss, chunkpositions in superscene_chunks.items():
            positions = np.vstack([cp[1] for cp in chunkpositions])
            combined = np.ones([positions[:, 0].max() + chunk_size,
                                positions[:, 1].max() + chunk_size,
                                positions[:, 2].max() + chunk_size]) * trunc_val
            for cp in chunkpositions:
                scene_unpadded = scene_accessor(container_obj, cp[0])
                combined[cp[1][0]:cp[1][0] + scene_unpadded.shape[0],
                         cp[1][1]:cp[1][1] + scene_unpadded.shape[1],
                         cp[1][2]:cp[1][2] + scene_unpadded.shape[2]] = scene_unpadded
            result[ss] = combined
        return result

    def combine_inputs(self):
        return self.combine_chunks(
            self.target_chunk_size / self.input_chunk_size, self.input_chunk_size,
            self.input_trunc, PatchedSceneDataset.get_scene_input, self)

    def combine_targets(self):
        return self.combine_chunks(
            1, self.target_chunk_size, self.target_trunc, PatchedSceneDataset.get_scene_target,
            self)

    def combine_retrievals(self, retrievals, k):
        def accessor(passed_obj, name):
            _retrievals, _scenes, _k = passed_obj
            return _retrievals[_scenes.index(name), _k, :, :, :]
        return self.combine_chunks(
            1, self.target_chunk_size, self.target_trunc, accessor, [retrievals, self.scenes, k])

    def denormalize_target(self, patch):
        return patch * self.target_std + self.target_mean

    def denormalize_input(self, patch):
        return patch * self.input_std + self.input_mean


class CombinedDataset:
    """Concatenation of several PatchedSceneDatasets."""

    def __init__(self, *datasets):
        self.datasets = datasets
        self.scenes = []
        for ds in self.datasets:
            self.scenes.extend(ds.scenes)

    def __len__(self):
        return sum(len(ds) for ds in self.datasets)

    def __getitem__(self, index):
        offset = 0
        item = None
        for ds in self.datasets:
            if index < len(ds) + offset:
                item = ds[index - offset]
                break
            offset += len(ds)
        item["input"] = []
        return item

    def get_scene_indices(self, scenes):
        return np.array([self.scenes.index(s) for s in scenes])

    def unpad(self, *extents):
        return self.datasets[0].unpad(*extents)

    @property
    def target_patch_size(self):
        return self.datasets[0].target_patch_size

    @property
    def target_patch_context(self):
        return self.datasets[0].target_patch_context

    def get_scene_target(self, scene):
        for ds in self.datasets:
            if scene in ds.scenes:
                return ds.get_scene_target(scene) * self.datasets[0].target_voxel_size \
                    / ds.target_voxel_size
        raise KeyError(scene)
