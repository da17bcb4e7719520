"""Retrieval engine, as in the JAX package's retrieval/engine.py: kNN
queries over the patch dictionary on the device, and composition of the
retrieved crops into full-scene approximation volumes on the host.

Artifacts, identical in layout: `map_{train,val}.npy` is a dict
patch_name -> (K, 8) float64 rows `[scene_idx, x0,x1,y0,y1,z0,z1, sq_dist]`;
`compose/<scene>.npz` holds the (K, *scene_size) stacked retrieval volume,
pasted with lowest-distance priority where strides overlap.

The search is exact: ops/knn.auto_exact_knn, which takes the streaming kNN
kernel at float32 query batches >= 4096 against >= 16,384 rows and the dense
path below (a float32 matmul and the topk kernel, for k <= 8). Compose
pastes in numpy, or with `use_native` in the native C++ paste
(native/compose.cpp), which gives the same volumes. With a `mesh`
(parallel/mesh.py) the database's rows are sharded over its ranks
(ops/knn.sharded_exact_knn): each rank searches its own block on its card
and every rank gets the merged mapping.
"""

from __future__ import annotations

import json
from pathlib import Path

import numpy as np
import torch

from retrieval_fuse_tpu_torch.data.scene import SceneHandler
from retrieval_fuse_tpu_torch.device import resolve_device
from retrieval_fuse_tpu_torch.ops.knn import auto_exact_knn, demote_same_scene, sharded_exact_knn
from retrieval_fuse_tpu_torch.ops.streaming_knn import knn_rows
from retrieval_fuse_tpu_torch.utils.timer import Timer

Q_BATCH = 8192  # queries per search, halved while the (Q, N) scores pass ~2 GB


def query_batch_size(n_rows: int) -> int:
    q_batch = Q_BATCH
    while q_batch > 256 and q_batch * n_rows * 4 > 2 << 30:
        q_batch //= 2
    return q_batch


def query_dictionary_using_features(query_config: dict, patch_names, input_features: np.ndarray,
                                    dataset, tree_path, ignore_patches_from_source: bool,
                                    device=None, mesh=None) -> dict:
    """kNN query of 2K neighbours per patch, same-scene demotion (when
    `ignore_patches_from_source`), keep the top K. Returns the mapping.
    With `mesh`, the database is sharded over its ranks (on the mesh's
    device)."""
    dev = mesh.device if mesh is not None else resolve_device(device)
    tree_path = Path(tree_path)
    database = np.load(tree_path / "database.npy")
    dataset_index = json.loads((tree_path / "index.json").read_text())
    k = query_config["K"]
    scene_to_id = {s: i for i, s in enumerate(dataset_index)}
    query_scene_ids = torch.tensor(
        [scene_to_id.get(s, -2) for s in dataset.get_scene_names_from_patches(patch_names)],
        dtype=torch.int32, device=dev)
    db_scene_ids = torch.from_numpy(database[:, 0].astype(np.int32)).to(dev)
    rows = torch.from_numpy(np.ascontiguousarray(database[:, 7:]))
    db_embeddings = rows if mesh is not None else knn_rows(rows.to(dev))
    q_batch = query_batch_size(-(-db_embeddings.shape[0] // (mesh.size if mesh else 1)))
    retrieval_mapping: dict = {}
    with Timer("ExactKNN", verbose=False):
        for start in range(0, input_features.shape[0], q_batch):
            q = torch.from_numpy(input_features[start: start + q_batch]).to(dev)
            if mesh is not None:
                top_idx, sq_d = sharded_exact_knn(q, db_embeddings, 2 * k, mesh)
            else:
                top_idx, sq_d = auto_exact_knn(q, db_embeddings, 2 * k)
            if ignore_patches_from_source:
                top_idx, sq_d = demote_same_scene(top_idx, sq_d, db_scene_ids,
                                                  query_scene_ids[start: start + q.shape[0]], k)
            else:
                top_idx, sq_d = top_idx[:, :k], sq_d[:, :k]
            top_idx, sq_d = top_idx.cpu().numpy(), sq_d.cpu().numpy()
            rows = np.concatenate([database[top_idx.reshape(-1), 0:7].reshape(top_idx.shape[0], k, 7),
                                   sq_d[..., None]], axis=2)  # (q, K, 8)
            for i, name in enumerate(patch_names[start: start + q.shape[0]]):
                retrieval_mapping[name] = rows[i].astype(np.float64)
    return retrieval_mapping


def create_retrieval_from_mapping(scene_name: str, retrieval_mappings: dict, K: int,
                                  dataset_train, dataset, tree_path,
                                  use_native: bool = False) -> np.ndarray:
    """Paste retrieved train-scene crops into K full-scene volumes: crops are
    rescaled by the trunc ratio, zero-patch rows paste trunc everywhere, and
    where strides overlap the lowest-distance patch wins per region through
    a running distance volume. Host-side, per scene: numpy, or with
    `use_native` the C++ paste (Python gathers the crops, C++ applies the
    priority rule; the same volumes)."""
    if use_native:
        return _create_retrieval_from_mapping_native(
            scene_name, retrieval_mappings, K, dataset_train, dataset, tree_path)
    dataset_index = json.loads((Path(tree_path) / "index.json").read_text())
    scene_size = dataset.get_scene_size(scene_name)
    scene_retrieval = np.ones((K, scene_size[0], scene_size[1], scene_size[2]),
                              dtype=np.float32) * dataset.target_trunc
    distances = np.ones_like(scene_retrieval) * 100.0
    scale = dataset.target_trunc / dataset_train.target_trunc
    for k in range(K):
        for p in dataset.patch_from_scene_lookup[scene_name]:
            X0, X1, Y0, Y1, Z0, Z1 = retrieval_mappings[p][k, 1:7].astype(np.int32).tolist()
            current_distance = retrieval_mappings[p][k, 7]
            xx0, xx1, yy0, yy1, zz0, zz1 = dataset_train.unpad(
                *SceneHandler.get_extent_from_name(p)[1])
            if dataset.no_overlap or distances[k, xx0:xx1, yy0:yy1, zz0:zz1].mean() > current_distance:
                index_ptr = int(retrieval_mappings[p][k, 0])
                if index_ptr >= 0:
                    crop = dataset_train.get_scene_target_crop(dataset_index[index_ptr],
                                                               X0, X1, Y0, Y1, Z0, Z1)
                else:
                    crop = (np.ones((scene_size[0], scene_size[1], scene_size[2]),
                                    dtype=np.float32) * dataset.target_trunc)[X0:X1, Y0:Y1, Z0:Z1]
                scene_retrieval[k, xx0:xx1, yy0:yy1, zz0:zz1] = crop * scale
                distances[k, xx0:xx1, yy0:yy1, zz0:zz1] = float(current_distance)
    return scene_retrieval


def _create_retrieval_from_mapping_native(scene_name, retrieval_mappings, K, dataset_train,
                                          dataset, tree_path) -> np.ndarray:
    """create_retrieval_from_mapping with the paste in C++: per k, the
    scene's P crops (trunc-ratio scaled; a zero-patch row's crop is trunc,
    scaled as well) go to native.compose_paste in one call."""
    from retrieval_fuse_tpu_torch.native import compose_paste
    dataset_index = json.loads((Path(tree_path) / "index.json").read_text())
    scene_size = tuple(dataset.get_scene_size(scene_name))
    scene_retrieval = np.ones((K,) + scene_size, dtype=np.float32) * dataset.target_trunc
    patches = dataset.patch_from_scene_lookup[scene_name]
    scale = dataset.target_trunc / dataset_train.target_trunc
    ps = dataset.target_patch_size
    extents = np.array([dataset_train.unpad(*SceneHandler.get_extent_from_name(p)[1])
                        for p in patches], np.int32).reshape(len(patches), 6)
    for k in range(K):
        crops = np.empty((len(patches), ps, ps, ps), np.float32)
        dists = np.empty(len(patches), np.float32)
        for i, p in enumerate(patches):
            row = retrieval_mappings[p][k]
            dists[i] = row[7]
            index_ptr = int(row[0])
            if index_ptr >= 0:
                crops[i] = dataset_train.get_scene_target_crop(
                    dataset_index[index_ptr], *row[1:7].astype(np.int32).tolist()) * scale
            else:
                crops[i] = dataset.target_trunc * scale
        distances = np.full(scene_size, 100.0, np.float32)
        compose_paste(scene_retrieval[k], distances, crops, extents, dists, dataset.no_overlap)
    return scene_retrieval


class RetrievalInterface:
    """High-level retrieve API over a dictionary on disk."""

    def __init__(self, config_query: dict, latent_dim: int, device=None, mesh=None):
        """`mesh`: shard the dictionary's rows over its ranks (sharded kNN)."""
        self.config = config_query
        self.latent_dim = latent_dim
        self.mesh = mesh
        self.device = mesh.device if mesh is not None else resolve_device(device)

    def get_retrieval_mapping(self, encode_fn, extraction_func, tree_path, dataset,
                              ignore_patches_from_source: bool) -> dict:
        patch_names, feats = extraction_func(encode_fn, self.config, self.latent_dim, dataset)
        return query_dictionary_using_features(
            self.config, patch_names, feats, dataset, tree_path, ignore_patches_from_source,
            self.device, self.mesh)

    def get_features(self, encode_input, encode_target, dataset):
        from retrieval_fuse_tpu_torch.retrieval.dictionary import (
            extract_input_features, extract_target_features)
        names_0, feats_input = extract_input_features(encode_input, self.config,
                                                      self.latent_dim, dataset)
        names_1, feats_target = extract_target_features(encode_target, self.config,
                                                        self.latent_dim, dataset)
        if len(names_0) != len(names_1) or sorted(names_0) != sorted(names_1):
            raise ValueError("input and target features cover different patches")
        return names_0, feats_input, feats_target

    @staticmethod
    def retrieve_nearest_scenes(retrieval_mapping, scene, K, tree_path, dataset_train, dataset):
        return create_retrieval_from_mapping(scene, retrieval_mapping, K, dataset_train, dataset,
                                             tree_path)

    @staticmethod
    def retrieve_nearest_scenes_for_all(retrieval_mapping, scenes, K, tree_path, dataset_train,
                                        dataset):
        return np.stack([
            create_retrieval_from_mapping(s, retrieval_mapping, K, dataset_train, dataset,
                                          tree_path)
            for s in scenes], axis=0)

    def create_mapping_and_retrieve_nearest_scenes_for_all(self, encode_input, tree_path,
                                                           dataset_train, dataset, K,
                                                           ignore_patches_from_source):
        from retrieval_fuse_tpu_torch.retrieval.dictionary import extract_input_features
        mapping = self.get_retrieval_mapping(
            encode_input, extract_input_features, tree_path, dataset, ignore_patches_from_source)
        return RetrievalInterface.retrieve_nearest_scenes_for_all(
            mapping, dataset.scenes, K, tree_path, dataset_train, dataset)
