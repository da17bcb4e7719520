"""Patch-dictionary construction, as in the JAX package's
retrieval/dictionary.py: encode every train target patch into the shared
latent space and persist the database.

Artifacts, identical in layout:
  * `database.npy`: one row per patch `[scene_idx, x0,x1,y0,y1,z0,z1, z]`
    (extents unpadded, z L2-normalised), plus one synthetic all-trunc
    "zero patch" row with scene_idx -1 at the end;
  * `index.json`: the scene list the scene indices refer to;
  * `params.json`: index metadata (exact search).

Encoders run on the caller's device; batches come from the host loader and
features go back to the host as float32 numpy rows.
"""

from __future__ import annotations

import json
from pathlib import Path

import numpy as np
import torch
from torch import nn

from retrieval_fuse_tpu_torch.data.loader import batch_iterator


def make_encoder_apply(model: nn.Module, device):
    """numpy (B, D, H, W, 1) batch -> the encoder's output on `device`."""
    model = model.to(device).eval()

    def apply_fn(batch: np.ndarray) -> torch.Tensor:
        with torch.inference_mode():
            return model(torch.as_tensor(batch, device=device))

    return apply_fn


def _encode_apply_normalized(encode_fn, batch_np: np.ndarray, latent_dim: int) -> np.ndarray:
    flat = encode_fn(batch_np).reshape(-1, latent_dim).float()
    flat = flat / torch.clamp(torch.linalg.vector_norm(flat, dim=1, keepdim=True), min=1e-12)
    return flat.cpu().numpy()


def get_zero_patch_entry(encode_fn, patch_size: int, patch_context: int,
                         latent_dim: int) -> np.ndarray:
    """Database row of the synthetic all-ones ("all truncation") patch:
    scene_idx -1, extent [0, patch_size]³."""
    side = patch_size + 2 * patch_context
    z = _encode_apply_normalized(encode_fn, np.ones((1, side, side, side, 1), np.float32),
                                 latent_dim)
    return np.hstack([
        np.array([[-1.0]], dtype=np.float32),
        np.array([[0.0, float(patch_size)] * 3], dtype=np.float32),
        z.astype(np.float32),
    ])


def extract_features(encode_fn, query_config: dict, latent_dim: int, dataset, key: str):
    """Batched encoder inference over a dataset split -> (patch_names,
    features (len, latent_dim)), in dataset order, L2-normalised; padding
    rows of the last batch are dropped by its valid count."""
    features = np.zeros((len(dataset), latent_dim), dtype=np.float32)
    patch_names: list[str] = []
    write_idx = 0
    for batch in batch_iterator(dataset, query_config["batch_size"], shuffle=False,
                                drop_last=False):
        valid = batch["valid"]
        feats = _encode_apply_normalized(encode_fn, batch[key], latent_dim)
        features[write_idx: write_idx + valid] = feats[:valid]
        patch_names.extend(batch["name"][:valid])
        write_idx += valid
    return patch_names, features


def extract_input_features(encode_fn, query_config, latent_dim, dataset):
    return extract_features(encode_fn, query_config, latent_dim, dataset, "input")


def extract_target_features(encode_fn, query_config, latent_dim, dataset):
    return extract_features(encode_fn, query_config, latent_dim, dataset, "target")


def create_dictionary(encode_fn, dictionary_config: dict, latent_dim: int, dataset,
                      tree_path) -> np.ndarray:
    """Encode all train target patches -> database rows; write database.npy,
    index.json and params.json under tree_path. Returns the database."""
    tree_path = Path(tree_path)
    tree_path.mkdir(exist_ok=True, parents=True)
    number_of_patches = len(dataset)
    database = np.zeros((number_of_patches + 1, 1 + 6 + latent_dim), dtype=np.float32)
    ctx = dataset.target_patch_context
    write_idx = 0
    for batch in batch_iterator(dataset, dictionary_config["batch_size"], shuffle=False,
                                drop_last=False):
        valid = batch["valid"]
        feats = _encode_apply_normalized(encode_fn, batch["target"], latent_dim)[:valid]
        scene_index = dataset.get_scene_indices(batch["scene"][:valid])[:, np.newaxis] \
            .astype(np.float32)
        extents = batch["extent"][:valid].astype(np.float32)
        extents[:, 1::2] -= 2 * ctx  # stored rows carry context-free extents
        database[write_idx: write_idx + valid] = np.hstack([scene_index, extents, feats])
        write_idx += valid
    database[number_of_patches] = get_zero_patch_entry(
        encode_fn, dataset.target_patch_size, dataset.target_patch_context, latent_dim)
    np.save(tree_path / "database", database)
    (tree_path / "index.json").write_text(json.dumps(dataset.scenes))
    (tree_path / "params.json").write_text(json.dumps(
        {"algorithm": "exact_matmul_topk", "latent_dim": latent_dim, "checks": -1}))
    return database
