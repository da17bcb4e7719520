"""Retrieval CLI, as in the JAX package's retrieval/cli.py: build the
dictionary and the retrieval mappings (`map`), write composed per-scene
retrieval volumes (`compose`), score the 1-NN composed scenes (`evaluate`).

  map      -> database.npy + index.json + params.json under the scratch tree
              path, map_train.npy / map_val.npy under the retrievals dir
  compose  -> compose/<scene>.npz per scene, pasted by the native C++ paste
              (native/compose.cpp; g++ is needed), shardable with
              --num_proc/--proc
  evaluate -> prints (and returns) [iou, cd, precision, recall]

    python -m retrieval_fuse_tpu_torch.retrieval.cli --config C.yaml \\
        --retrieval_ckpt runs/<exp>/ckpt_epoch=<E> --mode map compose evaluate [--device cpu]

`--retrieval_ckpt` is a checkpoint in the port's layout (train/checkpoint.py;
tools/torch_port_ckpt_from_jax.py converts a JAX one). The encoders and the
metrics run on `--device`: the CUDA card unless "cpu" is asked for.
"""

from __future__ import annotations

import argparse

import numpy as np

from retrieval_fuse_tpu_torch.data import SceneHandler, PatchedSceneDataset
from retrieval_fuse_tpu_torch.device import resolve_device
from retrieval_fuse_tpu_torch.models import get_retrieval_networks
from retrieval_fuse_tpu_torch.retrieval.dictionary import (
    create_dictionary, extract_input_features, extract_target_features, make_encoder_apply)
from retrieval_fuse_tpu_torch.retrieval.engine import (
    RetrievalInterface, create_retrieval_from_mapping)
from retrieval_fuse_tpu_torch.train.checkpoint import load_checkpoint
from retrieval_fuse_tpu_torch.utils.misc import get_retrievals_dir, get_tree_path
from retrieval_fuse_tpu_torch.utils.timer import Timer


def load_encoders_from_checkpoint(config: dict, device):
    """Apply functions of both encoders of a retrieval checkpoint, on `device`."""
    fenc_input, fenc_target = get_retrieval_networks(config["retrieval_model"])
    params = load_checkpoint(config["retrieval_ckpt"])["params"]
    fenc_input.load_state_dict(params["fenc_input"])
    fenc_target.load_state_dict(params["fenc_target"])
    return make_encoder_apply(fenc_input, device), make_encoder_apply(fenc_target, device)


def retrievals_to_disk(mode: str, config: dict, use_target_for_feats: bool = False,
                       num_proc: int = 1, proc: int = 0, device=None, mesh=None):
    """Run one mode of the pipeline. `evaluate` returns the metric list.
    With `mesh`, `map` shards the dictionary's rows over its ranks (every
    rank computes the same mapping; rank 0 writes the files)."""
    from retrieval_fuse_tpu_torch.parallel.mesh import barrier, is_writer
    dev = mesh.device if mesh is not None else resolve_device(device)
    retrievals_dir = get_retrievals_dir(config)
    tree_path = get_tree_path(config)

    scene_handler_train = SceneHandler("train", config)
    scene_handler_val = SceneHandler("val", config)
    dataset_train = PatchedSceneDataset("train", config["dataset_train"], scene_handler_train)
    dataset_val = PatchedSceneDataset("val", config["dataset_val"], scene_handler_val)

    if mode == "map":
        encode_in, encode_tgt = load_encoders_from_checkpoint(config, dev)
        retrievals_dir.mkdir(exist_ok=True, parents=True)
        latent_dim = config["retrieval_model"]["latent_dim"]
        if is_writer(mesh):
            create_dictionary(encode_tgt, config["dictionary"], latent_dim, dataset_train,
                              tree_path)
        barrier(mesh)
        handler = RetrievalInterface(config["query"], latent_dim, device=dev, mesh=mesh)
        encode = encode_tgt if use_target_for_feats else encode_in
        extract = extract_target_features if use_target_for_feats else extract_input_features
        mapping = handler.get_retrieval_mapping(encode, extract, tree_path, dataset_train, True)
        if is_writer(mesh):
            with Timer("np_save_train"):
                np.save(retrievals_dir / "map_train.npy", mapping)  # a pickled dict payload
        mapping = handler.get_retrieval_mapping(encode, extract, tree_path, dataset_val, False)
        if is_writer(mesh):
            with Timer("np_save_val"):
                np.save(retrievals_dir / "map_val.npy", mapping)
        barrier(mesh)
    elif mode == "compose":
        (retrievals_dir / "compose").mkdir(exist_ok=True, parents=True)
        for map_name, dataset in [("map_train.npy", dataset_train), ("map_val.npy", dataset_val)]:
            split_scenes = [x for i, x in enumerate(dataset.scenes) if i % num_proc == proc]
            mapping = np.load(retrievals_dir / map_name, allow_pickle=True)[()]
            for scene in split_scenes:
                retrieval = create_retrieval_from_mapping(
                    scene, mapping, config["K"], dataset_train, dataset, tree_path,
                    use_native=True)
                np.savez_compressed(retrievals_dir / "compose" / f"{scene}.npz", retrieval)
    elif mode == "evaluate":
        from retrieval_fuse_tpu_torch.train.retrieval_trainer import get_metrics_for_retrieval
        retrievals = [np.load(retrievals_dir / "compose" / f"{scene}.npz")["arr_0"][:1]
                      for scene in dataset_val.scenes]
        metrics = get_metrics_for_retrieval(np.stack(retrievals, axis=0), dataset_val, device=dev)
        print(metrics)
        return metrics
    else:
        raise ValueError(f"unknown mode {mode}")
    return None


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--config", type=str, help="config path")
    parser.add_argument("--retrieval_ckpt", type=str, default=None)
    parser.add_argument("--mode", type=str, nargs="+")
    parser.add_argument("--proc", type=int, default=0, help="process id")
    parser.add_argument("--K", type=int, default=4, help="kNN")
    parser.add_argument("--num_proc", type=int, default=1, help="num processes")
    parser.add_argument("--no_preload", action="store_true")
    parser.add_argument("--target_query", action="store_true")
    parser.add_argument("--device", type=str, default=None,
                        help="cuda (default) or cpu")
    args = parser.parse_args(argv)
    from retrieval_fuse_tpu_torch.config import read_config
    config = read_config(args.config, args)
    config["query"]["K"] = config["K"]
    if args.no_preload:
        config["dataset_train"]["preload_scenes"] = False
        config["dataset_val"]["preload_scenes"] = False
    for mode in args.mode:
        retrievals_to_disk(mode, config, args.target_query, args.num_proc, args.proc,
                           device=args.device)


if __name__ == "__main__":
    main()
