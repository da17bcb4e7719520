"""Driver entry points of the port, its counterpart of the JAX package's
__graft_entry__.py.

entry(device=None)   -> (fn, example_args): the flagship serving forward
                        (FAST_VARIANT, bf16) on one card; fn(raw_input)
                        returns the (B, 64, 64, 64, 1) TSDF.
dryrun_multichip(n)  -> spawns n ranks of a process group (parallel/mesh.py)
                        and runs on tiny synthetic data what the JAX dryrun
                        runs on its n-device mesh: one phase-3 refinement
                        step with the batch sharded, the sharded kNN against
                        the dense one, the sharded validation metrics, and
                        serving with the batch sharded (FAST_VARIANT,
                        `fused+pallasp+topk1p+dconv+fbb` and
                        `fused+pallasp+topk1p+cdec`) against the unsharded
                        `base` engine. Returns rank 0's readings.

    python -m retrieval_fuse_tpu_torch.entry [dryrun N] [--device cpu]

Both run on the card unless the CPU is asked for. The ranks of a dryrun on
CUDA each take card rank % device count: NCCL when there is a card for
every rank, gloo otherwise (two ranks then share one card, the collectives
staged through the host). On the CPU the ranks use gloo.
"""

from __future__ import annotations

import argparse
import copy
import json
import os
import tempfile

import numpy as np
import torch

from retrieval_fuse_tpu_torch.device import resolve_device

#: the JAX package's flagship serving geometry (bench.py:145-158):
#: ShapeNetV2 super-resolution 8³ -> 64³, nf 16, K 4, latent 64
FLAGSHIP = {
    "task": "superresolution", "K": 4, "nf": 16, "unet_num_level": 4,
    "layer_order": "gcr", "retrieval_fmaps": 16, "retrieval_num_level": 4,
    "attn_normalize": True, "attn_use_switching": True, "attn_retrieval_mode": True,
    "attn_no_output_mapping": True, "attn_blend": True,
    "attn_patch_extent": 4, "attn_num_patch": 16,
    "retrieval_model": {"network_input": "2+1", "network_target": "16+8",
                        "nf_input": 32, "nf_target": 8, "latent_dim": 64},
    "dataset_train": {"input_chunk_size": 8, "target_chunk_size": 64,
                      "input_mean": 0.3095340441938771, "input_std": 0.14730652990291243,
                      "target_mean": 0.059954833543534335, "target_std": 0.010110036361741626,
                      "voxel_size_input": 0.166667, "voxel_size_target": 0.020834},
}
FLAGSHIP_ROWS = 27132  # the ShapeNetV2 database (bench.py:196)

#: the dryrun's serving config (the JAX dryrun's: nf 4, K 2, latent 16)
DRYRUN_SERVING = {
    "task": "superresolution", "K": 2, "nf": 4, "unet_num_level": 4,
    "layer_order": "gcr", "retrieval_fmaps": 4, "retrieval_num_level": 4,
    "attn_normalize": True, "attn_use_switching": True,
    "attn_retrieval_mode": True, "attn_no_output_mapping": True,
    "attn_blend": True, "attn_patch_extent": 4, "attn_num_patch": 16,
    "retrieval_model": {"network_input": "2+1", "network_target": "16+8",
                        "nf_input": 4, "nf_target": 4, "latent_dim": 16},
    "dataset_train": {"input_chunk_size": 8, "target_chunk_size": 64,
                      "input_mean": 0.3, "input_std": 0.15,
                      "target_mean": 0.06, "target_std": 0.01,
                      "voxel_size_input": 0.166667, "voxel_size_target": 0.020834},
}
#: the dryrun's sharded serving paths and their float32 tolerance against `base`
DRYRUN_VARIANTS = {"fused+pallasg2+topk1p": 2e-5, "fused+pallasp+topk1p+dconv+fbb": 2e-4,
                   "fused+pallasp+topk1p+cdec": 2e-4}


def build_flagship(compute_dtype: torch.dtype = torch.bfloat16, device=None, seed: int = 0,
                   variant: str | None = None, rows: int = FLAGSHIP_ROWS, config=None,
                   mesh=None, params=None, database=None, feature_bank=None):
    """The serving engine of `config` (the flagship by default) through
    `variant` (FAST_VARIANT by default): `params` (seeded random weights,
    models.init_params, by default), `database` (`rows` random unit rows by
    default) and random distance-field bank tiles made on the device from
    `seed` (or a ready `feature_bank`); `mesh` shards each call's batch."""
    from retrieval_fuse_tpu_torch.inference import (
        FAST_VARIANT, RetrieveRefineEngine, variant_engine_kwargs)
    from retrieval_fuse_tpu_torch.models import init_params

    cfg = copy.deepcopy(FLAGSHIP if config is None else config)
    dev = mesh.device if mesh is not None else resolve_device(device)
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    if database is None:
        database = torch.randn((rows, cfg["retrieval_model"]["latent_dim"]), generator=gen,
                               device=dev)
        database = database / torch.linalg.vector_norm(database, dim=1, keepdim=True)
    bank = None
    if feature_bank is None:
        trunc = 3 * cfg["dataset_train"]["voxel_size_target"]
        bank = torch.rand((len(database), 16, 16, 16), generator=gen, device=dev) * trunc
    return RetrieveRefineEngine(cfg, params or init_params(cfg, seed), database, bank,
                                compute_dtype=compute_dtype, device=dev, mesh=mesh,
                                feature_bank=feature_bank,
                                **variant_engine_kwargs(variant or FAST_VARIANT))


def entry(device=None):
    """(fn, example_args): fn(raw_input) is the flagship FAST_VARIANT engine
    in bf16 on `device` (the card by default); example_args holds one
    (8, 8, 8, 8, 1) batch of raw input chunks there."""
    engine = build_flagship(torch.bfloat16, device)
    gen = torch.Generator(device=engine.device)
    gen.manual_seed(0)
    raw = torch.rand((8, 8, 8, 8, 1), generator=gen, device=engine.device) * 0.5

    def fn(raw_input):
        return engine(raw_input)

    return fn, (raw,)


def dryrun_multichip(n_devices: int, device=None) -> dict:
    """Spawn `n_devices` ranks on `device` ("cuda" by default, or "cpu";
    parallel/launch.py) and run the dryrun (module docstring) in each;
    raises if a rank fails. Returns rank 0's readings."""
    from retrieval_fuse_tpu_torch.data.synthetic import generate_synthetic_dataset
    from retrieval_fuse_tpu_torch.parallel.launch import rank_backend, spawn_ranks
    device = device or "cuda"
    if torch.device(device).type == "cuda":  # once, before the ranks need them
        from retrieval_fuse_tpu_torch.ops import _build
        _build.build_all(["topk", "gathered_attention", "patch_attention", "decoder_tail"])
    with tempfile.TemporaryDirectory(prefix="rf_dryrun_") as tmp:
        generate_synthetic_dataset(tmp, n_train=2, n_val=1, seed=0)
        out = spawn_ranks(_dryrun_rank, n_devices, device, args=(tmp,))[0]
    return {"ranks": n_devices, "backend": rank_backend(n_devices, device), **out}


def _dryrun_rank(mesh, root: str) -> dict:
    from retrieval_fuse_tpu_torch.data.loader import collate
    from retrieval_fuse_tpu_torch.data.synthetic import make_synthetic_config
    from retrieval_fuse_tpu_torch.evaluation.metrics import IoU, Precision, Recall
    from retrieval_fuse_tpu_torch.ops.knn import exact_knn, sharded_exact_knn
    from retrieval_fuse_tpu_torch.parallel.mesh import shard_batch
    from retrieval_fuse_tpu_torch.parallel.steps import launch_counts, serving_hold
    from retrieval_fuse_tpu_torch.train.refinement_trainer import RefinementTrainer

    n, device = mesh.size, mesh.device
    cwd = os.getcwd()
    try:
        os.chdir(root)
        out = {}

        # one phase-3 step, the global batch of n chunks sharded over the ranks
        cfg = make_synthetic_config(root, task="superresolution")
        cfg.update(nf=4, K=2, batch_size=n, unet_num_level=4, retrieval_fmaps=4,
                   retrieval_num_level=4, experiment="dryrun_multichip", current_phase=3)
        for d in ("dataset_train", "dataset_val"):
            cfg[d].update(patch_size_input=8, patch_context_input=0, patch_size_target=64,
                          patch_context_target=0, patch_stride=64)
        trainer = RefinementTrainer(cfg, mesh=mesh)
        ds = trainer.train_dataset
        batch = collate([ds[i % len(ds)] for i in range(n)], n)
        local = shard_batch({k: batch[k] for k in ("input", "target", "retrieval")}, mesh)
        total, _ = trainer.train_step(local, trainer.base_lr)
        out["loss"] = float(total)
        if not np.isfinite(out["loss"]):
            raise RuntimeError(f"dryrun: phase-3 loss {out['loss']}")

        # the sharded kNN against the dense search, on rows that straddle shards
        rng = np.random.default_rng(1)
        rows = rng.standard_normal((n * 37 + 5, 16)).astype(np.float32)
        rows /= np.linalg.norm(rows, axis=1, keepdims=True)
        queries = torch.from_numpy(rng.standard_normal((24, 16)).astype(np.float32))
        queries = (queries / torch.linalg.vector_norm(queries, dim=1, keepdim=True)).to(device)
        idx_s, _ = sharded_exact_knn(queries, rows, 4, mesh)
        idx_d, _ = exact_knn(queries, torch.from_numpy(rows).to(device), 4)
        if not torch.equal(idx_s, idx_d):
            raise RuntimeError("dryrun: the sharded kNN disagrees with the dense one")

        # the validation losses and metrics of the step's prediction, reduced
        pred, losses = trainer.val_losses(local, trainer._global_rowmask(len(local["input"])),
                                          trainer.gumbel_draw(len(local["input"])))
        thr = trainer.target_voxel_size * 0.75
        metrics = {}
        for name, m in (("iou", IoU(device)), ("precision", Precision(device)),
                        ("recall", Recall(device))):
            m.update(trainer.network_pred_to_df(pred) <= thr,
                     trainer.denormalize_target(local["target"]) <= thr)
            m.all_reduce(mesh)
            if not (np.isfinite(m.value_sum) and m.total > 0):
                raise RuntimeError(f"dryrun: metric {name} {m.value_sum} / {m.total}")
            metrics[name] = m.compute()
        out["metrics"] = metrics
        out["val_losses"] = {k: float(v) for k, v in losses.items()}

        # serving with the batch sharded against the unsharded `base` engine
        xs = rng.random((2 * n, 8, 8, 8, 1)).astype(np.float32) * 0.5
        launches = launch_counts()
        out["serving_max_abs"] = {}
        for variant, tol in DRYRUN_VARIANTS.items():
            h = serving_hold(mesh, DRYRUN_SERVING, xs, variant, seed=5)
            for kn, v in launch_counts().items():  # serving_hold counts the mesh's call
                launches[kn] += v
            if not h["max_abs_vs_base"] <= tol:
                raise RuntimeError(f"dryrun: sharded {variant} serving "
                                   f"{h['max_abs_vs_base']} from base")
            out["serving_max_abs"][variant] = h["max_abs_vs_base"]
        out["launches"] = launches
        return out
    finally:
        os.chdir(cwd)


def main(argv=None) -> None:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("mode", nargs="?", default="entry", choices=("entry", "dryrun"))
    parser.add_argument("n", nargs="?", type=int, default=2, help="dryrun ranks")
    parser.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = parser.parse_args(argv)
    if args.mode == "dryrun":
        out = dryrun_multichip(args.n, args.device)
        print(f"dryrun_multichip OK: {json.dumps(out)}")
        return
    fn, example_args = entry(args.device)
    with torch.inference_mode():
        y = fn(*example_args)
    print("entry OK:", tuple(y.shape), y.dtype)


if __name__ == "__main__":
    main()
