"""Real-data parity harness of the port: the counterpart of the JAX package's
root parity_real.py, for the day the datasets and the reference
implementation are mounted.

    python -m retrieval_fuse_tpu_torch.parity_real --config <refinement yaml> \\
        --retrieval_ckpt <reference .ckpt> [--refinement_ckpt <reference .ckpt>] \\
        [--retrieval_config <retrieval yaml>] [--reference_map <map_<split>.npy>] \\
        [--split val] [--n_chunks 16] [--device cuda] [--out parity_report.json]

Gates, in order:
  1. import both reference checkpoints (utils/reference_import.py) into the
     port's modules: layout conversions only;
  2. rebuild the dictionary with the imported target encoder and map the
     split (retrieval/cli.py's `map` semantics, on --device); with
     --reference_map (the reference's mapping artifact), per-row top-k
     identity: scene id and extent columns exact and distances within
     --dist_atol. Gate: match rate >= --topk_match_min (default 1.0);
  3. the refinement forward (deterministic attention, on --device) against
     the reference module on --n_chunks val chunks of identical batches.
     Gate: TSDF MAE <= --mae_budget (1e-3);
  4. the rough IoU / precision / recall of both predictions against the
     targets, printed and written to --out.

The reference forward of gate 3 is the reference implementation's
RefinementTrainingModule (PyTorch, CPU), loaded from REFERENCE_ROOT with
utils/reference_loader's stubs; `forward_parity` and `main` take any other
as `reference_forward`. Without one and without REFERENCE_ROOT, gate 3
raises, naming the path. Exit code 0 if and only if every enabled gate
passes (gate 2's comparison runs with --reference_map, gate 3 with
--refinement_ckpt). Imports torch and numpy, never JAX.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

import numpy as np
import torch

from retrieval_fuse_tpu_torch.utils import reference_loader

REFERENCE_ROOT = Path(reference_loader.REFERENCE_ROOT)


def load_torch_state_dict(path) -> dict:
    """A Lightning .ckpt or a raw state_dict file -> {key: numpy array}."""
    ckpt = torch.load(path, map_location="cpu", weights_only=False)
    sd = ckpt.get("state_dict", ckpt) if isinstance(ckpt, dict) else ckpt
    return {k: v.detach().cpu().numpy() if hasattr(v, "detach") else np.asarray(v)
            for k, v in sd.items()}


# ---------------------------------------------------------------- retrieval

def build_mapping_with_imported_encoder(config: dict, retrieval_params: dict, split: str,
                                        tree_path, device=None) -> dict:
    """The dictionary from the imported target encoder and the kNN mapping
    of `split` (the artifacts of retrieval/cli.py's `map`), on `device`."""
    from retrieval_fuse_tpu_torch.data import SceneHandler, PatchedSceneDataset
    from retrieval_fuse_tpu_torch.device import resolve_device
    from retrieval_fuse_tpu_torch.models import get_retrieval_networks
    from retrieval_fuse_tpu_torch.retrieval.dictionary import (
        create_dictionary, extract_input_features, make_encoder_apply)
    from retrieval_fuse_tpu_torch.retrieval.engine import RetrievalInterface
    dev = resolve_device(device)
    fenc_input, fenc_target = get_retrieval_networks(config["retrieval_model"])
    fenc_input.load_state_dict(retrieval_params["fenc_input"])
    fenc_target.load_state_dict(retrieval_params["fenc_target"])
    encode_in, encode_tgt = make_encoder_apply(fenc_input, dev), make_encoder_apply(fenc_target,
                                                                                    dev)
    ds_train = PatchedSceneDataset("train", config["dataset_train"],
                                   SceneHandler("train", config))
    if split == "train":
        ds_query, ignore_source = ds_train, True
    else:
        ds_query = PatchedSceneDataset("val", config["dataset_val"], SceneHandler("val", config))
        ignore_source = False
    latent = config["retrieval_model"]["latent_dim"]
    create_dictionary(encode_tgt, config["dictionary"], latent, ds_train, tree_path)
    handler = RetrievalInterface(config["query"], latent, device=dev)
    return handler.get_retrieval_mapping(encode_in, extract_input_features, tree_path, ds_query,
                                         ignore_source)


def compare_mappings(ours: dict, reference: dict, k: int, dist_atol: float) -> dict:
    """Per-(patch, rank) top-k identity of the port's mapping against the
    reference's: a row matches where its columns 0:7 (scene id and extent)
    are equal and its distances lie within dist_atol. Returns a stats dict
    (the JAX harness's keys, and the largest distance difference)."""
    common = sorted(set(ours) & set(reference))
    missing = {"missing_in_ours": len(set(reference) - set(ours)),
               "missing_in_reference": len(set(ours) - set(reference))}
    if not common:
        return {"patches_compared": 0, "topk_match_rate": 0.0, "dist_mae": float("nan"),
                "dist_max": float("nan"), "dist_atol": dist_atol,
                "first_mismatch_patch": None, **missing}
    a = np.stack([np.asarray(ours[n])[:k] for n in common])
    b = np.stack([np.asarray(reference[n])[:k] for n in common])
    dist = np.abs(a[..., 7] - b[..., 7])
    row_eq = (a[..., 0:7].astype(np.int64) == b[..., 0:7].astype(np.int64)).all(axis=2) \
        & (dist <= dist_atol)
    bad = np.flatnonzero(~row_eq.all(axis=1))
    return {"patches_compared": len(common), "topk_match_rate": float(row_eq.mean()),
            "dist_mae": float(dist.mean()), "dist_max": float(dist.max()),
            "dist_atol": dist_atol,
            "first_mismatch_patch": common[bad[0]] if len(bad) else None, **missing}


# ---------------------------------------------------------------- refinement

def reference_module_forward(config: dict, refinement_state_dict: dict):
    """The reference implementation's refinement forward: its
    RefinementTrainingModule, loaded from REFERENCE_ROOT with the reference
    checkpoint's weights, with a noise-free hard Gumbel selection. Returns
    forward(batch) -> the predicted distance fields (B, S, S, S, 1), numpy,
    of a loader batch (channels-last numpy). Raises FileNotFoundError,
    naming REFERENCE_ROOT, where it is missing."""
    if not REFERENCE_ROOT.is_dir():
        raise FileNotFoundError(
            f"the reference implementation is not at {REFERENCE_ROOT}: the forward gate needs "
            f"it (or a reference_forward passed in)")
    reference_loader.load_reference()
    import trainer.train_refinement as ref_refine  # the reference's own module

    module = ref_refine.RefinementTrainingModule(config).eval()
    tensors = {k: torch.from_numpy(np.ascontiguousarray(v))
               for k, v in refinement_state_dict.items()}
    missing, _ = module.load_state_dict(tensors, strict=False)
    missing = [m for m in missing if m.split(".")[0] in (
        "unet_backbone", "decoder", "retrieval_backbone", "patched_attention_block")]
    if missing:
        raise ValueError(f"the reference checkpoint misses model keys: {missing[:8]}")

    def forward(batch: dict) -> np.ndarray:
        tb = {"input": torch.from_numpy(np.transpose(batch["input"], (0, 4, 1, 2, 3))),
              "target": torch.from_numpy(np.transpose(batch["target"], (0, 4, 1, 2, 3))),
              "retrieval": torch.from_numpy(np.asarray(batch["retrieval"]))}
        with torch.no_grad(), reference_loader.deterministic_gumbel_hard():
            pred, *_ = module.forward_full(tb)
            df = module.network_pred_to_df(pred).numpy()
        return np.transpose(df, (0, 2, 3, 4, 1))

    return forward


def forward_parity(config: dict, refinement_params: dict, n_chunks: int, batch_size: int = 2,
                   device=None, reference_forward=None,
                   refinement_state_dict: dict | None = None) -> dict:
    """The port's refinement forward (deterministic attention, on `device`)
    on the imported weights against `reference_forward` (default:
    reference_module_forward of `refinement_state_dict`) on the first
    n_chunks val chunks: the TSDF MAE and both predictions' rough metrics."""
    from retrieval_fuse_tpu_torch.data import batch_iterator
    from retrieval_fuse_tpu_torch.evaluation.metrics import batch_occupancy_metrics
    from retrieval_fuse_tpu_torch.train.refinement_trainer import RefinementTrainer
    if reference_forward is None:
        reference_forward = reference_module_forward(config, refinement_state_dict)
    trainer = RefinementTrainer(config, device=device, deterministic_attention=True)
    trainer.load_params(refinement_params)
    thr = trainer.target_voxel_size * 0.75
    mae_sum, mae_n, seen = 0.0, 0, 0
    sums = {name: np.zeros(6) for name in ("ours", "reference")}
    for batch in batch_iterator(trainer.val_dataset, batch_size, shuffle=False, prefetch=0):
        if seen >= n_chunks:
            break
        v = min(batch["valid"], n_chunks - seen)
        with torch.no_grad():
            pred = trainer.forward_full(trainer._device_batch(batch))[0]
            ours = trainer.network_pred_to_df(pred).cpu().numpy()[:v].astype(np.float64)
        ref = np.asarray(reference_forward(batch), dtype=np.float64)[:v]
        mae_sum += float(np.abs(ours - ref).sum())
        mae_n += ours.size
        target = trainer.denormalize_target(np.asarray(batch["target"]))[:v]
        for name, p in (("ours", ours), ("reference", ref)):
            m = batch_occupancy_metrics(p.astype(np.float32), target, thr, device=trainer.device)
            for j, key in enumerate(("iou", "precision", "recall")):
                sums[name][2 * j: 2 * j + 2] += m[key]
        seen += v
    metrics = {name: {key: float(s[2 * j] / max(s[2 * j + 1], 1e-9))
                      for j, key in enumerate(("iou", "precision", "recall"))}
               for name, s in sums.items()}
    return {"tsdf_mae": mae_sum / max(mae_n, 1), "chunks": seen, "metrics": metrics}


# ---------------------------------------------------------------------- main

def parse_arguments(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--config", required=True,
                    help="refinement experiment yaml (forward-parity gate)")
    ap.add_argument("--retrieval_config", default=None,
                    help="retrieval experiment yaml for the dictionary and mapping gate (its "
                         "own patch geometry); defaults to --config")
    ap.add_argument("--retrieval_ckpt", required=True,
                    help="reference retrieval checkpoint (.ckpt)")
    ap.add_argument("--refinement_ckpt", default=None,
                    help="reference refinement checkpoint (.ckpt)")
    ap.add_argument("--reference_map", default=None,
                    help="the reference's map_<split>.npy to compare top-k against")
    ap.add_argument("--split", default="val", choices=("train", "val"))
    ap.add_argument("--n_chunks", type=int, default=16)
    ap.add_argument("--batch_size", type=int, default=2)
    ap.add_argument("--K", type=int, default=None)
    ap.add_argument("--topk_match_min", type=float, default=1.0)
    ap.add_argument("--dist_atol", type=float, default=1e-4)
    ap.add_argument("--mae_budget", type=float, default=1e-3)
    ap.add_argument("--tree_path", default=None,
                    help="dictionary scratch dir (default: runs/parity_tree)")
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    ap.add_argument("--out", default="parity_report.json")
    return ap.parse_args(argv)


def main(argv=None, reference_forward=None) -> int:
    """The harness; `reference_forward` replaces the reference module in
    gate 3 (forward_parity). Returns 0 if and only if every enabled gate
    passes."""
    from retrieval_fuse_tpu_torch.config import read_config
    from retrieval_fuse_tpu_torch.utils.reference_import import (
        import_refinement_checkpoint, import_retrieval_checkpoint_auto)
    args = parse_arguments(argv)
    config = read_config(args.config)
    retrieval_config = read_config(args.retrieval_config) if args.retrieval_config else config
    for c in ([config] if retrieval_config is config else [config, retrieval_config]):
        if args.K is not None:
            c["K"] = args.K
        c.setdefault("query", {})["K"] = c["K"]
    report: dict = {"config": str(args.config), "split": args.split}
    ok = True

    # 1) the import
    retrieval_params = import_retrieval_checkpoint_auto(load_torch_state_dict(args.retrieval_ckpt))
    report["retrieval_import"] = "ok"

    # 2) the dictionary, the mapping and top-k identity
    mapping = build_mapping_with_imported_encoder(
        retrieval_config, retrieval_params, args.split,
        Path(args.tree_path or "runs/parity_tree"), args.device)
    report["mapping_patches"] = len(mapping)
    if args.reference_map:
        stats = compare_mappings(mapping, np.load(args.reference_map, allow_pickle=True)[()],
                                 config["K"], args.dist_atol)
        report["topk"] = stats
        gate = stats["topk_match_rate"] >= args.topk_match_min
        ok &= gate
        print(f"[topk] match rate {stats['topk_match_rate']:.4f} over "
              f"{stats['patches_compared']} patches (distances within {args.dist_atol:g}; MAE "
              f"{stats['dist_mae']:.2e}, max {stats['dist_max']:.2e}) -> "
              f"{'PASS' if gate else 'FAIL'}")
    else:
        print("[topk] no --reference_map given: the mapping is built, the identity gate is off")

    # 3) and 4) the refinement forward and the metric table
    if args.refinement_ckpt:
        refinement_sd = load_torch_state_dict(args.refinement_ckpt)
        params = import_refinement_checkpoint(
            refinement_sd, task=config["task"],
            input_chunk_size=config["dataset_train"]["input_chunk_size"],
            attn_patch_extent=config["attn_patch_extent"])
        fp = forward_parity(config, params, args.n_chunks, args.batch_size, args.device,
                            reference_forward, refinement_sd)
        report["forward"] = fp
        gate = fp["tsdf_mae"] <= args.mae_budget
        ok &= gate
        print(f"[forward] TSDF MAE {fp['tsdf_mae']:.2e} over {fp['chunks']} chunks (budget "
              f"{args.mae_budget:.0e}) -> {'PASS' if gate else 'FAIL'}")
        for name, m in fp["metrics"].items():
            print(f"[metrics] {name:9s} iou={m['iou']:.4f} precision={m['precision']:.4f} "
                  f"recall={m['recall']:.4f}")
    else:
        print("[forward] no --refinement_ckpt given: the forward gate is off")

    report["ok"] = bool(ok)
    Path(args.out).write_text(json.dumps(report, indent=2))
    print(f"[report] {args.out} ok={ok}")
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
