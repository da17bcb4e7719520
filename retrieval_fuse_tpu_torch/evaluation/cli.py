"""Offline mesh-metrics CLI, as in the JAX package's evaluation/cli.py:
sweep predicted scene meshes against ground-truth meshes, shardable over
processes or hosts with --num_proc / --proc, one CSV per worker:

  python -m retrieval_fuse_tpu_torch.evaluation.cli metrics \
      --pred_dir runs/<exp>/scenes/ours --dataset ShapeNetV2 \
      --task superresolution --method ours --num_proc 4 --proc 0

It expects <pred_dir>/<scene>.obj with the ground truth at
<pred_dir>/../gt/<scene>.obj. `recompose` stitches chunk meshes
(<scene>__<x>_<y>_<z><suffix>) into scene meshes; `clean` crops meshes to
the centered 62-cube. Host numpy, scipy and the native voxelizer.
"""

from __future__ import annotations

import argparse
from pathlib import Path

import numpy as np

from retrieval_fuse_tpu_torch.evaluation import mesh_metrics


def main(argv=None):
    """Run one subcommand; `metrics` returns its rows ([scene, iou,
    chamfer-L1, normal correctness, F@t9, F@t14, chunks] per scene)."""
    parser = argparse.ArgumentParser()
    sub = parser.add_subparsers(dest="cmd", required=True)

    p_metrics = sub.add_parser("metrics", help="per-scene mesh metric sweep -> CSV")
    p_metrics.add_argument("--pred_dir", type=Path, required=True)
    p_metrics.add_argument("--dataset", type=str, required=True)
    p_metrics.add_argument("--task", type=str, required=True)
    p_metrics.add_argument("--method", type=str, default="ours")
    p_metrics.add_argument("--num_proc", type=int, default=1)
    p_metrics.add_argument("--proc", type=int, default=0)
    p_metrics.add_argument("--limit", type=int, default=None)

    p_rec = sub.add_parser("recompose", help="stitch chunk meshes into scene meshes")
    p_rec.add_argument("--base_path", type=Path, required=True)
    p_rec.add_argument("--suffix", type=str, default="_fuse.obj")
    p_rec.add_argument("--output_path", type=Path, required=True)
    p_rec.add_argument("--shift", type=float, nargs=3, default=[0, 0, 0])

    p_clean = sub.add_parser("clean", help="crop meshes to the centered 62-cube")
    p_clean.add_argument("--target_dir", type=Path, required=True)

    args = parser.parse_args(argv)
    if args.cmd == "metrics":
        rows = mesh_metrics.compute_all_metrics_for_scenes(
            args.dataset, args.task, args.method, args.pred_dir, None,
            args.num_proc, args.proc, args.limit)
        if rows:
            vals = np.array([r[1:6] for r in rows], dtype=np.float64)
            names = ["iou", "chamfer-L1", "normal-corr", "F@t9", "F@t14"]
            print(" | ".join(f"{n}: {v:.4f}" for n, v in zip(names, vals.mean(axis=0))))
        return rows
    elif args.cmd == "recompose":
        mesh_metrics.recompose_chunks_to_scenes(args.base_path, args.suffix,
                                                args.output_path, args.shift)
    elif args.cmd == "clean":
        mesh_metrics.clean_mesh(args.target_dir)


if __name__ == "__main__":
    main()
