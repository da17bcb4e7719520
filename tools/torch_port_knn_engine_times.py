#!/usr/bin/env python3
"""Time the streaming kNN kernel as the serving engine calls it, and the
engine call around it, on one CUDA card, for the port of a given checkout.

    python tools/torch_port_knn_engine_times.py [--tree PATH] [--batch 128]
                                                [--iters 20] [--seed 0]

`--tree` is a checkout of this repo (default: the one holding this script)
whose retrieval_fuse_tpu_torch package and chip_smoke.py are imported, so
that one script times a commit and its parent in turns in one chip call:
unpack the parent with `git archive` into a directory that .gitignore lists
and run parent, change, change, parent. Each tree builds its own kernels
into its own build directory.

At `--batch` chunks of the flagship geometry (chip_smoke.py's config, seeded
random weights and data: Q = batch·64 queries against 27,132 rows), for the
FAST_VARIANT engine in bf16 and in float32 it prints the kNN kernel's time
on the engine's own query rows, passed as that tree's engine passes them
(bf16 rows where the kernel takes them; float32 copies where it takes
float32 only), and the engine's time for one call on the batch. Needs a
CUDA card.
"""

from __future__ import annotations

import argparse
import subprocess
import sys
from pathlib import Path

import numpy as np


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--tree", default=str(Path(__file__).resolve().parents[1]))
    ap.add_argument("--batch", type=int, default=128)
    ap.add_argument("--iters", type=int, default=20)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    tree = Path(args.tree).resolve()
    sys.path.insert(0, str(tree))

    import torch

    import chip_smoke as cs
    from retrieval_fuse_tpu_torch.device import resolve_device
    from retrieval_fuse_tpu_torch.inference import (
        FAST_VARIANT, RetrieveRefineEngine, variant_engine_kwargs)
    from retrieval_fuse_tpu_torch.ops import _build
    from retrieval_fuse_tpu_torch.ops.streaming_knn import streaming_knn_sims

    dev = resolve_device("cuda")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True).stdout.strip()
    _build.build_all(["knn", "gathered_attention"])  # FAST_VARIANT's kernels at Q >= 8192
    cfg = cs.flagship_config()
    rng = np.random.default_rng(args.seed)
    params = cs.flagship_params(cfg, args.seed)
    db, bank = cs.flagship_data(cfg, rng, cs.SEED_BANK_ROWS, dev)
    chunks = cs.synthetic_df(rng, args.batch, 8, cfg["dataset_train"]["voxel_size_input"],
                             dev)[..., None].cpu().numpy()
    k = cfg["K"]
    for dtype in (torch.bfloat16, torch.float32):
        eng = RetrieveRefineEngine(cfg, params, db, bank, compute_dtype=dtype, device=dev,
                                   **variant_engine_kwargs(FAST_VARIANT))
        with torch.inference_mode():
            z = eng.embed_queries(torch.from_numpy(chunks).to(dev)).contiguous()
            knn_args, rows = (z, eng.database), "its own rows"
            try:
                streaming_knn_sims(*knn_args, k)
            except ValueError:  # a kernel that takes float32 rows only
                knn_args, rows = (z.float().contiguous(), eng._database_f32), "float32 copies"
            knn_ms = cs.cuda_ms(lambda: streaming_knn_sims(*knn_args, k), args.iters)
            engine_ms = cs.cuda_ms(lambda: eng(chunks), args.iters // 4 or 1)
        print(f"{tree.name} {str(dtype)[6:]} FAST_VARIANT batch {args.batch}: kNN kernel "
              f"{knn_ms:.4f} ms on {rows} (Q={z.shape[0]} N={eng.database.shape[0]} k={k}), "
              f"engine {engine_ms:.2f} ms a call [{card}]", flush=True)
        del eng, z, knn_args
    return 0


if __name__ == "__main__":
    sys.exit(main())
