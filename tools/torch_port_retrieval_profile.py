#!/usr/bin/env python3
"""Where the PyTorch port's retrieval pipeline spends its wall time.

    python tools/torch_port_retrieval_profile.py [--seed 0] [--out chiprun_out/retrieval_profile.json]

Makes the synthetic dataset that chip_smoke.py makes (train chunks until the
dictionary reaches 27,132 rows, 64 val chunks; ShapeNetV2's retrieval
config at full width, seeded random encoders), then runs
retrievals_to_disk's map, compose and evaluate on one CUDA card with timers
around the stages of each mode:
  - the scene handlers and datasets that each mode builds (scene loading
    and the occupancy caches included);
  - the host loader: the time the dictionary and feature loops wait for
    their next batch (items sliced and collated on a background thread);
  - the encoders: host-to-device copy, forward, L2 normalisation and the
    copy back, per batch;
  - the kNN search (auto_exact_knn) and the same-scene demotion, each
    ending in a synchronize;
  - numpy I/O: np.save, np.load, np.savez_compressed;
  - the compose paste (create_retrieval_from_mapping) and the metrics
    (get_metrics_for_retrieval, the chamfer kernel's calls inside it).
Each stage's time is inclusive: a stage called inside another (np.load
inside the scene handlers, the chamfer inside the metrics) counts in both.
"other" is the mode's wall time less the outermost stages' time: Python
between the stages. Prints one table per mode and writes the numbers to
--out. Needs a CUDA card.
"""

from __future__ import annotations

import argparse
import functools
import json
import os
import subprocess
import sys
import tempfile
import time
from collections import defaultdict
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

#: (module, attribute, stage, synchronize after)
STAGES = (
    ("retrieval_fuse_tpu_torch.retrieval.cli", "SceneHandler", "scene handlers", False),
    ("retrieval_fuse_tpu_torch.retrieval.cli", "PatchedSceneDataset", "datasets", False),
    ("retrieval_fuse_tpu_torch.retrieval.dictionary", "_encode_apply_normalized",
     "encoders (copy in, forward, normalise, copy out)", False),
    ("retrieval_fuse_tpu_torch.retrieval.engine", "auto_exact_knn", "kNN search", True),
    ("retrieval_fuse_tpu_torch.retrieval.engine", "demote_same_scene", "same-scene demotion",
     True),
    ("retrieval_fuse_tpu_torch.retrieval.cli", "create_retrieval_from_mapping",
     "compose paste", False),
    ("retrieval_fuse_tpu_torch.train.retrieval_trainer", "get_metrics_for_retrieval",
     "metrics", False),
    ("retrieval_fuse_tpu_torch.evaluation.metrics", "chamfer_batch",
     "chamfer (kernel and masked means)", True),
    ("numpy", "save", "np.save (database, mappings)", False),
    ("numpy", "load", "np.load (scenes, mappings, composed volumes)", False),
    ("numpy", "savez_compressed", "np.savez_compressed (composed volumes)", False),
)
LOADER = "loader (waiting for the next batch)"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out", default="chiprun_out/retrieval_profile.json")
    args = ap.parse_args(argv)

    import importlib

    import numpy as np
    import torch

    from chip_smoke import (RETRIEVAL_MIN_ROWS, RETRIEVAL_VAL_CHUNKS, retrieval_config,
                            write_retrieval_dataset)
    from retrieval_fuse_tpu_torch.device import resolve_device
    from retrieval_fuse_tpu_torch.models import get_retrieval_networks, init_module_params
    from retrieval_fuse_tpu_torch.ops import _build
    from retrieval_fuse_tpu_torch.retrieval import cli, dictionary
    from retrieval_fuse_tpu_torch.train.checkpoint import save_checkpoint

    dev = resolve_device("cuda")
    _build.build_all(["knn", "chamfer"])
    acc: dict = defaultdict(float)
    depth = [0]  # timed calls in progress: only the outermost adds to "outer"

    def add(stage, t0):
        dt = time.perf_counter() - t0
        acc[stage] += dt
        if depth[0] == 0:
            acc["outer"] += dt

    def timed(fn, stage, sync):
        @functools.wraps(fn)
        def run(*a, **k):
            t0 = time.perf_counter()
            depth[0] += 1
            try:
                out = fn(*a, **k)
                if sync:
                    torch.cuda.synchronize()
            finally:
                depth[0] -= 1
                add(stage, t0)
            return out
        return run

    for mod, attr, stage, sync in STAGES:
        m = importlib.import_module(mod)
        setattr(m, attr, timed(getattr(m, attr), stage, sync))
    iterate = dictionary.batch_iterator

    def waited_batches(*a, **k):
        it = iterate(*a, **k)
        while True:
            t0 = time.perf_counter()
            try:
                b = next(it)
            except StopIteration:
                return
            finally:
                add(LOADER, t0)
            yield b

    dictionary.batch_iterator = waited_batches

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip()
    card = smi or torch.cuda.get_device_name(0)  # the name and the power limit
    rng = np.random.default_rng(args.seed)
    report = {"card": card}
    with tempfile.TemporaryDirectory() as tmp:
        root = Path(tmp)
        t0 = time.perf_counter()
        made = write_retrieval_dataset(root / "data", rng, RETRIEVAL_MIN_ROWS,
                                       RETRIEVAL_VAL_CHUNKS, dev)
        report["data_s"] = time.perf_counter() - t0
        nets = get_retrieval_networks(retrieval_config(root, "")["retrieval_model"])
        wrng = np.random.default_rng(args.seed + 1)
        ckpt = save_checkpoint(root / "runs" / "profile", 0, {
            name: init_module_params(net, wrng)
            for name, net in zip(("fenc_input", "fenc_target"), nets)})
        cfg = retrieval_config(root / "data", ckpt)
        print(f"{card}: {len(made['train'])} train and {len(made['val'])} val chunks, "
              f"~{made['rows']} dictionary rows; made in {report['data_s']:.1f} s", flush=True)
        cwd = os.getcwd()
        os.chdir(root)
        try:
            for mode in ("map", "compose", "evaluate"):
                acc.clear()
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                cli.retrievals_to_disk(mode, cfg, device=dev)
                torch.cuda.synchronize()
                wall = time.perf_counter() - t0
                stages = {k: v for k, v in acc.items() if v > 0 and k != "outer"}
                stages["other"] = wall - acc["outer"]
                report[mode] = {"wall_s": wall, "stages_s": stages}
                print(f"{mode}: {wall:.2f} s wall [{card}]")
                for stage, s in sorted(stages.items(), key=lambda kv: -kv[1]):
                    print(f"  {stage:52s} {s:8.2f} s  {s / wall:6.1%}")
        finally:
            os.chdir(cwd)
    out = Path(args.out)
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_text(json.dumps(report, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
