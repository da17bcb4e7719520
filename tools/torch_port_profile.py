#!/usr/bin/env python3
"""Where the PyTorch port's serving engine spends its device time.

    python tools/torch_port_profile.py [--seed 0] [--variant V] [--out chiprun_out/profile]

Builds the flagship engine of --variant (default FAST_VARIANT) in bf16 on
one CUDA card (weights and data as chip_smoke.py draws them), then traces
three engine calls at batch 64 and at batch 128 with torch.profiler. Prints
per batch: the host time per call (ending in a synchronize), the summed
device time of the CUDA kernels, the device's idle share of the traced
window, and the device time by kernel group (convolutions, GroupNorm, the
port's kernels, the rest) and for the top kernels. Writes a Chrome trace per batch under
--out. Needs a CUDA card.
"""

from __future__ import annotations

import argparse
import sys
import time
from collections import defaultdict
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

GROUPS = (  # (group, substrings of the kernel name), first match wins
    ("attention kernel", ("gathered_attention", "patch_attention")),
    ("decoder tail kernel", ("decoder_tail",)),
    ("knn kernel", ("knn_kernel",)),
    ("topk kernel", ("topk_rows",)),
    ("convolution", ("conv", "xmma", "implicit", "cudnn", "sm90_", "gemm", "winograd")),
    ("group norm", ("group_norm", "GroupNorm", "RowwiseMoments", "ComputeFused")),
    ("upsample / pool", ("upsample", "nearest", "max_pool", "MaxPool")),
)


def group_of(name: str) -> str:
    for group, keys in GROUPS:
        if any(k in name for k in keys):
            return group
    return "other (copies, elementwise, reductions)"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--variant", default=None, help="engine variant (default FAST_VARIANT)")
    ap.add_argument("--out", default="chiprun_out/profile")
    args = ap.parse_args(argv)

    import numpy as np
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from chip_smoke import (SEED_BANK_ROWS, flagship_config, flagship_data,
                            flagship_params, synthetic_df)
    from retrieval_fuse_tpu_torch.device import resolve_device
    from retrieval_fuse_tpu_torch.inference import (
        FAST_VARIANT, RetrieveRefineEngine, variant_engine_kwargs)
    from retrieval_fuse_tpu_torch.ops import _build

    dev = resolve_device("cuda")
    _build.build_all()
    cfg = flagship_config()
    rng = np.random.default_rng(args.seed)
    db, bank = flagship_data(cfg, rng, SEED_BANK_ROWS, dev)
    eng = RetrieveRefineEngine(cfg, flagship_params(cfg, args.seed), db, bank,
                               compute_dtype=torch.bfloat16, device=dev,
                               **variant_engine_kwargs(args.variant or FAST_VARIANT))
    del bank
    chunks = synthetic_df(rng, 128, 8, cfg["dataset_train"]["voxel_size_input"], dev)[..., None]
    out = Path(args.out)
    out.mkdir(parents=True, exist_ok=True)
    import subprocess
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip()
          or torch.cuda.get_device_name(0), flush=True)
    for batch in (64, 128):
        x = chunks[:batch]
        for _ in range(2):
            eng(x)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(3):
            eng(x)
        torch.cuda.synchronize()
        host_ms = (time.perf_counter() - t0) / 3 * 1e3
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            for _ in range(3):
                eng(x)
            torch.cuda.synchronize()
            window_ms = (time.perf_counter() - t0) * 1e3
        prof.export_chrome_trace(str(out / f"trace_b{batch}.json"))
        kernels = defaultdict(float)
        for e in prof.events():
            if e.device_type == DeviceType.CUDA:
                kernels[e.name] += e.device_time_total / 1e3 / 3  # ms per call
        device_ms = sum(kernels.values())
        groups = defaultdict(float)
        for name, ms in kernels.items():
            groups[group_of(name)] += ms
        print(f"batch {batch}: host {host_ms:.2f} ms per call; device kernels "
              f"{device_ms:.2f} ms per call; idle share of the traced window "
              f"{1 - 3 * device_ms / window_ms:.1%}")
        if device_ms == 0:
            print("  the profiler recorded no device time")
            continue
        for group, ms in sorted(groups.items(), key=lambda kv: -kv[1]):
            print(f"  {group:42s} {ms:8.3f} ms  {ms / device_ms:6.1%}")
        for name, ms in sorted(kernels.items(), key=lambda kv: -kv[1])[:12]:
            print(f"    {ms:8.3f} ms  {name[:110]}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
