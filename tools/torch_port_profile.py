#!/usr/bin/env python3
"""Where the PyTorch port's serving engine, or its retrieval trainer,
spends its device time.

    python tools/torch_port_profile.py [--seed 0] [--variant V] [--out chiprun_out/profile]
                                       [--task flagship|surface|superres16] [--f32]
    python tools/torch_port_profile.py --train
    python tools/torch_port_profile.py --refine

Builds the flagship engine of --variant (default FAST_VARIANT) in bf16 on
one CUDA card (weights and data as chip_smoke.py draws them), then traces
three engine calls at batch 64 and at batch 128 with torch.profiler. With
--task surface it builds phase 9a's engine instead (3DFront surface
reconstruction at full width, chip_smoke.surface_config, on 64 synthetic
128³ occupancy grids) and traces batches 32 and 64; with --task superres16
phase 9b's (Matterport3D 16³ -> 64³) at batch 64; --f32 serves in float32.
Each engine batch also gets its stages timed alone with CUDA events (query
encoder, kNN, backbone, attention, decoder). With
--train it traces three retrieval train steps instead, at chip_smoke.py's
config (ShapeNetV2's retrieval width, batch 128, float32) on one resident
batch of a small synthetic dataset (no loader). Prints per batch or step:
the host time per call (ending in a synchronize), the summed device time of
the CUDA kernels, the device's idle share of the traced window, and the
device time by kernel group (convolutions, GroupNorm, the port's kernels,
the rest) and for the top kernels. Writes a Chrome trace per engine batch
under --out (none for the train steps). Needs a CUDA card.
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
    ap.add_argument("--train", action="store_true",
                    help="trace the retrieval trainer's steps instead of the engine")
    ap.add_argument("--refine", action="store_true",
                    help="trace the refinement trainer's steps instead of the engine")
    ap.add_argument("--task", choices=("flagship", "surface", "superres16"), default="flagship",
                    help="the engine's config: the 8³ flagship, or phase 9a's / 9b's")
    ap.add_argument("--f32", action="store_true", help="serve in float32 (default bf16)")
    args = ap.parse_args(argv)

    import numpy as np
    import torch

    from chip_smoke import (SEED_BANK_ROWS, SURFACE_BATCHES, SUPERRES16_BATCH, flagship_config,
                            flagship_data, flagship_params, superres16_config, surface_config,
                            surface_inputs, synthetic_df)
    from retrieval_fuse_tpu_torch.device import resolve_device
    from retrieval_fuse_tpu_torch.inference import (
        FAST_VARIANT, RetrieveRefineEngine, variant_engine_kwargs)
    from retrieval_fuse_tpu_torch.ops import _build

    dev = resolve_device("cuda")
    out = Path(args.out).resolve()
    out.mkdir(parents=True, exist_ok=True)
    import subprocess
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip()
          or torch.cuda.get_device_name(0), flush=True)
    if args.train:
        return profile_train()
    if args.refine:
        return profile_refine()
    _build.build_all()
    cfg = {"flagship": flagship_config, "surface": surface_config,
           "superres16": superres16_config}[args.task]()
    rng = np.random.default_rng(args.seed)
    db, bank = flagship_data(cfg, rng, SEED_BANK_ROWS, dev)
    # phi's output negated opens the flagship's attention switch, and shuts
    # the other tasks' (chip_smoke.run_phase9)
    params = flagship_params(cfg, args.seed, negate_phi=args.task == "flagship")
    eng = RetrieveRefineEngine(cfg, params, db, bank,
                               compute_dtype=torch.float32 if args.f32 else torch.bfloat16,
                               device=dev, **variant_engine_kwargs(args.variant or FAST_VARIANT))
    del bank
    dtr = cfg["dataset_train"]
    if args.task == "surface":
        import tempfile
        with tempfile.TemporaryDirectory() as tmp:
            chunks = torch.from_numpy(surface_inputs(Path(tmp), SURFACE_BATCHES[-1], args.seed,
                                                     dtr["input_chunk_size"]))[..., None].to(dev)
        batches = SURFACE_BATCHES
    else:
        batches = (64, 128) if args.task == "flagship" else (SUPERRES16_BATCH,)
        chunks = synthetic_df(rng, batches[-1], dtr["input_chunk_size"], dtr["voxel_size_input"],
                              dev)[..., None]
    for batch in batches:
        x = chunks[:batch]
        trace(lambda: eng(x), f"{args.task} batch {batch}",
              out / f"trace_{args.task}_b{batch}.json")
        stages(eng, x)
    return 0


def stages(eng, x, iters: int = 2) -> None:
    """Each stage of an engine call alone (CUDA events, ms): the query
    encoder (embed_queries), the kNN (retrieve less the encoder), the
    backbone, the attention path and the decoder, on the call's own
    intermediates."""
    import torch
    from chip_smoke import cuda_ms
    with torch.inference_mode():
        xin = ((x.float() - eng.in_mean) / eng.in_std).to(eng.compute_dtype)
        top_idx = eng.retrieve(x)
        backbone = eng.unet_backbone if eng.fused_backbone is None else eng.fused_backbone
        decoder = eng.decoder if eng.fused_decoder is None else eng.fused_decoder
        feats = backbone(xin)
        fused = eng._attend(feats, top_idx, x.shape[0])
        ms = {"query encoder": cuda_ms(lambda: eng.embed_queries(x), iters)}
        ms["kNN"] = cuda_ms(lambda: eng.retrieve(x), iters) - ms["query encoder"]
        ms["backbone"] = cuda_ms(lambda: backbone(xin), iters)
        ms["attention"] = cuda_ms(lambda: eng._attend(feats, top_idx, x.shape[0]), iters)
        ms["decoder"] = cuda_ms(lambda: decoder(fused), iters)
    total = sum(ms.values())
    print("  stages alone: " + ", ".join(f"{k} {v:.2f} ms ({v / total:.0%})"
                                         for k, v in ms.items()), flush=True)


def trace(fn, label: str, path: Path | None, calls: int = 3) -> None:
    """Warm fn up, time `calls` calls on the host clock, trace `calls` more
    with torch.profiler, and print the device time by group and kernel;
    write the Chrome trace to `path` unless it is None."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    for _ in range(2):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    torch.cuda.synchronize()
    host_ms = (time.perf_counter() - t0) / calls * 1e3
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
        window_ms = (time.perf_counter() - t0) * 1e3
    if path is not None:
        prof.export_chrome_trace(str(path))
    kernels = defaultdict(float)
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            kernels[e.name] += e.device_time_total / 1e3 / calls  # ms per call
    device_ms = sum(kernels.values())
    groups = defaultdict(float)
    for name, ms in kernels.items():
        groups[group_of(name)] += ms
    print(f"{label}: host {host_ms:.2f} ms per call; device kernels "
          f"{device_ms:.2f} ms per call; idle share of the traced window "
          f"{1 - calls * device_ms / window_ms:.1%}")
    if device_ms == 0:
        print("  the profiler recorded no device time")
        return
    for group, ms in sorted(groups.items(), key=lambda kv: -kv[1]):
        print(f"  {group:42s} {ms:8.3f} ms  {ms / device_ms:6.1%}")
    for name, ms in sorted(kernels.items(), key=lambda kv: -kv[1])[:12]:
        print(f"    {ms:8.3f} ms  {name[:110]}")


def profile_train() -> int:
    """Trace three retrieval train steps at chip_smoke.py's config on one
    resident batch of a synthetic dataset, with cuDNN and without it."""
    import os
    import tempfile

    import torch

    from chip_smoke import first_batches, retrieval_config
    from retrieval_fuse_tpu_torch.data.synthetic import generate_synthetic_dataset
    from retrieval_fuse_tpu_torch.train.retrieval_trainer import RetrievalTrainer

    cwd = os.getcwd()
    with tempfile.TemporaryDirectory() as tmp:
        generate_synthetic_dataset(Path(tmp) / "data", n_train=12, n_val=2, seed=3)
        os.chdir(tmp)
        try:
            cfg = dict(retrieval_config(Path(tmp) / "data", ""), seed=0, experiment="profile")
            trainer = RetrievalTrainer(cfg, device="cuda")
            batch = trainer._device_batch(first_batches(
                trainer.train_dataset, trainer.batch_size, 1)[0])
            step = lambda: trainer._train_step(batch, trainer.base_lr)  # noqa: E731
            # no trace files: without cuDNN one step records ~10^5 events
            trace(step, f"retrieval train step, batch {trainer.batch_size}", None)
            torch.backends.cudnn.enabled = False  # only this flag; TF32 stays off
            try:
                trace(step, f"retrieval train step, batch {trainer.batch_size}, cuDNN off "
                      "(PyTorch's own convolution kernels)", None)
            finally:
                torch.backends.cudnn.enabled = True
        finally:
            os.chdir(cwd)
    return 0


def profile_refine() -> int:
    """Trace the refinement trainer's step of each phase at chip_smoke.py's
    config on one resident batch of a synthetic dataset."""
    import os
    import tempfile

    import numpy as np
    import torch

    from chip_smoke import first_batches, refinement_config, write_composed_retrievals
    from retrieval_fuse_tpu_torch.data.synthetic import generate_synthetic_dataset
    from retrieval_fuse_tpu_torch.train.refinement_trainer import RefinementTrainer

    cwd = os.getcwd()
    with tempfile.TemporaryDirectory() as tmp:
        generate_synthetic_dataset(Path(tmp) / "data", n_train=12, n_val=2, seed=3)
        cfg = dict(refinement_config(Path(tmp) / "data", "runs/tools/ckpt_epoch=0"), seed=0,
                   experiment="profile")
        write_composed_retrievals(cfg, np.random.default_rng(1))
        os.chdir(tmp)
        try:
            tr = RefinementTrainer(cfg, device="cuda")
            batch = tr._device_batch(first_batches(tr.train_dataset, tr.batch_size, 1)[0])
            with torch.no_grad():
                cached = dict(zip(("x_back", "x_target", "occ"), tr._frozen_features(batch)))
            for phase in (0, 1, 2, "2 cached", 3):
                tr.set_phase(int(str(phase)[0]))
                step = ((lambda: tr.train_step(cached, tr.base_lr, cached=True))
                        if phase == "2 cached" else (lambda: tr.train_step(batch, tr.base_lr)))
                trace(step, f"refinement phase {phase} step, batch {tr.batch_size}", None,
                      calls=1 if phase == 3 else 3)
        finally:
            os.chdir(cwd)
    return 0


if __name__ == "__main__":
    sys.exit(main())
