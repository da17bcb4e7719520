#!/usr/bin/env python3
"""Time the attention, decoder-tail and topk kernels at their shipped shapes,
for comparing two checkouts of the port inside one chip call.

    python tools/torch_port_shipped_times.py [--root DIR] [--iters 10] [--seed 0]

Imports retrieval_fuse_tpu_torch from --root (default: the checkout this
file is in), builds its kernels there, and times with CUDA events, on
seeded random rows and weights, each kernel at the shapes of PERF.md's
kernel table that have instances of their own: the three attention kernels
in bf16 at batch 128 (8,192 tiles of 64 rows, K = 4, a 27,132-tile bank;
patch_attention on the same rows gathered, N = 524,288) at F = 128, 96, 64
and 32; the decoder tail in bf16 at B = 128, S = 32, nf 16, 12, 8 and 4;
the topk kernel at k = 4 on 4,096 x 27,132 scores. Prints the card, then
one JSON line {"root", "card", "ms": {name: ms}}. Run it for a parent and
its change in turns (parent, change, change, parent) in one call, so that
both are read on one card. Needs a CUDA card.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", default=str(Path(__file__).resolve().parents[1]))
    ap.add_argument("--iters", type=int, default=10)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    root = Path(args.root).resolve()
    sys.path.insert(0, str(root))

    import numpy as np
    import torch
    if not torch.cuda.is_available():
        print("torch_port_shipped_times: no CUDA device", file=sys.stderr)
        return 1
    from retrieval_fuse_tpu_torch.models.attention import AttentionFeatureEncoder
    from retrieval_fuse_tpu_torch.ops import _build
    from retrieval_fuse_tpu_torch.ops import decoder_tail as dt
    from retrieval_fuse_tpu_torch.ops import patch_attention as pa
    from retrieval_fuse_tpu_torch.ops.topk import topk
    assert Path(pa.__file__).resolve().is_relative_to(root), pa.__file__

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True)
    card = smi.stdout.strip().splitlines()[0] if smi.returncode == 0 else "unknown card"
    print(card, flush=True)
    _build.build_all(["topk", "gathered_attention", "gathered_attention_v1", "patch_attention",
                      "decoder_tail"])
    dev = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    def cuda_ms(fn) -> float:
        fn()
        torch.cuda.synchronize()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(args.iters):
            fn()
        end.record()
        end.synchronize()
        return start.elapsed_time(end) / args.iters

    gen = torch.Generator(device=dev).manual_seed(args.seed)
    ms = {}
    q, t, k, n_bank = 8192, 64, 4, 27132
    for f in (128, 96, 64, 32):
        torch.manual_seed(args.seed + f)
        theta, phi = (AttentionFeatureEncoder(f, 32).to(dev, torch.bfloat16) for _ in range(2))
        if hasattr(pa, "freeze_operands"):  # as an engine does; older trees pack every call
            pa.freeze_operands(theta, phi)
        xt = torch.randn((q, t, f), generator=gen, device=dev).bfloat16()
        bank = torch.randn((n_bank, t, f), generator=gen, device=dev).bfloat16()
        idx = torch.randint(0, n_bank, (q, k), generator=gen, device=dev, dtype=torch.int32)
        p = bank[idx.long()].transpose(1, 2).reshape(q * t, k, f).contiguous()
        x = xt.reshape(q * t, f)
        with torch.inference_mode():
            ms[f"attention@F{f}"] = cuda_ms(
                lambda: pa.gathered_patch_attention(xt, bank, idx, theta, phi, k))
            ms[f"attention_v1@F{f}"] = cuda_ms(
                lambda: pa.gathered_patch_attention_v1(xt, bank, idx, theta, phi, k))
            ms[f"patch_attention@F{f}"] = cuda_ms(lambda: pa.patch_attention(x, p, theta, phi, k))
        del xt, bank, p, x
    b, s = 128, 32
    for nf in (16, 12, 8, 4):
        hn = torch.zeros((b, s + 2, s + 2, s + 2, 8 * nf), device=dev, dtype=torch.bfloat16)
        hn[:, 1:-1, 1:-1, 1:-1] = torch.randn((b, s, s, s, 8 * nf), generator=gen,
                                              device=dev).bfloat16()
        w2 = torch.randn((3, 3, 3, nf, nf), generator=gen, device=dev) / np.sqrt(27 * nf)
        w2 = w2.bfloat16()
        wh = (torch.randn((nf,), generator=gen, device=dev) / np.sqrt(nf)).bfloat16()
        ms[f"decoder_tail@nf{nf}"] = cuda_ms(lambda: dt.decoder_tail(hn, w2, wh, 0.1))
        del hn
    sims = torch.randn((4096, n_bank), generator=gen, device=dev)
    ms["topk@k4"] = cuda_ms(lambda: topk(sims, 4))
    print(json.dumps({"root": str(root), "card": card, "ms": ms}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
