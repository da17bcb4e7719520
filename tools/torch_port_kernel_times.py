#!/usr/bin/env python3
"""Build, check and time the port's redesigned kernels alone, on one CUDA card.

    python tools/torch_port_kernel_times.py [--seed 0] [--batch 128] [--iters 10]

Builds csrc/gathered_attention.cu, gathered_attention_v1.cu,
patch_attention.cu, decoder_tail.cu and chamfer.cu (printing what ptxas says
of registers and spills), then at the serving shapes of `--batch` chunks
(batch·64 tiles of 64 rows x 128 features, K = 4, a 27,132-tile bank; decoder
tail B = batch, S = 32, nf = 16), on seeded random rows and weights:
  - holds each kernel against its plain PyTorch version in bf16 (selection
    agreement and max |diff| for the attentions, max |diff| for the tail)
    and in float32, with chip_smoke.py's tolerances;
  - times the bf16 and float32 launches with CUDA events.
Then the chamfer kernel on random voxel coordinates at the sizes of the
pipeline's `evaluate` calls (B = 1 in buffers of 49,152: 5,400 against
38,800 points, as a val scene's target against its retrieved prediction,
and 14,600 against 14,600, the same number of pairs) and batched
(B = `--batch`, 4,600-6,600 points a set in buffers of 16,384): minima
bit-equal to the plain version's, times beside chip_smoke.py's bound. A
chamfer call is short enough for the host to be the slower side (the
wrapper's checks, two allocations and the launch), so each size is timed
twice: launch after launch as a caller sees it, and queued behind a long
matrix product, so that the launches are waiting when the card reaches them
and only the device's time is read. chip_smoke.py measures the same kernels on the
engine's and the pipeline's own data; this tool is the short loop for
working on a kernel. Needs a CUDA card.
"""

from __future__ import annotations

import argparse
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))


def voxel_sets(gen, b: int, cap: int, lo_hi: tuple):
    """(points (b, cap, 3) float32, counts (b,) int32): b sets of lo..hi random
    voxel coordinates below 128, zeros past each count, on gen's device."""
    import torch
    lo, hi = lo_hi
    n = torch.randint(lo, hi + 1, (b,), generator=gen, device=gen.device, dtype=torch.int32)
    pts = torch.randint(0, 128, (b, cap, 3), generator=gen, device=gen.device).float()
    pts[torch.arange(cap, device=gen.device)[None, :] >= n[:, None]] = 0.0
    return pts, n


def queued_ms(fn, iters: int) -> float:
    """Mean device time of fn() over `iters` launches enqueued while the card
    is busy with a float32 matrix product (~20 ms on an H100), so that no
    launch waits for the host: iters x fn's host time must stay below it."""
    import torch
    a = torch.zeros((8192, 8192), device="cuda")
    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.mm(a, a)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


#: the chamfer kernel's timed sizes: (label, pairs or None for --batch,
#: capacity, (fewest, most) points of a set a, of a set b)
CHAMFER_SIZES = (("evaluate size, uneven sets, B=1", 1, 49152, (5400, 5400), (38800, 38800)),
                 ("evaluate size, even sets, B=1", 1, 49152, (14600, 14600), (14600, 14600)),
                 ("batched", None, 16384, (4600, 6600), (4600, 6600)))


def chamfer_cases(gen, batch: int) -> list:
    """[(label, [points_a, n_a, points_b, n_b])] of CHAMFER_SIZES."""
    return [(label if b else f"{label}, B={batch}",
             [*voxel_sets(gen, b or batch, cap, n_a), *voxel_sets(gen, b or batch, cap, n_b)])
            for label, b, cap, n_a, n_b in CHAMFER_SIZES]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--batch", type=int, default=128)
    ap.add_argument("--iters", type=int, default=10)
    args = ap.parse_args(argv)

    import torch

    from chip_smoke import SEED_BANK_ROWS, chamfer_bound, cuda_ms
    from retrieval_fuse_tpu_torch.device import resolve_device
    from retrieval_fuse_tpu_torch.models.attention import AttentionFeatureEncoder
    from retrieval_fuse_tpu_torch.ops import _build
    from retrieval_fuse_tpu_torch.ops import decoder_tail as dt
    from retrieval_fuse_tpu_torch.ops import patch_attention as pa
    from retrieval_fuse_tpu_torch.ops.streaming_chamfer import (
        chamfer_minima, chamfer_minima_plain)

    dev = resolve_device("cuda")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True).stdout.strip()
    print(card, flush=True)
    for name, rep in _build.build_all(["gathered_attention", "gathered_attention_v1",
                                       "patch_attention", "decoder_tail", "chamfer"]).items():
        for line in rep.splitlines():
            if "registers" in line or "spill" in line or "warning" in line:
                print(f"ptxas {name}: {line.strip()}", flush=True)

    gen = torch.Generator(device=dev).manual_seed(args.seed)
    q, t, f, k, nf, s = args.batch * 64, 64, 128, 4, 16, 32
    failed = []

    def hold(label, ok, text):
        print(f"{label}: {text}{'' if ok else '  <-- FAILED'}", flush=True)
        if not ok:
            failed.append(label)

    with torch.inference_mode():
        torch.manual_seed(args.seed)
        theta, phi = AttentionFeatureEncoder(f, 32).to(dev), AttentionFeatureEncoder(f, 32).to(dev)
        mlps = {torch.float32: (theta, phi),
                torch.bfloat16: tuple(AttentionFeatureEncoder(f, 32).to(dev).bfloat16()
                                      for _ in range(2))}
        for m16, m32 in zip(mlps[torch.bfloat16], (theta, phi)):
            m16.load_state_dict({n: v.bfloat16() for n, v in m32.state_dict().items()})
        bank = torch.randn((SEED_BANK_ROWS, t, f), generator=gen, device=dev).bfloat16()
        xt = torch.randn((q, t, f), generator=gen, device=dev).bfloat16()
        # candidates near their query row, so that scores are spread and the switch opens
        idx = torch.randint(0, SEED_BANK_ROWS, (q, k), generator=gen, device=dev,
                            dtype=torch.int32)
        xt = (0.5 * xt.float() + 0.5 * bank[idx[:, 0].long()].float()).bfloat16()
        p = bank[idx.long()].transpose(1, 2).reshape(q * t, k, f).contiguous()
        x = xt.reshape(q * t, f)

        cases = (("gathered_patch_attention", pa.gathered_patch_attention,
                  pa.gathered_patch_attention_plain, lambda d: (xt.to(d), bank.to(d), idx)),
                 ("gathered_patch_attention_v1", pa.gathered_patch_attention_v1,
                  pa.gathered_patch_attention_v1_plain, lambda d: (xt.to(d), bank.to(d), idx)),
                 ("patch_attention", pa.patch_attention, pa.patch_attention_plain,
                  lambda d: (x.to(d), p.to(d))))
        for name, kernel, plain, operands in cases:
            for dtype, share_min, tol in ((torch.bfloat16, 0.99, None),
                                          (torch.float32, 0.999, 1e-4)):
                ops = operands(dtype)
                for mode in (True, False):
                    out, sel = kernel(*ops, *mlps[dtype], k, mode, return_selection=True)
                    want, want_sel = plain(*ops, *mlps[dtype], k, mode)
                    torch.cuda.synchronize()
                    agree = sel.long() == want_sel
                    share = float(agree.float().mean())
                    diff = (out.float() - want.float()).abs()[agree]
                    ok = share >= share_min and (tol is None or float(diff.max()) <= tol)
                    hold(f"{name} {dtype} {'hard' if mode else 'softmax'} [{kernel.math}]", ok,
                         f"selections agree on {share:.5%}, max |diff| {float(diff.max()):.3e}, "
                         f"mean {float(diff.mean()):.3e}")
                    del out, want
                ms = cuda_ms(lambda: kernel(*ops, *mlps[dtype], k), args.iters)
                print(f"{name} {dtype} [{kernel.math}]: {ms:.3f} ms [{card}]", flush=True)
                del ops
        del bank, xt, p, x

        hn = torch.zeros((args.batch, s + 2, s + 2, s + 2, 8 * nf), device=dev)
        hn[:, 1:-1, 1:-1, 1:-1] = torch.randn((args.batch, s, s, s, 8 * nf), generator=gen,
                                              device=dev)
        w2 = torch.randn((3, 3, 3, nf, nf), generator=gen, device=dev) / (27 * nf) ** 0.5
        wh = torch.randn((nf,), generator=gen, device=dev) / nf ** 0.5
        for dtype, tol in ((torch.bfloat16, 1e-2), (torch.float32, 1e-4)):
            h, w2d, whd = hn.to(dtype), w2.to(dtype), wh.to(dtype)
            got = dt.decoder_tail(h, w2d, whd, 0.25)
            want = dt.decoder_tail_plain(h, w2d, whd, 0.25)
            torch.cuda.synchronize()
            diff = (got - want).abs()
            hold(f"decoder_tail {dtype} [{dt.decoder_tail.math}]", float(diff.max()) <= tol,
                 f"max |diff| {float(diff.max()):.3e}, mean {float(diff.mean()):.3e}")
            del got, want, diff
            ms = cuda_ms(lambda: dt.decoder_tail(h, w2d, whd, 0.25), args.iters)
            print(f"decoder_tail {dtype} [{dt.decoder_tail.math}]: {ms:.3f} ms [{card}]",
                  flush=True)
        del hn

        for label, cargs in chamfer_cases(gen, args.batch):
            got, want = chamfer_minima(*cargs), chamfer_minima_plain(*cargs)
            torch.cuda.synchronize()
            hold(f"chamfer {label}", all(torch.equal(g, w) for g, w in zip(got, want)),
                 "minima bit-equal to the plain version's")
            ms = cuda_ms(lambda: chamfer_minima(*cargs), 5 * args.iters)
            dev_ms = queued_ms(lambda: chamfer_minima(*cargs), 5 * args.iters)
            bound_ms, by = chamfer_bound([cargs])
            print(f"chamfer {label}, cap {cargs[0].shape[1]}: {ms:.4f} ms a call, {dev_ms:.4f} "
                  f"ms queued, bound {bound_ms:.4f} ms ({by}) [{card}]", flush=True)
    if failed:
        print(f"FAILED: {failed}", file=sys.stderr)
        return 1
    print("all holds passed", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
