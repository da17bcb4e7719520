#!/usr/bin/env python3
"""Build, check and time the port's redesigned kernels alone, on one CUDA card.

    python tools/torch_port_kernel_times.py [--seed 0] [--batch 128] [--iters 10]
                                            [--crossover] [--nf 16 12]

Builds csrc/knn.cu, gathered_attention.cu, gathered_attention_v1.cu,
patch_attention.cu, decoder_tail.cu and chamfer.cu (printing the build's
wall time and what ptxas says of registers and spills). First the streaming
kNN kernel on seeded random unit rows at the serving shape (Q = batch·64
queries against 27,132 rows of width 64) with k = 4 (serving) and k = 8
(`map`'s 2K), in bf16 and float32: indices equal to the plain version's off
near-ties (chip_smoke.knn_index_agreement) and similarities within 2e-6,
times beside the bound, the dense path the engine takes below the crossover
(float32 matmul + the topk kernel) and the library call (matmul +
torch.topk). With --crossover it times the kernel against the dense path at
Q in {1024, 2048, 4096, 8192} x N in {16,384, 27,132}, both dtypes, k in
{4, 8}: the table that sets
ops/knn.py's crossovers. Then for each width of `--nf` (16, the
super-resolution configs', and 12, the surface-reconstruction configs'), at
the serving shapes of `--batch` chunks (batch·64 tiles of 64 rows x F = 8·nf
features, K = 4, a 27,132-tile bank; decoder tail B = batch, S = 32), on
seeded random rows and weights:
  - holds each kernel against its plain PyTorch version in bf16 (selection
    agreement and max |diff| for the attentions, max |diff| for the tail)
    and in float32, with chip_smoke.py's tolerances (the float32 softmax
    attentions by chip_smoke.softmax_f64_hold: against the plain version
    in float64, with its negative control; `--nf 4 8 12 16` for every
    width the kernels take);
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
import time
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


#: the knn.cu instantiations of the serving shapes (D = 64; lists of 4 and 8),
#: by their mangled names' template arguments
KNN_SERVING_KERNELS = {"I13__nv_bfloat16Li4ELi4E": "bf16 D=64 k=4",
                       "I13__nv_bfloat16Li4ELi8E": "bf16 D=64 k=8",
                       "IfLi8ELi4E": "f32 D=64 k=4", "IfLi8ELi8E": "f32 D=64 k=8"}


def print_knn_ptxas(report: str) -> None:
    """knn.cu has 140 instantiations: the registers of the serving ones,
    the range over all, and every spill."""
    regs, entry = {}, ""
    for line in report.splitlines():
        if "Compiling entry function" in line:
            entry = line.split("'")[1] if "'" in line else line
        elif "Used " in line:
            n_regs = int(line.split("Used ")[1].split()[0])
            regs[entry] = n_regs
            for key, label in KNN_SERVING_KERNELS.items():
                if key in entry:
                    print(f"ptxas knn {label}: {line.strip()}", flush=True)
        elif "spill" in line and "0 bytes spill" not in line:
            print(f"ptxas knn {entry}: {line.strip()}", flush=True)
    if regs:
        print(f"ptxas knn: {len(regs)} entry functions, {min(regs.values())} to "
              f"{max(regs.values())} registers", flush=True)


def unit_rows(gen, n: int, d: int, dtype):
    """n seeded random unit rows of width d on gen's device, in dtype."""
    import torch
    x = torch.randn((n, d), generator=gen, device=gen.device)
    return (x / x.norm(dim=1, keepdim=True)).to(dtype).contiguous()


def time_knn(gen, q: int, n: int, k: int, iters: int, card: str, hold) -> None:
    """The kNN kernel at (Q, N, 64, k) in bf16 and float32: held against the
    plain version, timed beside its bound, the engine's dense path (float32
    matmul of the rows + the topk kernel) and matmul + torch.topk."""
    import torch
    from chip_smoke import (KNN_MIN_ORDER_CLEAR, KNN_SIM_TOL, cuda_ms, knn_bound,
                            knn_index_agreement)
    from retrieval_fuse_tpu_torch.ops.streaming_knn import (
        streaming_knn_sims, streaming_knn_sims_plain)
    from retrieval_fuse_tpu_torch.ops.topk import topk
    for dtype in (torch.bfloat16, torch.float32):
        qr, db = unit_rows(gen, q, 64, dtype), unit_rows(gen, n, 64, dtype)
        v, i = streaming_knn_sims(qr, db, k)
        pv, pi = streaming_knn_sims_plain(qr, db, k + 1)
        torch.cuda.synchronize()
        agree, set_clear, order_clear = knn_index_agreement(i, pv, pi, k)
        err = float((v - pv[:, :k]).abs().max())
        hold(f"knn {dtype} Q={q} N={n} k={k} [{streaming_knn_sims.math}]",
             agree and order_clear >= KNN_MIN_ORDER_CLEAR * q and err <= KNN_SIM_TOL,
             f"the same top-k rows on {set_clear} set-clear queries, in order on "
             f"{order_clear} order-clear, of {q}; max |sim diff| {err:.3e}")
        del pv, pi
        ms = cuda_ms(lambda: streaming_knn_sims(qr, db, k), iters)
        q32, db32 = qr.float(), db.float()
        dense = cuda_ms(lambda: topk(q32 @ db32.T, k), iters)
        library = cuda_ms(lambda: torch.topk(q32 @ db32.T, k), iters)
        b_ms, by = knn_bound(q, n, 64, k, dtype)
        print(f"knn {dtype} Q={q} N={n} D=64 k={k} [{streaming_knn_sims.math}]: kernel "
              f"{ms:.4f} ms, bound {b_ms:.4f} ms ({by}), dense path {dense:.4f} ms, "
              f"matmul + torch.topk {library:.4f} ms [{card}]", flush=True)


def knn_crossover(gen, iters: int, card: str) -> None:
    """The kernel against the dense path (float32 matmul + the topk kernel:
    what the engine runs below the crossover), both dtypes, at serving's
    k = 4 and `map`'s 2K = 8."""
    import torch
    from chip_smoke import cuda_ms
    from retrieval_fuse_tpu_torch.ops.streaming_knn import streaming_knn_sims
    from retrieval_fuse_tpu_torch.ops.topk import topk
    for dtype in (torch.bfloat16, torch.float32):
        for n in (16384, 27132):
            db = unit_rows(gen, n, 64, dtype)
            db32 = db.float()
            for q in (1024, 2048, 4096, 8192):
                qr = unit_rows(gen, q, 64, dtype)
                for k in (4, 8):
                    ms = cuda_ms(lambda: streaming_knn_sims(qr, db, k), iters)
                    dense = cuda_ms(lambda: topk(qr.float() @ db32.T, k), iters)
                    print(f"knn crossover {dtype} Q={q} N={n} k={k}: kernel {ms:.4f} ms, "
                          f"dense path {dense:.4f} ms, kernel/dense {ms / dense:.3f} [{card}]",
                          flush=True)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--batch", type=int, default=128)
    ap.add_argument("--iters", type=int, default=10)
    ap.add_argument("--crossover", action="store_true")
    ap.add_argument("--nf", type=int, nargs="+", default=[16, 12],
                    help="conv widths: the attention kernels at F = 8·nf, the tail at nf")
    args = ap.parse_args(argv)

    import torch

    from chip_smoke import SEED_BANK_ROWS, chamfer_bound, cuda_ms, softmax_f64_hold
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
    t0 = time.perf_counter()
    reports = _build.build_all(["knn", "gathered_attention", "gathered_attention_v1",
                                "patch_attention", "decoder_tail", "chamfer"])
    print(f"build: {len(reports)} libraries in {time.perf_counter() - t0:.1f} s", flush=True)
    for name, rep in reports.items():
        if name == "knn":
            print_knn_ptxas(rep)
            continue
        for line in rep.splitlines():
            if "registers" in line or "spill" in line or "warning" in line:
                print(f"ptxas {name}: {line.strip()}", flush=True)

    gen = torch.Generator(device=dev).manual_seed(args.seed)
    q, t, k, s = args.batch * 64, 64, 4, 32
    failed = []

    def hold(label, ok, text):
        print(f"{label}: {text}{'' if ok else '  <-- FAILED'}", flush=True)
        if not ok:
            failed.append(label)

    with torch.inference_mode():
        for knn_k in (4, 8):
            time_knn(gen, q, SEED_BANK_ROWS, knn_k, args.iters, card, hold)
        if args.crossover:
            knn_crossover(gen, args.iters, card)
        for nf in args.nf:
            f = 8 * nf
            torch.manual_seed(args.seed)
            theta = AttentionFeatureEncoder(f, 32).to(dev)
            phi = AttentionFeatureEncoder(f, 32).to(dev)
            mlps = {torch.float32: (theta, phi),
                    torch.bfloat16: tuple(AttentionFeatureEncoder(f, 32).to(dev).bfloat16()
                                          for _ in range(2))}
            for m16, m32 in zip(mlps[torch.bfloat16], (theta, phi)):
                m16.load_state_dict({n: v.bfloat16() for n, v in m32.state_dict().items()})
            pa.freeze_operands(*mlps[torch.float32], *mlps[torch.bfloat16])  # packed once
            bank = torch.randn((SEED_BANK_ROWS, t, f), generator=gen, device=dev).bfloat16()
            xt = torch.randn((q, t, f), generator=gen, device=dev).bfloat16()
            # candidates near their query row, so that scores are spread and the switch opens
            idx = torch.randint(0, SEED_BANK_ROWS, (q, k), generator=gen, device=dev,
                                dtype=torch.int32)
            xt = (0.5 * xt.float() + 0.5 * bank[idx[:, 0].long()].float()).bfloat16()
            p = bank[idx.long()].transpose(1, 2).reshape(q * t, k, f).contiguous()
            x = xt.reshape(q * t, f)
            # a shut switch (out = x) would compare x with x: where the seeded
            # weights shut it, negate phi's output layer, as chip_smoke does
            sample = slice(0, 4096)
            if (pa.patch_attention_plain(x[sample].float(), p[sample].float(), theta, phi, k)[0]
                    == x[sample].float()).all(dim=-1).float().mean() > 0.5:
                for m in (phi, mlps[torch.bfloat16][1]):
                    m.out.weight.neg_()
                    m.out.bias.neg_()

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
                        label = (f"{name} F={f} {dtype} {'hard' if mode else 'softmax'} "
                                 f"[{kernel.math}]")
                        if dtype == torch.float32 and not mode:
                            # chip_smoke's float64-anchored bound and its negative control
                            h = softmax_f64_hold(out, plain, (*ops, *mlps[dtype], k))
                            hold(label, share >= share_min and h["err"] <= h["bound"]
                                 and h["control"] > h["bound"],
                                 f"selections agree on {share:.5%}; max |diff| from float64 "
                                 f"{h['err']:.3e}, the plain float32's {h['plain_f32']:.3e}, "
                                 f"bound {h['bound']:.3e}, bf16 control {h['control']:.3e}")
                            del out, want
                            continue
                        ok = share >= share_min and (tol is None or float(diff.max()) <= tol)
                        hold(label, ok,
                             f"selections agree on {share:.5%}, max |diff| "
                             f"{float(diff.max()):.3e}, mean {float(diff.mean()):.3e}")
                        del out, want
                    ms = cuda_ms(lambda: kernel(*ops, *mlps[dtype], k), args.iters)
                    print(f"{name} F={f} {dtype} [{kernel.math}]: {ms:.3f} ms [{card}]",
                          flush=True)
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
                hold(f"decoder_tail nf={nf} {dtype} [{dt.decoder_tail.math}]",
                     float(diff.max()) <= tol,
                     f"max |diff| {float(diff.max()):.3e}, mean {float(diff.mean()):.3e}")
                del got, want, diff
                ms = cuda_ms(lambda: dt.decoder_tail(h, w2d, whd, 0.25), args.iters)
                print(f"decoder_tail nf={nf} {dtype} [{dt.decoder_tail.math}]: {ms:.3f} ms "
                      f"[{card}]", flush=True)
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
