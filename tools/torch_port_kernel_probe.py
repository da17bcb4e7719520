#!/usr/bin/env python3
"""What holds the port's redesigned kernels: probes built with compile-time
switches, on one CUDA card.

    python tools/torch_port_kernel_probe.py [--seed 0] [--iters 10]
                                            [--probe tail attention v1 chamfer knn]

At the batch-128 serving shapes (seeded random rows and weights):
  - csrc/decoder_tail.cu (bf16, nf = 16) as it is, without its slab copies
    (-DRF_PROBE_NO_COPY), without its conv (-DRF_PROBE_NO_CONV) and without
    both: the time of each half alone beside the whole. Where the whole is
    near the sum, copies and conv do not overlap; where it is near the
    larger, they do. The probes' outputs are meaningless and are not checked.
  - csrc/gathered_attention.cu (bf16, the wgmma body) with persistent blocks
    of 2, 3 and 4 warpgroups (-DRF_PROBE_ATTN_THREADS=128·G), with ptxas's
    registers, spills and wgmma serialization warnings and the selection
    agreement with the plain version beside each time.
  - csrc/gathered_attention_v1.cu (bf16) with rings of 2 slots and of 1
    (-DRF_PROBE_V1_SLOTS=1: a candidate's copy starts when the one before it
    has been taken), beside csrc/gathered_attention.cu on the same rows.
  - csrc/chamfer.cu at tools/torch_port_kernel_times.py's three sizes: block
    shapes (-DRF_PROBE_CHAMFER_THREADS, -DRF_PROBE_CHAMFER_POINTS), blocks
    wanted for every SM (-DRF_PROBE_CHAMFER_WAVES, which sets the split count
    of a B = 1 call), and the merge by atomicMin in place of the cluster's
    (-DRF_PROBE_CHAMFER_ATOMIC=S, up to S splits), each held bit-equal to
    the plain version, timed call after call and queued behind a long
    kernel (the device's time alone); and the inner loop without its minimum
    (-DRF_PROBE_CHAMFER_NO_MIN), without its FMAs (-DRF_PROBE_CHAMFER_NO_FMA)
    and without both, whose outputs are meaningless and are not checked.
  - csrc/knn.cu at the serving shape (Q = 8192 against 27,132 rows, D = 64,
    k = 4 and 8, bf16 and float32), each variant built with
    -DRF_PROBE_KNN_SERVING_ONLY (those shapes alone, so that a build takes
    seconds): as shipped; the products without the select
    (-DRF_PROBE_KNN_NO_SELECT, unchecked); the cluster's split count forced
    (-DRF_PROBE_KNN_SPLITS=S, S in 1, 2, 3, 4, 6, 8); ring depths 2 and 4
    (-DRF_PROBE_KNN_SLOTS); tiles of 32 and 128 rows (-DRF_PROBE_KNN_TILE);
    each held against the plain version (indices off near-ties, 2e-6).
    Before them, the wall time of the full build of knn.cu (every width
    bucket and list size).
Each variant is its own library (the flags are part of its name); the
kernels the port loads afterwards are the unflagged ones. Needs a CUDA card.
"""

from __future__ import annotations

import argparse
import re
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))


PROBES = ("tail", "attention", "v1", "chamfer", "knn")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--iters", type=int, default=10)
    ap.add_argument("--probe", nargs="+", choices=PROBES, default=list(PROBES))
    args = ap.parse_args(argv)

    import torch

    from chip_smoke import SEED_BANK_ROWS, cuda_ms, knn_index_agreement
    from retrieval_fuse_tpu_torch.device import resolve_device
    from retrieval_fuse_tpu_torch.models.attention import AttentionFeatureEncoder
    from retrieval_fuse_tpu_torch.ops import _build
    from retrieval_fuse_tpu_torch.ops import decoder_tail as dt
    from retrieval_fuse_tpu_torch.ops import patch_attention as pa
    from retrieval_fuse_tpu_torch.ops.streaming_chamfer import (
        chamfer_minima, chamfer_minima_plain)
    from tools.torch_port_kernel_times import chamfer_cases, queued_ms

    dev = resolve_device("cuda")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True).stdout.strip()
    print(card, flush=True)
    gen = torch.Generator(device=dev).manual_seed(args.seed)
    base_flags = _build.NVCC_FLAGS

    def rebuilt(name: str, flags: tuple) -> str:
        """Make `flags` the build's, build kernel `name`; its ptxas lines for
        the tensor-core kernels (the widest register counts)."""
        _build.NVCC_FLAGS = base_flags + flags
        _build._loaded.clear()
        rep = _build.build_all([name]).get(name, "")
        lines = rep.splitlines()
        regs = {ln.split("Used ")[1].split(",")[0] for ln in lines if "Used " in ln}
        spills = {ln.strip() for ln in lines if "spill" in ln and "0 bytes spill" not in ln}
        serialized = {ln.strip()[:160] for ln in lines if "serialized" in ln}
        wgmma = {}  # the wgmma entry points' registers and spills, by (F, hard)
        for i, ln in enumerate(lines):
            m = re.search(r"Compiling entry function '\S*_wgmmaILi(\d+)ELb(\d)", ln)
            if m:
                stats = " ".join(x.strip().replace("ptxas info    : ", "")
                                 for x in lines[i + 1:i + 5] if "spill" in x or "Used" in x)
                wgmma[f"F{m.group(1)}{' hard' if m.group(2) == '1' else ''}"] = stats
        per_entry = [f"wgmma {k}: {v}" for k, v in sorted(wgmma.items())]
        return "; ".join([", ".join(sorted(regs)), *sorted(spills), *sorted(serialized),
                          *per_entry])

    def probe_tail():
        hn = torch.zeros((128, 34, 34, 34, 128), device=dev, dtype=torch.bfloat16)
        hn[:, 1:-1, 1:-1, 1:-1] = torch.randn((128, 32, 32, 32, 128), generator=gen,
                                              device=dev).bfloat16()
        w2 = (torch.randn((3, 3, 3, 16, 16), generator=gen, device=dev) / 432 ** 0.5).bfloat16()
        wh = (torch.randn((16,), generator=gen, device=dev) / 4).bfloat16()
        for label, flags in (("whole", ()), ("no copies", ("-DRF_PROBE_NO_COPY",)),
                             ("no conv", ("-DRF_PROBE_NO_CONV",)),
                             ("neither", ("-DRF_PROBE_NO_COPY", "-DRF_PROBE_NO_CONV"))):
            rebuilt("decoder_tail", flags)
            ms = cuda_ms(lambda: dt.decoder_tail(hn, w2, wh, 0.25), args.iters)
            print(f"decoder_tail bf16 B=128 S=32 nf=16, {label}: {ms:.3f} ms [{card}]",
                  flush=True)

    def attention_operands():
        """(xt, bank, idx, theta, phi, 4) at batch 128 in bf16, and the plain
        version's selections."""
        torch.manual_seed(args.seed)
        theta, phi = (AttentionFeatureEncoder(128, 32).to(dev).bfloat16() for _ in range(2))
        pa.freeze_operands(theta, phi)  # packed once, as the engine's
        bank = torch.randn((SEED_BANK_ROWS, 64, 128), generator=gen, device=dev).bfloat16()
        xt = torch.randn((8192, 64, 128), generator=gen, device=dev).bfloat16()
        idx = torch.randint(0, SEED_BANK_ROWS, (8192, 4), generator=gen, device=dev,
                            dtype=torch.int32)
        ops = (xt, bank, idx, theta, phi, 4)
        return ops, pa.gathered_patch_attention_plain(*ops)[1]

    def attention_line(kernel, ops, want_sel) -> str:
        _, sel = kernel(*ops, return_selection=True)
        agree = float((sel.long() == want_sel).float().mean())
        ms = cuda_ms(lambda: kernel(*ops), args.iters)
        return f"{ms:.3f} ms, selections agree on {agree:.5%}"

    def probe_attention():
        ops, want_sel = attention_operands()
        for threads in (256, 384, 512, 256, 384):
            ptxas = rebuilt("gathered_attention", (f"-DRF_PROBE_ATTN_THREADS={threads}",))
            print(f"gathered_patch_attention bf16 Q=8192 K=4, {threads // 128} warpgroups a block: "
                  f"{attention_line(pa.gathered_patch_attention, ops, want_sel)}; "
                  f"ptxas {ptxas} [{card}]", flush=True)

    def probe_v1():
        ops, want_sel = attention_operands()
        rebuilt("gathered_attention", ())
        print(f"gathered_patch_attention bf16 Q=8192 K=4, as shipped: "
              f"{attention_line(pa.gathered_patch_attention, ops, want_sel)} [{card}]",
              flush=True)
        for slots in (2, 1, 2):
            ptxas = rebuilt("gathered_attention_v1", (f"-DRF_PROBE_V1_SLOTS={slots}",))
            print(f"gathered_patch_attention_v1 bf16 Q=8192 K=4, {slots} slots a ring: "
                  f"{attention_line(pa.gathered_patch_attention_v1, ops, want_sel)}; "
                  f"ptxas {ptxas} [{card}]", flush=True)

    def probe_chamfer():
        sizes = chamfer_cases(gen, 128)
        wants = [chamfer_minima_plain(*cargs) for _, cargs in sizes]
        d = "-DRF_PROBE_CHAMFER_"
        for label, flags in (
                ("128 threads x 2 points, 16 blocks an SM wanted, clusters (as shipped)", ()),
                ("as shipped without the minimum (a sum)", (d + "NO_MIN",)),
                ("as shipped without the FMAs (one addition)", (d + "NO_FMA",)),
                ("as shipped without either", (d + "NO_MIN", d + "NO_FMA")),
                ("128 x 4, 16 wanted", (d + "POINTS=4",)),
                ("128 x 4, 4 wanted", (d + "POINTS=4", d + "WAVES=4")),
                ("128 x 8, 16 wanted", (d + "POINTS=8",)),
                ("128 x 8, 4 wanted", (d + "POINTS=8", d + "WAVES=4")),
                ("128 x 1, 32 wanted", (d + "POINTS=1", d + "WAVES=32")),
                ("64 x 2, 32 wanted", (d + "THREADS=64", d + "WAVES=32")),
                ("256 x 2, 16 wanted", (d + "THREADS=256",)),
                ("128 x 2, atomicMin, up to 32 splits", (d + "ATOMIC=32", d + "WAVES=64")),
                ("128 x 4, atomicMin, up to 32 splits",
                 (d + "POINTS=4", d + "ATOMIC=32", d + "WAVES=32")),
                ("as shipped, again", ())):
            ptxas = rebuilt("chamfer", flags)
            checked = not any("NO_" in f for f in flags)
            times = []
            for (size, cargs), want in zip(sizes, wants):
                got = chamfer_minima(*cargs)
                differ = checked and not all(torch.equal(g, w) for g, w in zip(got, want))
                ms = cuda_ms(lambda: chamfer_minima(*cargs), 5 * args.iters)
                dev_ms = queued_ms(lambda: chamfer_minima(*cargs), 5 * args.iters)
                times.append(f"{size} {ms:.4f} ms a call, {dev_ms:.4f} queued"
                             f"{' (MINIMA DIFFER)' if differ else ''}")
            print(f"chamfer {label}: {'; '.join(times)}; ptxas {ptxas} [{card}]", flush=True)

    def probe_knn():
        from retrieval_fuse_tpu_torch.ops.streaming_knn import (
            streaming_knn_sims, streaming_knn_sims_plain)
        from tools.torch_port_kernel_times import unit_rows
        ops = {dtype: (unit_rows(gen, 8192, 64, dtype), unit_rows(gen, SEED_BANK_ROWS, 64, dtype))
               for dtype in (torch.bfloat16, torch.float32)}
        wants = {(dtype, k): streaming_knn_sims_plain(*ops[dtype], k + 1)
                 for dtype in ops for k in (4, 8)}
        t0 = time.perf_counter()
        rebuilt("knn", ())
        print(f"knn.cu, every instantiation: built in {time.perf_counter() - t0:.1f} s "
              f"[{card}]", flush=True)
        d = "-DRF_PROBE_KNN_"
        variants = [("as shipped (3 slots, 64-row tiles, 3 blocks an SM wanted)", ())]
        variants += [("the products alone, no select", (f"{d}NO_SELECT",))]
        variants += [(f"{s_} splits", (f"{d}SPLITS={s_}",)) for s_ in (1, 2, 3, 4, 6, 8)]
        variants += [(f"{n_} slots", (f"{d}SLOTS={n_}",)) for n_ in (2, 4)]
        variants += [(f"{n_}-row tiles", (f"{d}TILE={n_}",)) for n_ in (32, 128)]
        variants += [("as shipped, again", ())]
        for label, flags in variants:
            ptxas = rebuilt("knn", flags + (d + "SERVING_ONLY",))
            times = []
            for (dtype, k), (pv, pi) in wants.items():
                v, i = streaming_knn_sims(*ops[dtype], k)
                torch.cuda.synchronize()
                ok = "NO_SELECT" in "".join(flags) or (
                    knn_index_agreement(i, pv, pi, k)[0]
                    and float((v - pv[:, :k]).abs().max()) <= 2e-6)
                ms = cuda_ms(lambda: streaming_knn_sims(*ops[dtype], k), args.iters)
                times.append(f"{str(dtype)[6:]} k={k} {ms:.4f} ms{'' if ok else ' (DIFFERS)'}")
            print(f"knn Q=8192 N={SEED_BANK_ROWS} D=64, {label}: {'; '.join(times)}; "
                  f"ptxas {ptxas} [{card}]", flush=True)

    probes = {"tail": probe_tail, "attention": probe_attention, "v1": probe_v1,
              "chamfer": probe_chamfer, "knn": probe_knn}
    try:
        with torch.inference_mode():
            for name in PROBES:
                if name in args.probe:
                    probes[name]()
    finally:
        _build.NVCC_FLAGS = base_flags
        _build._loaded.clear()
    return 0


if __name__ == "__main__":
    sys.exit(main())
