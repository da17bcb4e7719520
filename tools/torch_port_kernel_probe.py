#!/usr/bin/env python3
"""What holds the port's tensor-core kernels: probes built with compile-time
switches, on one CUDA card.

    python tools/torch_port_kernel_probe.py [--seed 0] [--iters 10]

At the batch-128 serving shapes (seeded random rows and weights):
  - csrc/decoder_tail.cu (bf16, nf = 16) as it is, without its slab copies
    (-DRF_PROBE_NO_COPY), without its conv (-DRF_PROBE_NO_CONV) and without
    both: the time of each half alone beside the whole. Where the whole is
    near the sum, copies and conv do not overlap; where it is near the
    larger, they do. The probes' outputs are meaningless and are not checked.
  - csrc/gathered_attention.cu (bf16) with persistent blocks of 8, 10, 12 and
    16 warps (-DRF_PROBE_ATTN_THREADS=n), with ptxas's registers and spills
    and the selection agreement with the plain version beside each time.
Each variant is its own library (the flags are part of its name); the
kernels the port loads afterwards are the unflagged ones. Needs a CUDA card.
"""

from __future__ import annotations

import argparse
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--iters", type=int, default=10)
    args = ap.parse_args(argv)

    import torch

    from chip_smoke import SEED_BANK_ROWS, cuda_ms
    from retrieval_fuse_tpu_torch.device import resolve_device
    from retrieval_fuse_tpu_torch.models.attention import AttentionFeatureEncoder
    from retrieval_fuse_tpu_torch.ops import _build
    from retrieval_fuse_tpu_torch.ops import decoder_tail as dt
    from retrieval_fuse_tpu_torch.ops import patch_attention as pa

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
        return "; ".join([", ".join(sorted(regs)), *sorted(spills)])

    try:
        with torch.inference_mode():
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
            del hn

            torch.manual_seed(args.seed)
            theta, phi = (AttentionFeatureEncoder(128, 32).to(dev).bfloat16() for _ in range(2))
            bank = torch.randn((SEED_BANK_ROWS, 64, 128), generator=gen, device=dev).bfloat16()
            xt = torch.randn((8192, 64, 128), generator=gen, device=dev).bfloat16()
            idx = torch.randint(0, SEED_BANK_ROWS, (8192, 4), generator=gen, device=dev,
                                dtype=torch.int32)
            _, want_sel = pa.gathered_patch_attention_plain(xt, bank, idx, theta, phi, 4)
            for threads in (256, 320, 384, 512):
                ptxas = rebuilt("gathered_attention", (f"-DRF_PROBE_ATTN_THREADS={threads}",))
                _, sel = pa.gathered_patch_attention(xt, bank, idx, theta, phi, 4,
                                                     return_selection=True)
                agree = float((sel.long() == want_sel).float().mean())
                ms = cuda_ms(lambda: pa.gathered_patch_attention(xt, bank, idx, theta, phi, 4),
                             args.iters)
                print(f"gathered_patch_attention bf16 Q=8192 K=4, {threads // 32} warps a block: "
                      f"{ms:.3f} ms, selections agree on {agree:.5%}; ptxas {ptxas} [{card}]",
                      flush=True)
    finally:
        _build.NVCC_FLAGS = base_flags
        _build._loaded.clear()
    return 0


if __name__ == "__main__":
    sys.exit(main())
