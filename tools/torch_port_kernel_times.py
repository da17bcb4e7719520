#!/usr/bin/env python3
"""Build, check and time the port's tensor-core kernels alone, on one CUDA card.

    python tools/torch_port_kernel_times.py [--seed 0] [--batch 128] [--iters 10]

Builds csrc/gathered_attention.cu, patch_attention.cu and decoder_tail.cu
(printing what ptxas says of registers and spills), then at the serving
shapes of `--batch` chunks (batch·64 tiles of 64 rows x 128 features, K = 4,
a 27,132-tile bank; decoder tail B = batch, S = 32, nf = 16), on seeded
random rows and weights:
  - holds each kernel against its plain PyTorch version in bf16 (selection
    agreement and max |diff| for the attentions, max |diff| for the tail)
    and in float32, with chip_smoke.py's tolerances;
  - times the bf16 and float32 launches with CUDA events.
chip_smoke.py measures the same kernels on the engine's own rows; this tool
is the short loop for working on a kernel. Needs a CUDA card.
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
    ap.add_argument("--batch", type=int, default=128)
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
    for name, rep in _build.build_all(["gathered_attention", "patch_attention",
                                       "decoder_tail"]).items():
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
    if failed:
        print(f"FAILED: {failed}", file=sys.stderr)
        return 1
    print("all holds passed", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
