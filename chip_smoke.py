#!/usr/bin/env python3
"""Drive the PyTorch port's serving path on one CUDA card and check it.

    python3 chip_smoke.py [--seed 0] [--out chiprun_out/chip_smoke.json]

Builds the port's CUDA kernels from retrieval_fuse_tpu_torch/csrc, builds
the flagship engine (ShapeNetV2 super-resolution 8³ -> 64³, nf=16, K=4,
latent 64, a 27,132-row database and feature bank; random weights and data
from --seed; data are distance fields of random spheres and boxes, as the
JAX package's synthetic scenes), holds each of the six kernels against its
plain PyTorch version at the serving shapes (float32, the algorithm check,
and bf16), times kernel, plain version, a library call where one exists and
the bound, then drives the serving paths, each with the kernel launch
counts set to 0 just before and read just after:
  - serve_directory with the shipped variant (FAST_VARIANT, bf16) at batch
    64 (dense kNN + the topk kernel) and batch 128 (the streaming kNN
    kernel), and with `fused+pallasp+topk1p+cdec` at batch 128;
  - the engine at batch 128 in bf16 and float32 for each of VARIANT_PATHS,
checking each path's TSDF against the plain `base` engine in bf16 (MAE <
1e-3, the budget of the JAX tests) and in float32 (MAE < 1e-5); the
bf16-vs-float32 MAE of FAST_VARIANT is printed.

Prints the card (nvidia-smi name and power limit), one line per check,
a `{"kernels": [...]}` JSON line and, last, `{"ok": true, "device": ...}`.
Any failed check exits non-zero. Needs one CUDA card; exits non-zero
without one, or without the retrieval_fuse_tpu_torch package beside it.
"""

from __future__ import annotations

import argparse
import copy
import json
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np

# H100 SXM published peaks (dense), at the 700 W limit
HBM_BYTES_PER_S = 3.35e12
F32_FLOPS = 67e12       # float32 outside the tensor cores
BF16_FLOPS = 989e12     # bf16 tensor cores

SEED_BANK_ROWS = 27132  # the ShapeNetV2 database (bench.py:196)
DENSE_BATCH = 64        # Q = 4096 queries: dense kNN + the topk kernel
STREAM_BATCH = 128      # Q = 8192 queries: the streaming kNN kernel
N_CHUNKS = 192          # chunk files served at each batch size (tail padded at 128)
CDEC_VARIANT = "fused+pallasp+topk1p+cdec"
#: the engine's other serving paths, each run at STREAM_BATCH -> the kernels
#: it must launch there (the streaming kNN kernel is auto-selected at Q=8192)
VARIANT_PATHS = {
    CDEC_VARIANT: ("knn", "patch_attention", "decoder_tail"),
    "fused+pallasg+topk1p+packed": ("knn", "attention_v1"),
    "pallas+dconv+fbb": ("knn", "patch_attention"),
    "fused+flatg+pallasp": ("knn", "patch_attention"),
    "phib+fused": ("knn",),
    "approxk+fused": ("knn",),
}


def flagship_config() -> dict:
    """The JAX package's flagship serving geometry (bench.py:145-158)."""
    return {
        "task": "superresolution", "K": 4, "nf": 16, "unet_num_level": 4,
        "layer_order": "gcr", "retrieval_fmaps": 16, "retrieval_num_level": 4,
        "attn_normalize": True, "attn_use_switching": True, "attn_retrieval_mode": True,
        "attn_no_output_mapping": True, "attn_blend": True,
        "attn_patch_extent": 4, "attn_num_patch": 16,
        "retrieval_model": {"network_input": "2+1", "network_target": "16+8",
                            "nf_input": 32, "nf_target": 8, "latent_dim": 64},
        "dataset_train": {"input_chunk_size": 8, "target_chunk_size": 64,
                          "input_mean": 0.3095340441938771, "input_std": 0.14730652990291243,
                          "target_mean": 0.059954833543534335, "target_std": 0.010110036361741626,
                          "voxel_size_input": 0.166667, "voxel_size_target": 0.020834},
    }


def synthetic_df(rng, n: int, res: int, voxel_size: float, device, n_prims: int = 3):
    """n truncated unsigned distance fields (res³, channels-last without the
    channel) of unions of random spheres and boxes in a unit chunk: the
    scenes of the JAX package's data/synthetic.py, drawn from `rng`."""
    import torch
    c = (torch.arange(res, dtype=torch.float32, device=device) + 0.5) / res
    g = torch.stack(torch.meshgrid(c, c, c, indexing="ij"), -1).reshape(1, -1, 3)
    d = torch.full((n, res ** 3), float("inf"), device=device)

    def draw(lo, hi, shape):
        return torch.from_numpy(rng.uniform(lo, hi, shape).astype(np.float32)).to(device)

    for _ in range(n_prims):
        center, radius, half = draw(0.25, 0.75, (n, 1, 3)), draw(0.08, 0.22, (n, 1)), \
            draw(0.06, 0.2, (n, 1, 3))
        sphere = torch.from_numpy(rng.integers(0, 2, (n, 1)) == 0).to(device)
        p = g - center
        q = p.abs() - half
        box = q.clamp(min=0).norm(dim=-1) + q.amax(dim=-1).clamp(max=0)
        d = torch.minimum(d, torch.where(sphere, p.norm(dim=-1) - radius, box))
    trunc = float(np.float16(voxel_size * 3))
    return torch.clamp(d.abs() * (voxel_size * res), max=trunc).reshape(n, res, res, res)


def flagship_params(cfg: dict, seed: int) -> dict:
    """Seeded random state_dicts (PyTorch's default law, models.init_params)
    with phi's output layer negated, so that theta and phi embeddings point
    the same way on average: the attention's ReLU switch opens and its
    selection does real work on most rows."""
    from retrieval_fuse_tpu_torch.models import init_params
    params = init_params(cfg, seed)
    blk = params["patched_attention_block"]
    for key in ("attention_blocks_layer.phi.out.weight", "attention_blocks_layer.phi.out.bias"):
        blk[key] = -blk[key]
    return params


def flagship_data(cfg: dict, rng, n: int, device):
    """(database (n, 64) random unit rows as numpy, patch bank (n, 16, 16, 16)
    on `device`: the 16³ tiles, in row-major order, of synthetic 64³
    target-resolution scenes)."""
    db = rng.standard_normal((n, 64), dtype=np.float32)
    db /= np.linalg.norm(db, axis=1, keepdims=True)
    scenes = synthetic_df(rng, n // 64 + 1, 64, cfg["dataset_train"]["voxel_size_target"],
                          device)
    bank = scenes.reshape(-1, 4, 16, 4, 16, 4, 16).permute(0, 1, 3, 5, 2, 4, 6) \
        .reshape(-1, 16, 16, 16)[:n].contiguous()
    return db, bank


class Failed(Exception):
    pass


def check(cond: bool, what: str) -> None:
    if not cond:
        raise Failed(what)


def cuda_ms(fn, iters: int, warmup: int = 1) -> float:
    """Mean device time of fn() over `iters` back-to-back runs (CUDA events)."""
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def log(msg: str) -> None:
    print(msg, flush=True)


def bound(nbytes: float, flops: float, peak: float) -> tuple[float, str]:
    """The least time (ms) the card could take: bytes over the memory rate or
    operations over `peak`, whichever is larger, and which it is."""
    by_bytes, by_ops = nbytes / HBM_BYTES_PER_S, flops / peak
    return 1e3 * max(by_bytes, by_ops), "bytes" if by_bytes >= by_ops else "operations"


def hold_attention(label: str, kernel, plain, args32: tuple, args16: tuple) -> tuple[float, float]:
    """An attention kernel against its plain version: float32 (selections
    agree on >= 99.9% of rows, max |diff| <= 1e-4 on them) and bf16
    (selections agree on >= 99%). Returns (float32 max |diff|, bf16 share)."""
    import torch
    out, sel = kernel(*args32, return_selection=True)
    want, want_sel = plain(*args32)
    torch.cuda.synchronize()
    agree = sel.long() == want_sel
    share = float(agree.float().mean())
    err = float((out - want).abs()[agree].max())
    switch_open = float((want != args32[0]).any(dim=-1).float().mean())
    check(share >= 0.999, f"{label} f32: selections agree on {share:.5f}")
    check(err <= 1e-4, f"{label} f32: max |diff| {err} on agreeing rows")
    log(f"{label} f32: selections agree on {share:.5%} of rows, max |diff| {err:.2e} on "
        f"them; switch open on {switch_open:.1%} of rows")
    out16, sel16 = kernel(*args16, return_selection=True)
    want16, want_sel16 = plain(*args16)
    agree16 = sel16.long() == want_sel16
    share16 = float(agree16.float().mean())
    diff16 = (out16.float() - want16.float()).abs()[agree16]
    check(share16 >= 0.99, f"{label} bf16: selections agree on {share16}")
    log(f"{label} bf16: selections agree on {share16:.5%} of rows, "
        f"max |diff| {float(diff16.max()):.2e}, mean {float(diff16.mean()):.2e}")
    return err, share16


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out", default="chiprun_out/chip_smoke.json")
    args = ap.parse_args(argv)

    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    try:
        from retrieval_fuse_tpu_torch.device import resolve_device
        from retrieval_fuse_tpu_torch.inference import (
            FAST_VARIANT, RetrieveRefineEngine, variant_engine_kwargs)
        from retrieval_fuse_tpu_torch.ops import _build
        from retrieval_fuse_tpu_torch.ops import decoder_tail as dt
        from retrieval_fuse_tpu_torch.ops import patch_attention as pa
        from retrieval_fuse_tpu_torch.ops.fused_decoder import depth_to_space_2x
        from retrieval_fuse_tpu_torch.ops.streaming_knn import (
            streaming_knn_sims, streaming_knn_sims_plain)
        from retrieval_fuse_tpu_torch.ops.topk import topk, topk_plain
        from retrieval_fuse_tpu_torch.serve import serve_directory
    except ImportError as e:
        print(f"chip_smoke: the port package is missing ({e})", file=sys.stderr)
        return 1
    import torch.nn.functional as F

    results: dict = {"seed": args.seed}
    try:
        # 1) the card
        try:
            smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                                  "--format=csv,noheader"], capture_output=True, text=True,
                                 timeout=60)
            card = smi.stdout.strip().splitlines()[0] if smi.returncode == 0 else ""
        except (OSError, subprocess.TimeoutExpired):
            card = ""
        card = card or "nvidia-smi gave no card name and power limit"
        log(card)
        results["card"] = card
        dev = resolve_device("cuda")
        results["torch"] = f"{torch.__version__} cuda {torch.version.cuda}"

        # 2) the kernels, built from the checkout's sources, all at once
        t0 = time.perf_counter()
        reports = _build.build_all()
        results["build_s"] = time.perf_counter() - t0
        log(f"build: {len(reports)} kernel libraries in {results['build_s']:.1f} s "
            f"-> {_build.BUILD_DIR}")
        for name, rep in reports.items():
            for line in rep.splitlines():
                if "registers" in line or "spill" in line:
                    log(f"  ptxas {name}: {line.strip()}")

        # 3) the flagship engines: base, FAST_VARIANT and VARIANT_PATHS, in
        # bf16 and float32, all on base's feature bank
        cfg = flagship_config()
        rng = np.random.default_rng(args.seed)
        params = flagship_params(cfg, args.seed)
        n = SEED_BANK_ROWS
        db, patch_bank = flagship_data(cfg, rng, n, dev)
        dtr = cfg["dataset_train"]
        engines, times = {}, {}
        for dtype, tag in ((torch.bfloat16, "bf16"), (torch.float32, "f32")):
            t0 = time.perf_counter()
            base_ = RetrieveRefineEngine(cfg, params, db, patch_bank, compute_dtype=dtype,
                                         device=dev)
            torch.cuda.synchronize()
            times[tag] = time.perf_counter() - t0
            check(torch.isfinite(base_.feature_bank).all().item(), f"{tag} feature bank")
            engines["base", tag] = base_
            for variant in (FAST_VARIANT, *VARIANT_PATHS):
                engines[variant, tag] = RetrieveRefineEngine(
                    cfg, params, db, compute_dtype=dtype, device=dev,
                    feature_bank=base_.feature_bank, **variant_engine_kwargs(variant))
        del patch_bank
        fast, fast32 = engines[FAST_VARIANT, "bf16"], engines[FAST_VARIANT, "f32"]
        results["feature_bank_s"] = times
        log(f"engines: feature bank precompute of {n} tiles: bf16 {times['bf16']:.2f} s, "
            f"f32 {times['f32']:.2f} s; {len(engines)} engines")

        chunks = synthetic_df(rng, N_CHUNKS, 8, dtr["voxel_size_input"], dev).cpu().numpy()
        base_out = {}

        def tsdf_check(variant: str, xb) -> dict:
            """`variant`'s TSDF against the plain `base` engine's on the batch
            xb: MAE < 1e-3 in bf16, < 1e-5 in float32; the bf16-vs-float32
            MAE is reported."""
            key = xb.shape[0]
            if key not in base_out:
                base_out[key] = {tag: engines["base", tag](xb) for tag in ("bf16", "f32")}
            got = {tag: engines[variant, tag](xb) for tag in ("bf16", "f32")}
            for tag, o in got.items():
                check(o.shape == (key, 64, 64, 64, 1) and torch.isfinite(o).all().item(),
                      f"{variant} {tag}: TSDF not finite or of shape {tuple(o.shape)}")
            maes = {f"mae_vs_base_{tag}": float((got[tag] - base_out[key][tag]).abs().mean())
                    for tag in ("bf16", "f32")}
            # reported: with random weights at this width it is bf16 rounding
            # amplified by the untrained network, the same in the JAX engine
            maes["mae_bf16_vs_f32_base"] = float((got["bf16"] - base_out[key]["f32"]).abs().mean())
            check(maes["mae_vs_base_bf16"] < 1e-3,
                  f"{variant} batch {key}: bf16 MAE vs bf16 base {maes['mae_vs_base_bf16']} >= 1e-3")
            check(maes["mae_vs_base_f32"] < 1e-5,
                  f"{variant} batch {key}: f32 MAE vs f32 base {maes['mae_vs_base_f32']} >= 1e-5")
            log(f"  TSDF MAE (df units), {variant} batch {key}: vs base bf16 "
                f"{maes['mae_vs_base_bf16']:.2e} (< 1e-3), f32 {maes['mae_vs_base_f32']:.2e} "
                f"(< 1e-5); bf16 vs f32 base {maes['mae_bf16_vs_f32_base']:.2e}")
            return maes

        kernels = {}
        k = cfg["K"]

        # 4a) topk at the dense path's shape (batch 64: Q = 4096)
        with torch.inference_mode():
            x64 = torch.from_numpy(chunks[:DENSE_BATCH, ..., None]).to(dev)
            sims = fast.embed_queries(x64).float() @ fast._database_f32.T
        q = sims.shape[0]
        worst = 0.0
        for label, s in (("scores", sims), ("bf16-tied scores", sims.bfloat16().float())):
            v, i = topk(s, k)
            pv, pi = topk_plain(s, k)
            torch.cuda.synchronize()
            check(torch.equal(i, pi) and torch.equal(v, pv),
                  f"topk {label}: kernel differs from plain")
            worst = max(worst, float((v - pv).abs().max()))
            ties = int((s.topk(k + 1).values.diff(dim=1) == 0).any(dim=1).sum())
            log(f"topk Q={q} N={n} {label}: values and indices bit-equal "
                f"({ties} rows with tied top-{k + 1} scores)")
        topk_bound = bound(q * n * 4 + q * k * 8, q * n, F32_FLOPS)
        kernels["topk"] = dict(
            name="topk", route="cuda", source="retrieval_fuse_tpu_torch/csrc/topk.cu",
            replaces="retrieval_fuse_tpu/ops/pallas_topk.py:32", max_abs_err=worst,
            ms=cuda_ms(lambda: topk(sims, k), 20),
            plain_ms=cuda_ms(lambda: topk_plain(sims, k), 5),
            library_ms=cuda_ms(lambda: torch.topk(sims, k), 20),
            bound_ms=topk_bound[0], bound_by=topk_bound[1], shape=f"Q={q} N={n} k={k} f32")
        del sims

        # 4b) streaming kNN at the streaming path's shape (batch 128: Q = 8192)
        with torch.inference_mode():
            x128 = torch.from_numpy(chunks[:STREAM_BATCH, ..., None]).to(dev)
            z = fast.embed_queries(x128).float().contiguous()
        db32 = fast._database_f32
        q = z.shape[0]
        v, i = streaming_knn_sims(z, db32, k)
        pv, pi = streaming_knn_sims_plain(z, db32, k + 1)
        torch.cuda.synchronize()
        clear = (pv[:, k - 1] - pv[:, k]) > 1e-5
        near = int((~clear).sum())
        check(torch.equal(i[clear], pi[clear, :k]), "streaming kNN: indices differ off near-ties")
        err = float((v - pv[:, :k]).abs().max())
        check(err <= 2e-6, f"streaming kNN: similarities differ by {err}")
        log(f"streaming kNN Q={q} N={n}: indices equal on {q - near} queries, "
            f"{near} near-tie queries (k-th/(k+1)-th gap <= 1e-5) excluded; "
            f"max |sim diff| {err:.2e}")
        knn_bound = bound((q + n) * 64 * 4 + q * k * 8, 2 * q * n * 64, F32_FLOPS)
        kernels["knn"] = dict(
            name="streaming_knn", route="cuda", source="retrieval_fuse_tpu_torch/csrc/knn.cu",
            replaces="retrieval_fuse_tpu/ops/pallas_knn.py:49", max_abs_err=err,
            ms=cuda_ms(lambda: streaming_knn_sims(z, db32, k), 20),
            plain_ms=cuda_ms(lambda: streaming_knn_sims_plain(z, db32, k), 5),
            library_ms=cuda_ms(lambda: torch.topk(z @ db32.T, k), 20),
            bound_ms=knn_bound[0], bound_by=knn_bound[1], near_ties=near,
            shape=f"Q={q} N={n} D=64 k={k} f32")

        # 4c-4e) the three attention kernels at batch 128 (Q = 8192 tiles of
        # 64 rows), on the FAST_VARIANT engine's rows and retrievals
        with torch.inference_mode():
            top_idx = fast.retrieve(x128)
            x_back = fast.unet_backbone(((x128 - fast.in_mean) / fast.in_std).bfloat16())
            xt16 = fast._tile_major_rows(x_back).contiguous()
        att = fast.attention.attention_blocks_layer
        q, t_rows, f = xt16.shape
        theta32, phi32 = [copy.deepcopy(m).float() for m in (att.theta, att.phi)]
        xt32, bank32 = xt16.float(), fast.feature_bank.float()
        bank16 = fast.feature_bank
        mlp_flops = 2 * (f * 128 + 2 * 128 * 128 + 128 * 32)
        attn_bound = bound(2 * (2 * q * t_rows * f + q * k * t_rows * f) + q * k * 4,
                           q * t_rows * (1 + k) * mlp_flops, BF16_FLOPS)
        with torch.inference_mode():
            # gathered attention v2 (kernel 3)
            err, share16 = hold_attention(
                f"gathered attention Q={q}", pa.gathered_patch_attention,
                pa.gathered_patch_attention_plain,
                (xt32, bank32, top_idx, theta32, phi32, k),
                (xt16, bank16, top_idx, att.theta, att.phi, k))
            args16 = (xt16, bank16, top_idx, att.theta, att.phi, k)
            kernels["attention"] = dict(
                name="gathered_patch_attention", route="cuda",
                source="retrieval_fuse_tpu_torch/csrc/gathered_attention.cu",
                replaces="retrieval_fuse_tpu/ops/pallas_attention.py:249", max_abs_err=err,
                ms=cuda_ms(lambda: pa.gathered_patch_attention(*args16), 5),
                plain_ms=cuda_ms(lambda: pa.gathered_patch_attention_plain(*args16), 3),
                library_ms=None, bound_ms=attn_bound[0], bound_by=attn_bound[1],
                f32_ms=cuda_ms(lambda: pa.gathered_patch_attention(
                    xt32, bank32, top_idx, theta32, phi32, k), 3),
                bf16_agreement=share16, shape=f"Q={q} T={t_rows} F={f} K={k} bf16")

            # gathered attention v1 (kernel 5): the same function and inputs
            err, share16 = hold_attention(
                f"gathered attention v1 Q={q}", pa.gathered_patch_attention_v1,
                pa.gathered_patch_attention_v1_plain,
                (xt32, bank32, top_idx, theta32, phi32, k), args16)
            kernels["attention_v1"] = dict(
                name="gathered_patch_attention_v1", route="cuda",
                source="retrieval_fuse_tpu_torch/csrc/gathered_attention_v1.cu",
                replaces="retrieval_fuse_tpu/ops/pallas_attention.py:151", max_abs_err=err,
                ms=cuda_ms(lambda: pa.gathered_patch_attention_v1(*args16), 5),
                plain_ms=cuda_ms(lambda: pa.gathered_patch_attention_v1_plain(*args16), 3),
                library_ms=None, bound_ms=attn_bound[0], bound_by=attn_bound[1],
                f32_ms=cuda_ms(lambda: pa.gathered_patch_attention_v1(
                    xt32, bank32, top_idx, theta32, phi32, k), 3),
                bf16_agreement=share16, shape=f"Q={q} T={t_rows} F={f} K={k} bf16")

            # patch attention (kernel 4) at the `pallasp` shape: N = Q·T rows,
            # each with its K candidate rows gathered (K and T swapped)
            n_rows = q * t_rows
            p16 = bank16[top_idx.long()].transpose(1, 2).reshape(n_rows, k, f).contiguous()
            x16 = xt16.reshape(n_rows, f)
            err, share16 = hold_attention(
                f"patch attention N={n_rows}", pa.patch_attention, pa.patch_attention_plain,
                (x16.float(), p16.float(), theta32, phi32, k),
                (x16, p16, att.theta, att.phi, k))
            pargs16 = (x16, p16, att.theta, att.phi, k)
            kernels["patch_attention"] = dict(
                name="patch_attention", route="cuda",
                source="retrieval_fuse_tpu_torch/csrc/patch_attention.cu",
                replaces="retrieval_fuse_tpu/ops/pallas_attention.py:46", max_abs_err=err,
                ms=cuda_ms(lambda: pa.patch_attention(*pargs16), 5),
                plain_ms=cuda_ms(lambda: pa.patch_attention_plain(*pargs16), 3),
                library_ms=None, bound_ms=attn_bound[0], bound_by=attn_bound[1],
                f32_ms=cuda_ms(lambda: pa.patch_attention(
                    x16.float(), p16.float(), theta32, phi32, k), 3),
                bf16_agreement=share16, shape=f"N={n_rows} K={k} F={f} bf16")
            del xt32, bank32, p16

        # 4f) the decoder tail (kernel 6) at batch 128 on the input the cdec
        # decoder makes from the FAST_VARIANT engine's fused features
        with torch.inference_mode():
            cdec = {tag: engines[CDEC_VARIANT, tag].fused_decoder for tag in ("bf16", "f32")}
            hn = {}
            for tag, eng in (("bf16", fast), ("f32", fast32)):
                xb = ((x128 - eng.in_mean) / eng.in_std).to(eng.compute_dtype)
                hn[tag] = cdec[tag].tail_input(
                    eng._attend(eng.unet_backbone(xb), eng.retrieve(x128), STREAM_BATCH))
            errs = {}
            for tag in ("f32", "bf16"):
                d = cdec[tag]
                got = dt.decoder_tail(hn[tag], d.w2_dhwio, d.w_final, d.bias_h)
                want = dt.decoder_tail_plain(hn[tag], d.w2_dhwio, d.w_final, d.bias_h)
                torch.cuda.synchronize()
                diff = (got - want).abs()
                errs[tag] = float(diff.max())
                check(errs[tag] <= (1e-4 if tag == "f32" else 1e-2),
                      f"decoder tail {tag}: max |diff| {errs[tag]}")
                log(f"decoder tail {tag} B={STREAM_BATCH} S={hn[tag].shape[1] - 2}: max |diff| "
                    f"{errs[tag]:.2e}, mean {float(diff.mean()):.2e}")
            d, h16 = cdec["bf16"], hn["bf16"]
            b_, s2 = h16.shape[0], 2 * (h16.shape[1] - 2)
            nf = cfg["nf"]
            # the library yardstick: cuDNN's conv3d of conv2 alone on the
            # unpacked (B, nf, 2S, 2S, 2S) tensor, as the plain decoder runs it
            h2x = depth_to_space_2x(h16[:, 1:-1, 1:-1, 1:-1], nf).permute(0, 4, 1, 2, 3) \
                .contiguous()
            dargs = (h16, d.w2_dhwio, d.w_final, d.bias_h)
            tail_bound = bound(h16.numel() * 2 + b_ * s2 ** 3 * 4,
                               b_ * s2 ** 3 * (27 * nf * nf * 2 + 2 * nf), BF16_FLOPS)
            kernels["decoder_tail"] = dict(
                name="decoder_tail", route="cuda",
                source="retrieval_fuse_tpu_torch/csrc/decoder_tail.cu",
                replaces="retrieval_fuse_tpu/ops/pallas_decoder.py:94", max_abs_err=errs["f32"],
                ms=cuda_ms(lambda: dt.decoder_tail(*dargs), 5),
                plain_ms=cuda_ms(lambda: dt.decoder_tail_plain(*dargs), 3),
                library_ms=cuda_ms(lambda: F.conv3d(h2x, d.w2, padding=1), 10),
                library_call="F.conv3d of conv2 alone on the unpacked tensor (cuDNN)",
                bound_ms=tail_bound[0], bound_by=tail_bound[1], bf16_max_abs_err=errs["bf16"],
                f32_ms=cuda_ms(lambda: dt.decoder_tail(
                    hn["f32"], cdec["f32"].w2_dhwio, cdec["f32"].w_final, cdec["f32"].bias_h), 3),
                shape=f"B={b_} S={s2 // 2} nf={nf} bf16")
            del hn, h2x
        for kr in kernels.values():
            lib_ms = "none" if kr["library_ms"] is None else f"{kr['library_ms']:.3f} ms"
            log(f"{kr['name']}: kernel {kr['ms']:.3f} ms, plain {kr['plain_ms']:.3f} ms, "
                f"library {lib_ms}, bound {kr['bound_ms']:.3f} ms ({kr['bound_by']}) "
                f"[{kr['shape']}; {card}]")

        # 5) serve through serve_directory: FAST_VARIANT bf16 at batch 64 and
        # 128, and the cdec variant at batch 128
        counters = {"topk": topk, "knn": streaming_knn_sims,
                    "attention": pa.gathered_patch_attention,
                    "attention_v1": pa.gathered_patch_attention_v1,
                    "patch_attention": pa.patch_attention, "decoder_tail": dt.decoder_tail}
        launches = {name: 0 for name in counters}

        def drive(label: str, needed, fn):
            """Run one path with every launch count at 0 just before it; check
            that it launched the kernels it needs; add its counts up."""
            torch.cuda.synchronize()
            for c in counters.values():
                c.launches = 0
            out = fn()
            torch.cuda.synchronize()
            counts = {name: c.launches for name, c in counters.items()}
            for name in needed:
                check(counts[name] > 0, f"{label}: kernel {name} was not launched")
            for name in counts:
                launches[name] += counts[name]
            return out, {name: c for name, c in counts.items() if c}

        serving = {}
        with tempfile.TemporaryDirectory() as tmp:
            indir = Path(tmp) / "in"
            indir.mkdir()
            for j, vol in enumerate(chunks):
                np.savez_compressed(indir / f"chunk{j:04d}.npz", arr=vol)
            for variant, batch, needed in (
                    (FAST_VARIANT, DENSE_BATCH, ("topk", "attention")),
                    (FAST_VARIANT, STREAM_BATCH, ("knn", "attention")),
                    (CDEC_VARIANT, STREAM_BATCH, VARIANT_PATHS[CDEC_VARIANT])):
                eng = engines[variant, "bf16"]
                eng(chunks[:batch, ..., None])  # warm-up: cuDNN plans, allocator
                outdir = Path(tmp) / f"out-{variant}-{batch}"
                t0 = time.perf_counter()
                done, counts = drive(f"serve {variant} batch {batch}", needed,
                                     lambda: serve_directory(eng, indir, outdir,
                                                             batch_size=batch))
                wall = time.perf_counter() - t0
                check(len(done) == len(chunks), f"batch {batch}: served {len(done)} chunks")
                preds = [np.load(outdir / f"{s}_pred.npz")["arr"] for s in done]
                for p_ in preds:
                    check(p_.shape == (64, 64, 64) and np.isfinite(p_).all()
                          and p_.min() >= -1e-3 and p_.max() <= fast.target_trunc + 1e-3,
                          f"batch {batch}: served TSDF out of shape or range")
                xb = chunks[:batch, ..., None]
                engine_ms = cuda_ms(lambda: eng(xb), 5)
                served = np.stack(preds[:batch]).astype(np.float32)
                # float16 files; cuDNN may pick another algorithm between calls
                served_err = float(np.abs(served - eng(xb)[..., 0].cpu().numpy()).mean())
                check(served_err <= 1e-4, f"batch {batch}: served files differ by {served_err}")
                rec = dict(served_chunks_per_s=len(done) / wall, engine_ms=engine_ms,
                           engine_chunks_per_s=batch / (engine_ms / 1e3), launches=counts)
                if variant == FAST_VARIANT:
                    rec.update(tsdf_check(variant, xb))
                serving[f"{variant}@{batch}"] = rec
                log(f"serve {variant} batch {batch}: {len(done)} chunks, "
                    f"{len(done) / wall:.1f} chunks/s through serve_directory (npz I/O "
                    f"included), engine {engine_ms:.2f} ms/batch = "
                    f"{batch / (engine_ms / 1e3):.1f} chunks/s; launches {counts} [{card}]")
        results["serving"] = serving

        # 6) the engine's other serving paths at batch 128, bf16 and float32
        xb = chunks[:STREAM_BATCH, ..., None]
        paths = {}
        for variant, needed in VARIANT_PATHS.items():
            _, counts = drive(variant, needed, lambda: [engines[variant, tag](xb)
                                                        for tag in ("bf16", "f32")])
            rec = tsdf_check(variant, xb)
            eng = engines[variant, "bf16"]
            rec.update(engine_ms=cuda_ms(lambda: eng(xb), 3), launches=counts)
            rec["engine_chunks_per_s"] = STREAM_BATCH / (rec["engine_ms"] / 1e3)
            paths[variant] = rec
            log(f"path {variant} batch {STREAM_BATCH}: engine {rec['engine_ms']:.2f} ms/batch "
                f"bf16 = {rec['engine_chunks_per_s']:.1f} chunks/s; launches {counts} [{card}]")
        results["paths"] = paths
        for key in kernels:
            kernels[key]["launches"] = launches[key]
        results["kernels"] = kernels
    except Failed as e:
        print(f"chip_smoke: FAILED: {e}", file=sys.stderr)
        return 1

    keys = ("name", "route", "source", "replaces", "launches", "max_abs_err", "ms",
            "plain_ms", "bound_ms", "bound_by", "library_ms")
    out = Path(args.out)
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_text(json.dumps(results, indent=1, default=str))
    log(json.dumps({"kernels": [{k_: kr[k_] for k_ in keys} for kr in kernels.values()]}))
    log(card)
    log(json.dumps({"ok": True, "device": {"platform": "gpu",
                                           "kind": torch.cuda.get_device_name(0),
                                           "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
