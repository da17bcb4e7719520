#!/usr/bin/env python3
"""How far the retrieval trainer's step-1 gradients on the card lie from
float64 gradients, beside the CPU's float32 ones.

    python tools/torch_port_train_precision.py [--out chiprun_out/train_precision.json]
    python tools/torch_port_train_precision.py --refine
    python tools/torch_port_train_precision.py --refine --seed 0 1 2 3 4 5 6 7
    python tools/torch_port_train_precision.py --task surface superres16
    python tools/torch_port_train_precision.py --refine --task surface superres16 [--localize]

With --refine: the refinement trainer's step of each phase at batch 1 and
chip_smoke.py's config (ShapeNetV2's refinement width, nf 16, K 4) on a
small synthetic dataset with composed retrievals (other scenes' targets),
from the same seeded weights (the decoder's output bias as
chip_smoke.open_occupancy_gate sets it) and Gumbel draw: the gradients of
the phase's trainable sub-networks (chip_smoke.step_gradients: the train
step without its Adam update), float32 on the card as the port runs it,
with TF32 on (cuDNN and matmuls), with cuDNN off, and on the CPU, against
float64 on the CPU, as chip_smoke.grad_share reads them (the largest difference over
a tensor as a share of its sub-network's largest float64 gradient), and the
loss; on the first train item perturbed as chip_smoke.perturb_batch does
(what chip_smoke.hold_refine_steps holds) and unperturbed (constant 16³
patches).

With --refine --seed S...: chip_smoke.hold_refine_steps's phase-3 hold once
for each seed S, on data that S moves: the synthetic dataset
(generate_synthetic_dataset(seed=S)), its composed retrievals, the held
item's REFINE_HOLD_DRAWS perturbations and the Gumbel draw, drawn in the
hold's order. For each seed and draw: how far the card's float32 gradients
lie from the float64 ones of the draw (grad_share; float64 on the card, as
the hold runs it), beside the CPU's float32, the card with cuDNN's
deterministic algorithms, with cuDNN off and with TF32 on; the bound
REFINE_F64_FACTOR x the CPU's largest over the draws + REFINE_F64_FLOOR and
whether the card lies inside it and TF32 outside it on every draw; on draw
0, the card's float64 gradients against the CPU's float64 ones and the five
worst tensors of the card's float32. A line a seed, and
chiprun_out/train_precision_seeds.json.

With --task T...: the retrieval step that chip_smoke.py's phase 12 holds
(12a), on each of REFINE_HOLD_DRAWS batches of TASK_HOLD_BATCH of its task's
config (task_retrieval_config) and data (write_task_dataset, a few chunks),
read as below with TF32 on for convolutions and matmuls (chip_smoke.tf32)
beside the cuDNN settings.

With --refine --task T...: chip_smoke.hold_refine_steps on each task's
refinement config (task_refinement_config, batch 1) on a small dataset of
the task, as the port runs it and with cuDNN off: every reading of every
phase and draw, and the checks it fails. With --localize instead, where the
card's float32 loses precision in the frozen features of phase 2, on the
hold's trainers and draws (chip_smoke.refine_hold_items): each frozen
feature's (x_back, x_target) largest error as a share of its largest, on
the card, the card with cuDNN off and the CPU, and phase 2's float64
gradients (the cached step on float64's gate) with that one feature in
float32; and every leaf module (convolution, GroupNorm, BatchNorm, linear)
of the frozen networks (the U-Net backbone on the input, the decoder on its
features, the retrieval backbone on the target's 16³ patches): its own
float32 error, max |m(x) - m64(x64)| / max |m64(x64)|, on the input that the
float64 forward gives it, on the card, with cuDNN off and on the CPU.

Otherwise one batch of the trainer's epoch-0 order, from the same seeded
weights, in these cases: the CPU tests' geometry (nf 4 / 4, latent 16, batch 16, the
synthetic config's normalisation) and chip_smoke.py's (ShapeNetV2's
retrieval width, batch 128), each with the plain target encoder (16+8) and
the BatchNorm one (16+8N), on a small synthetic dataset (data/synthetic.py,
12 train chunks: the card tests' data); and chip_smoke.py's geometry with
both encoders on data made as chip_smoke.py's phase 7 makes it
(write_retrieval_dataset, 576 train chunks). For each, the loss gradient of
every encoder tensor: float32 on the card as the port runs it
(device.resolve_device's flags), and with one cuDNN setting changed
(deterministic algorithms; TF32 allowed; the fp32_precision "ieee" of
torch.backends.cudnn.conv; cuDNN off, so that PyTorch's own convolution
kernels run), float32 on the CPU, and float64 on the CPU, the reference.
Prints the flags, max |g - g64| / max |g64| per tensor and the worst of
each, the card's float32 against the CPU's (what chip_smoke.hold_train_steps
holds), and the card's name and power limit. The conv biases that a
BatchNorm follows have no gradient in exact arithmetic: they are left out
of the worst and printed as their largest magnitude over the encoder's
largest float64 gradient. Needs a CUDA card and PyYAML.
"""

from __future__ import annotations

import argparse
import contextlib
import copy
import json
import os
import subprocess
import sys
import tempfile
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import numpy as np  # noqa: E402
import torch  # noqa: E402

import chip_smoke  # noqa: E402
from retrieval_fuse_tpu_torch.data.synthetic import (  # noqa: E402
    generate_synthetic_dataset, make_synthetic_config)
from retrieval_fuse_tpu_torch.train.retrieval_trainer import RetrievalTrainer  # noqa: E402


def step1_grads(trainer, batch, dtype) -> dict:
    """{name.key: gradient (float64, on the CPU)} of the train-mode loss on
    `batch`, with the trainer's encoders in `dtype` (copies)."""
    nets = {name: copy.deepcopy(net).to(dtype).train()
            for name, net in trainer.encoders.items()}
    saved = trainer.fenc_input, trainer.fenc_target
    trainer.fenc_input, trainer.fenc_target = nets["fenc_input"], nets["fenc_target"]
    try:
        total, _ = trainer._loss_fn({k: v.to(dtype) for k, v in batch.items()}, train=True)
        total.backward()
    finally:
        trainer.fenc_input, trainer.fenc_target = saved
    return {f"{name}.{key}": p.grad.detach().double().cpu()
            for name, net in nets.items() for key, p in net.named_parameters()}


@contextlib.contextmanager
def cudnn_setting(name: str):
    """Change one cuDNN setting for the block ("" changes none)."""
    import torch.backends.cudnn as cudnn
    saved = (cudnn.deterministic, cudnn.allow_tf32, cudnn.enabled, cudnn.conv.fp32_precision)
    try:
        if name == "deterministic":
            cudnn.deterministic = True
        elif name == "allow_tf32":
            cudnn.allow_tf32 = True
        elif name == "conv fp32_precision ieee":
            cudnn.conv.fp32_precision = "ieee"
        elif name == "cuDNN off":
            cudnn.enabled = False
        yield
    finally:
        (cudnn.deterministic, cudnn.allow_tf32, cudnn.enabled,
         cudnn.conv.fp32_precision) = saved


SETTINGS = ("", "deterministic", "allow_tf32", "conv fp32_precision ieee", "cuDNN off")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default="chiprun_out/train_precision.json")
    ap.add_argument("--refine", action="store_true",
                    help="the refinement trainer's phases instead of the retrieval trainer")
    ap.add_argument("--seed", type=int, nargs="+", default=None,
                    help="with --refine: the phase-3 hold on the data of each seed")
    ap.add_argument("--task", nargs="+", default=None, choices=chip_smoke.TASKS12,
                    help="the retrieval step of chip_smoke.py's phase-12 hold instead (with "
                         "--refine: its refinement hold)")
    ap.add_argument("--localize", action="store_true",
                    help="with --refine --task: phase 2's frozen features by feature and by "
                         "layer instead of the hold")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("torch_port_train_precision: no CUDA device", file=sys.stderr)
        return 1
    if args.refine and args.task:
        return task_refine_holds(args.task, args.out.replace(".json", "_task_refine.json"),
                                 args.localize)
    if args.refine and args.seed is not None:
        return phase3_seeds(args.seed, args.out.replace(".json", "_seeds.json"))
    if args.refine:
        return refine_precision(args.out.replace(".json", "_refine.json"))
    try:
        card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                               "--format=csv,noheader"], capture_output=True, text=True,
                              timeout=60).stdout.strip()
    except (OSError, subprocess.TimeoutExpired):
        card = ""
    card = card or "nvidia-smi gave no card name and power limit"
    print(card)
    results = {"card": card}
    cwd = os.getcwd()
    with tempfile.TemporaryDirectory() as tmp:
        root = Path(tmp)
        configs, n_batches = {}, 1
        if args.task:  # phase 12's held step: its configs, batch and data
            n_batches = chip_smoke.REFINE_HOLD_DRAWS
            for task in args.task:
                chip_smoke.write_task_dataset(
                    task, root / task, np.random.default_rng(0),
                    2 * n_batches * chip_smoke.TASK_HOLD_BATCH, 1, "cuda", per_draw=8)
                cfg = chip_smoke.task_retrieval_config(task, root / task, "")
                cfg["retrieval_training"]["batch_size"] = chip_smoke.TASK_HOLD_BATCH
                configs[f"phase 12 {task} (batch {chip_smoke.TASK_HOLD_BATCH})"] = cfg
        else:
            generate_synthetic_dataset(root / "data", n_train=12, n_val=2, seed=3)
            chip_smoke.write_retrieval_dataset(
                root / "phase7", np.random.default_rng(0), chip_smoke.RETRIEVAL_MIN_ROWS,
                chip_smoke.RETRIEVAL_VAL_CHUNKS, "cuda")
            tests_cfg = make_synthetic_config(root / "data")
            tests_cfg["retrieval_model"].update(nf_input=4, nf_target=4, latent_dim=16)
            tests_cfg["retrieval_training"]["batch_size"] = 16
            for code in ("16+8", "16+8N"):
                for label, cfg in (
                        ("tests (nf 4/4, latent 16, batch 16)", tests_cfg),
                        ("chip_smoke (nf 32/8, latent 64, batch 128)",
                         chip_smoke.retrieval_config(root / "data", "")),
                        ("chip_smoke on phase 7's data",
                         chip_smoke.retrieval_config(root / "phase7", ""))):
                    cfg = copy.deepcopy(cfg)
                    cfg["retrieval_model"]["network_target"] = code
                    configs[f"{label}, target {code}"] = cfg
        os.chdir(root)
        try:
            for config_label, cfg in configs.items():
                cfg = dict(cfg, seed=5, experiment="precision")
                cpu = RetrievalTrainer(cfg, device="cpu")
                gpu = RetrievalTrainer(cfg, device="cuda")
                for b, batch in enumerate(chip_smoke.first_batches(cpu.train_dataset,
                                                                   cpu.batch_size, n_batches)):
                    label = config_label + (f", batch {b}" if n_batches > 1 else "")
                    host = {k: torch.from_numpy(batch[k]) for k in ("input", "target")}
                    dev = {k: v.cuda() for k, v in host.items()}
                    cudnn = torch.backends.cudnn
                    print(f"flags: cudnn.allow_tf32 {cudnn.allow_tf32}, cudnn.conv.fp32_precision "
                          f"{cudnn.conv.fp32_precision!r}, cudnn.fp32_precision "
                          f"{cudnn.fp32_precision!r}, float32 matmul precision "
                          f"{torch.get_float32_matmul_precision()!r}, torch {torch.__version__}")
                    ref = step1_grads(cpu, host, torch.float64)
                    grads = {}
                    for name in SETTINGS:
                        with cudnn_setting(name):
                            grads[f"card float32{', ' + name if name else ''}"] = step1_grads(
                                gpu, dev, torch.float32)
                    with chip_smoke.tf32():
                        grads["card float32, TF32"] = step1_grads(gpu, dev, torch.float32)
                    grads["CPU float32"] = step1_grads(cpu, host, torch.float32)
                    noise = {f"{name}.{key}" for name, net in cpu.encoders.items()
                             for key in chip_smoke.batchnorm_fed_biases(net)}
                    largest = {name: max(float(r.abs().max()) for k, r in ref.items()
                                         if k.startswith(name + "."))
                               for name in cpu.encoders}
                    rec = {}
                    for way, g in grads.items():
                        rec[way] = {k: float((g[k] - r).abs().max() / r.abs().max())
                                    for k, r in ref.items() if k not in noise}
                        worst = max(rec[way], key=rec[way].get)
                        print(f"{label}, {way}: worst {rec[way][worst]:.2e} ({worst}) of the "
                              f"float64 gradient's largest magnitude [{card}]")
                        if noise:
                            rec[way]["batchnorm-fed biases"] = max(
                                float(g[k].abs().max()) / largest[k.split(".")[0]] for k in noise)
                            print(f"{label}, {way}: batchnorm-fed conv biases at most "
                                  f"{rec[way]['batchnorm-fed biases']:.2e} of their encoder's "
                                  f"largest float64 gradient")
                    held = grads["card float32"]
                    cpu32 = grads["CPU float32"]
                    rec["card float32 vs CPU float32"] = {
                        k: float((held[k] - cpu32[k]).abs().max() / cpu32[k].abs().max())
                        for k in ref if k not in noise}
                    worst = max(rec["card float32 vs CPU float32"],
                                key=rec["card float32 vs CPU float32"].get)
                    print(f"{label}, card float32 vs CPU float32 (the hold): worst "
                          f"{rec['card float32 vs CPU float32'][worst]:.2e} ({worst}) [{card}]")
                    scale = {k: float(r.abs().max()) for k, r in ref.items()}
                    print(f"{label}, per tensor, float64 largest magnitude | "
                          f"{' / '.join(rec)}: " + ", ".join(
                              f"{k} {scale[k]:.1e} | " + " / ".join(
                                  f"{r[k]:.1e}" for r in rec.values() if k in r)
                              for k in ref if k not in noise))
                    results[label] = dict(rec, largest_float64=scale)
        finally:
            os.chdir(cwd)
    out = Path(args.out)
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_text(json.dumps(results, indent=1))
    return 0


def card_name() -> str:
    try:
        return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                               "--format=csv,noheader"], capture_output=True, text=True,
                              timeout=60).stdout.strip() or "nvidia-smi gave nothing"
    except (OSError, subprocess.TimeoutExpired):
        return "nvidia-smi gave nothing"


#: the card's runs of a refinement step: as the port runs it, and with one
#: setting changed
CARD_WAYS = {"card float32": contextlib.nullcontext,
             "card float32, TF32": chip_smoke.tf32,
             "card float32, cuDNN off": lambda: cudnn_setting("cuDNN off")}


def refine_precision(out_path: str) -> int:
    """The --refine readings (see the module docstring)."""
    from retrieval_fuse_tpu_torch.device import resolve_device
    from retrieval_fuse_tpu_torch.train.refinement_trainer import RefinementTrainer
    card = card_name()
    print(card)
    dev = resolve_device("cuda")
    results = {"card": card}
    cwd = os.getcwd()
    with tempfile.TemporaryDirectory() as tmp:
        root = Path(tmp)
        generate_synthetic_dataset(root / "data", n_train=12, n_val=2, seed=3)
        cfg = dict(chip_smoke.refinement_config(root / "data", "runs/tools/ckpt_epoch=0"),
                   seed=5, experiment="precision", batch_size=1)
        chip_smoke.write_composed_retrievals(cfg, np.random.default_rng(1))
        os.chdir(root)
        try:
            gpu = RefinementTrainer(dict(cfg), device=dev)
            cpu = RefinementTrainer(dict(cfg), device="cpu")
            for tr in (gpu, cpu):
                chip_smoke.open_occupancy_gate(tr)
            rng = np.random.default_rng(6)
            raw = chip_smoke.first_batches(cpu.train_dataset, 1, 1)[0]
            batches = {"perturbed": chip_smoke.perturb_batch(raw, rng,
                                                             chip_smoke.REFINE_HOLD_NOISE),
                       "unperturbed": raw}
            rows = cpu.patched_attention_block.num_patch_x ** 3
            u = torch.from_numpy(rng.uniform(1e-20, 1.0, (rows, cpu.K)).astype(np.float32))
            for label, batch in batches.items():
                for phase in (0, 1, 2, 3):
                    got = {}
                    for way, setting in CARD_WAYS.items():
                        with setting():
                            got[way] = chip_smoke.step_gradients(
                                gpu, phase, gpu._device_batch(batch), u.to(dev))
                    got["CPU float32"] = chip_smoke.step_gradients(
                        cpu, phase, cpu._device_batch(batch), u)
                    ref = chip_smoke.step_gradients(cpu, phase, cpu._device_batch(batch), u,
                                                    float64=True)
                    rec = {"loss float64": float(ref[0])}
                    for way, g in got.items():
                        share, where = chip_smoke.grad_share(g[2], ref[2])
                        rec[way] = dict(grad_share=share, worst=where,
                                        loss_rel=abs(float(g[0]) - float(ref[0]))
                                        / max(abs(float(ref[0])), 1e-30))
                    share, where = chip_smoke.grad_share(got["card float32"][2],
                                                         got["CPU float32"][2])
                    rec["card vs CPU"] = dict(grad_share=share, worst=where)
                    results[f"{label} phase {phase}"] = rec
                    print(f"refine {label} item, phase {phase}: " + "; ".join(
                        f"{way}: gradients {r['grad_share']:.2e} ({r['worst']})"
                        + (f", loss {r['loss_rel']:.1e} relative" if "loss_rel" in r else "")
                        for way, r in rec.items() if isinstance(r, dict))
                        + f" [{card}]", flush=True)
        finally:
            os.chdir(cwd)
    out = Path(out_path)
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_text(json.dumps(results, indent=1))
    return 0


#: the card's phase-3 steps beside the port's own: one setting changed each
SEED_WAYS = {"card float32": contextlib.nullcontext,
             "card float32, deterministic": lambda: cudnn_setting("deterministic"),
             "card float32, cuDNN off": lambda: cudnn_setting("cuDNN off"),
             "card float32, TF32": chip_smoke.tf32}


def task_refine_holds(tasks: list, out_path: str, localize: bool = False) -> int:
    """The --refine --task readings: chip_smoke.hold_refine_steps on each
    phase-12 task's refinement config (task_refinement_config, batch 1) on a
    small dataset of the task (write_task_dataset) with composed retrievals
    of other scenes' targets, as the port runs it and with cuDNN off; every
    reading of every phase and draw, and the checks it fails. With
    `localize`, localize_phase2 on the hold's items instead."""
    from retrieval_fuse_tpu_torch.device import resolve_device
    card = card_name()
    print(card)
    dev = resolve_device("cuda")
    results = {"card": card}
    cwd = os.getcwd()
    failures: list = []
    check = chip_smoke.check
    chip_smoke.check = lambda cond, what: None if cond else failures.append(what)
    try:
        for task in tasks:
            with tempfile.TemporaryDirectory() as tmp:
                root = Path(tmp)
                rng = np.random.default_rng(12)
                chip_smoke.write_task_dataset(task, root / "data", rng, 64, 1, dev, per_draw=8)
                cfg = dict(chip_smoke.task_refinement_config(task, root / "data",
                                                             "runs/tools/ckpt_epoch=0"),
                           seed=5, experiment="precision")
                chip_smoke.write_composed_retrievals(cfg, rng)
                os.chdir(root)
                try:
                    if localize:
                        card_tr, cpu_tr, _, _, held, _ = chip_smoke.refine_hold_items(
                            cfg, dev, 24, chip_smoke.REFINE_HOLD_DRAWS)
                        results[task] = localize_phase2(card_tr, cpu_tr, held, dev,
                                                        f"{task} [{card}]")
                        del card_tr, cpu_tr, held
                        torch.cuda.empty_cache()
                        continue
                    for setting in ("", "cuDNN off"):
                        failures.clear()
                        with cudnn_setting(setting):
                            hold = chip_smoke.hold_refine_steps(cfg, dev, 24)
                        hold.pop("init")
                        label = f"{task}{', ' + setting if setting else ''}"
                        results[label] = dict(hold, failures=list(failures))
                        for phase, rec in sorted(hold["phases"].items()):
                            print(f"{label} phase {phase}: bound {rec['bound']:.2e}; by draw: "
                                  + "; ".join(f"{k} " + "/".join(
                                      f"{d[k]:.2e}" for d in rec["draws"])
                                      for k in ("card_f64", "cpu_f64", "tf32_f64"))
                                  + f"; worst {rec['worst']} [{card}]", flush=True)
                        print(f"{label}: {len(failures)} failed checks: {failures}", flush=True)
                finally:
                    os.chdir(cwd)
    finally:
        chip_smoke.check = check
    out = Path(out_path)
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_text(json.dumps(results, indent=1, default=str))
    return 0


#: the leaf modules that --localize prints a network
TOP_LEAVES = 8


def leaf_errors(net, x, label: str) -> list:
    """[(name, type, card, card with cuDNN off, CPU)] of every leaf module
    of `net` (float32, on the card): the module's own float32 error on the
    input that the float64 forward of `net` on `x` gives it, as a share of
    the float64 output's largest. Prints the TOP_LEAVES whose card error
    exceeds the CPU's most."""
    from retrieval_fuse_tpu_torch.models.encoders import BatchNorm3d
    leaves = (torch.nn.Conv3d, torch.nn.ConvTranspose3d, torch.nn.GroupNorm, torch.nn.Linear,
              BatchNorm3d)
    net64, net_cpu = copy.deepcopy(net).double(), copy.deepcopy(net).cpu()
    seen, hooks = {}, []

    def keep(name):
        def hook(module, inputs, output):  # returns None: the output stands
            seen.setdefault(name, (inputs[0].detach(), output.detach()))
        return hook

    for name, m in net64.named_modules():
        if isinstance(m, leaves):
            hooks.append(m.register_forward_hook(keep(name)))
    with torch.no_grad():
        net64(x.double())
    for h in hooks:
        h.remove()
    mods, mods_cpu = dict(net.named_modules()), dict(net_cpu.named_modules())
    rows = []
    for name, (x64, y64) in seen.items():
        scale = float(y64.abs().max()) or 1.0

        def err(m, dev, setting):
            with cudnn_setting(setting), torch.no_grad():
                y = m(x64.float().to(dev))
            return float((y.double().to(y64.device) - y64).abs().max()) / scale

        rows.append((name, type(mods[name]).__name__, err(mods[name], x64.device, ""),
                     err(mods[name], x64.device, "cuDNN off"), err(mods_cpu[name], "cpu", "")))
    seen.clear()
    worst = sorted(rows, key=lambda r: r[2] / max(r[4], 1e-30), reverse=True)[:TOP_LEAVES]
    print(f"  {label}: {len(rows)} leaf modules; the largest card / CPU (card, cuDNN off, "
          f"CPU): " + "; ".join(f"{n} ({t}) {c:.2e}, {o:.2e}, {p:.2e}" for n, t, c, o, p in worst),
          flush=True)
    return rows


def localize_phase2(card, cpu, held: list, dev, label: str) -> list:
    """The --localize readings of each held draw (see the module
    docstring), printed a line each and returned by draw."""
    from retrieval_fuse_tpu_torch.ops.fold3d import unfold3d
    out = []
    for r, batch in enumerate(held):
        on_card, on_cpu = card._device_batch(batch), cpu._device_batch(batch)
        f64, _ = chip_smoke.frozen_phase2(card, on_card, float64=True)
        feats = {"card": chip_smoke.frozen_phase2(card, on_card)[0],
                 "cpu": chip_smoke.frozen_phase2(cpu, on_cpu)[0]}
        with cudnn_setting("cuDNN off"):
            feats["cuDNN off"] = chip_smoke.frozen_phase2(card, on_card)[0]
        ref = chip_smoke.step_gradients(card, 2, f64, cached=True, float64=True)[2]
        rec = {"features": {}, "leaves": {}}
        for key, fz in feats.items():
            for feat in ("x_back", "x_target"):
                share = float((fz[feat].double().to(dev) - f64[feat]).abs().max()
                              / f64[feat].abs().max())
                one = dict(f64, **{feat: fz[feat].to(dev)})
                grad = chip_smoke.grad_share(
                    chip_smoke.step_gradients(card, 2, one, cached=True, float64=True)[2], ref)
                rec["features"][f"{key} {feat}"] = dict(share=share, gradients=grad[0],
                                                        worst=grad[1])
        print(f"{label} phase 2 draw {r}: float32 feature error as a share of its largest, "
              f"and phase 2's float64 gradients with that feature alone in float32 (from "
              f"float64): " + "; ".join(f"{k} {v['share']:.2e} -> gradients {v['gradients']:.2e}"
                                        for k, v in rec["features"].items()), flush=True)
        if r == 0:
            rec["leaves"]["unet_backbone"] = leaf_errors(card.unet_backbone, on_card["input"],
                                                         "unet_backbone on the input")
            rec["leaves"]["decoder"] = leaf_errors(card.decoder, f64["x_back"].float(),
                                                   "decoder on x_back")
        rec["leaves"]["retrieval_backbone"] = leaf_errors(
            card.retrieval_backbone, unfold3d(on_card["target"], 16),
            f"draw {r} retrieval_backbone on the target's 16³ patches")
        out.append(rec)
        del f64, feats
        torch.cuda.empty_cache()
    return out


def worst_tensors(got: dict, want: dict, n: int = 5) -> list:
    """The n largest max |got - want| over a tensor, as grad_share reads them."""
    rows = []
    for name, sd in want.items():
        scale = max(float(g.abs().max()) for g in sd.values()) or float("inf")
        for key, w in sd.items():
            rows.append((float((got[name][key].cpu().double() - w.cpu().double()).abs().max())
                         / scale,
                         f"{name}.{key}"))
    return sorted(rows, reverse=True)[:n]


def phase3_seeds(seeds: list, out_path: str) -> int:
    """The --refine --seed readings (see the module docstring)."""
    from retrieval_fuse_tpu_torch.device import resolve_device
    from retrieval_fuse_tpu_torch.train.refinement_trainer import RefinementTrainer
    card = card_name()
    print(card)
    dev = resolve_device("cuda")
    draws = chip_smoke.REFINE_HOLD_DRAWS
    results = {"card": card, "factor": chip_smoke.REFINE_F64_FACTOR,
               "floor": chip_smoke.REFINE_F64_FLOOR, "draws": draws, "seeds": {}}
    cwd = os.getcwd()
    failed = 0
    for seed in seeds:
        with tempfile.TemporaryDirectory() as tmp:
            root = Path(tmp)
            generate_synthetic_dataset(root / "data", n_train=4, n_val=1, seed=seed)
            cfg = dict(chip_smoke.refinement_config(root / "data", "runs/tools/ckpt_epoch=0"),
                       seed=5, experiment="precision", batch_size=1)
            rng = np.random.default_rng(seed)
            chip_smoke.write_composed_retrievals(cfg, rng)
            os.chdir(root)
            try:
                gpu = RefinementTrainer(dict(cfg), device=dev)
                cpu = RefinementTrainer(dict(cfg), device="cpu")
                for tr in (gpu, cpu):
                    chip_smoke.open_occupancy_gate(tr)
                # the draws of chip_smoke.hold_refine_steps: draw 0, the
                # Gumbel draw, then the others
                raw = chip_smoke.first_batches(cpu.train_dataset, 1, 1)[0]
                held = [chip_smoke.perturb_batch(raw, rng, chip_smoke.REFINE_HOLD_NOISE)]
                rows = cpu.patched_attention_block.num_patch_x ** 3
                u = torch.from_numpy(rng.uniform(1e-20, 1.0, (rows, cpu.K)).astype(np.float32))
                held += [chip_smoke.perturb_batch(raw, rng, chip_smoke.REFINE_HOLD_NOISE)
                         for _ in range(draws - 1)]
                per_draw = []
                for r, batch in enumerate(held):
                    on_card = gpu._device_batch(batch)
                    ref = chip_smoke.step_gradients(gpu, 3, on_card, u.to(dev), float64=True)[2]
                    got = {"CPU float32": chip_smoke.step_gradients(
                        cpu, 3, cpu._device_batch(batch), u)[2]}
                    for way, setting in SEED_WAYS.items():
                        with setting():
                            got[way] = chip_smoke.step_gradients(gpu, 3, on_card, u.to(dev))[2]
                    rec = {way: dict(zip(("grad_share", "worst"), chip_smoke.grad_share(g, ref)))
                           for way, g in got.items()}
                    if r == 0:  # the card's float64 reference against the CPU's
                        ref_cpu = chip_smoke.step_gradients(cpu, 3, cpu._device_batch(batch), u,
                                                            float64=True)[2]
                        rec["card float64 vs CPU float64"] = chip_smoke.grad_share(ref, ref_cpu)[0]
                        rec["card worst tensors"] = worst_tensors(got["card float32"], ref)
                    per_draw.append(rec)
            finally:
                os.chdir(cwd)
        bound = (chip_smoke.REFINE_F64_FACTOR
                 * max(d["CPU float32"]["grad_share"] for d in per_draw)
                 + chip_smoke.REFINE_F64_FLOOR)
        passes = {way: [d[way]["grad_share"] <= bound for d in per_draw]
                  for way in ("CPU float32", *SEED_WAYS)}
        ok = all(passes["card float32"]) and not any(passes["card float32, TF32"])
        failed += not ok
        results["seeds"][seed] = {"bound": bound, "draws": per_draw, "passes": passes,
                                  "card inside and TF32 outside on every draw": ok}
        print(f"seed {seed}: bound {bound:.2e}; by draw: " + "; ".join(
            f"{way} " + "/".join(f"{d[way]['grad_share']:.2e}" for d in per_draw)
            for way in ("CPU float32", *SEED_WAYS))
            + f"; card float64 vs CPU float64 {per_draw[0]['card float64 vs CPU float64']:.1e};"
            f" card worst {per_draw[0]['card worst tensors'][:2]}; "
            f"{'PASS' if ok else 'FAIL'} [{card}]", flush=True)
    results["failed_seeds"] = failed
    print(f"{len(seeds) - failed} of {len(seeds)} seeds: the card inside the bound and TF32 "
          f"outside it on every draw [{card}]")
    out = Path(out_path)
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_text(json.dumps(results, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
