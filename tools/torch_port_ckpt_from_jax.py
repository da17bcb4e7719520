#!/usr/bin/env python3
"""Convert a checkpoint of the JAX package (orbax) into the PyTorch port's
checkpoint layout (retrieval_fuse_tpu_torch/train/checkpoint.py).

    python tools/torch_port_ckpt_from_jax.py runs/<exp>/ckpt_epoch=<E> <out_runs>/<exp>

reads the checkpoint through retrieval_fuse_tpu/train/checkpoint.py, turns
each sub-network's flax params into a state_dict with the port's weight
bridge (retrieval_fuse_tpu_torch/utils/flax_import.py) and writes
<out_runs>/<exp>/ckpt_epoch=<E>/params.pt and meta.json. A refinement
checkpoint's optax Adam state (mu, nu, count of the trainable
sub-networks) becomes the port's optimizer state (optim.pt: exp_avg,
exp_avg_sq, step), which RefinementTrainer.load(params_only=False) resumes
from. Keep the
experiment directory's name: the retrieval artifacts of a checkpoint are
addressed by it and by the epoch (utils/misc.get_retrievals_dir).

Needs both packages (JAX and PyTorch), so it lives outside the port.
"""

from __future__ import annotations

import argparse
import os
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
os.environ.setdefault("JAX_PLATFORMS", "cpu")

from retrieval_fuse_tpu.train.checkpoint import load_checkpoint  # noqa: E402
from retrieval_fuse_tpu_torch.train.checkpoint import save_checkpoint  # noqa: E402
from retrieval_fuse_tpu_torch.utils.flax_import import (  # noqa: E402
    flax_adam_state, flax_engine_params)


def convert(jax_ckpt, out_run_dir) -> Path:
    """Write the port's checkpoint of the JAX checkpoint directory
    `jax_ckpt` (runs/<exp>/ckpt_epoch=<E>) under `out_run_dir`, with the
    same epoch and meta. Returns the written directory."""
    jax_ckpt = Path(jax_ckpt)
    restored = load_checkpoint(jax_ckpt)
    meta = dict(restored.get("meta", {}))
    epoch = int(meta.pop("epoch", jax_ckpt.name.split("=")[1]))
    meta["converted_from"] = str(jax_ckpt.resolve())
    opt_state = None
    if restored.get("opt_state") and "phase" in meta:
        opt_state = flax_adam_state(restored["opt_state"], meta["phase"])
    return save_checkpoint(out_run_dir, epoch, flax_engine_params(restored["params"]), meta,
                           opt_state=opt_state)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("jax_ckpt", help="runs/<exp>/ckpt_epoch=<E> written by the JAX package")
    ap.add_argument("out_run_dir", help="run directory of the port's checkpoint (<out>/<exp>)")
    args = ap.parse_args(argv)
    print(convert(args.jax_ckpt, args.out_run_dir))


if __name__ == "__main__":
    main()
