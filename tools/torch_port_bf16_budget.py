#!/usr/bin/env python3
"""bf16-vs-float32 TSDF error of the serving engine at the flagship widths,
in the JAX engine and in the PyTorch port, with the same weights and inputs.

    JAX_PLATFORMS=cpu python tools/torch_port_bf16_budget.py [--seed 0] [--batch 2]

Weights are chip_smoke.py's seeded flagship weights (PyTorch's default
law), converted to flax trees; the database is random
unit rows and the bank and inputs are synthetic distance fields
(chip_smoke.synthetic_df). Both engines run the plain `base` path on the
CPU, each in float32 and in bf16, and the script prints
  - max |JAX f32 - port f32| (the port's float32 agreement), and
  - the bf16-vs-f32 TSDF MAE of each engine (df units),
showing whether an error above the 1e-3 budget comes from the port or from
bf16 itself on these weights. Runs a few minutes on a CPU.
"""

from __future__ import annotations

import argparse
import os
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
os.environ.setdefault("JAX_PLATFORMS", "cpu")


def to_flax(state_dict: dict) -> dict:
    """The port's state_dict -> a flax param tree (inverse of the bridge)."""
    import jax.numpy as jnp
    import numpy as np
    out: dict = {}
    for key, value in state_dict.items():
        parts = key.split(".")
        leaf, a = parts[-1], value.numpy()
        if leaf == "weight":
            if parts[-2] == "groupnorm":
                leaf = "scale"
            elif a.ndim == 5:
                a, leaf = a.transpose(2, 3, 4, 1, 0), "kernel"
            elif a.ndim == 2:
                a, leaf = a.T, "kernel"
        node = out
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[leaf] = jnp.asarray(np.ascontiguousarray(a))
    return out


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--batch", type=int, default=2)
    ap.add_argument("--bank-rows", type=int, default=3008)
    args = ap.parse_args(argv)

    import jax
    jax.config.update("jax_platforms", "cpu")
    import jax.numpy as jnp
    import numpy as np
    import torch

    from chip_smoke import flagship_config, flagship_data, flagship_params, synthetic_df
    from retrieval_fuse_tpu.inference import RetrieveRefineEngine as JaxEngine
    from retrieval_fuse_tpu_torch.inference import RetrieveRefineEngine

    cfg = flagship_config()
    dtr = cfg["dataset_train"]
    rng = np.random.default_rng(args.seed)
    params = flagship_params(cfg, args.seed)
    n = args.bank_rows
    db, bank = flagship_data(cfg, rng, n, "cpu")
    x = synthetic_df(rng, args.batch, 8, dtr["voxel_size_input"], "cpu")[..., None]

    port = {tag: RetrieveRefineEngine(cfg, params, db, bank, compute_dtype=dt, device="cpu")
            for tag, dt in (("f32", torch.float32), ("bf16", torch.bfloat16))}
    p_out = {tag: eng(x).numpy() for tag, eng in port.items()}
    fparams = {name: to_flax(sd) for name, sd in params.items()}
    j_out = {}
    for tag, dt in (("f32", jnp.float32), ("bf16", jnp.bfloat16)):
        fb = jnp.asarray(port[tag].feature_bank.float().numpy(), dt)  # same bank tiles
        eng = JaxEngine(cfg, fparams, db, None, compute_dtype=dt, feature_bank=fb)
        j_out[tag] = np.asarray(eng(x.numpy()))
    print(f"seed {args.seed}, batch {args.batch}, {n} bank rows, flagship widths (CPU)")
    print(f"max |JAX f32 - port f32| = {np.abs(j_out['f32'] - p_out['f32']).max():.3e}")
    for name, o in (("JAX", j_out), ("port", p_out)):
        print(f"{name} bf16-vs-f32 TSDF MAE = {np.abs(o['bf16'] - o['f32']).mean():.4e}")


if __name__ == "__main__":
    main()
