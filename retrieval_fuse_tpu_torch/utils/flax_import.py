"""Weight bridge: flax-layout param trees -> the port's state_dicts.

The inverse of the JAX package's utils/torch_import.py layout maps. The
port's modules carry the flax module names, so the nested-dict path of each
leaf is its state_dict key; only the leaf names and layouts change:

  Conv   kernel (kD, kH, kW, I, O) -> weight (O, I, kD, kH, kW)
  TorchConvTranspose2x (a module named `upconv`): its correlation kernel
         (kD, kH, kW, I, O), spatially flipped -> ConvTranspose3d weight
         (I, O, kD, kH, kW)
  Dense  kernel (I, O)             -> weight (O, I)
  GroupNorm / BatchNorm scale      -> weight
  bias, sig_scale, sig_shift       -> unchanged
  batch_stats mean, var            -> running_mean, running_var

The port keeps the JAX channels-last flatten order wherever a Dense layer
reads a flattened patch (patch encoder, attention MLPs), so no channel
permutation is needed here.

An optax Adam state (`scale_by_adam`'s count, mu and nu, as the JAX
refinement trainer's checkpoints hold it) maps onto torch Adam's step,
exp_avg and exp_avg_sq with the same layouts (flax_adam_state).
"""

from __future__ import annotations

from collections.abc import Mapping

import numpy as np
import torch


_STAT_NAMES = {"mean": "running_mean", "var": "running_var"}
#: flax modules whose 5-D kernel is a transposed conv's correlation kernel
TRANSPOSED_CONV_NAMES = ("upconv",)


def flax_to_state_dict(params: Mapping, batch_stats: Mapping | None = None
                       ) -> dict[str, torch.Tensor]:
    """Nested mapping of arrays (flax params of one module, and its
    BatchNorm `batch_stats` if it has any) -> flat float32 state_dict for
    the port's module of the same structure."""
    out: dict[str, torch.Tensor] = {}

    def walk(tree: Mapping, prefix: str) -> None:
        for name, leaf in tree.items():
            if isinstance(leaf, Mapping):
                walk(leaf, f"{prefix}{name}.")
                continue
            a = np.asarray(leaf).astype(np.float32)
            if name == "kernel":
                if a.ndim == 5 and prefix.rstrip(".").rpartition(".")[2] in TRANSPOSED_CONV_NAMES:
                    # a transposed conv is a correlation with the flipped kernel
                    a, name = a[::-1, ::-1, ::-1].transpose(3, 4, 0, 1, 2), "weight"
                elif a.ndim == 5:
                    a, name = a.transpose(4, 3, 0, 1, 2), "weight"
                elif a.ndim == 2:
                    a, name = a.T, "weight"
                else:
                    raise ValueError(f"{prefix}{name}: unexpected kernel rank {a.ndim}")
            elif name == "scale":
                name = "weight"
            out[prefix + name] = torch.from_numpy(np.ascontiguousarray(a))

    walk(params, "")
    if batch_stats:
        for key, value in flax_to_state_dict(batch_stats).items():
            prefix, _, name = key.rpartition(".")
            out[f"{prefix}.{_STAT_NAMES[name]}"] = value
    return out


def flax_engine_params(params: Mapping) -> dict[str, dict[str, torch.Tensor]]:
    """The JAX engine's params {'fenc_input', 'unet_backbone', ...} -> one
    state_dict per module, keyed the same."""
    return {name: flax_to_state_dict(tree) for name, tree in params.items()}


def flax_adam_state(opt_state: Mapping, phase: int) -> dict:
    """The JAX refinement trainer's restored optimizer state (a
    multi_transform whose "train" part is scale_by_adam, with None for the
    masked sub-networks) -> the port's optimizer state: {"phase": phase,
    "state": {"<subnet>.<key>": {"step", "exp_avg", "exp_avg_sq"}}} for the
    sub-networks it trains."""
    adam = opt_state["inner_states"]["train"]["inner_state"][0]
    step = torch.tensor(float(np.asarray(adam["count"])))
    state = {}
    for name, mu in adam["mu"].items():
        if mu is None:
            continue
        nu = flax_to_state_dict(adam["nu"][name])
        for key, m in flax_to_state_dict(mu).items():
            state[f"{name}.{key}"] = {"step": step.clone(), "exp_avg": m, "exp_avg_sq": nu[key]}
    return {"phase": int(phase), "state": state}
