"""The port's checkpoint layout, with the JAX package's addressing:

    runs/<experiment>/ckpt_epoch=<E>/params.pt   one state_dict per sub-network,
                                                 keyed "fenc_input", "fenc_target", ...
    runs/<experiment>/ckpt_epoch=<E>/optim.pt    the optimizer state, where one was
                                                 saved: {"phase": P, "state":
                                                 {"<subnet>.<key>": {"step", "exp_avg",
                                                 "exp_avg_sq"}}} (torch Adam's moments
                                                 by parameter name)
    runs/<experiment>/ckpt_epoch=<E>/meta.json   {"epoch": E, ...}

The directory name is what get_tree_path / get_retrievals_dir read, so the
retrieval artifacts of a checkpoint land where the JAX package puts them.
A JAX (orbax) checkpoint is converted by tools/torch_port_ckpt_from_jax.py.
"""

from __future__ import annotations

import json
from pathlib import Path

import torch

PARAMS_FILE = "params.pt"
OPTIM_FILE = "optim.pt"
META_FILE = "meta.json"
CONVERTER = "tools/torch_port_ckpt_from_jax.py"


def save_checkpoint(run_dir, epoch: int, params: dict, extra: dict | None = None,
                    opt_state: dict | None = None) -> Path:
    """Write runs/<experiment>/ckpt_epoch=<E>/ with params, meta and, when
    given, the optimizer state (an older one is removed otherwise)."""
    path = (Path(run_dir) / f"ckpt_epoch={epoch}").resolve()
    path.mkdir(parents=True, exist_ok=True)
    host = {name: {k: v.detach().cpu() for k, v in sd.items()} for name, sd in params.items()}
    torch.save(host, path / PARAMS_FILE)
    if opt_state is not None:
        torch.save(opt_state, path / OPTIM_FILE)
    else:
        (path / OPTIM_FILE).unlink(missing_ok=True)
    meta = {"epoch": epoch}
    meta.update(extra or {})
    (path / META_FILE).write_text(json.dumps(meta))
    return path


def load_checkpoint(path) -> dict:
    """{'params': {subnet: state_dict}, 'meta': {...}} of a checkpoint
    directory, and 'opt_state' where it holds one. An orbax (JAX) checkpoint
    raises, naming the converter."""
    path = Path(path).resolve()
    params_path = path / PARAMS_FILE
    if not params_path.exists():
        if path.is_dir() and any(p.name != META_FILE for p in path.iterdir()):
            raise ValueError(
                f"{path} holds no {PARAMS_FILE}: it looks like a JAX (orbax) checkpoint. "
                f"Convert it with `python {CONVERTER} {path} <out_run_dir>`")
        raise FileNotFoundError(f"no checkpoint at {path} ({PARAMS_FILE} missing)")
    params = torch.load(params_path, map_location="cpu", weights_only=True)
    meta_path = path / META_FILE
    meta = json.loads(meta_path.read_text()) if meta_path.exists() else {}
    out = {"params": params, "meta": meta}
    if (path / OPTIM_FILE).exists():
        out["opt_state"] = torch.load(path / OPTIM_FILE, map_location="cpu", weights_only=True)
    return out


def load_subnet_params(ckpt_path, subnet: str) -> dict:
    """One sub-network's state_dict out of a full checkpoint."""
    params = load_checkpoint(ckpt_path)["params"]
    if subnet not in params:
        raise KeyError(f"subnet '{subnet}' not in checkpoint ({list(params)})")
    return params[subnet]


def latest_checkpoint(run_dir) -> Path | None:
    """The checkpoint of the highest epoch under run_dir, or None."""
    run_dir = Path(run_dir)
    if not run_dir.exists():
        return None
    ckpts = sorted(run_dir.glob("ckpt_epoch=*"), key=lambda p: int(p.name.split("=")[1]))
    return ckpts[-1] if ckpts else None
