"""Retrieval patch encoders, as in the JAX package's models/encoders.py.

Ported: the MLP encoders (Patch04 is the serving path's query encoder,
network code "2+1"). The conv encoders (Patch32 and the rest of CONV_SPECS)
build the database offline and are not ported yet.

Layout is channels-last: input (B, D, H, W, 1), flattened in that order, so
flax Dense kernels transpose straight into nn.Linear weights; output
(B, 1, 1, 1, z).
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

MLP_SPECS: dict[str, tuple[int, tuple[int, ...]]] = {
    # (flat input size, hidden multipliers of nf)
    "Patch04": (4 ** 3, (4, 8, 16, 8)),
    "Patch05": (5 ** 3, (4, 8, 16, 8)),
    "Patch04V2": (4 ** 3, (4, 8, 16, 16, 8)),
}

INPUT_CODE_TO_ENCODER = {
    "2+1": "Patch04",
    "2+1V2": "Patch04V2",
    "4+2": "Patch08",
    "4+2N": "PatchNorm08",
    "16+4": "Patch24",
    "pc_16+8": "PCPatch32",
    "pc_32+8": "PCPatch48",
    "pc_32+16": "PCPatch64",
}


class MLPPatchEncoder(nn.Module):
    """Flattened-input MLP with ReLU (the tiny-patch variants)."""

    def __init__(self, nf: int, z_dim: int, in_size: int, hidden: Sequence[int]):
        super().__init__()
        self.n_hidden = len(hidden)
        self.z_dim = z_dim
        fan_in = in_size
        for i, mult in enumerate(hidden):
            self.add_module(f"fc{i}", nn.Linear(fan_in, nf * mult))
            fan_in = nf * mult
        self.final_layer = nn.Linear(fan_in, z_dim)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b = x.shape[0]
        x = x.reshape(b, -1)
        for i in range(self.n_hidden):
            x = F.relu(getattr(self, f"fc{i}")(x))
        return self.final_layer(x).reshape(b, 1, 1, 1, self.z_dim)


def make_encoder(name: str, nf: int, z_dim: int) -> nn.Module:
    """Instantiate an encoder by its reference class name."""
    if name not in MLP_SPECS:
        raise NotImplementedError(
            f"encoder {name!r}: only the MLP encoders are ported "
            "(conv encoders: ROADMAP Queue 1 item 3)")
    in_size, hidden = MLP_SPECS[name]
    return MLPPatchEncoder(nf, z_dim, in_size, hidden)
