"""Retrieval patch encoders, as in the JAX package's models/encoders.py.

The MLP encoders (Patch04 is the query encoder, network code "2+1") and
the conv encoders of CONV_SPECS (Patch32, code "16+8", encodes the target
patches into the dictionary): valid-padding conv stacks with LeakyReLU(0.2)
and a final Linear to the latent width. The PatchNorm* variants put a
BatchNorm with flax's semantics after each conv (`BatchNorm3d` here).

Layout is channels-last: input (B, D, H, W, 1), output (B, 1, 1, 1, z).
The MLP flattens its input in that order, and the conv stack's final map
is flattened channels-last too, so flax Dense kernels transpose straight
into nn.Linear weights (utils/flax_import.py). The conv stacks run
channels-first inside (nn.Conv3d), whose weights are flax's conv kernels
transposed.
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

# (channel multiplier of nf, kernel, stride) per conv layer
CONV_SPECS: dict[str, tuple[tuple[int, int, int], ...]] = {
    "Patch32": ((1, 5, 1), (2, 3, 1), (4, 3, 2), (8, 3, 1), (8, 3, 2), (8, 4, 1)),  # 32³
    "Patch08": ((1, 3, 1), (4, 3, 1), (4, 3, 1), (8, 2, 1)),  # 8³
    "Patch16": ((1, 3, 1), (2, 3, 1), (2, 3, 1), (4, 3, 1), (4, 3, 1), (8, 3, 1), (8, 4, 1)),
    "Patch24": ((1, 5, 1), (2, 3, 1), (2, 3, 2), (4, 3, 1), (8, 3, 1), (8, 3, 1), (8, 2, 1)),
    "Patch24V2": ((1, 3, 1), (2, 3, 1), (2, 3, 2), (4, 3, 1), (8, 3, 1), (8, 3, 1), (8, 3, 1)),
    "Patch12": ((1, 3, 1), (2, 3, 1), (4, 3, 1), (4, 3, 1), (8, 3, 1), (8, 2, 1)),
    "PCPatch32": ((1, 3, 1), (2, 3, 1), (4, 3, 2), (4, 3, 1), (8, 3, 2), (8, 3, 1), (8, 3, 1)),
    "PCPatch48": ((1, 5, 1), (2, 3, 1), (4, 3, 2), (4, 3, 2), (8, 3, 2), (8, 3, 1), (8, 2, 1)),
    "PCPatch64": ((1, 5, 1), (2, 3, 1), (4, 3, 2), (4, 3, 2), (8, 3, 2), (8, 3, 1), (8, 4, 1)),
}

MLP_SPECS: dict[str, tuple[int, tuple[int, ...]]] = {
    # (flat input size, hidden multipliers of nf)
    "Patch04": (4 ** 3, (4, 8, 16, 8)),
    "Patch05": (5 ** 3, (4, 8, 16, 8)),
    "Patch04V2": (4 ** 3, (4, 8, 16, 16, 8)),
}

# network code ("<patch_size>+<context>") -> encoder class name
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

TARGET_CODE_TO_ENCODER = {
    "pc_32+16": "PCPatch64",
    "8+2": "Patch12",
    "8+4": "Patch16",
    "16+4": "Patch24",
    "16+4V2": "Patch24V2",
    "16+8": "Patch32",
    "16+8N": "PatchNorm32",
}


class BatchNorm3d(nn.Module):
    """flax's nn.BatchNorm(momentum=0.9, epsilon=1e-5) on NCDHW input.

    In training mode it normalises with the batch statistics over (N, D, H,
    W): the mean and the biased variance max(0, E[x²] - E[x]²), as flax
    computes it; and it updates the running statistics with those same
    values, running = 0.9 · running + 0.1 · batch (nn.BatchNorm3d would
    update the variance with the unbiased one). In eval mode it normalises
    with the running statistics. Buffers and parameters carry
    nn.BatchNorm3d's names, without num_batches_tracked.

    With a `mesh` set (parallel/mesh.py; `set_batchnorm_mesh`), the training
    statistics are the global batch's, as JAX's jit over a sharded batch
    computes them: the float32 sums of x and x² and the count are summed
    over the ranks, gradient included, in one collective."""

    mesh = None  # the data-parallel mesh whose global batch the statistics cover

    def __init__(self, num_features: int, momentum: float = 0.9, eps: float = 1e-5):
        super().__init__()
        self.momentum, self.eps = momentum, eps
        self.weight = nn.Parameter(torch.ones(num_features))
        self.bias = nn.Parameter(torch.zeros(num_features))
        self.register_buffer("running_mean", torch.zeros(num_features))
        self.register_buffer("running_var", torch.ones(num_features))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        shape = (1, -1, 1, 1, 1)
        if self.training:
            xf = x.to(torch.promote_types(x.dtype, torch.float32))  # float32 over bf16
            if self.mesh is None:
                mean = xf.mean(dim=(0, 2, 3, 4))
                mean_sq = (xf * xf).mean(dim=(0, 2, 3, 4))
            else:
                from retrieval_fuse_tpu_torch.parallel.mesh import all_reduce_sum
                dims = (0, 2, 3, 4)
                sums = all_reduce_sum(torch.stack([xf.sum(dim=dims), (xf * xf).sum(dim=dims)]),
                                      self.mesh)
                count = xf.numel() // xf.shape[1] * self.mesh.size
                mean, mean_sq = sums[0] / count, sums[1] / count
            var = torch.clamp(mean_sq - mean * mean, min=0.0)
            with torch.no_grad():
                m = self.momentum
                self.running_mean.mul_(m).add_((1 - m) * mean)
                self.running_var.mul_(m).add_((1 - m) * var)
        else:
            mean, var = self.running_mean, self.running_var
        mul = torch.rsqrt(var + self.eps) * self.weight
        return ((x - mean.reshape(shape)) * mul.reshape(shape) + self.bias.reshape(shape)) \
            .to(x.dtype)


class ConvPatchEncoder(nn.Module):
    """Valid-padding conv stack (+ BatchNorm with use_batchnorm) +
    LeakyReLU(0.2) + final Linear -> latent. Each spec collapses its patch
    size to a 1³ map, so the Linear reads the last conv's channels."""

    def __init__(self, nf: int, z_dim: int, spec: Sequence[tuple[int, int, int]],
                 use_batchnorm: bool = False):
        super().__init__()
        self.z_dim = z_dim
        self.n_conv = len(spec)
        self.use_batchnorm = use_batchnorm
        in_ch = 1
        for i, (mult, k, s) in enumerate(spec):
            self.add_module(f"conv{i}", nn.Conv3d(in_ch, nf * mult, k, stride=s))
            if use_batchnorm:
                self.add_module(f"bn{i}", BatchNorm3d(nf * mult))
            in_ch = nf * mult
        self.final_layer = nn.Linear(in_ch, z_dim)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b = x.shape[0]
        x = x.permute(0, 4, 1, 2, 3)
        for i in range(self.n_conv):
            x = getattr(self, f"conv{i}")(x)
            if self.use_batchnorm:
                x = getattr(self, f"bn{i}")(x)
            x = F.leaky_relu(x, negative_slope=0.2)
        x = x.permute(0, 2, 3, 4, 1).reshape(b, -1)  # flax's channels-last flatten
        return self.final_layer(x).reshape(b, 1, 1, 1, self.z_dim)


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


def set_batchnorm_mesh(module: nn.Module, mesh) -> None:
    """Make every BatchNorm3d in `module` take its training statistics over
    `mesh`'s global batch (None: this process's batch)."""
    for m in module.modules():
        if isinstance(m, BatchNorm3d):
            m.mesh = mesh


def make_encoder(name: str, nf: int, z_dim: int) -> nn.Module:
    """Instantiate an encoder by its reference class name (PatchNorm* are
    the Patch* conv stacks with BatchNorm)."""
    if name in MLP_SPECS:
        in_size, hidden = MLP_SPECS[name]
        return MLPPatchEncoder(nf, z_dim, in_size, hidden)
    use_bn = name.startswith("PatchNorm")
    return ConvPatchEncoder(nf, z_dim, CONV_SPECS[name.replace("PatchNorm", "Patch")],
                            use_batchnorm=use_bn)
