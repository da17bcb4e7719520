"""Parameter initialisers of the JAX package's ops/init.py, as functions
that fill a tensor from an explicit generator: a `torch.Generator`, or a
`numpy.random.Generator` as models.init_module_params takes.

torch's own Conv3d / Linear default is U(-1/√fan_in, 1/√fan_in) for the
weight and the bias; the attention's feature MLPs and output mappings use
N(0, std) and a Dirac kernel plus N(0, std) noise.
"""

from __future__ import annotations

import numpy as np
import torch


def _uniform(shape, low: float, high: float, generator) -> torch.Tensor:
    if isinstance(generator, np.random.Generator):
        return torch.from_numpy(generator.uniform(low, high, tuple(shape)).astype(np.float32))
    return torch.rand(tuple(shape), generator=generator) * (high - low) + low


def _normal(shape, std: float, generator) -> torch.Tensor:
    if isinstance(generator, np.random.Generator):
        return torch.from_numpy((generator.standard_normal(tuple(shape)) * std)
                                .astype(np.float32))
    return torch.randn(tuple(shape), generator=generator) * std


@torch.no_grad()
def torch_bias_init(tensor: torch.Tensor, fan_in: int, generator=None) -> torch.Tensor:
    """Fill `tensor` with U(-1/√fan_in, 1/√fan_in) (the layer's fan-in, which
    a bias alone does not show)."""
    bound = 1.0 / (fan_in ** 0.5)
    return tensor.copy_(_uniform(tensor.shape, -bound, bound, generator))


@torch.no_grad()
def dirac_noise_init(weight: torch.Tensor, noise_std: float = 0.01,
                     generator=None) -> torch.Tensor:
    """Fill a conv weight (C_out, C_in, kD, kH, kW) with the identity map at
    the kernel's centre (for the first min(C_in, C_out) channels) plus
    N(0, noise_std) noise."""
    c_out, c_in, kd, kh, kw = weight.shape
    eye = torch.zeros(weight.shape)
    n = min(c_in, c_out)
    eye[torch.arange(n), torch.arange(n), kd // 2, kh // 2, kw // 2] = 1.0
    return weight.copy_(eye + _normal(weight.shape, noise_std, generator))


@torch.no_grad()
def normal_init(tensor: torch.Tensor, std: float = 0.01, generator=None) -> torch.Tensor:
    """Fill `tensor` with N(0, std)."""
    return tensor.copy_(_normal(tensor.shape, std, generator))
