"""Refinement backbone, final decoder and retrieval backbone, as in the JAX
package's models/refinement.py. Each takes and returns channels-last
(B, D, H, W, C) tensors; inside they run NCDHW (a permuted view, no copy).

The four task stacks of the JAX package: Superresolution08UNetBackbone
(8³ -> 32³), Superresolution16UNetBackbone (16³ -> 32³),
SurfaceReconstructionUNetBackbone (128³ occupancy -> 32³, a five-level
UNet3D whose two finest decoders are removed), the final decoder that every
task shares (32³ -> 64³), and the retrieval backbone (16³ tiles -> 8³).
"""

from __future__ import annotations

import torch
from torch import nn

from retrieval_fuse_tpu_torch.models.unet import UNet3D, DecoderNoJoining


def _ncdhw(x: torch.Tensor) -> torch.Tensor:
    """A channels-first view. One channel is a reshape, the same memory with
    NCDHW strides: the permuted view's strides also read as channels-last,
    and oneDNN's CPU backward of a 1-channel channels-last conv crashes."""
    if x.shape[-1] == 1:
        return x.reshape(x.shape[0], 1, *x.shape[1:4])
    return x.permute(0, 4, 1, 2, 3)


def _ndhwc(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, 2, 3, 4, 1)


class Superresolution08UNetBackbone(nn.Module):
    """(B, 8, 8, 8, 1) -> (B, 32, 32, 32, nf)."""

    def __init__(self, nf: int, num_levels: int = 4, layer_order: str = "gcr"):
        super().__init__()
        self.unet = UNet3D(1, 2 * nf, f_maps=nf, num_groups=nf // 2,
                           layer_order=layer_order, num_levels=num_levels)
        self.up0 = DecoderNoJoining(2 * nf, 2 * nf, conv_layer_order=layer_order,
                                    num_groups=nf // 2)
        self.up1 = DecoderNoJoining(2 * nf, nf, conv_layer_order=layer_order,
                                    num_groups=nf // 2)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return _ndhwc(self.up1(self.up0(self.unet(_ncdhw(x)))))


class Superresolution16UNetBackbone(nn.Module):
    """(B, 16, 16, 16, 1) -> (B, 32, 32, 32, nf)."""

    def __init__(self, nf: int, num_levels: int = 4, layer_order: str = "gcr"):
        super().__init__()
        self.unet = UNet3D(1, 2 * nf, f_maps=nf, num_groups=nf // 2,
                           layer_order=layer_order, num_levels=num_levels)
        self.up0 = DecoderNoJoining(2 * nf, nf, conv_layer_order=layer_order,
                                    num_groups=nf // 2)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return _ndhwc(self.up0(self.unet(_ncdhw(x))))


class SurfaceReconstructionUNetBackbone(nn.Module):
    """(B, S, S, S, 1) occupancy -> (B, S/4, S/4, S/4, nf); S = 128 in the
    shipped configs."""

    def __init__(self, nf: int, num_levels: int = 5, layer_order: str = "gcr"):
        super().__init__()
        self.unet = UNet3D(1, nf, f_maps=nf, num_groups=nf // 2, layer_order=layer_order,
                           num_levels=num_levels, remove_n_final_layers=2)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return _ndhwc(self.unet(_ncdhw(x)))


class Superresolution08FinalDecoder(nn.Module):
    """(B, 32, 32, 32, nf) -> (B, 64, 64, 64, 1) in tanh space."""

    def __init__(self, nf: int, layer_order: str = "gcr"):
        super().__init__()
        self.up0 = DecoderNoJoining(nf, nf, conv_layer_order=layer_order,
                                    num_groups=nf // 2)
        self.final_conv = nn.Conv3d(nf, 1, kernel_size=1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return _ndhwc(torch.tanh(self.final_conv(self.up0(_ncdhw(x)))))


class RetrievalUNetBackbone(nn.Module):
    """(B, 16, 16, 16, 1) raw-tile volumes -> (B, 8, 8, 8, nf) features."""

    def __init__(self, nf: int, f_maps: int = 16, num_levels: int = 4,
                 layer_order: str = "gcr"):
        super().__init__()
        self.unet = UNet3D(1, nf, f_maps=f_maps, num_groups=nf // 2,
                           layer_order=layer_order, num_levels=num_levels,
                           remove_n_final_layers=1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return _ndhwc(self.unet(_ncdhw(x)))
