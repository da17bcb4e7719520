"""The 8³ super-resolution backbone with its upsample stages on the coarse
grid, as in the JAX package's ops/fused_backbone.py (token `fbb`).

Superresolution08UNetBackbone is a U-Net on the 8³ input followed by two
nearest-upsample DoubleConv stages (up0: 8³ -> 16³, up1: 16³ -> 32³). The
decoder's playbook (ops/fused_decoder) applies to both:

  up0: GN -> fused upsample-conv on 8³ (2nf -> 8·2nf) -> ReLU -> d2s
       -> GN -> conv2 on 16³ (unchanged)
  up1: GN -> fused upsample-conv on 16³ (2nf -> 8·nf) -> ReLU -> packed GN
       -> parity-decomposed conv2 -> ReLU -> d2s

The U-Net head is the port's UNet3D module, unchanged. Same function as the
plain backbone; layer order 'gcr' and 8³ input only.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from retrieval_fuse_tpu_torch.ops.fused_decoder import (
    _dhwio, _oidhw, conv3d, decomposed_conv, decomposed_conv2_kernels, depth_to_space_2x,
    fuse_upsample_conv_kernel, group_norm, group_norm_packed)


class FusedSuperres08Backbone(nn.Module):
    """Serving replacement for a Superresolution08UNetBackbone (layer order
    'gcr'), built from that module: its `unet` is shared, the upsample
    stages' weights are cast to `dtype` and then fused."""

    def __init__(self, backbone: nn.Module, nf: int, layer_order: str = "gcr",
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        if layer_order != "gcr":
            raise ValueError("the fused backbone covers the shipped 'gcr' layer order")
        self.unet = backbone.unet
        self.nf, self.num_groups = nf, nf // 2
        sd = {k: v.detach().to(dtype) for k, v in backbone.state_dict().items()}
        conv = {}  # "01" -> up0's SingleConv1 weight, ...
        for stage in ("01", "02", "11", "12"):
            prefix = f"up{stage[0]}.basic_module.SingleConv{stage[1]}."
            self.register_buffer(f"gn{stage}_scale", sd[prefix + "groupnorm.weight"])
            self.register_buffer(f"gn{stage}_bias", sd[prefix + "groupnorm.bias"])
            conv[stage] = sd[prefix + "conv.weight"]
        self.register_buffer("w01_fused", _oidhw(fuse_upsample_conv_kernel(
            _dhwio(conv["01"]), dtype), dtype))
        self.register_buffer("w02", conv["02"].contiguous())
        self.register_buffer("w11_fused", _oidhw(fuse_upsample_conv_kernel(
            _dhwio(conv["11"]), dtype), dtype))
        ks, self.w12_pads = decomposed_conv2_kernels(_dhwio(conv["12"]))
        for s, k in enumerate(ks):
            self.register_buffer(f"w12_dec{s}", _oidhw(k, dtype))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """x: (B, 8, 8, 8, 1) normalised input -> (B, 32, 32, 32, nf)."""
        nf, g = self.nf, self.num_groups
        h = self.unet(x.permute(0, 4, 1, 2, 3)).permute(0, 2, 3, 4, 1)   # (B, 8³, 2nf)
        h = group_norm(h, self.gn01_scale, self.gn01_bias, g)
        h = F.relu(conv3d(h, self.w01_fused))                            # (B, 8³, 16nf)
        h = depth_to_space_2x(h, 2 * nf)                                 # (B, 16³, 2nf)
        h = group_norm(h, self.gn02_scale, self.gn02_bias, g)
        h = F.relu(conv3d(h, self.w02))
        h = group_norm(h, self.gn11_scale, self.gn11_bias, g)
        h = F.relu(conv3d(h, self.w11_fused))                            # (B, 16³, 8nf)
        h = group_norm_packed(h, self.gn12_scale, self.gn12_bias, g, nf)
        h = F.relu(decomposed_conv(h, [getattr(self, f"w12_dec{s}") for s in range(8)],
                                   self.w12_pads, nf))
        return depth_to_space_2x(h, nf)                                  # (B, 32³, nf)
