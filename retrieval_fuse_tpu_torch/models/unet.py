"""3D U-Net blocks, as in the JAX package's models/unet.py.

The modules here take and return NCDHW tensors (PyTorch's own idiom); the
public refinement stacks (models/refinement.py) take channels-last
(B, D, H, W, C) tensors and permute once at entry and exit, which is a view.
Submodule names equal the flax module names, so a flax param tree maps onto
these state_dicts key for key (utils/flax_import.py).

The family: the 'c', 'g', 'b', 'r', 'l', 'e' layer orders (BatchNorm with
flax's semantics, models/encoders.BatchNorm3d), DoubleConv,
StepDownDoubleConv, ExtResNetBlock, max-pool Encoder, the Decoder (nearest
upsample + concat, or with ExtResNetBlock the transposed conv
TorchConvTranspose2x + sum), DecoderNoJoining (and its fused
upsample-conv, FusedUpsampleSingleConv), UNet3D with
`remove_n_final_layers` and the optional 1x1 final conv, and
ResidualUNet3D.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from retrieval_fuse_tpu_torch.models.encoders import BatchNorm3d
from retrieval_fuse_tpu_torch.ops.fused_decoder import fuse_upsample_conv_kernel_torch


def number_of_features_per_level(init_channel_number: int, num_levels: int) -> list[int]:
    return [init_channel_number * 2 ** k for k in range(num_levels)]


def _adapt_num_groups(num_channels: int, num_groups: int) -> int:
    if num_channels < num_groups:
        return 1
    if num_channels % num_groups:
        raise ValueError(f"channels ({num_channels}) must divide num_groups ({num_groups})")
    return num_groups


def upsample_nearest_2x(x: torch.Tensor) -> torch.Tensor:
    """Nearest-neighbour 2x on (B, C, D, H, W)."""
    return F.interpolate(x, scale_factor=2, mode="nearest")


class SingleConv(nn.Module):
    """One conv with norm / non-linearity in configurable order: 'c' conv
    (bias only without norm), 'g' GroupNorm (eps 1e-5, on the channels at
    its position), 'b' BatchNorm (flax's: momentum 0.9, eps 1e-5, batch
    statistics in train mode, running ones in eval mode), 'r' ReLU, 'l'
    LeakyReLU(0.1), 'e' ELU."""

    def __init__(self, in_channels: int, out_channels: int, kernel_size: int = 3,
                 order: str = "crg", num_groups: int = 8, padding: int = 1):
        super().__init__()
        if "c" not in order:
            raise ValueError("Conv layer MUST be present")
        if order[0] in "rle":
            raise ValueError("Non-linearity cannot be the first operation in the layer")
        self.order = order
        ch = in_channels
        for char in order:
            if char == "c":
                self.conv = nn.Conv3d(in_channels, out_channels, kernel_size,
                                      padding=padding, bias="g" not in order and "b" not in order)
                ch = out_channels
            elif char == "g":
                self.groupnorm = nn.GroupNorm(_adapt_num_groups(ch, num_groups), ch, eps=1e-5)
            elif char == "b":
                self.batchnorm = BatchNorm3d(ch)
            elif char not in "rle":
                raise ValueError(f"Unsupported layer type '{char}'")

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for char in self.order:
            if char == "r":
                x = F.relu(x)
            elif char == "l":
                x = F.leaky_relu(x, 0.1)
            elif char == "e":
                x = F.elu(x)
            elif char == "c":
                x = self.conv(x)
            elif char == "g":
                x = self.groupnorm(x)
            else:
                x = self.batchnorm(x)
        return x


class DoubleConv(nn.Module):
    """Two SingleConvs; an encoder halves-then-doubles channels."""

    def __init__(self, in_channels: int, out_channels: int, encoder: bool,
                 kernel_size: int = 3, order: str = "crg", num_groups: int = 8):
        super().__init__()
        conv1_out = max(out_channels // 2, in_channels) if encoder else out_channels
        self.SingleConv1 = SingleConv(in_channels, conv1_out, kernel_size, order, num_groups)
        self.SingleConv2 = SingleConv(conv1_out, out_channels, kernel_size, order, num_groups)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.SingleConv2(self.SingleConv1(x))


class StepDownDoubleConv(nn.Module):
    """Two SingleConvs stepping through (in + out) // 2 channels."""

    def __init__(self, in_channels: int, out_channels: int, encoder: bool = False,
                 kernel_size: int = 3, order: str = "crg", num_groups: int = 8):
        super().__init__()
        mid = (in_channels + out_channels) // 2
        self.SingleConv1 = SingleConv(in_channels, mid, kernel_size, order, num_groups)
        self.SingleConv2 = SingleConv(mid, out_channels, kernel_size, order, num_groups)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.SingleConv2(self.SingleConv1(x))


class ExtResNetBlock(nn.Module):
    """SingleConv, then a residual pair whose second conv has no
    non-linearity; the non-linearity of `order` follows the sum."""

    def __init__(self, in_channels: int, out_channels: int, encoder: bool = False,
                 kernel_size: int = 3, order: str = "cge", num_groups: int = 8):
        super().__init__()
        self.order = order
        self.conv1 = SingleConv(in_channels, out_channels, kernel_size, order, num_groups)
        self.conv2 = SingleConv(out_channels, out_channels, kernel_size, order, num_groups)
        n_order = "".join(c for c in order if c not in "rel")
        self.conv3 = SingleConv(out_channels, out_channels, kernel_size, n_order, num_groups)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        residual = self.conv1(x)
        out = self.conv3(self.conv2(residual)) + residual
        if "l" in self.order:
            return F.leaky_relu(out, 0.1)
        if "e" in self.order:
            return F.elu(out)
        return F.relu(out)


_BASIC_MODULES = {"DoubleConv": DoubleConv, "StepDownDoubleConv": StepDownDoubleConv,
                  "ExtResNetBlock": ExtResNetBlock}


def torch_conv_transpose_2x(in_channels: int, out_channels: int) -> nn.ConvTranspose3d:
    """The JAX package's TorchConvTranspose2x: ConvTranspose3d(k=3, s=2,
    p=1) at twice the input size (output_padding 1). Its flax kernel is the
    equivalent correlation's (3, 3, 3, in, out); the weight bridge flips it
    into this module's (in, out, 3, 3, 3) weight."""
    return nn.ConvTranspose3d(in_channels, out_channels, 3, stride=2, padding=1,
                              output_padding=1)


class Encoder(nn.Module):
    """Optional 2³ max-pool + basic module."""

    def __init__(self, in_channels: int, out_channels: int, apply_pooling: bool = True,
                 basic_module: str = "DoubleConv", conv_layer_order: str = "crg",
                 num_groups: int = 8):
        super().__init__()
        self.apply_pooling = apply_pooling
        self.basic_module = _BASIC_MODULES[basic_module](
            in_channels, out_channels, encoder=True, order=conv_layer_order,
            num_groups=num_groups)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.apply_pooling:
            x = F.max_pool3d(x, kernel_size=2, stride=2)
        return self.basic_module(x)


class Decoder(nn.Module):
    """Nearest-upsample + concat([skip, x]) + basic module; with
    ExtResNetBlock, the transposed conv `upconv` to out_channels + skip
    (which must have out_channels) + basic module."""

    def __init__(self, skip_channels: int, in_channels: int, out_channels: int,
                 basic_module: str = "DoubleConv", conv_layer_order: str = "crg",
                 num_groups: int = 8):
        super().__init__()
        self.summed = basic_module == "ExtResNetBlock"
        if self.summed:
            if skip_channels != out_channels:
                raise ValueError(f"summing joins need skip channels ({skip_channels}) = "
                                 f"out channels ({out_channels})")
            self.upconv = torch_conv_transpose_2x(in_channels, out_channels)
        basic_in = out_channels if self.summed else skip_channels + in_channels
        self.basic_module = _BASIC_MODULES[basic_module](
            basic_in, out_channels, encoder=False, order=conv_layer_order,
            num_groups=num_groups)

    def forward(self, encoder_features: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
        if self.summed:
            x = encoder_features + self.upconv(x)
        else:
            x = torch.cat([encoder_features, upsample_nearest_2x(x)], dim=1)
        return self.basic_module(x)


class FusedUpsampleSingleConv(nn.Module):
    """A 'gcr' SingleConv of nearest-2x-upsampled input, computed on the
    grid before the upsample: GroupNorm (nearest repeats leave the
    statistics unchanged) -> one 3³ conv with the fused kernel
    (fuse_upsample_conv_kernel_torch of the canonical weight, 8·C_out
    channels) -> ReLU -> depth-to-space. The function and the state_dict
    ('groupnorm', 'conv.weight') of upsample_nearest_2x + SingleConv."""

    def __init__(self, in_channels: int, out_channels: int, num_groups: int = 8):
        super().__init__()
        self.out_channels = out_channels
        self.groupnorm = nn.GroupNorm(_adapt_num_groups(in_channels, num_groups), in_channels,
                                      eps=1e-5)
        self.conv = nn.Conv3d(in_channels, out_channels, 3, padding=1, bias=False)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """(B, C_in, S, S, S) -> (B, C_out, 2S, 2S, 2S)."""
        w = fuse_upsample_conv_kernel_torch(self.conv.weight.permute(2, 3, 4, 1, 0))
        y = F.relu(F.conv3d(self.groupnorm(x), w.permute(4, 3, 0, 1, 2), padding=1))
        b, _, s = y.shape[:3]
        c = self.out_channels
        # channel o_idx·C + c, o_idx = o0·4 + o1·2 + o2 -> voxel (2i+o0, 2j+o1, 2k+o2)
        y = y.reshape(b, 2, 2, 2, c, s, s, s).permute(0, 4, 5, 1, 6, 2, 7, 3)
        return y.reshape(b, c, 2 * s, 2 * s, 2 * s)


class _FusedUpsampleDoubleConv(nn.Module):
    """Decoder-side DoubleConv whose first SingleConv is the fused
    upsample-conv (conv1 has out_channels, the encoder=False branch)."""

    def __init__(self, in_channels: int, out_channels: int, order: str = "gcr",
                 num_groups: int = 8):
        super().__init__()
        self.SingleConv1 = FusedUpsampleSingleConv(in_channels, out_channels, num_groups)
        self.SingleConv2 = SingleConv(out_channels, out_channels, 3, order, num_groups)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.SingleConv2(self.SingleConv1(x))


class DecoderNoJoining(nn.Module):
    """Upsample 2x + basic module, no skip connection. fused_upsample runs
    the upsample and the first conv fused on the coarse grid
    (_FusedUpsampleDoubleConv; DoubleConv and 'gcr' only): the same
    function and state_dict."""

    def __init__(self, in_channels: int, out_channels: int,
                 basic_module: str = "DoubleConv", conv_layer_order: str = "crg",
                 num_groups: int = 8, fused_upsample: bool = False):
        super().__init__()
        self.fused_upsample = fused_upsample
        if fused_upsample:
            if basic_module != "DoubleConv" or conv_layer_order != "gcr":
                raise ValueError("fused_upsample supports the DoubleConv / 'gcr' decoder")
            self.basic_module = _FusedUpsampleDoubleConv(in_channels, out_channels,
                                                         conv_layer_order, num_groups)
        else:
            self.basic_module = _BASIC_MODULES[basic_module](
                in_channels, out_channels, encoder=False, order=conv_layer_order,
                num_groups=num_groups)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.fused_upsample:
            return self.basic_module(x)
        return self.basic_module(upsample_nearest_2x(x))


class UNet3D(nn.Module):
    """Encoder path + truncatable decoder path + optional 1x1 final conv.
    Without final_conv, `out_channels` is written into the last kept
    decoder, which becomes a StepDownDoubleConv when truncated; with it,
    the decoders keep the f_maps widths and `final_conv` maps to
    out_channels (then sigmoid or softmax over channels where
    is_segmentation and testing)."""

    def __init__(self, in_channels: int, out_channels: int, f_maps=64,
                 layer_order: str = "gcr", num_groups: int = 8, num_levels: int = 4,
                 remove_n_final_layers: int = 0, final_conv: bool = False,
                 basic_module: str = "DoubleConv", final_sigmoid: bool = False,
                 is_segmentation: bool = False, testing: bool = False):
        super().__init__()
        if isinstance(f_maps, int):
            f_maps = number_of_features_per_level(f_maps, num_levels)
        ch = in_channels
        for i, out_feature_num in enumerate(f_maps):
            self.add_module(f"encoders_{i}", Encoder(
                ch, out_feature_num, apply_pooling=i != 0, basic_module=basic_module,
                conv_layer_order=layer_order, num_groups=num_groups))
            ch = out_feature_num
        reversed_f_maps = list(reversed(f_maps))
        if remove_n_final_layers > 0:
            reversed_f_maps = reversed_f_maps[:-remove_n_final_layers]
        modified = list(reversed_f_maps)
        if not final_conv:
            modified[-1] = out_channels
        skips = list(reversed(f_maps))[1:]
        self.n_decoders = len(reversed_f_maps) - 1
        self.n_encoders = len(f_maps)
        for i in range(self.n_decoders):
            last_truncated = (i == self.n_decoders - 1 and not final_conv
                              and remove_n_final_layers > 0)
            self.add_module(f"decoders_{i}", Decoder(
                skips[i], ch, modified[i + 1],
                basic_module="StepDownDoubleConv" if last_truncated else basic_module,
                conv_layer_order=layer_order, num_groups=num_groups))
            ch = modified[i + 1]
        if final_conv:
            self.final_conv = nn.Conv3d(ch, out_channels, 1)
        self.final_sigmoid = final_sigmoid
        self.segmentation_output = is_segmentation and testing

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        features = []
        for i in range(self.n_encoders):
            x = getattr(self, f"encoders_{i}")(x)
            features.insert(0, x)
        # the skips the decoders read: a truncated decoder path reads only
        # the coarse ones, so the finer maps are freed here
        features = features[1:self.n_decoders + 1]
        for i in range(self.n_decoders):
            x = getattr(self, f"decoders_{i}")(features[i], x)
        if hasattr(self, "final_conv"):
            x = self.final_conv(x)
        if self.segmentation_output:
            x = torch.sigmoid(x) if self.final_sigmoid else torch.softmax(x, dim=1)
        return x


class ResidualUNet3D(UNet3D):
    """UNet3D of ExtResNetBlocks: transposed-conv upsampling, summed skips,
    five levels by default."""

    def __init__(self, in_channels: int, out_channels: int, f_maps=64,
                 layer_order: str = "gcr", num_groups: int = 8, num_levels: int = 5,
                 **kwargs):
        super().__init__(in_channels, out_channels, f_maps=f_maps, layer_order=layer_order,
                         num_groups=num_groups, num_levels=num_levels,
                         basic_module="ExtResNetBlock", **kwargs)
