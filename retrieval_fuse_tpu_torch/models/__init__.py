"""Model factories, mirroring the JAX package's models/__init__.py with the
same network codes and config keys, plus a seeded numpy initialiser."""

from __future__ import annotations

import numpy as np
import torch
from torch import nn

from retrieval_fuse_tpu_torch.models.encoders import (
    make_encoder, INPUT_CODE_TO_ENCODER, TARGET_CODE_TO_ENCODER, ConvPatchEncoder,
    MLPPatchEncoder)
from retrieval_fuse_tpu_torch.models.refinement import (
    Superresolution08UNetBackbone, Superresolution16UNetBackbone,
    SurfaceReconstructionUNetBackbone, Superresolution08FinalDecoder, RetrievalUNetBackbone)
from retrieval_fuse_tpu_torch.models.attention import AttentionBlock, PatchedAttentionBlock
from retrieval_fuse_tpu_torch.models.unet import UNet3D, ResidualUNet3D, DecoderNoJoining

__all__ = [
    "ConvPatchEncoder", "MLPPatchEncoder", "AttentionBlock", "PatchedAttentionBlock",
    "Superresolution08UNetBackbone", "Superresolution16UNetBackbone",
    "SurfaceReconstructionUNetBackbone", "Superresolution08FinalDecoder",
    "RetrievalUNetBackbone", "UNet3D", "ResidualUNet3D", "DecoderNoJoining",
    "get_retrieval_networks", "get_input_encoder",
    "get_unet_backbone", "get_decoder", "get_retrieval_backbone", "get_attention_block",
    "build_modules", "init_module_params", "init_params",
]


def get_retrieval_networks(model_config: dict):
    """(fenc_input, fenc_target) from the network codes; None for a code
    with no encoder."""
    fenc_input = fenc_target = None
    code_in, code_tgt = model_config["network_input"], model_config["network_target"]
    if code_in in INPUT_CODE_TO_ENCODER:
        fenc_input = make_encoder(INPUT_CODE_TO_ENCODER[code_in],
                                  model_config["nf_input"], model_config["latent_dim"])
    if code_tgt in TARGET_CODE_TO_ENCODER:
        fenc_target = make_encoder(TARGET_CODE_TO_ENCODER[code_tgt],
                                   model_config["nf_target"], model_config["latent_dim"])
    return fenc_input, fenc_target


def get_input_encoder(model_config: dict) -> nn.Module:
    """The query-side patch encoder for `network_input`."""
    return make_encoder(INPUT_CODE_TO_ENCODER[model_config["network_input"]],
                        model_config["nf_input"], model_config["latent_dim"])


def get_unet_backbone(config: dict) -> nn.Module:
    """The refinement backbone of the config's task and input chunk size."""
    kw = dict(nf=config["nf"], num_levels=config["unet_num_level"],
              layer_order=config["layer_order"])
    if config["task"] == "superresolution":
        ics = config["dataset_train"]["input_chunk_size"]
        if ics == 8:
            return Superresolution08UNetBackbone(**kw)
        if ics == 16:
            return Superresolution16UNetBackbone(**kw)
    if config["task"] == "surface_reconstruction":
        return SurfaceReconstructionUNetBackbone(**kw)
    raise ValueError(f"no backbone for task={config['task']}")


def get_decoder(config: dict) -> nn.Module:
    return Superresolution08FinalDecoder(nf=config["nf"], layer_order=config["layer_order"])


def get_retrieval_backbone(config: dict) -> nn.Module:
    return RetrievalUNetBackbone(
        nf=config["nf"], f_maps=config["retrieval_fmaps"],
        num_levels=config["retrieval_num_level"], layer_order=config["layer_order"])


def get_attention_block(config: dict, deterministic_selection: bool = True) -> nn.Module:
    """The patched attention block of `config`. Its default selects
    deterministically (the argmax), which is what serving runs; the JAX
    package's factory defaults to Gumbel selection, which its refinement
    trainer trains with, and so does the port's trainer, which passes
    deterministic_selection=False unless it is built with
    deterministic_attention=True."""
    attention_kwargs = dict(
        normalize=config["attn_normalize"],
        use_switching=config["attn_use_switching"],
        retrieval_mode=config["attn_retrieval_mode"],
        no_output_mapping=config["attn_no_output_mapping"],
        blend=config["attn_blend"],
        deterministic_selection=deterministic_selection,
    )
    return PatchedAttentionBlock(
        nf=config["nf"], num_patch_x=config["attn_num_patch"],
        patch_extent=config["attn_patch_extent"] // 2,
        num_nearest_neighbors=config["K"], attention_kwargs=attention_kwargs)


def build_modules(config: dict) -> dict[str, nn.Module]:
    """The serving engine's modules under the JAX engine's param names."""
    return {
        "fenc_input": get_input_encoder(config["retrieval_model"]),
        "unet_backbone": get_unet_backbone(config),
        "decoder": get_decoder(config),
        "retrieval_backbone": get_retrieval_backbone(config),
        "patched_attention_block": get_attention_block(config),
    }


def init_params(config: dict, seed: int) -> dict[str, dict[str, torch.Tensor]]:
    """Random state_dicts for `build_modules(config)`, drawn from a numpy
    generator: conv and linear weights and biases U(-1/√fan_in, 1/√fan_in)
    (PyTorch's default law), GroupNorm weight 1 and bias 0, the attention
    switch parameters at their initial values."""
    rng = np.random.default_rng(seed)
    return {name: init_module_params(module, rng)
            for name, module in build_modules(config).items()}


def init_module_params(module: nn.Module, rng: np.random.Generator) -> dict[str, torch.Tensor]:
    """A random state_dict for `module`: conv and linear weights and biases
    U(-1/√fan_in, 1/√fan_in) drawn from `rng` (a transposed conv's fan is
    its out channels x taps, as PyTorch's), everything else as built."""
    sd = module.state_dict()
    for mod_name, mod in module.named_modules():
        if isinstance(mod, (nn.Conv3d, nn.ConvTranspose3d, nn.Linear)):
            bound = 1.0 / np.sqrt(mod.weight[0].numel())
            for p in ("weight", "bias"):
                key = f"{mod_name}.{p}"
                if key in sd:
                    sd[key] = torch.from_numpy(rng.uniform(
                        -bound, bound, tuple(sd[key].shape)).astype(np.float32))
    return sd
