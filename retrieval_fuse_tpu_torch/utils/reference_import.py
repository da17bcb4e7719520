"""Import the reference implementation's PyTorch (Lightning) checkpoints
into the port's modules: the counterpart of the JAX package's
utils/torch_import.py.

A reference state_dict's keys follow its own module structure (e.g.
`fenc_input.layers.0.weight`, `unet_backbone.network.0.encoders.0.
basic_module.SingleConv1.conv.weight`). The functions below are a numpy
copy of the JAX package's layout conversions, which turn those tensors into
flax-layout param trees:

  Conv3d weight (O, I, kD, kH, kW)       -> kernel (kD, kH, kW, I, O)
  ConvTranspose3d weight (I, O, k, k, k) -> the spatially flipped
                                            correlation kernel (k, k, k, I, O)
  Linear weight (O, I)                   -> kernel (I, O)
  GroupNorm / BatchNorm weight, bias     -> scale, bias
  the attention MLPs' first Linear       -> its input rows from the
                                            channels-first patch order
                                            (c·e³ + s) to channels-last
                                            (s·C + c)

and `import_refinement_checkpoint` / `import_retrieval_checkpoint[_auto]`
compose them with utils/flax_import.flax_to_state_dict, which gives the
state_dict of the port's module of the same name (BatchNorm running
statistics included). `export_refinement_state_dict` /
`export_retrieval_state_dict` are their inverses: the port's weights in the
reference's layout (what its checkpoints hold).
"""

from __future__ import annotations

import re

import numpy as np
import torch

from retrieval_fuse_tpu_torch.utils.flax_import import flax_to_state_dict


def conv_w(t):
    return np.asarray(t).transpose(2, 3, 4, 1, 0)


def conv_transpose_w(t):
    """torch ConvTranspose3d weight (I, O, kD, kH, kW) -> the CORRELATION
    kernel (kD, kH, kW, I, O) of the flax TorchConvTranspose2x: transposed
    convolution is correlation with the spatially FLIPPED kernel (and the
    in/out axes in their natural contraction roles)."""
    w = np.asarray(t).transpose(2, 3, 4, 0, 1)
    return w[::-1, ::-1, ::-1].copy()


def linear_w(t):
    return np.asarray(t).transpose(1, 0)


def _strip(sd: dict, prefix: str) -> dict:
    """Sub-dict of keys under `prefix.` with the prefix removed (utils/misc.
    rename_state_dict's)."""
    out = {}
    for k, v in sd.items():
        if k.startswith(prefix + "."):
            out[k[len(prefix) + 1:]] = v
    return out


# ------------------------------------------------------------------ encoders

def import_conv_encoder(sd: dict, n_convs: int) -> dict:
    """Reference conv patch encoders: `layers.{i}` Conv3d at even indices (or
    every 3rd with BatchNorm variants), plus `final_layer` Linear."""
    conv_keys = sorted({int(k.split(".")[1]) for k in sd
                        if k.startswith("layers.") and k.endswith(".weight")
                        and np.asarray(sd[k]).ndim == 5})
    params = {}
    for i, li in enumerate(conv_keys):
        params[f"conv{i}"] = {"kernel": conv_w(sd[f"layers.{li}.weight"]),
                              "bias": np.asarray(sd[f"layers.{li}.bias"])}
    bn_keys = sorted({int(k.split(".")[1]) for k in sd
                      if k.startswith("layers.") and k.endswith(".running_mean")})
    for i, li in enumerate(bn_keys):
        params[f"bn{i}"] = {"scale": np.asarray(sd[f"layers.{li}.weight"]),
                            "bias": np.asarray(sd[f"layers.{li}.bias"])}
    params["final_layer"] = {"kernel": linear_w(sd["final_layer.weight"]),
                             "bias": np.asarray(sd["final_layer.bias"])}
    if len(conv_keys) != n_convs:
        raise ValueError(f"expected {n_convs} Conv3d layers, the state_dict has them at "
                         f"layers {conv_keys}")
    return params


def import_conv_encoder_stats(sd: dict) -> dict:
    """BatchNorm running stats of the PatchNorm* encoder variants -> the flax
    `batch_stats` collection ({bn{i}: {mean, var}}); empty for non-BN encoders."""
    bn_keys = sorted({int(k.split(".")[1]) for k in sd
                      if k.startswith("layers.") and k.endswith(".running_mean")})
    return {f"bn{i}": {"mean": np.asarray(sd[f"layers.{li}.running_mean"]),
                       "var": np.asarray(sd[f"layers.{li}.running_var"])}
            for i, li in enumerate(bn_keys)}


def import_mlp_encoder(sd: dict) -> dict:
    """Reference MLP patch encoders: `layers.{even}` Linear chain; the last
    Linear maps to `final_layer`."""
    lin_keys = sorted({int(k.split(".")[1]) for k in sd
                       if k.startswith("layers.") and k.endswith(".weight")})
    params = {}
    for i, li in enumerate(lin_keys[:-1]):
        params[f"fc{i}"] = {"kernel": linear_w(sd[f"layers.{li}.weight"]),
                            "bias": np.asarray(sd[f"layers.{li}.bias"])}
    last = lin_keys[-1]
    params["final_layer"] = {"kernel": linear_w(sd[f"layers.{last}.weight"]),
                             "bias": np.asarray(sd[f"layers.{last}.bias"])}
    return params


# -------------------------------------------------------------------- U-Nets

def _import_single_conv(sd: dict) -> dict:
    out = {}
    if "conv.weight" in sd:
        p = {"kernel": conv_w(sd["conv.weight"])}
        if "conv.bias" in sd:
            p["bias"] = np.asarray(sd["conv.bias"])
        out["conv"] = p
    if "groupnorm.weight" in sd:
        out["groupnorm"] = {"scale": np.asarray(sd["groupnorm.weight"]),
                            "bias": np.asarray(sd["groupnorm.bias"])}
    if "batchnorm.weight" in sd:
        out["batchnorm"] = {"scale": np.asarray(sd["batchnorm.weight"]),
                            "bias": np.asarray(sd["batchnorm.bias"])}
    return out


def _import_basic_module(sd: dict) -> dict:
    out = {}
    for name in ("SingleConv1", "SingleConv2", "conv1", "conv2", "conv3"):
        sub = _strip(sd, name)
        if sub:
            out[name] = _import_single_conv(sub)
    return out


def import_unet3d(sd: dict) -> dict:
    """Reference Abstract3DUNet state (keys `encoders.{i}...`, `decoders.{i}...`,
    optional `final_conv`) -> the UNet3D flax tree."""
    params = {}
    enc_ids = sorted({int(k.split(".")[1]) for k in sd if k.startswith("encoders.")})
    for i in enc_ids:
        params[f"encoders_{i}"] = {
            "basic_module": _import_basic_module(_strip(sd, f"encoders.{i}.basic_module"))}
    dec_ids = sorted({int(k.split(".")[1]) for k in sd if k.startswith("decoders.")})
    for i in dec_ids:
        sub = _strip(sd, f"decoders.{i}")
        dec = {"basic_module": _import_basic_module(_strip(sub, "basic_module"))}
        if "upsampling.upsample.weight" in sub:  # transposed-conv variant
            dec["upconv"] = {"kernel": conv_transpose_w(sub["upsampling.upsample.weight"]),
                             "bias": np.asarray(sub["upsampling.upsample.bias"])}
        params[f"decoders_{i}"] = dec
    if "final_conv.weight" in sd:
        params["final_conv"] = {"kernel": conv_w(sd["final_conv.weight"]),
                                "bias": np.asarray(sd["final_conv.bias"])}
    return params


def _import_decoder_no_joining(sd: dict) -> dict:
    return {"basic_module": _import_basic_module(_strip(sd, "basic_module"))}


# --------------------------------------------------- refinement sub-networks

def import_superres08_backbone(sd: dict) -> dict:
    """network.0 = UNet3D, network.1/2 = DecoderNoJoining -> unet/up0/up1."""
    return {
        "unet": import_unet3d(_strip(sd, "network.0")),
        "up0": _import_decoder_no_joining(_strip(sd, "network.1")),
        "up1": _import_decoder_no_joining(_strip(sd, "network.2")),
    }


def import_superres16_backbone(sd: dict) -> dict:
    return {
        "unet": import_unet3d(_strip(sd, "network.0")),
        "up0": _import_decoder_no_joining(_strip(sd, "network.1")),
    }


def import_surface_recon_backbone(sd: dict) -> dict:
    return {"unet": import_unet3d(_strip(sd, "network"))}


def import_final_decoder(sd: dict) -> dict:
    """network.0 = DecoderNoJoining, network.1 = 1x1x1 Conv3d -> up0/final_conv."""
    return {
        "up0": _import_decoder_no_joining(_strip(sd, "network.0")),
        "final_conv": {"kernel": conv_w(sd["network.1.weight"]),
                       "bias": np.asarray(sd["network.1.bias"])},
    }


def import_retrieval_backbone(sd: dict) -> dict:
    return {"unet": import_unet3d(_strip(sd, "network"))}


# ---------------------------------------------------------------- attention

def _import_attention_feature_encoder(sd: dict, patch_extent: int) -> dict:
    """The reference's AttentionFeatureEncoder (`encoder.{i}` Linear chain).

    The reference flattens a (C, e, e, e) channels-first patch into the first
    Linear; the port's modules flatten (e, e, e, C) channels-last, so the first
    kernel's input rows are permuted from c·e³+s to s·C+c ordering (a pure
    relabelling: the outputs are the same)."""
    lin = sorted({int(k.split(".")[1]) for k in sd if k.endswith(".weight")})
    params = {}
    for i, li in enumerate(lin[:-1]):
        kernel = linear_w(sd[f"encoder.{li}.weight"])
        if i == 0:
            n_in, width = kernel.shape
            e3 = patch_extent ** 3
            c = n_in // e3
            kernel = kernel.reshape(c, e3, width).transpose(1, 0, 2).reshape(n_in, width)
        params[f"fc{i}"] = {"kernel": kernel,
                            "bias": np.asarray(sd[f"encoder.{li}.bias"])}
    last = lin[-1]
    params["out"] = {"kernel": linear_w(sd[f"encoder.{last}.weight"]),
                     "bias": np.asarray(sd[f"encoder.{last}.bias"])}
    return params


def import_attention_block(sd: dict, patch_extent: int = 2) -> dict:
    params = {
        "theta": _import_attention_feature_encoder(_strip(sd, "theta"), patch_extent),
        "phi": _import_attention_feature_encoder(_strip(sd, "phi"), patch_extent),
        "sig_scale": np.asarray(sd["sig_scale"]),
        "sig_shift": np.asarray(sd["sig_shift"]),
    }
    if "g.weight" in sd:
        params["g"] = {"kernel": conv_w(sd["g.weight"]), "bias": np.asarray(sd["g.bias"])}
        params["o"] = {"kernel": conv_w(sd["o.weight"]), "bias": np.asarray(sd["o.bias"])}
    return params


def import_patched_attention_block(sd: dict, patch_extent: int = 2) -> dict:
    return {"attention_blocks_layer": import_attention_block(
        _strip(sd, "attention_blocks_layer"), patch_extent)}


# ------------------------------------------------------------ full checkpoint

def refinement_checkpoint_tree(state_dict: dict, task: str = "superresolution",
                               input_chunk_size: int = 8, attn_patch_extent: int = 4) -> dict:
    """Full reference refinement Lightning state_dict -> the 4-subnet flax tree.
    `attn_patch_extent` is the config's attn_patch_extent (4 in every shipped
    config); the attention blocks operate on extent attn_patch_extent//2."""
    if task == "superresolution":
        backbone = (import_superres08_backbone if input_chunk_size == 8
                    else import_superres16_backbone)(_strip(state_dict, "unet_backbone"))
    else:
        backbone = import_surface_recon_backbone(_strip(state_dict, "unet_backbone"))
    return {
        "unet_backbone": backbone,
        "decoder": import_final_decoder(_strip(state_dict, "decoder")),
        "retrieval_backbone": import_retrieval_backbone(_strip(state_dict, "retrieval_backbone")),
        "patched_attention_block": import_patched_attention_block(
            _strip(state_dict, "patched_attention_block"), attn_patch_extent // 2),
    }


def retrieval_checkpoint_tree(state_dict: dict, input_is_mlp: bool,
                              n_convs_input: int = 0, n_convs_target: int = 6) -> dict:
    """Reference retrieval Lightning state_dict -> {fenc_input, fenc_target}."""
    sd_in = _strip(state_dict, "fenc_input")
    sd_tgt = _strip(state_dict, "fenc_target")
    fin = import_mlp_encoder(sd_in) if input_is_mlp else import_conv_encoder(sd_in, n_convs_input)
    ftgt = import_conv_encoder(sd_tgt, n_convs_target)
    return {"fenc_input": fin, "fenc_target": ftgt}


def _n_conv_layers(sd: dict) -> int:
    return len({k for k in sd if k.startswith("layers.") and k.endswith(".weight")
                and np.asarray(sd[k]).ndim == 5})


def import_refinement_checkpoint(state_dict: dict, task: str = "superresolution",
                                 input_chunk_size: int = 8, attn_patch_extent: int = 4
                                 ) -> dict[str, dict[str, torch.Tensor]]:
    """A reference refinement state_dict -> one state_dict per sub-network
    of the port (unet_backbone, decoder, retrieval_backbone,
    patched_attention_block): the 8³ (input_chunk_size 8) or 16³
    super-resolution backbone, or the surface-reconstruction one
    (task "surface_reconstruction"). `attn_patch_extent` is the config's
    (4 in every shipped config)."""
    tree = refinement_checkpoint_tree(_numpy(state_dict), task, input_chunk_size,
                                      attn_patch_extent)
    return {name: flax_to_state_dict(sub) for name, sub in tree.items()}


def import_retrieval_checkpoint(state_dict: dict, input_is_mlp: bool, n_convs_input: int = 0,
                                n_convs_target: int = 6) -> dict[str, dict[str, torch.Tensor]]:
    """A reference retrieval state_dict -> {"fenc_input", "fenc_target"}
    state_dicts of the port's encoders, with the BatchNorm running
    statistics of the Patch*N encoders."""
    sd = _numpy(state_dict)
    tree = retrieval_checkpoint_tree(sd, input_is_mlp, n_convs_input, n_convs_target)
    return {name: flax_to_state_dict(tree[name], import_conv_encoder_stats(_strip(sd, name)))
            for name in ("fenc_input", "fenc_target")}


def import_retrieval_checkpoint_auto(state_dict: dict) -> dict[str, dict[str, torch.Tensor]]:
    """import_retrieval_checkpoint with the encoder kinds read from the
    weights: a 5-D `layers.*.weight` is a Conv3d, an encoder without one is
    an MLP."""
    sd = _numpy(state_dict)
    n_in = _n_conv_layers(_strip(sd, "fenc_input"))
    n_tgt = _n_conv_layers(_strip(sd, "fenc_target"))
    return import_retrieval_checkpoint(sd, input_is_mlp=n_in == 0, n_convs_input=n_in,
                                       n_convs_target=n_tgt)


def _numpy(state_dict: dict) -> dict:
    """Tensors (or arrays) -> numpy arrays."""
    return {k: (v.detach().cpu().numpy() if isinstance(v, torch.Tensor) else np.asarray(v))
            for k, v in state_dict.items()}


# ------------------------------------------------------------------- export

def _reference_key(key: str) -> str:
    """A port U-Net key -> the reference's: encoders_i / decoders_i ->
    encoders.i / decoders.i, upconv -> upsampling.upsample (both
    ConvTranspose3d weights in torch's layout)."""
    parts = [re.sub(r"^(encoders|decoders)_(\d+)$", r"\1.\2", p) for p in key.split(".")]
    return ".".join("upsampling.upsample" if p == "upconv" else p for p in parts)


def _renamed(sd: dict, prefix: str, rename) -> dict:
    """`sd` as numpy arrays under prefix + rename(key)."""
    return {prefix + rename(k): np.ascontiguousarray(v) for k, v in _numpy(sd).items()}


def _export_attention_encoder(sd: dict, patch_extent: int) -> dict:
    """fc0.. and out -> encoder.{2i}; the first weight's input columns back
    from the port's channels-last (s·C + c) to the reference's
    channels-first (c·e³ + s) patch order."""
    sd = _numpy(sd)
    n = sum(k.startswith("fc") and k.endswith(".weight") for k in sd)
    out = {}
    for i in range(n + 1):
        name = f"fc{i}" if i < n else "out"
        w = sd[f"{name}.weight"]
        if i == 0:
            width, n_in = w.shape
            e3 = patch_extent ** 3
            w = w.reshape(width, e3, n_in // e3).transpose(0, 2, 1).reshape(width, n_in)
        out[f"encoder.{2 * i}.weight"] = np.ascontiguousarray(w)
        out[f"encoder.{2 * i}.bias"] = sd[f"{name}.bias"]
    return out


def export_refinement_state_dict(params: dict, task: str = "superresolution",
                                 attn_patch_extent: int = 4) -> dict[str, np.ndarray]:
    """The port's refinement sub-networks' state_dicts (unet_backbone,
    decoder, retrieval_backbone, patched_attention_block) -> a reference
    refinement state_dict (numpy): the inverse of import_refinement_checkpoint
    for the task's backbone."""
    def modules(names: dict):  # the port's first key part -> the reference's
        return lambda k: _reference_key(names[k.partition(".")[0]] + "." + k.partition(".")[2])

    out = {}
    backbone = {"unet": "network"} if task != "superresolution" else \
        {"unet": "network.0", "up0": "network.1", "up1": "network.2"}
    out.update(_renamed(params["unet_backbone"], "unet_backbone.", modules(backbone)))
    out.update(_renamed(params["decoder"], "decoder.",
                        modules({"up0": "network.0", "final_conv": "network.1"})))
    out.update(_renamed(params["retrieval_backbone"], "retrieval_backbone.",
                        modules({"unet": "network"})))
    pre = "patched_attention_block.attention_blocks_layer."
    att = _strip(params["patched_attention_block"], "attention_blocks_layer")
    for mlp in ("theta", "phi"):
        out.update({f"{pre}{mlp}.{k}": v for k, v in _export_attention_encoder(
            _strip(att, mlp), attn_patch_extent // 2).items()})
    rest = {k: v for k, v in att.items() if not k.startswith(("theta.", "phi."))}
    out.update(_renamed(rest, pre, lambda k: k))
    return out


def export_retrieval_state_dict(params: dict) -> dict[str, np.ndarray]:
    """The port's retrieval encoders' state_dicts {fenc_input, fenc_target}
    -> a reference retrieval state_dict (numpy): conv{i} at layers.{2i}, or
    at layers.{3i} with its BatchNorm (and running statistics) at 3i + 1,
    final_layer as is; an MLP's fc{i} at layers.{2i} and final_layer at the
    next. The inverse of import_retrieval_checkpoint."""
    out = {}
    for name in ("fenc_input", "fenc_target"):
        sd = params[name]
        bn = any(k.startswith("bn") for k in sd)
        n_fc = sum(k.startswith("fc") and k.endswith(".weight") for k in sd)

        def rename(k: str) -> str:
            head, _, rest = k.partition(".")
            if head == "final_layer":
                return k if n_fc == 0 else f"layers.{2 * n_fc}.{rest}"
            i = int(head[2:] if head.startswith(("fc", "bn")) else head[4:])
            if head.startswith("fc"):
                return f"layers.{2 * i}.{rest}"
            return f"layers.{(3 if bn else 2) * i + head.startswith('bn')}.{rest}"
        out.update(_renamed(sd, f"{name}.", rename))
    return out
