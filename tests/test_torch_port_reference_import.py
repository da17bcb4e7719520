"""The import of the reference implementation's PyTorch checkpoints
(utils/reference_import.py) against the JAX package's utils/torch_import.py,
on the CPU.

No reference checkpoint is needed: flax params of every checkpoint kind
(the 8³ and 16³ super-resolution and the surface-reconstruction refinement
networks at nf 4, the retrieval MLP encoder, and the conv encoders with and
without BatchNorm, with running statistics) are made from seeded numpy and
written in the reference's state_dict layout by `export_*` below, the
inverse of the JAX import. Held: the JAX import gives the params back
exactly; the port's import equals flax_import.flax_to_state_dict of the JAX
import, tensor for tensor; the port's modules with the imported weights
give the flax modules' outputs within 1e-5 of the largest magnitude, in
float64 and in float32 against flax's float64 (the U-Net backbones' float32
at GN_F32_TOL, as tests/test_torch_port_tasks.py holds them).
"""

import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from retrieval_fuse_tpu import models as jmodels
from retrieval_fuse_tpu.utils import torch_import as jti
from retrieval_fuse_tpu_torch import models as tmodels
from retrieval_fuse_tpu_torch.utils import reference_import as ri
from retrieval_fuse_tpu_torch.utils.flax_import import flax_to_state_dict
from test_torch_port_engine import CFG as SR08_CFG
from test_torch_port_models import flax_params
from test_torch_port_tasks import GN_F32_TOL, batch_stats
from test_torch_port_models import torch_threads  # noqa: F401 (autouse fixture)

REL_TOL = 1e-5
NF = 4
SR16_CFG = dict(chip_smoke.superres16_config(), nf=NF, K=2)
SURFACE_CFG = dict(chip_smoke.surface_config(), nf=NF, K=2, retrieval_fmaps=NF)
#: (config, input chunk side of the backbone) of each refinement kind
REFINEMENT = {"superres08": (SR08_CFG, 8), "superres16": (SR16_CFG, 16),
              "surface": (SURFACE_CFG, 32)}


# ---------------------------------------------------- reference-layout export


def export_tree(tree, prefix: str, out: dict, transposed: bool = False) -> dict:
    """A flax module's params -> reference state_dict entries under
    `prefix`: encoders_i / decoders_i -> encoders.i / decoders.i, upconv ->
    upsampling.upsample (a ConvTranspose3d), kernel -> weight in torch
    layout, scale -> weight."""
    for name, leaf in tree.items():
        key = "upsampling.upsample" if name == "upconv" else re.sub(
            r"^(encoders|decoders)_(\d+)$", r"\1.\2", name)
        if isinstance(leaf, dict):
            export_tree(leaf, f"{prefix}{key}.", out, transposed=name == "upconv")
            continue
        a = np.asarray(leaf)
        if name == "kernel":
            if transposed:
                a = a[::-1, ::-1, ::-1].transpose(3, 4, 0, 1, 2)
            else:
                a = a.transpose(4, 3, 0, 1, 2) if a.ndim == 5 else a.T
            key = "weight"
        elif name == "scale":
            key = "weight"
        out[prefix + key] = np.ascontiguousarray(a)
    return out


def export_attention_encoder(p: dict, prefix: str, patch_extent: int, out: dict) -> None:
    """fc0.. and out -> encoder.{2i}; the first kernel's rows back from the
    channels-last (s·C + c) to the reference's channels-first (c·e³ + s)."""
    n = len(p) - 1
    for i in range(n + 1):
        layer = p[f"fc{i}"] if i < n else p["out"]
        kernel = np.asarray(layer["kernel"])
        if i == 0:
            n_in, width = kernel.shape
            e3 = patch_extent ** 3
            kernel = kernel.reshape(e3, n_in // e3, width).transpose(1, 0, 2).reshape(n_in, width)
        out[f"{prefix}encoder.{2 * i}.weight"] = np.ascontiguousarray(kernel.T)
        out[f"{prefix}encoder.{2 * i}.bias"] = np.asarray(layer["bias"])


def export_refinement(params: dict, kind: str, patch_extent: int = 2) -> dict:
    sd = {}
    bb = params["unet_backbone"]
    if kind == "surface":
        export_tree(bb["unet"], "unet_backbone.network.", sd)
    else:
        for j, name in enumerate(("unet", "up0", "up1")):
            if name in bb:
                export_tree(bb[name], f"unet_backbone.network.{j}.", sd)
    export_tree(params["decoder"]["up0"], "decoder.network.0.", sd)
    export_tree(params["decoder"]["final_conv"], "decoder.network.1.", sd)
    export_tree(params["retrieval_backbone"]["unet"], "retrieval_backbone.network.", sd)
    att = params["patched_attention_block"]["attention_blocks_layer"]
    pre = "patched_attention_block.attention_blocks_layer."
    for mlp in ("theta", "phi"):
        export_attention_encoder(att[mlp], f"{pre}{mlp}.", patch_extent, sd)
    for name in ("sig_scale", "sig_shift"):
        sd[pre + name] = np.asarray(att[name])
    for conv in ("g", "o"):
        if conv in att:
            export_tree(att[conv], f"{pre}{conv}.", sd)
    return sd


def export_encoder(params: dict, stats: dict, prefix: str) -> dict:
    """A conv encoder (conv{i} at layers.{2i}, or layers.{3i} with its
    BatchNorm at 3i + 1) or an MLP (fc{i} at layers.{2i}, final_layer the
    last Linear) in the reference layout."""
    sd = {}
    if "conv0" in params:
        step = 3 if stats else 2
        for i in range(sum(k.startswith("conv") for k in params)):
            export_tree(params[f"conv{i}"], f"{prefix}layers.{step * i}.", sd)
            if stats:
                bn = f"{prefix}layers.{step * i + 1}."
                export_tree(params[f"bn{i}"], bn, sd)
                sd[bn + "running_mean"] = np.asarray(stats[f"bn{i}"]["mean"])
                sd[bn + "running_var"] = np.asarray(stats[f"bn{i}"]["var"])
                sd[bn + "num_batches_tracked"] = np.array(7)
        export_tree(params["final_layer"], f"{prefix}final_layer.", sd)
    else:
        n = sum(k.startswith("fc") for k in params)
        for i in range(n):
            export_tree(params[f"fc{i}"], f"{prefix}layers.{2 * i}.", sd)
        export_tree(params["final_layer"], f"{prefix}layers.{2 * n}.", sd)
    return sd


# ------------------------------------------------------------- fixtures


def refinement_inputs(cfg: dict, side: int, rng) -> dict:
    nf, k = cfg["nf"], cfg["K"]
    up = cfg["attn_num_patch"] * cfg["attn_patch_extent"] // 2
    r = lambda *shape: rng.standard_normal(shape).astype(np.float32)  # noqa: E731
    return {"unet_backbone": (r(1, side, side, side, 1),),
            "decoder": (r(1, 16, 16, 16, nf),),
            "retrieval_backbone": (r(1, 16, 16, 16, 1),),
            "patched_attention_block": (r(1, up, up, up, nf), r(k, up, up, up, nf))}


def refinement_modules(cfg: dict, jax_side: bool):
    m = jmodels if jax_side else tmodels
    kw = {"deterministic_selection": True}
    return {"unet_backbone": m.get_unet_backbone(cfg), "decoder": m.get_decoder(cfg),
            "retrieval_backbone": m.get_retrieval_backbone(cfg),
            "patched_attention_block": m.get_attention_block(cfg, **kw)}


@pytest.fixture(scope="module", params=sorted(REFINEMENT))
def refinement(request):
    kind = request.param
    cfg, side = REFINEMENT[kind]
    rng = np.random.default_rng(len(kind))
    inputs = refinement_inputs(cfg, side, rng)
    jm = refinement_modules(cfg, True)
    params = {name: flax_params(jm[name], *inputs[name], seed=i)
              for i, name in enumerate(jm)}
    sd = {k: torch.from_numpy(v.copy()) for k, v in export_refinement(params, kind).items()}
    task = cfg["task"]
    ics = cfg["dataset_train"]["input_chunk_size"]
    jax_tree = jti.import_refinement_checkpoint({k: v.numpy() for k, v in sd.items()}, task,
                                                ics, cfg["attn_patch_extent"])
    port = ri.import_refinement_checkpoint(sd, task, ics, cfg["attn_patch_extent"])
    return dict(kind=kind, cfg=cfg, inputs=inputs, params=params, sd=sd, jax=jax_tree,
                port=port, modules=jm)


def assert_trees_equal(got, want, path=""):
    assert isinstance(got, dict) == isinstance(want, dict), path
    if isinstance(want, dict):
        assert sorted(got) == sorted(want), (path, sorted(got), sorted(want))
        for k in want:
            assert_trees_equal(got[k], want[k], f"{path}/{k}")
        return
    g, w = np.asarray(got), np.asarray(want)
    assert g.shape == w.shape, path
    np.testing.assert_array_equal(g, w, err_msg=path)


def assert_state_dicts_equal(got: dict, want: dict) -> None:
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k].dtype == want[k].dtype == torch.float32, k
        assert torch.equal(got[k], want[k]), k


# ------------------------------------------------------------- refinement


def test_jax_import_of_the_export_gives_the_params_back(refinement):
    assert_trees_equal(refinement["jax"], refinement["params"])


def test_port_import_is_flax_import_of_the_jax_import(refinement):
    port, jax_tree = refinement["port"], refinement["jax"]
    assert sorted(port) == ["decoder", "patched_attention_block", "retrieval_backbone",
                            "unet_backbone"]
    for name in port:
        assert_state_dicts_equal(port[name], flax_to_state_dict(jax_tree[name]))


def test_port_modules_with_imported_weights_match_flax(refinement):
    """Each sub-network with the imported weights against the flax module
    in float64 (jax.enable_x64) at REL_TOL, and in float32 against that
    float64 forward: at REL_TOL, the U-Net backbones at GN_F32_TOL (their
    GroupNorm chains reach 1³ groups, which amplify float32 rounding: the
    8³ backbone's float32 lies ~2e-5 from float32 JAX). The decoder, the
    retrieval backbone and the attention import through the same code at
    every kind (held tensor for tensor above): their forwards are held at
    superres08 only."""
    tm = refinement_modules(refinement["cfg"], False)
    names = list(tm) if refinement["kind"] == "superres08" else ["unet_backbone"]
    for name in names:
        jm = refinement["modules"][name]
        x = refinement["inputs"][name]
        with jax.enable_x64():
            p64 = jax.tree_util.tree_map(lambda a: jnp.asarray(a, jnp.float64),
                                         refinement["params"][name])
            want = np.asarray(jax.jit(jm.apply)(
                {"params": p64}, *(jnp.asarray(a, jnp.float64) for a in x)))
        tm[name].load_state_dict(refinement["port"][name])
        with torch.no_grad():
            got = tm[name].eval()(*map(torch.from_numpy, x)).numpy()
            got64 = tm[name].double()(*(torch.from_numpy(a).double() for a in x)).numpy()
        assert got.shape == want.shape, name
        scale = float(np.abs(want).max())
        assert float(np.abs(got64 - want).max()) <= REL_TOL * scale, name
        tol = GN_F32_TOL if name.endswith("backbone") else REL_TOL
        assert float(np.abs(got - want).max()) <= tol * scale, name


# ------------------------------------------------------------- retrieval


@pytest.mark.parametrize("codes", [("2+1", "16+8"), ("4+2N", "16+8N")],
                         ids=["mlp-conv", "batchnorm"])
def test_retrieval_checkpoint_import(codes):
    """Both encoders, exported with their running statistics where they
    have BatchNorm: the JAX import (params and stats) gives them back, the
    port's import is flax_import of it, explicit and auto, and the port's
    encoders give the flax encoders' outputs (eval mode)."""
    mc = {"network_input": codes[0], "network_target": codes[1], "nf_input": 4,
          "nf_target": 2, "latent_dim": 16}
    jnets = jmodels.get_retrieval_networks(mc)
    rng = np.random.default_rng(3)
    sd, want_params, want_stats, xs = {}, {}, {}, {}
    for name, net, side in zip(("fenc_input", "fenc_target"), jnets,
                               (4 if codes[0] == "2+1" else 8, 32)):
        xs[name] = rng.standard_normal((2, side, side, side, 1)).astype(np.float32)
        want_params[name] = flax_params(net, jnp.asarray(xs[name]), seed=len(name))
        want_stats[name] = (batch_stats(net, jnp.asarray(xs[name]), seed=len(name))
                            if codes[1].endswith("N") and "conv0" in want_params[name] else {})
        sd.update(export_encoder(want_params[name], want_stats[name], f"{name}."))
    is_mlp = "conv0" not in want_params["fenc_input"]
    n_in = 0 if is_mlp else len(jnets[0].spec)
    jax_tree = jti.import_retrieval_checkpoint(sd, is_mlp, n_in, len(jnets[1].spec))
    assert_trees_equal(jax_tree, want_params)
    assert_trees_equal(jti.import_retrieval_checkpoint_auto(sd), want_params)
    tsd = {k: torch.from_numpy(np.asarray(v).copy()) for k, v in sd.items()}
    for port in (ri.import_retrieval_checkpoint(tsd, is_mlp, n_in, len(jnets[1].spec)),
                 ri.import_retrieval_checkpoint_auto(tsd)):
        for name in ("fenc_input", "fenc_target"):
            stats = jti.import_conv_encoder_stats(jti._strip(sd, name))
            assert_trees_equal(stats, want_stats[name])
            assert_state_dicts_equal(port[name], flax_to_state_dict(jax_tree[name], stats))
    tnets = tmodels.get_retrieval_networks(mc)
    for name, jnet, tnet in zip(("fenc_input", "fenc_target"), jnets, tnets):
        variables = {"params": want_params[name]}
        if want_stats[name]:
            variables["batch_stats"] = want_stats[name]
        want = np.asarray(jax.jit(jnet.apply)(variables, jnp.asarray(xs[name])))
        tnet.load_state_dict(port[name])
        with torch.no_grad():
            got = tnet.eval()(torch.from_numpy(xs[name])).numpy()
        scale = float(np.abs(want).max())
        assert got.shape == want.shape and float(np.abs(got - want).max()) <= REL_TOL * scale


def test_conv_encoder_count_is_checked():
    enc = {"conv0": {"kernel": np.zeros((3, 3, 3, 1, 2)), "bias": np.zeros(2)},
           "final_layer": {"kernel": np.zeros((2, 4)), "bias": np.zeros(4)}}
    sd = {**export_encoder(enc, {}, "fenc_input."), **export_encoder(enc, {}, "fenc_target.")}
    assert sorted(ri.import_retrieval_checkpoint(sd, False, 1, 1)["fenc_target"]) == \
        ["conv0.bias", "conv0.weight", "final_layer.bias", "final_layer.weight"]
    with pytest.raises(ValueError, match="expected 2 Conv3d layers"):
        ri.import_retrieval_checkpoint(sd, False, 1, 2)
