"""The other tasks' networks, their kernels' widths and their data, against
the JAX package, on the CPU.

Every module new to the port (the 16³ super-resolution and the
surface-reconstruction backbones, the BatchNorm layer order, ExtResNetBlock,
the transposed conv and the summing decoder, UNet3D's final conv,
ResidualUNet3D, unfold3d_pad_stride) gets a flax param tree of numpy values,
carried across by the weight bridge, and the same numpy inputs as its JAX
counterpart: float32, max |diff| <= 1e-5 of the output's largest
magnitude. The attention kernels' plain versions at F = 96 (nf 12) and the
decoder tail's at nf 12 are held against the Pallas kernels in interpret
mode, as tests/test_torch_port_kernels.py holds them at F = 128 and nf 4
(atol 1e-5 and 2e-5). The surface-reconstruction data path (SceneHandler's
occupancy grid, a PatchedSceneDataset item) is held bit-equal to the JAX
package's. The port's YAML tree holds the JAX package's files,
chip_smoke.py's phase-9 configs are pinned to those YAMLs, and the engine's
kernel limits are held at nf 12.
"""

import random
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch import nn

import chip_smoke
from retrieval_fuse_tpu import config as jconfig
from retrieval_fuse_tpu import models as jmodels
from retrieval_fuse_tpu.data import PatchedSceneDataset as JaxDataset, SceneHandler as JaxScenes
from retrieval_fuse_tpu.data import synthetic as jsynth
from retrieval_fuse_tpu.models import unet as junet
from retrieval_fuse_tpu.ops import fused_decoder as jfd
from retrieval_fuse_tpu.ops.fold3d import unfold3d_pad_stride as jax_unfold_pad_stride
from retrieval_fuse_tpu.ops.pallas_attention import (
    pallas_gathered_patch_attention, pallas_gathered_patch_attention_v2, pallas_patch_attention)
from retrieval_fuse_tpu.ops.pallas_decoder import (
    pack_conv2_imcol_kernel, pack_head_kernel, packed_decoder_tail)
from retrieval_fuse_tpu_torch import config as tconfig
from retrieval_fuse_tpu_torch import models as tmodels
from retrieval_fuse_tpu_torch.data import PatchedSceneDataset, SceneHandler
from retrieval_fuse_tpu_torch.inference import (
    RetrieveRefineEngine, check_kernel_limits, variant_engine_kwargs)
from retrieval_fuse_tpu_torch.models import unet as tunet
from retrieval_fuse_tpu_torch.ops import decoder_tail as dt
from retrieval_fuse_tpu_torch.ops import fused_decoder as tfd
from retrieval_fuse_tpu_torch.ops import patch_attention as pa
from retrieval_fuse_tpu_torch.ops.fold3d import unfold3d_pad_stride
from retrieval_fuse_tpu_torch.utils.flax_import import flax_to_state_dict
from test_torch_port_cuda import attention_inputs
from test_torch_port_kernels import _flax_mlp
from test_torch_port_models import flax_params
from test_torch_port_models import torch_threads  # noqa: F401 (autouse fixture)

#: max |port - JAX| as a share of the output's largest magnitude (float32)
REL_TOL = 1e-5
#: the U-Net backbones' GroupNorm chains (5 levels, 20 GroupNorms at nf 12)
#: amplify float32 rounding: against the JAX float64 forward, JAX's own
#: float32 lies 1.3e-5 (16³) and 6.3e-5 (surface) of the largest magnitude
#: away, the port's float32 3.8e-6 and 1.1e-5. So the backbones are held in
#: float64 at REL_TOL (they read ~1e-13) and in float32 against the float64
#: forward at GN_F32_TOL
GN_F32_TOL = 5e-5
#: softmax selection at sharpness 1024 turns a score's float32 order
#: difference (~1e-7) into a weight difference of ~1e-4, so the blended rows
#: of near-tied candidates may differ by that much (ROADMAP hazards); hard
#: selection is held at 1e-5
SOFTMAX_ATOL = 1e-4


def batch_stats(module, *inputs, seed=0):
    """BatchNorm running statistics for a flax module, from numpy: means
    U(±0.1), variances U(0.5, 1.5)."""
    key = jax.random.PRNGKey(0)
    shapes = jax.eval_shape(module.init, {"params": key}, *inputs)["batch_stats"]
    rng = np.random.default_rng(seed)

    def fill(path, leaf):
        lo, hi = (-0.1, 0.1) if path[-1].key == "mean" else (0.5, 1.5)
        return rng.uniform(lo, hi, leaf.shape).astype(np.float32)

    return jax.tree_util.tree_map_with_path(fill, shapes)


def assert_close(got: torch.Tensor, want) -> None:
    want = np.asarray(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    scale = max(float(np.abs(want).max()), 1e-30)
    err = float(np.abs(got.detach().numpy() - want).max())
    assert err <= REL_TOL * scale, (err, scale)


def ncdhw(x: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(x).permute(0, 4, 1, 2, 3)


def ndhwc(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, 2, 3, 4, 1)


def _port(module: nn.Module, params, stats=None) -> nn.Module:
    module.load_state_dict(flax_to_state_dict(params, stats))
    return module


# ------------------------------------------------------------ the config tree

JAX_CONFIG = Path(jconfig.__file__).resolve().parent
YAMLS = sorted(str(p.relative_to(JAX_CONFIG)) for p in JAX_CONFIG.rglob("*.yaml"))


def test_the_port_reads_no_yaml_of_the_jax_package():
    """The port's tree holds a copy of every YAML of the JAX package's and
    no other (test_torch_port_retrieval.py pins each byte for byte)."""
    assert tconfig.CONFIG_ROOT == Path(tconfig.__file__).resolve().parent
    assert sorted(str(p.relative_to(tconfig.CONFIG_ROOT))
                  for p in tconfig.CONFIG_ROOT.rglob("*.yaml")) == YAMLS
    rel = Path("surface_reconstruction") / "3DFront" / "refinement_128_064.yaml"
    assert tconfig.read_config(tconfig.CONFIG_ROOT / rel) == jconfig.read_config(JAX_CONFIG / rel)


def _merged_serving_yamls(refinement: str, retrieval: str) -> dict:
    """The two YAMLs merged as data/synthetic.make_synthetic_config merges
    them: the retrieval config's keys win."""
    cfg = tconfig.read_config(tconfig.CONFIG_ROOT / retrieval)
    for key, value in tconfig.read_config(tconfig.CONFIG_ROOT / refinement).items():
        cfg.setdefault(key, value)
    return cfg


@pytest.mark.parametrize("name, refinement, retrieval", [
    ("surface_config", "surface_reconstruction/3DFront/refinement_128_064.yaml",
     "surface_reconstruction/3DFront/retrieval_128_064.yaml"),
    ("superres16_config", "super_resolution/Matterport3D/refinement_016_064.yaml",
     "super_resolution/Matterport3D/retrieval_016_064.yaml")])
def test_chip_smoke_phase9_configs_are_the_yamls(name, refinement, retrieval):
    """chip_smoke.py builds phase 9's serving configs in code: each key is
    the merged YAMLs' value; the engine's retrieval geometry is the input
    encoder's network code and the target patch size; serving takes the
    refinement config's K."""
    got = getattr(chip_smoke, name)()
    want = _merged_serving_yamls(refinement, retrieval)
    ps, ctx = (int(v) for v in want["retrieval_model"]["network_input"]
               .replace("pc_", "").split("+"))
    geometry = {"retrieval_patch_size_input": ps, "retrieval_patch_context_input": ctx,
                "retrieval_patch_size_target": want["dataset_train"]["patch_size_target"]}
    for key, value in got.items():
        if key in geometry:
            assert value == geometry[key], key
        elif isinstance(value, dict):
            for sub, v in value.items():
                assert v == want[key][sub], (key, sub)
        else:
            assert value == want[key], key
    assert got["K"] == tconfig.read_config(tconfig.CONFIG_ROOT / refinement)["K"] == 4
    assert set(tmodels.build_modules(got)) == {"fenc_input", "unet_backbone", "decoder",
                                              "retrieval_backbone", "patched_attention_block"}


# --------------------------------------------------------------- the modules

@pytest.mark.parametrize("task, ics, cls", [
    ("superresolution", 8, "Superresolution08UNetBackbone"),
    ("superresolution", 16, "Superresolution16UNetBackbone"),
    ("surface_reconstruction", 128, "SurfaceReconstructionUNetBackbone")])
def test_get_unet_backbone_picks_the_jax_class(task, ics, cls):
    cfg = {"task": task, "nf": 12, "unet_num_level": 5, "layer_order": "gcr",
           "dataset_train": {"input_chunk_size": ics}}
    assert type(jmodels.get_unet_backbone(cfg)).__name__ == cls
    assert type(tmodels.get_unet_backbone(cfg)).__name__ == cls


def test_get_unet_backbone_refuses_what_jax_refuses():
    cfg = {"task": "superresolution", "nf": 4, "unet_num_level": 4, "layer_order": "gcr",
           "dataset_train": {"input_chunk_size": 32}}
    with pytest.raises(ValueError, match="no backbone"):
        jmodels.get_unet_backbone(cfg)
    with pytest.raises(ValueError, match="no backbone"):
        tmodels.get_unet_backbone(cfg)


@pytest.mark.parametrize("order, train", [("cbr", True), ("cbr", False), ("bcl", True),
                                          ("bcl", False)])
def test_single_conv_batchnorm_matches_flax(order, train):
    """Order 'b' in train mode (batch statistics, running ones updated with
    momentum 0.9) and in eval mode (running statistics), before and after
    the conv."""
    x = np.random.default_rng(0).standard_normal((2, 5, 5, 5, 3)).astype(np.float32)
    jm = junet.SingleConv(6, 3, order, 2)
    params, stats = flax_params(jm, x, seed=1), batch_stats(jm, x, seed=2)
    want, upd = jm.apply({"params": params, "batch_stats": stats}, jnp.asarray(x), train,
                         mutable=["batch_stats"])
    tm = _port(tunet.SingleConv(3, 6, 3, order, 2), params, stats).train(train)
    with torch.no_grad():
        got = ndhwc(tm(ncdhw(x)))
    assert_close(got, want)
    assert "bias" not in params["conv"] and tm.conv.bias is None
    new = flax_to_state_dict(params, upd["batch_stats"])
    for key in ("batchnorm.running_mean", "batchnorm.running_var"):
        np.testing.assert_allclose(tm.state_dict()[key].numpy(), new[key].numpy(), atol=1e-6)


@pytest.mark.parametrize("order", ["cge", "cbl", "crg"])
def test_ext_resnet_block_matches_flax(order):
    x = np.random.default_rng(3).standard_normal((2, 4, 4, 4, 4)).astype(np.float32)
    jm = junet.ExtResNetBlock(8, order=order, num_groups=2)
    params = flax_params(jm, x, seed=4)
    variables = {"params": params}
    stats = None
    if "b" in order:
        stats = batch_stats(jm, x, seed=5)
        variables["batch_stats"] = stats
    want = jm.apply(variables, jnp.asarray(x))
    tm = _port(tunet.ExtResNetBlock(4, 8, order=order, num_groups=2), params, stats).eval()
    with torch.no_grad():
        got = ndhwc(tm(ncdhw(x)))
    assert_close(got, want)


class _Up(nn.Module):
    def __init__(self, cin, cout):
        super().__init__()
        self.upconv = tunet.torch_conv_transpose_2x(cin, cout)


def test_transposed_conv_2x_matches_flax():
    """ConvTranspose3d(k=3, s=2, p=1, output_padding=1) with the weight
    bridge's flipped kernel equals TorchConvTranspose2x's correlation."""
    x = np.random.default_rng(6).standard_normal((2, 3, 4, 5, 3)).astype(np.float32)
    jm = junet.TorchConvTranspose2x(5)
    params = flax_params(jm, x, seed=7)
    want = jm.apply({"params": params}, jnp.asarray(x))
    tm = _port(_Up(3, 5), {"upconv": params})
    with torch.no_grad():
        got = ndhwc(tm.upconv(ncdhw(x)))
    assert got.shape == (2, 6, 8, 10, 5)
    assert_close(got, want)


def test_summing_decoder_matches_flax():
    """The Decoder of ExtResNetBlocks: transposed conv to the skip's width,
    sum, block."""
    rng = np.random.default_rng(8)
    skip = rng.standard_normal((2, 8, 8, 8, 4)).astype(np.float32)
    x = rng.standard_normal((2, 4, 4, 4, 8)).astype(np.float32)
    jm = junet.Decoder(4, basic_module="ExtResNetBlock", conv_layer_order="cge", num_groups=2)
    params = flax_params(jm, skip, x, seed=9)
    want = jm.apply({"params": params}, jnp.asarray(skip), jnp.asarray(x))
    tm = _port(tunet.Decoder(4, 8, 4, basic_module="ExtResNetBlock", conv_layer_order="cge",
                             num_groups=2), params)
    with torch.no_grad():
        got = ndhwc(tm(ncdhw(skip), ncdhw(x)))
    assert_close(got, want)


@pytest.mark.parametrize("kind, out, kw", [
    ("unet", 3, dict(final_conv=True)),
    ("unet", 3, dict(final_conv=True, is_segmentation=True, testing=True)),
    ("unet", 3, dict(final_conv=True, is_segmentation=True, testing=True, final_sigmoid=True)),
    ("residual", 4, dict()),  # the last summing join: out channels = f_maps[0]
    ("residual", 3, dict(final_conv=True, remove_n_final_layers=1))])
def test_unet_final_conv_and_residual_unet_match_flax(kind, out, kw):
    x = np.random.default_rng(10).standard_normal((1, 8, 8, 8, 1)).astype(np.float32)
    jcls, tcls = {"unet": (junet.UNet3D, tunet.UNet3D),
                  "residual": (junet.ResidualUNet3D, tunet.ResidualUNet3D)}[kind]
    jm = jcls(out_channels=out, f_maps=4, num_groups=2, num_levels=3, **kw)
    params = flax_params(jm, x, seed=11)
    want = jm.apply({"params": params}, jnp.asarray(x))
    tm = _port(tcls(1, out, f_maps=4, num_groups=2, num_levels=3, **kw), params)
    with torch.no_grad():
        got = ndhwc(tm(ncdhw(x)))
    assert_close(got, want)


@pytest.mark.parametrize("name, nf, side", [("superres16", 4, 16), ("surface", 12, 32)])
def test_task_backbones_match_flax(name, nf, side):
    """Superresolution16UNetBackbone (16³ -> 32³) and
    SurfaceReconstructionUNetBackbone at nf 12 (5 levels, the two finest
    decoders removed: 32³ -> 8³; GroupNorm of nf // 2 = 6 groups)."""
    jcls, tcls = {"superres16": (jmodels.Superresolution16UNetBackbone,
                                 tmodels.Superresolution16UNetBackbone),
                  "surface": (jmodels.SurfaceReconstructionUNetBackbone,
                              tmodels.SurfaceReconstructionUNetBackbone)}[name]
    levels = 4 if name == "superres16" else 5
    x = np.random.default_rng(12).standard_normal((2, side, side, side, 1)).astype(np.float32)
    jm = jcls(nf=nf, num_levels=levels)
    params = flax_params(jm, x, seed=13)
    with jax.enable_x64():
        p64 = jax.tree_util.tree_map(lambda a: jnp.asarray(a, jnp.float64), params)
        want = np.asarray(jax.jit(jm.apply)({"params": p64}, jnp.asarray(x, jnp.float64)))
    tm = _port(tcls(nf=nf, num_levels=levels), params)
    with torch.no_grad():
        got = tm(torch.from_numpy(x))
        got64 = tm.double()(torch.from_numpy(x).double())
    out_side = 32 if name == "superres16" else side // 4
    assert got.shape == (2, out_side, out_side, out_side, nf)
    assert_close(got64, want)
    scale = float(np.abs(want).max())
    assert float(np.abs(got.numpy() - want).max()) <= GN_F32_TOL * scale


def test_final_decoders_match_jax_at_nf12():
    """The decoder every task shares, at nf 12 (GroupNorm of 6 groups of 2):
    the plain module and the fused one against theirs, the compact one (its
    tail's plain version, held against the Pallas tail below) against the
    plain flax module, which the JAX tests pin the compact decoder to; and
    GroupNorm on the packed (8·nf) layout against flax's statistics."""
    nf = 12
    dec = jmodels.Superresolution08FinalDecoder(nf=nf)
    x = np.random.default_rng(14).standard_normal((2, 8, 8, 8, nf)).astype(np.float32)
    params = flax_params(dec, x, seed=15)
    want = jax.jit(dec.apply)({"params": params}, jnp.asarray(x))
    sd = flax_to_state_dict(params)
    plain = _port(tmodels.Superresolution08FinalDecoder(nf=nf), params)
    with torch.no_grad():
        assert_close(plain(torch.from_numpy(x)), want)
        assert_close(tfd.FusedFinalDecoder(sd, nf)(torch.from_numpy(x)),
                     jfd.FusedFinalDecoder(params, nf)(jnp.asarray(x)))
        assert_close(dt.CompactPackedDecoder(sd, nf)(torch.from_numpy(x)), want)
    rng = np.random.default_rng(16)
    packed = rng.standard_normal((2, 3, 3, 3, 8 * nf)).astype(np.float32)
    scale, bias = rng.uniform(0.5, 1.5, nf).astype(np.float32), rng.uniform(-.1, .1, nf).astype(
        np.float32)
    assert_close(tfd.group_norm_packed(torch.from_numpy(packed), torch.from_numpy(scale),
                                       torch.from_numpy(bias), nf // 2, nf),
                 jfd.group_norm_packed(jnp.asarray(packed), scale, bias, nf // 2, nf))


@pytest.mark.parametrize("e, pad, stride, side", [(48, 8, 32, 64), (8, 2, 4, 16), (3, 1, 2, 5)])
def test_unfold3d_pad_stride_matches_jax(e, pad, stride, side):
    x = np.random.default_rng(17).standard_normal((2, side, side, side, 2)).astype(np.float32)
    want = np.asarray(jax_unfold_pad_stride(jnp.asarray(x), e, pad, 0.25, stride))
    got = unfold3d_pad_stride(torch.from_numpy(x), e, pad, 0.25, stride)
    np.testing.assert_array_equal(got.numpy(), want)


# ------------------------------------------------- the kernels' plain versions

@pytest.mark.parametrize("kernel", ["v2", "v1", "patch"])
@pytest.mark.parametrize("retrieval_mode", [True, False], ids=["hard", "softmax"])
def test_attention_plain_at_f96_matches_pallas(kernel, retrieval_mode):
    """F = 96 (nf 12, e 2): the three attention kernels' plain versions
    against their Pallas kernels in interpret mode, f32, atol 1e-5 (hard)
    and SOFTMAX_ATOL (softmax)."""
    k = 4
    xt, bank, idx, theta, phi = attention_inputs(np.random.default_rng(18), 5, 7, 64, 96, k)
    jt, jp = _flax_mlp(theta), _flax_mlp(phi)
    kw = dict(retrieval_mode=retrieval_mode, sharpness=1024.0)
    with torch.no_grad():
        if kernel == "patch":
            x, p = xt.reshape(-1, 96), bank.reshape(-1, 96)[
                np.random.default_rng(19).integers(0, 7 * 64, (5 * 64, k))]
            want = pallas_patch_attention(jnp.asarray(x), jnp.asarray(p), jt, jp, k, tile=512,
                                          interpret=True, **kw)
            got = pa.patch_attention(torch.from_numpy(x), torch.from_numpy(p), theta, phi, k,
                                     **kw)
        else:
            args = (jnp.asarray(xt), jnp.asarray(bank), jnp.asarray(idx), jt, jp, k)
            want = (pallas_gathered_patch_attention_v2(*args, group=4, interpret=True, **kw)
                    if kernel == "v2" else
                    pallas_gathered_patch_attention(*args, interpret=True, **kw))
            fn = pa.gathered_patch_attention if kernel == "v2" else pa.gathered_patch_attention_v1
            got = fn(torch.from_numpy(xt), torch.from_numpy(bank), torch.from_numpy(idx), theta,
                     phi, k, **kw)
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               atol=1e-5 if retrieval_mode else SOFTMAX_ATOL)
    assert not np.allclose(got.numpy(), np.asarray(xt).reshape(got.shape))


def test_decoder_tail_plain_at_nf12_matches_pallas():
    """decoder_tail_plain against packed_decoder_tail (interpret) at nf 12,
    atol 2e-5, as test_torch_port_kernels.py holds nf 4."""
    rng = np.random.default_rng(20)
    nf, s = 12, 5
    w2 = (rng.standard_normal((3, 3, 3, nf, nf)) / np.sqrt(27 * nf)).astype(np.float32)
    wh = (rng.standard_normal((nf, 1)) / np.sqrt(nf)).astype(np.float32)
    xp = rng.standard_normal((1, s, s, s, 8 * nf)).astype(np.float32)
    want = packed_decoder_tail(
        jnp.pad(jnp.asarray(xp), ((0, 0), (1, 1), (1, 1), (1, (-(s + 2)) % 8 + 1), (0, 0))),
        jnp.asarray(pack_conv2_imcol_kernel(w2)), jnp.asarray(pack_head_kernel(wh)), -0.2,
        t0=s, interpret=True)
    hn = torch.nn.functional.pad(torch.from_numpy(xp), (0, 0, 1, 1, 1, 1, 1, 1))
    got = dt.decoder_tail(hn, torch.from_numpy(w2), torch.from_numpy(wh[:, 0]), -0.2)
    assert got.shape == (1, s, s, s, 8)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-5)


# ------------------------------------------------------------- kernel limits

#: the 3DFront surface-reconstruction serving config (chip_smoke.py phase 9a)
SURFACE = chip_smoke.surface_config()

#: every variant the JAX engine serves the 3DFront surface-reconstruction
#: config with: all but `phib` (hard selection only) and `fbb` (8³ only)
SURFACE_VARIANTS = ["base", "fused+pallasg2+topk1p", "fused+pallasg2+topk1p+cdec",
                    "fused+pallasp+topk1p+cdec", "fused+pallasg+topk1p+packed",
                    "pallas+dconv", "fused+flatg+pallasp", "approxk+fused", "cdec",
                    "pallasg2+streamknn", "pallasg+denseknn"]


@pytest.mark.parametrize("variant", SURFACE_VARIANTS)
def test_kernel_limits_take_the_surface_config(variant):
    """nf 12 (F = 96, T = 64, K 4, S = 32) is inside every kernel's limits,
    in bf16 and in float32 (v1 stages 5 float32 tiles of F = 96)."""
    kw = variant_engine_kwargs(variant)
    for dtype in (torch.bfloat16, torch.float32):
        check_kernel_limits(SURFACE, torch.device("cuda"), kw["attention"], kw["decoder"], dtype)


@pytest.mark.parametrize("variant, token", [("fused+fbb", "fused backbone"),
                                            ("phib+fused", "hard selection")])
def test_surface_engine_refuses_what_jax_refuses(variant, token):
    """The fused backbone covers 8³ inputs and the phi bank hard selection,
    as the JAX engine's asserts say; the port raises at build."""
    with pytest.raises(ValueError, match=token):
        RetrieveRefineEngine(SURFACE, tmodels.init_params(SURFACE, 0),
                             np.zeros((4, 64), np.float32), device="cpu",
                             feature_bank=np.zeros((4, 8, 8, 8, 12), np.float32),
                             **variant_engine_kwargs(variant))


# -------------------------------------------------------------- the data path

@pytest.fixture(scope="module")
def surface_dataset(tmp_path_factory):
    """A synthetic surface-reconstruction dataset (pc_20K point clouds and
    64³ targets), written once by the JAX package's generator."""
    root = tmp_path_factory.mktemp("surface")
    jsynth.generate_synthetic_dataset(root, n_train=3, n_val=1, seed=5,
                                      task="surface_reconstruction", input_dir="pc_20K",
                                      target_dir="sdf_064")
    return root


def _surface_cfg(make, root, ctx):
    cfg = make(root, task="surface_reconstruction")
    for d in ("dataset_train", "dataset_val"):
        cfg[d].update(num_points=500, patch_size_input=128 if ctx == 0 else 32,
                      patch_context_input=ctx)
    return cfg


@pytest.mark.parametrize("ctx", [0, 8], ids=["refinement-128", "retrieval-128+8"])
def test_surface_scene_input_grid_matches_jax(surface_dataset, tmp_path, ctx, monkeypatch):
    """SceneHandler.get_scene_input: the 128³ occupancy grid of 500 points
    (with 8 voxels of context, 144³), voxelised from the same point indices
    (random.randint seeded alike), equal to the JAX package's."""
    from retrieval_fuse_tpu_torch.data import synthetic as tsynth
    monkeypatch.chdir(tmp_path)
    jsh = JaxScenes("train", _surface_cfg(jsynth.make_synthetic_config, surface_dataset, ctx))
    tsh = SceneHandler("train", _surface_cfg(tsynth.make_synthetic_config, surface_dataset, ctx))
    for scene in jsh.scenes[:2]:
        random.seed(3)
        want = jsh.get_scene_input(scene)
        random.seed(3)
        got = tsh.get_scene_input(scene)
        assert got.shape == (128 + 2 * ctx,) * 3
        np.testing.assert_array_equal(got, want)
        assert 0 < got.sum() <= 500


def test_surface_dataset_item_matches_jax(surface_dataset, tmp_path, monkeypatch):
    """A PatchedSceneDataset item of the retrieval geometry (48³ input
    windows of occupancy, 24³ target patches) equal to the JAX package's."""
    from retrieval_fuse_tpu_torch.data import synthetic as tsynth
    monkeypatch.chdir(tmp_path)
    jcfg = _surface_cfg(jsynth.make_synthetic_config, surface_dataset, 8)
    tcfg = _surface_cfg(tsynth.make_synthetic_config, surface_dataset, 8)
    jds = JaxDataset("train", jcfg["dataset_train"], JaxScenes("train", jcfg))
    tds = PatchedSceneDataset("train", tcfg["dataset_train"], SceneHandler("train", tcfg))
    assert len(tds) == len(jds) > 0
    for i in (0, len(jds) - 1):
        random.seed(7)
        want = jds[i]
        random.seed(7)
        got = tds[i]
        assert got["input"].shape == (48, 48, 48, 1) and got["target"].shape == (24, 24, 24, 1)
        for key in ("input", "target"):
            np.testing.assert_array_equal(np.asarray(got[key]), np.asarray(want[key]))


def test_serving_geometry_follows_the_input_code():
    """serve.build_engine_from_artifacts takes the engine's query patches
    from the input encoder's code: patch size + 2·context is the window
    each input encoder reads (48 for `pc_32+8`, 8 for `4+2`, 4 for `2+1`)."""
    from retrieval_fuse_tpu_torch.models.encoders import INPUT_CODE_TO_ENCODER, make_encoder
    from retrieval_fuse_tpu_torch.serve import code_geometry
    assert code_geometry("pc_32+8") == (32, 8) and code_geometry("4+2N") == (4, 2)
    for code, name in INPUT_CODE_TO_ENCODER.items():
        ps, ctx = code_geometry(code)
        side = ps + 2 * ctx
        enc = make_encoder(name, 2, 8).eval()
        with torch.no_grad():
            out = enc(torch.zeros((1, side, side, side, 1)))
        assert out.shape == (1, 1, 1, 1, 8), (code, side)
