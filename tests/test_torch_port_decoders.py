"""The port's coarse-grid decoders and backbone against the JAX package's.

FusedFinalDecoder, PackedFinalDecoder, DecomposedPackedDecoder,
CompactPackedDecoder (its decoder tail run as the plain version here; the
JAX one in interpret mode) and FusedSuperres08Backbone get the same numpy
weights (through the weight bridge) and inputs as their JAX classes;
float32, atol 3e-5 (2e-4 for the backbone, whose GroupNorms amplify float32
summation-order differences). Their weight helpers are bit-equal to JAX's,
in float32 and in bf16, where the JAX engine sums the fused taps in bf16.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from retrieval_fuse_tpu.models.refinement import (
    Superresolution08FinalDecoder, Superresolution08UNetBackbone)
from retrieval_fuse_tpu.ops import fused_decoder as jfd
from retrieval_fuse_tpu.ops import pallas_decoder as jpd
from retrieval_fuse_tpu.ops.fused_backbone import FusedSuperres08Backbone as JaxFusedBackbone
from retrieval_fuse_tpu_torch.models.refinement import Superresolution08UNetBackbone as TorchBackbone
from retrieval_fuse_tpu_torch.ops import decoder_tail as tdt
from retrieval_fuse_tpu_torch.ops import fused_decoder as tfd
from retrieval_fuse_tpu_torch.ops.fused_backbone import FusedSuperres08Backbone
from retrieval_fuse_tpu_torch.utils.flax_import import flax_to_state_dict
from test_torch_port_models import flax_params
from test_torch_port_models import torch_threads  # noqa: F401 (autouse fixture)

NF = 4


@pytest.fixture(scope="module")
def decoder_setup():
    dec = Superresolution08FinalDecoder(nf=NF, layer_order="gcr")
    x = np.random.default_rng(1).standard_normal((2, 8, 8, 8, NF)).astype(np.float32)
    params = flax_params(dec, x, seed=6)
    return params, x


@pytest.mark.parametrize("name", ["fused", "packed", "decomposed", "compact"])
def test_decoder_matches_jax(decoder_setup, name):
    params, x = decoder_setup
    jax_cls, port_cls = {
        "fused": (jfd.FusedFinalDecoder, tfd.FusedFinalDecoder),
        "packed": (jfd.PackedFinalDecoder, tfd.PackedFinalDecoder),
        "decomposed": (jfd.DecomposedPackedDecoder, tfd.DecomposedPackedDecoder),
        "compact": (lambda p, nf: jpd.CompactPackedDecoder(p, nf, interpret=True),
                    tdt.CompactPackedDecoder),
    }[name]
    want = np.asarray(jax_cls(params, NF)(jnp.asarray(x)))
    with torch.no_grad():
        got = port_cls(flax_to_state_dict(params), NF)(torch.from_numpy(x))
    assert got.dtype == torch.float32 and got.shape == want.shape == (2, 16, 16, 16, 1)
    np.testing.assert_allclose(got.numpy(), want, atol=3e-5)


def test_fused_backbone_matches_jax():
    """The flagship width nf=16 (fused convs of 256 and 128 channels)."""
    nf, levels = 16, 4
    bb = Superresolution08UNetBackbone(nf=nf, num_levels=levels, layer_order="gcr")
    x = np.random.default_rng(1).standard_normal((1, 8, 8, 8, 1)).astype(np.float32)
    params = flax_params(bb, x, seed=1)
    want = np.asarray(JaxFusedBackbone(params, nf=nf, num_levels=levels)(
        params["unet"], jnp.asarray(x)))
    port = TorchBackbone(nf, levels, "gcr")
    port.load_state_dict(flax_to_state_dict(params))
    with torch.no_grad():
        got = FusedSuperres08Backbone(port.eval(), nf)(torch.from_numpy(x)).numpy()
    assert got.shape == want.shape == (1, 32, 32, 32, nf)
    np.testing.assert_allclose(got, want, atol=2e-4)


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_weight_helpers_bit_equal_to_jax(dtype):
    """Every packing helper, on values of the compute dtype: the JAX ones
    get the dtype's numpy arrays, the port's float32 arrays of the same
    values and the dtype to round each add to."""
    w = np.random.default_rng(0).standard_normal((3, 3, 3, NF, NF)).astype(np.float32)
    jdt, tdt_ = (jnp.float32, torch.float32) if dtype == "f32" else (jnp.bfloat16, torch.bfloat16)
    wj = np.asarray(jnp.asarray(w, jdt))
    wt = wj.astype(np.float32)

    def bits(a):
        return np.asarray(a).astype(np.float32).view(np.uint32)

    for jfn, tfn in ((jfd.fuse_upsample_conv_kernel, tfd.fuse_upsample_conv_kernel),
                     (jfd.pack_conv_kernel_2x, tfd.pack_conv_kernel_2x)):
        np.testing.assert_array_equal(bits(tfn(wt, tdt_)), bits(jfn(wj)))
    (jks, jpads), (tks, tpads) = jfd.decomposed_conv2_kernels(wj), tfd.decomposed_conv2_kernels(wt)
    assert jpads == tpads
    for a, b in zip(jks, tks):
        np.testing.assert_array_equal(bits(b), bits(a))
    np.testing.assert_array_equal(bits(tdt.pack_conv2_imcol_kernel(wt)),
                                  bits(jpd.pack_conv2_imcol_kernel(wj)))
    np.testing.assert_array_equal(bits(tdt.pack_head_kernel(wt[0, 0, 0, :, 0])),
                                  bits(jpd.pack_head_kernel(wj[0, 0, 0, :, 0])))


def test_fused_decoder_bf16_weights_bit_equal_to_jax_engine(decoder_setup):
    """In bf16 the JAX engine casts params first and then fuses them
    (inference.py:173-175, 219-222), so the fused taps are summed in bf16.
    The port's FusedFinalDecoder holds the same bits, which differ from
    summing in float32 and rounding once."""
    params, _ = decoder_setup
    cast = jax.tree_util.tree_map(lambda a: jnp.asarray(a, jnp.bfloat16), params)
    want = np.asarray(jfd.FusedFinalDecoder(cast, NF, dtype=jnp.bfloat16).w1_fused)
    port = tfd.FusedFinalDecoder(flax_to_state_dict(params), NF, torch.bfloat16)
    got = port.w1_fused.permute(2, 3, 4, 1, 0)                     # OIDHW -> DHWIO
    assert got.dtype == torch.bfloat16
    np.testing.assert_array_equal(got.float().numpy().view(np.uint32),
                                  want.astype(np.float32).view(np.uint32))
    w1 = np.asarray(cast["up0"]["basic_module"]["SingleConv1"]["conv"]["kernel"]).astype(np.float32)
    once = torch.from_numpy(tfd.fuse_upsample_conv_kernel(w1)).bfloat16().float().numpy()
    assert (once != got.float().numpy()).any()


def test_layout_and_norm_helpers_match_jax():
    rng = np.random.default_rng(2)
    x = rng.standard_normal((2, 3, 3, 3, 8 * NF)).astype(np.float32)
    np.testing.assert_array_equal(tfd.depth_to_space_2x(torch.from_numpy(x), NF).numpy(),
                                  np.asarray(jfd.depth_to_space_2x(jnp.asarray(x), NF)))
    x8 = x[..., :8]
    np.testing.assert_array_equal(tdt.depth_to_space_1ch(torch.from_numpy(x8)).numpy(),
                                  np.asarray(jpd.depth_to_space_1ch(jnp.asarray(x8))))
    scale, bias = rng.uniform(0.5, 1.5, NF).astype(np.float32), rng.uniform(-.1, .1, NF).astype(np.float32)
    ts, tb = torch.from_numpy(scale), torch.from_numpy(bias)
    np.testing.assert_allclose(
        tfd.group_norm_packed(torch.from_numpy(x), ts, tb, NF // 2, NF).numpy(),
        np.asarray(jfd.group_norm_packed(jnp.asarray(x), scale, bias, NF // 2, NF)), atol=1e-5)
    xn = x[..., :NF]
    np.testing.assert_allclose(tfd.group_norm(torch.from_numpy(xn), ts, tb, NF // 2).numpy(),
                               np.asarray(jfd.group_norm(jnp.asarray(xn), scale, bias, NF // 2)),
                               atol=1e-5)


def test_compact_decoder_bf16_tracks_fused_bf16(decoder_setup):
    """bf16: the compact decoder rounds at other places than the fused one
    (GN2 on the packed layout, the tail's float32 sums), within the bound
    the JAX test holds its two to (test_pallas_decoder.py:66-80)."""
    params, x = decoder_setup
    sd = flax_to_state_dict(params)
    xb = torch.from_numpy(x).bfloat16()
    with torch.no_grad():
        a = tfd.FusedFinalDecoder(sd, NF, torch.bfloat16)(xb)
        b = tdt.CompactPackedDecoder(sd, NF, torch.bfloat16)(xb)
    assert float((a - b).abs().max()) < 0.03
