"""The port at the widths past its kernels' shipped shapes, against the JAX
package on the CPU: the plain versions of the attention, decoder-tail and
topk kernels against their Pallas kernels (interpret=True, as the JAX tests
run them) at F = 48 and 432, K = 12 and 32, T = 27 and 8, nf 6 and 24 and
k = 12 and 32; the serving engine at nf 6 (F = 48) and K 12 against the JAX
engine; the operand layout of the kernels' general instances (the zero
padding of `_pack` and the B-fragment order of layer 0), emulated in the
kernels' own order of sums; and the flax bridge at those widths. The CUDA
general instances are held against the same plain versions in
test_torch_port_cuda.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from retrieval_fuse_tpu.inference import (
    RetrieveRefineEngine as JaxEngine, variant_engine_kwargs as jax_variant_kwargs)
from retrieval_fuse_tpu.models import (
    get_retrieval_networks, get_unet_backbone, get_decoder, get_retrieval_backbone,
    get_attention_block)
from retrieval_fuse_tpu.ops.knn import exact_knn as jax_exact_knn
from retrieval_fuse_tpu.ops.pallas_attention import (
    pallas_gathered_patch_attention, pallas_gathered_patch_attention_v2, pallas_patch_attention)
from retrieval_fuse_tpu.ops.pallas_decoder import (
    pack_conv2_imcol_kernel, pack_head_kernel, packed_decoder_tail)
from retrieval_fuse_tpu.ops.pallas_topk import pallas_topk
from retrieval_fuse_tpu_torch.inference import (
    FAST_VARIANT, RetrieveRefineEngine, variant_engine_kwargs)
from retrieval_fuse_tpu_torch.models.attention import AttentionFeatureEncoder
from retrieval_fuse_tpu_torch.ops import decoder_tail as dt
from retrieval_fuse_tpu_torch.ops import patch_attention as pa
from retrieval_fuse_tpu_torch.ops.topk import topk
from retrieval_fuse_tpu_torch.utils.flax_import import flax_engine_params, flax_to_state_dict
from test_torch_port_cuda import attention_inputs, tied_scores
from test_torch_port_models import CFG, flax_params
from test_torch_port_models import torch_threads  # noqa: F401 (autouse fixture)

#: (F, K, T) past the shipped shapes: nf 6 at e = 2 (F = 48, no multiple of
#: 32) with K 12 and T = 3³; the outer corner F = 16·3³ = 432 with K 32 and
#: T = 8
WIDE_SHAPES = [(48, 12, 27), (432, 32, 8)]


def _to_flax(m):
    return {n: {"kernel": getattr(m, n).weight.detach().numpy().T,
                "bias": getattr(m, n).bias.detach().numpy()} for n in pa._LAYERS}


def _flax_mlp(m):
    return {k: {"kernel": jnp.asarray(v["kernel"]), "bias": jnp.asarray(v["bias"])}
            for k, v in _to_flax(m).items()}


@pytest.mark.parametrize("retrieval_mode", [True, False], ids=["hard", "softmax"])
@pytest.mark.parametrize("kernel", ["v2", "v1", "patch"])
@pytest.mark.parametrize("f, k, t", WIDE_SHAPES, ids=[f"F{f}-K{k}-T{t}" for f, k, t in WIDE_SHAPES])
def test_attention_plain_matches_pallas_past_the_shipped_shapes(kernel, retrieval_mode, f, k, t):
    """Each attention kernel's plain version against its Pallas kernel at
    F and K past the shipped widths and T other than 64: float32, atol 1e-5
    (the shipped widths' tolerance); the switch open somewhere and more than
    one candidate selected. Two queries, v2 in groups of one: the Pallas
    kernels' interpret-mode compile grows with the group."""
    q, n = 2, 5
    xt, bank, idx, theta, phi = attention_inputs(np.random.default_rng(f + k), q, n, t, f, k)
    kw = dict(retrieval_mode=retrieval_mode, sharpness=1024.0)
    with torch.no_grad():
        if kernel == "patch":
            x = xt.reshape(-1, f)
            p = bank[idx].transpose(0, 2, 1, 3).reshape(q * t, k, f)
            want = pallas_patch_attention(jnp.asarray(x), jnp.asarray(p), _flax_mlp(theta),
                                          _flax_mlp(phi), k, tile=512, interpret=True, **kw)
            got, sel = pa.patch_attention(torch.from_numpy(x), torch.from_numpy(p), theta, phi,
                                          k, return_selection=True, **kw)
        else:
            pallas = (pallas_gathered_patch_attention_v2 if kernel == "v2"
                      else pallas_gathered_patch_attention)
            extra = dict(group=1) if kernel == "v2" else {}
            want = pallas(jnp.asarray(xt), jnp.asarray(bank), jnp.asarray(idx),
                          _flax_mlp(theta), _flax_mlp(phi), k, interpret=True, **extra, **kw)
            fn = pa.gathered_patch_attention if kernel == "v2" else pa.gathered_patch_attention_v1
            got, sel = fn(torch.from_numpy(xt), torch.from_numpy(bank), torch.from_numpy(idx),
                          theta, phi, k, return_selection=True, **kw)
    np.testing.assert_allclose(got.numpy().reshape(np.shape(want)), np.asarray(want), atol=1e-5)
    assert not np.allclose(got.numpy().reshape(xt.shape), xt)
    assert len(np.unique(sel.numpy())) > 1


@pytest.mark.parametrize("nf", [6, 24])
def test_decoder_tail_plain_matches_pallas_at_other_widths(nf):
    """decoder_tail_plain against packed_decoder_tail (interpret) at nf 6 and
    24, on test_torch_port_kernels.py's construction (S = 4; the JAX input
    carries the TPU's sublane pad of the minor axis); atol 2e-5."""
    rng = np.random.default_rng(nf)
    s2 = 8
    w2 = (rng.standard_normal((3, 3, 3, nf, nf)) / np.sqrt(27 * nf)).astype(np.float32)
    wh = (rng.standard_normal((nf, 1)) / np.sqrt(nf)).astype(np.float32)
    x = rng.standard_normal((2, s2, s2, s2, nf)).astype(np.float32)
    h = s2 // 2
    xp = x.reshape(2, h, 2, h, 2, h, 2, nf).transpose(0, 1, 3, 5, 2, 4, 6, 7)
    xp = xp.reshape(2, h, h, h, 8 * nf)
    want = packed_decoder_tail(
        jnp.pad(jnp.asarray(xp), ((0, 0), (1, 1), (1, 1), (1, (-(h + 2)) % 8 + 1), (0, 0))),
        jnp.asarray(pack_conv2_imcol_kernel(w2)), jnp.asarray(pack_head_kernel(wh)), -0.2,
        t0=2, interpret=True)
    hn = torch.nn.functional.pad(torch.from_numpy(xp), (0, 0, 1, 1, 1, 1, 1, 1))
    got = dt.decoder_tail(hn, torch.from_numpy(w2), torch.from_numpy(wh[:, 0]), -0.2)
    assert got.shape == (2, h, h, h, 8) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-5)


@pytest.mark.parametrize("k", [12, 32])
def test_topk_plain_matches_pallas_topk_at_wider_k(k):
    """k past the shipped 8: values and indices equal, tie order included,
    on raw and on bf16-rounded (tie-rich) scores."""
    sims = tied_scores(np.random.default_rng(k), 40, 700)
    for s in (sims, np.array(jnp.asarray(sims, jnp.bfloat16).astype(jnp.float32))):
        want_v, want_i = pallas_topk(jnp.asarray(s), k, tile_n=256, tile_q=32, interpret=True)
        got_v, got_i = topk(torch.from_numpy(s), k)
        np.testing.assert_array_equal(got_i.numpy(), np.asarray(want_i))
        np.testing.assert_array_equal(got_v.numpy(), np.asarray(want_v))


#: the engine at nf 6 (F = 6·2³ = 48) and K 12; the retrieval backbone's
#: f_maps follow nf, as in every YAML (its GroupNorms take nf / 2 groups)
WIDE_CFG = dict(CFG, nf=6, K=12, retrieval_fmaps=6)


def test_engine_matches_jax_at_nf6_k12():
    """The port's FAST_VARIANT engine against the JAX engine at nf 6, K 12
    (float32, the tiny geometry of test_inference.py, one chunk): the same
    param tree through the weight bridge, retrieved indices equal, TSDF
    atol 1e-4. The JAX engine serves `base`, whose variants the JAX tests
    pin equal to each other; its FAST_VARIANT compiles its Pallas kernels in
    interpret mode for a group of 32 tiles of 12 candidates, which takes a
    minute and a half on the CPU."""
    nf, k = WIDE_CFG["nf"], WIDE_CFG["K"]
    z = np.zeros
    params = {
        "fenc_input": flax_params(get_retrieval_networks(WIDE_CFG["retrieval_model"])[0],
                                  z((1, 4, 4, 4, 1), np.float32), seed=1),
        "unet_backbone": flax_params(get_unet_backbone(WIDE_CFG), z((1, 8, 8, 8, 1), np.float32),
                                     seed=2),
        "decoder": flax_params(get_decoder(WIDE_CFG), z((1, 32, 32, 32, nf), np.float32),
                               seed=3),
        "retrieval_backbone": flax_params(get_retrieval_backbone(WIDE_CFG),
                                          z((1, 16, 16, 16, 1), np.float32), seed=4),
        "patched_attention_block": flax_params(
            get_attention_block(WIDE_CFG, deterministic_selection=True),
            z((1, 32, 32, 32, nf), np.float32), z((k, 32, 32, 32, nf), np.float32), seed=5),
    }
    rng = np.random.default_rng(0)
    db = rng.standard_normal((300, 16)).astype(np.float32)
    db /= np.linalg.norm(db, axis=1, keepdims=True)
    bank = rng.random((300, 16, 16, 16)).astype(np.float32) * 0.0625
    x = rng.random((1, 8, 8, 8, 1)).astype(np.float32) * 0.5
    dtr = WIDE_CFG["dataset_train"]
    fb = jax.jit(get_retrieval_backbone(WIDE_CFG).apply)(
        {"params": params["retrieval_backbone"]},
        jnp.asarray(((bank - dtr["target_mean"]) / dtr["target_std"])[..., None]))
    eng = JaxEngine(WIDE_CFG, params, db, None, compute_dtype=jnp.float32, feature_bank=fb,
                    **jax_variant_kwargs("base"))
    q = eng.fenc_input.apply({"params": eng.params["fenc_input"]},
                             eng._unfold_input_patches(jnp.asarray(x)))
    q = q.reshape(q.shape[0], -1)
    q = q / jnp.maximum(jnp.linalg.norm(q, axis=1, keepdims=True), 1e-12)
    want_idx = np.asarray(jax_exact_knn(q, jnp.asarray(db), k)[0])
    want = np.asarray(eng(x))

    port = RetrieveRefineEngine(WIDE_CFG, flax_engine_params(params), db, bank,
                                compute_dtype=torch.float32, device="cpu",
                                **variant_engine_kwargs(FAST_VARIANT))
    assert port.feature_bank.shape[-1] == 8 * nf  # attention rows of F = 48
    np.testing.assert_array_equal(port.retrieve(torch.from_numpy(x)).numpy(), want_idx)
    got = port(x).numpy()
    assert got.shape == want.shape == (1, 64, 64, 64, 1)
    np.testing.assert_allclose(got, want, atol=1e-4)
    other = torch.zeros(want_idx.shape, dtype=torch.int32)
    assert not np.allclose(got, port.refine(torch.from_numpy(x), other).numpy())  # retrievals count


def _sequential_mlp0(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """x (R, Fx) @ w (Fx, H) in float32, one input column after another, as
    the FMA body sums its layer 0 (products rounded, then added)."""
    acc = torch.zeros((x.shape[0], w.shape[1]), dtype=torch.float32)
    for c in range(x.shape[1]):
        acc = acc + x[:, c:c + 1] * w[c]
    return acc


@pytest.mark.parametrize("f", [12, 48, 192, 432])
def test_zero_padding_of_the_general_operands_is_exact(f):
    """`_pack(..., general=True)` gives fc0 Fp - F zero rows (Fp = F rounded
    up to 32) and leaves the rest as the shipped operands: layer 0 over the
    padded operands (rows zero-padded to Fp, as the kernels' masked loads
    read them) equals the unpadded one bit for bit in the kernels' order of
    sums, since 0·0 adds an exact 0. The plain version, which the kernels
    are held against, takes the unpadded rows."""
    fp = -(-f // 32) * 32
    torch.manual_seed(f)
    m = AttentionFeatureEncoder(f, 32).requires_grad_(False)
    w, b = pa._pack(m, torch.float32)
    wg, bg = pa._pack(m, torch.float32, general=True)
    assert torch.equal(b, bg) and wg.numel() == w.numel() + (fp - f) * 128
    w0, w0g = w[:f * 128].reshape(f, 128), wg[:fp * 128].reshape(fp, 128)
    assert torch.equal(w0g[:f], w0) and not w0g[f:].any()
    assert torch.equal(wg[fp * 128:], w[f * 128:])
    x = torch.from_numpy(np.random.default_rng(f).standard_normal((64, f)).astype(np.float32))
    xp = torch.nn.functional.pad(x, (0, fp - f))
    assert torch.equal(_sequential_mlp0(xp, w0g), _sequential_mlp0(x, w0))
    torch.testing.assert_close(_sequential_mlp0(x, w0), x @ w0, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("f", [12, 192, 432])
def test_layer0_fragment_order_is_the_bf16_bodys_product(f):
    """The bf16 general operands: layer 0 in B-fragment order. Emulating the
    kernel's reads (lane (g, t) takes columns 32c + 8t .. +7 of rows g and
    g + 8 as the A fragments of k16 steps 2c and 2c + 1; b0 / b1 of the
    uint4 (s·8 + jp)·32 + lane are the B fragments of n8 tiles 2jp and 2jp + 1)
    through mma.m16n8k16's definition gives x @ fc0 for rows zero-padded to
    Fp."""
    fp = -(-f // 32) * 32
    torch.manual_seed(f)
    m = AttentionFeatureEncoder(f, 32).requires_grad_(False)
    wg, _ = pa._pack(m, torch.bfloat16, general=True)
    frag = wg[:fp * 128].float().reshape(fp // 16, 8, 32, 4, 2).numpy()  # s, jp, lane, r, lo/hi
    x = np.random.default_rng(f).standard_normal((16, fp))
    x[:, f:] = 0.0
    acc = np.zeros((16, 128))
    for s in range(fp // 16):
        c, half = divmod(s, 2)
        a = np.zeros((16, 16))  # the k16 step's A, logical columns
        for t in range(4):
            run = x[:, 32 * c + 8 * t + 4 * half: 32 * c + 8 * t + 4 * half + 4]
            a[:, [2 * t, 2 * t + 1, 2 * t + 8, 2 * t + 9]] = run
        for jp in range(8):
            for tile in range(2):
                bmat = np.zeros((16, 8))  # B (k16 x n8)
                for lane in range(32):
                    g, t = lane >> 2, lane & 3
                    for u in range(2):
                        lo, hi = frag[s, jp, lane, 2 * tile + u]
                        bmat[2 * t + 8 * u, g], bmat[2 * t + 8 * u + 1, g] = lo, hi
                n0 = 8 * (2 * jp + tile)
                acc[:, n0:n0 + 8] += a @ bmat
    w0 = m.fc0.weight.detach().T.bfloat16().double().numpy()
    np.testing.assert_allclose(acc, x[:, :f] @ w0, rtol=1e-12, atol=1e-12)


@pytest.mark.parametrize("f", [48, 432])
def test_flax_bridge_carries_widths_past_the_shipped(f):
    """utils/flax_import at attention rows outside the old widths: a flax
    MLP tree of F = 48 or 432 comes back as the module's state_dict, and a
    module loaded from it packs to the same general operands."""
    torch.manual_seed(f)
    m = AttentionFeatureEncoder(f, 32).requires_grad_(False)
    sd = flax_to_state_dict(_to_flax(m))
    for key, v in m.state_dict().items():
        assert torch.equal(sd[key], v)
    m2 = AttentionFeatureEncoder(f, 32).requires_grad_(False)
    m2.load_state_dict(sd)
    for dtype in (torch.float32, torch.bfloat16):
        for a, b in zip(pa._pack(m, dtype, general=True), pa._pack(m2, dtype, general=True)):
            assert torch.equal(a, b)
