"""The training-time parts of the port's models against flax, on the CPU,
forward and backward (torch.autograd against jax.grad; float32):

- the BatchNorm encoders (PatchNorm08, PatchNorm32) in train and eval
  mode, running statistics included, after three train-mode calls;
- Gumbel selection (the noise passed in), the g / o output mappings and
  get_features of the attention;
- the differentiable upsample-conv kernel fusion and the fused
  upsample-conv modules of the U-Net decoder.

Gradients agree within 1e-5 of each tensor's largest magnitude (float32
sums over a batch in another order).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import retrieval_fuse_tpu.models.attention as jattn
from retrieval_fuse_tpu.models.encoders import make_encoder as jax_make_encoder
from retrieval_fuse_tpu.models.unet import (
    FusedUpsampleSingleConv as JaxFusedUpsampleSingleConv,
    _FusedUpsampleDoubleConv as JaxFusedUpsampleDoubleConv)
from retrieval_fuse_tpu.ops.fused_decoder import fuse_upsample_conv_kernel_jnp
from retrieval_fuse_tpu_torch.models import attention as tattn
from retrieval_fuse_tpu_torch.models.encoders import make_encoder
from retrieval_fuse_tpu_torch.models.unet import (
    DecoderNoJoining, FusedUpsampleSingleConv, _FusedUpsampleDoubleConv)
from retrieval_fuse_tpu_torch.ops.fused_decoder import fuse_upsample_conv_kernel_torch
from retrieval_fuse_tpu_torch.utils.flax_import import flax_to_state_dict
from test_torch_port_models import flax_params
from test_torch_port_trainer import MODEL, RTOL, assert_close_trees
from test_torch_port_models import torch_threads  # noqa: F401 (autouse fixture)


# ------------------------------------------------------------ BatchNorm


@pytest.mark.parametrize("name, side", [("PatchNorm08", 8), ("PatchNorm32", 32)])
def test_batchnorm_encoder_matches_flax(name, side):
    """Three train-mode calls (batch statistics, running statistics updated
    with momentum 0.9 and the biased variance), then eval mode."""
    jnet, net = jax_make_encoder(name, 4, 16), make_encoder(name, 4, 16)
    rng = np.random.default_rng(8)
    xs = [rng.standard_normal((4, side, side, side, 1)).astype(np.float32) * (1 + i)
          for i in range(4)]
    params = flax_params(jnet, jnp.asarray(xs[0]), seed=9)
    # flax's initial statistics (mean 0, variance 1), without an eager init
    shapes = jax.eval_shape(jnet.init, jax.random.PRNGKey(0), jnp.asarray(xs[0]))
    stats = jax.tree_util.tree_map_with_path(
        lambda path, leaf: (jnp.ones if path[-1].key == "var" else jnp.zeros)(
            leaf.shape, leaf.dtype), shapes["batch_stats"])
    net.load_state_dict(flax_to_state_dict(params, stats))
    apply = jax.jit(jnet.apply, static_argnames=("train", "mutable"))
    net.train()
    for x in xs[:3]:
        want, upd = apply({"params": params, "batch_stats": stats}, jnp.asarray(x),
                          train=True, mutable=("batch_stats",))
        stats = upd["batch_stats"]
        with torch.no_grad():
            got = net(torch.from_numpy(x))
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL, atol=1e-5)
    sd = net.state_dict()
    assert "bn0.running_mean" in sd and not any("num_batches" in k for k in sd)
    assert_close_trees({k: v for k, v in sd.items() if "running" in k},
                       flax_to_state_dict({}, stats), atol=1e-6)
    want = apply({"params": params, "batch_stats": stats}, jnp.asarray(xs[3]))
    with torch.no_grad():
        got = net.eval()(torch.from_numpy(xs[3]))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL, atol=1e-5)


def test_retrieval_networks_take_the_batchnorm_codes():
    from retrieval_fuse_tpu_torch.models import get_retrieval_networks
    fi, ft = get_retrieval_networks({"network_input": "4+2N", "network_target": "16+8N",
                                     **MODEL})
    assert fi.use_batchnorm and ft.use_batchnorm and hasattr(ft, "bn5")


# ------------------------------------------------- training-time model parts


def test_gumbel_softmax_matches_jax():
    rng = np.random.default_rng(10)
    logits = rng.standard_normal((50, 4)).astype(np.float32) * 3
    w = rng.standard_normal((50, 4)).astype(np.float32)
    key = jax.random.PRNGKey(1)
    u = np.array(jax.random.uniform(key, logits.shape, minval=1e-20, maxval=1.0))
    for hard in (True, False):
        def jloss(lg):
            return jnp.sum(jattn.gumbel_softmax(lg, key, tau=0.7, hard=hard) * w)

        jv, jg = jax.jit(jax.value_and_grad(jloss))(jnp.asarray(logits))
        lt = torch.tensor(logits, requires_grad=True)
        y = tattn.gumbel_softmax(lt, torch.from_numpy(u), tau=0.7, hard=hard)
        (y * torch.from_numpy(w)).sum().backward()
        if hard:  # one-hot in the forward, up to the straight-through rounding
            hot = torch.nn.functional.one_hot(y.detach().argmax(-1), 4).float()
            assert float((y.detach() - hot).abs().max()) < 1e-6
        np.testing.assert_allclose(float((y.detach() * torch.from_numpy(w)).sum()), float(jv),
                                   rtol=RTOL)
        np.testing.assert_allclose(lt.grad.numpy(), np.asarray(jg), rtol=RTOL, atol=1e-6)


def attention_case(no_output_mapping: bool, deterministic: bool, seed: int = 11):
    """(flax AttentionBlock, its params, port block loaded with them, x, p,
    gumbel uniform draw, output weights) at nf 4, e 2, K 3."""
    kw = dict(num_output_channels=4, patch_extent=2, K=3, no_output_mapping=no_output_mapping,
              deterministic_selection=deterministic)
    jblk = jattn.AttentionBlock(**kw)
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((40, 2, 2, 2, 4)).astype(np.float32)
    p = (x[:, None] + 0.5 * rng.standard_normal((40, 3, 2, 2, 2, 4))).astype(np.float32)
    params = flax_params(jblk, jnp.asarray(x), jnp.asarray(p), seed=seed)
    blk = tattn.AttentionBlock(**kw)
    blk.load_state_dict(flax_to_state_dict(params))
    u = rng.uniform(1e-20, 1.0, (40, 3)).astype(np.float32)
    w = rng.standard_normal(x.shape).astype(np.float32)
    return jblk, params, blk, x, p, u, w


@pytest.mark.parametrize("no_output_mapping, deterministic", [
    (False, True), (True, False), (False, False)], ids=["g-o", "gumbel", "g-o-gumbel"])
def test_attention_block_training_paths_match_flax(monkeypatch, no_output_mapping, deterministic):
    """Forward and the gradients of a weighted sum of the output, for the
    inputs and every parameter; the Gumbel noise is the same uniform draw
    on both sides (the flax module's draw replaced by it)."""
    jblk, params, blk, x, p, u, w = attention_case(no_output_mapping, deterministic)
    monkeypatch.setattr(jattn, "gumbel_softmax", lambda logits, rng, tau=1.0, hard=True:
                        _gumbel_with(logits, u, tau, hard))

    def jloss(prm, xx, pp):
        out = jblk.apply({"params": prm}, xx, pp, rngs={"gumbel": jax.random.PRNGKey(0)})
        return jnp.sum(out * w)

    want_out = jax.jit(lambda prm, xx, pp: jblk.apply(
        {"params": prm}, xx, pp, rngs={"gumbel": jax.random.PRNGKey(0)}))(
        params, jnp.asarray(x), jnp.asarray(p))
    _, (jgp, jgx, jgpp) = jax.jit(jax.value_and_grad(jloss, argnums=(0, 1, 2)))(
        params, jnp.asarray(x), jnp.asarray(p))
    xt, pt = (torch.tensor(a, requires_grad=True) for a in (x, p))
    out = blk(xt, pt, gumbel_uniform_draw=torch.from_numpy(u))
    (out * torch.from_numpy(w)).sum().backward()
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(want_out), rtol=RTOL, atol=1e-6)
    assert_close_trees({"x": xt.grad.numpy(), "p": pt.grad.numpy()},
                       {"x": jgx, "p": jgpp}, rel_to_max=1e-5)
    got = {k: q.grad.numpy() for k, q in blk.named_parameters() if q.grad is not None}
    want = {k: v for k, v in flax_to_state_dict(jgp).items() if k in got}
    assert ("g.weight" in got) == (not no_output_mapping)
    assert_close_trees(got, want, rel_to_max=1e-5)


def _gumbel_with(logits, u, tau, hard):
    """The JAX gumbel_softmax's arithmetic with the uniform draw u."""
    gumbels = -jnp.log(-jnp.log(jnp.asarray(u) + 1e-20))
    y_soft = jax.nn.softmax((logits + gumbels) / tau, axis=-1)
    if not hard:
        return y_soft
    y_hard = jax.nn.one_hot(jnp.argmax(y_soft, axis=-1), logits.shape[-1], dtype=logits.dtype)
    return y_hard + y_soft - jax.lax.stop_gradient(y_soft)


def test_patched_attention_get_features_matches_flax():
    cfg = {"nf": 4, "attn_num_patch": 4, "attn_patch_extent": 4, "K": 2,
           "attn_normalize": True, "attn_use_switching": True, "attn_retrieval_mode": True,
           "attn_no_output_mapping": True, "attn_blend": True}
    from retrieval_fuse_tpu.models import get_attention_block as jax_block
    from retrieval_fuse_tpu_torch.models import get_attention_block
    jblk, blk = jax_block(cfg, deterministic_selection=True), get_attention_block(cfg)
    rng = np.random.default_rng(12)
    xp, xt = (rng.standard_normal((2, 8, 8, 8, 4)).astype(np.float32) for _ in range(2))
    occ = rng.random((2, 8, 8, 8, 1)) < 0.01
    params = flax_params(jblk, jnp.asarray(xp), jnp.asarray(np.tile(xt, (2, 1, 1, 1, 1))),
                         seed=12)
    blk.load_state_dict(flax_to_state_dict(params))
    want = jax.jit(lambda prm, a, b, c: jblk.apply({"params": prm}, a, b, c,
                                                   method=jblk.get_features))(
        params, jnp.asarray(xp), jnp.asarray(xt), jnp.asarray(occ))
    with torch.no_grad():
        got = blk.get_features(*(torch.from_numpy(a) for a in (xp, xt, occ)))
    for g, w_ in zip(got, want):
        assert tuple(g.shape) == w_.shape
        np.testing.assert_allclose(g.numpy().astype(np.float32), np.asarray(w_, np.float32),
                                   rtol=RTOL, atol=1e-6)
    assert got[2].dtype == torch.bool and 0 < int(got[2].sum()) < got[2].numel()


def test_fuse_upsample_conv_kernel_gradient_matches_jax():
    rng = np.random.default_rng(13)
    w = rng.standard_normal((3, 3, 3, 3, 5)).astype(np.float32)
    c = rng.standard_normal((3, 3, 3, 3, 40)).astype(np.float32)
    jv, jg = jax.jit(jax.value_and_grad(
        lambda a: jnp.sum(fuse_upsample_conv_kernel_jnp(a) * c)))(jnp.asarray(w))
    wt = torch.tensor(w, requires_grad=True)
    v = (fuse_upsample_conv_kernel_torch(wt) * torch.from_numpy(c)).sum()
    v.backward()
    np.testing.assert_allclose(float(v.detach()), float(jv), rtol=RTOL)
    np.testing.assert_allclose(wt.grad.numpy(), np.asarray(jg), rtol=RTOL, atol=1e-6)


@pytest.mark.parametrize("double", [False, True], ids=["single", "double"])
def test_fused_upsample_modules_match_flax(double):
    """Forward and gradients (input and parameters) of the fused
    upsample-conv, alone and as the first conv of a DoubleConv, against
    flax; and the fused DecoderNoJoining equals the unfused one."""
    jmod = JaxFusedUpsampleDoubleConv(6, "gcr", 2) if double else \
        JaxFusedUpsampleSingleConv(6, 2)
    mod = _FusedUpsampleDoubleConv(4, 6, "gcr", 2) if double else FusedUpsampleSingleConv(4, 6, 2)
    rng = np.random.default_rng(14)
    x = rng.standard_normal((2, 5, 5, 5, 4)).astype(np.float32)
    params = flax_params(jmod, jnp.asarray(x), seed=14)
    mod.load_state_dict(flax_to_state_dict(params))
    w = rng.standard_normal((2, 10, 10, 10, 6)).astype(np.float32)

    def jloss(prm, xx):
        return jnp.sum(jmod.apply({"params": prm}, xx) * w)

    want_out = jax.jit(jmod.apply)({"params": params}, jnp.asarray(x))
    _, (jgp, jgx) = jax.jit(jax.value_and_grad(jloss, argnums=(0, 1)))(params, jnp.asarray(x))
    xt = torch.tensor(x, requires_grad=True)
    out = mod(xt.permute(0, 4, 1, 2, 3)).permute(0, 2, 3, 4, 1)
    (out * torch.from_numpy(w)).sum().backward()
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(want_out), rtol=RTOL, atol=1e-5)
    got = {k: q.grad.numpy() for k, q in mod.named_parameters()}
    got["x"] = xt.grad.numpy()
    assert_close_trees(got, {**flax_to_state_dict(jgp), "x": jgx}, rel_to_max=1e-5)
    if double:
        fused = DecoderNoJoining(4, 6, conv_layer_order="gcr", num_groups=2, fused_upsample=True)
        plain = DecoderNoJoining(4, 6, conv_layer_order="gcr", num_groups=2)
        fused.basic_module.load_state_dict(mod.state_dict())
        plain.load_state_dict(fused.state_dict())
        with torch.no_grad():
            xc = torch.from_numpy(x).permute(0, 4, 1, 2, 3)
            np.testing.assert_allclose(fused(xc).numpy(), plain(xc).numpy(), atol=1e-5)
