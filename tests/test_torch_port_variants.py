"""Every serving variant of the port's engine against the JAX engine built
from the same variant string.

Same param tree (numpy values, through the weight bridge), database, bank
and inputs for both, at the tiny geometry of tests/test_inference.py; the
JAX engine runs its Pallas kernels with interpret=True, as its own tests
do; the port runs the kernels' plain versions (CPU tensors). float32:
retrieved indices equal, TSDF atol 1e-4. Together the variants cover every
token of the JAX engine's variant_engine_kwargs.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from retrieval_fuse_tpu.inference import (
    RetrieveRefineEngine as JaxEngine, variant_engine_kwargs as jax_variant_kwargs)
from retrieval_fuse_tpu_torch.inference import RetrieveRefineEngine, variant_engine_kwargs
from retrieval_fuse_tpu_torch.utils.flax_import import flax_engine_params
from retrieval_fuse_tpu_torch.ops.patch_attention import embed
from test_torch_port_engine import jax_ref, setup  # noqa: F401 (fixtures)
from test_torch_port_models import CFG
from test_torch_port_models import torch_threads  # noqa: F401 (autouse fixture)

VARIANTS = [
    "pallas",
    "fused+pallasp+topk1p+cdec",
    "fused+flatg+pallasp",
    "fused+pallasg+topk1p+packed",
    "phib+fused",
    "pallas+dconv+fbb",
    "approxk+fused",
    "fused+pallasp+topk1p+dconv+fbb",
    "packed+denseknn",
]


def _engines(setup, jax_ref, variant, **kw):
    params, db, bank, x = setup
    fb = None if kw.get("use_feature_bank") is False else jax_ref[1]
    jax_eng = JaxEngine(CFG, params, db, bank if fb is None else None,
                        compute_dtype=jnp.float32, feature_bank=fb,
                        **jax_variant_kwargs(variant), **kw)
    port = RetrieveRefineEngine(CFG, flax_engine_params(params), db,
                                bank if fb is None else None, compute_dtype=torch.float32,
                                device="cpu", feature_bank=fb, **variant_engine_kwargs(variant),
                                **kw)
    return jax_eng, port


@pytest.mark.parametrize("variant", VARIANTS)
def test_variant_engine_matches_jax(setup, jax_ref, variant):
    x = setup[3]
    jax_eng, port = _engines(setup, jax_ref, variant)
    np.testing.assert_array_equal(port.retrieve(torch.from_numpy(x)).numpy(), jax_ref[0])
    want = np.asarray(jax_eng(x))
    got = port(x).numpy()
    assert got.shape == want.shape == (2, 64, 64, 64, 1)
    np.testing.assert_allclose(got, want, atol=1e-4)


@pytest.mark.parametrize("variant", ["base", "pallas"])
def test_reencode_engine_matches_jax(setup, jax_ref, variant):
    """No feature bank: the retrieved raw tiles are composed and re-encoded
    on every call (plain attention modules, and the `pallas` attention
    over the re-encoded volumes)."""
    x = setup[3]
    jax_eng, port = _engines(setup, jax_ref, variant, use_feature_bank=False)
    assert port.feature_bank is None and port.patch_bank is not None
    np.testing.assert_allclose(port(x).numpy(), np.asarray(jax_eng(x)), atol=1e-4)


def test_phibank_holds_the_phi_embedding_of_every_bank_row(setup):
    """The precomputed phi bank is the normalised phi embedding of every
    packed bank row, (N, T, cf_feat), batched or not."""
    params, db, bank, _ = setup
    port = RetrieveRefineEngine(CFG, flax_engine_params(params), db, bank,
                                compute_dtype=torch.float32, device="cpu",
                                **variant_engine_kwargs("phib"))
    n, t, f = port.feature_bank.shape
    assert port.phi_bank.shape == (n, t, 32)
    phi = port.attention.attention_blocks_layer.phi
    np.testing.assert_allclose(port.phi_bank.numpy(),
                               embed(port.feature_bank.reshape(-1, f), phi).reshape(n, t, -1).numpy(),
                               atol=1e-6)
    np.testing.assert_allclose(port.phi_bank.norm(dim=-1).numpy(), 1.0, atol=1e-5)
    np.testing.assert_allclose(port._precompute_phi_bank(batch=1000).numpy(),
                               port.phi_bank.numpy(), atol=1e-6)


def test_phibank_refuses_softmax_selection(setup):
    params, db, bank, _ = setup
    cfg = dict(CFG, attn_retrieval_mode=False)
    with pytest.raises(ValueError, match="hard selection"):
        RetrieveRefineEngine(cfg, flax_engine_params(params), db, bank,
                             compute_dtype=torch.float32, device="cpu", attention="phibank")


def test_kernel_paths_need_the_feature_bank(setup):
    params, db, bank, _ = setup
    for attention in ("packedrows", "gathered", "gathered2", "phibank"):
        with pytest.raises(ValueError, match="feature bank"):
            RetrieveRefineEngine(CFG, flax_engine_params(params), db, bank,
                                 compute_dtype=torch.float32, device="cpu",
                                 use_feature_bank=False, attention=attention)


@pytest.mark.parametrize("cfg_over, variant, dtype, names", [
    ({"nf": 129}, "fused+pallasg2+topk1p", torch.bfloat16,
     ("'pallasg2'", "gathered_attention kernel", "F in 1..1024", "T in 1..512",
      "F = nf·e³ = 1032")),
    ({"nf": 16, "K": 33}, "fused+pallasp+topk1p+cdec", torch.bfloat16,
     ("'pallasp'", "patch_attention kernel", "K in 1..32", "K = 33")),
    ({"nf": 65}, "cdec", torch.bfloat16, ("'cdec'", "decoder_tail", "1..64", "nf = 65")),
    ({"nf": 16, "K": 33}, "fused+pallasg+topk1p", torch.float32,
     ("'pallasg'", "gathered_attention_v1", "K in 1..32", "K = 33")),
    ({"nf": 16, "attn_patch_extent": 12}, "fused+pallas", torch.bfloat16,
     ("'pallas'", "patch_attention kernel", "F = nf·e³ = 3456")),
    ({"nf": 16, "K": 33}, "fused+topk1p", torch.bfloat16,
     ("'topk1p'", "topk kernel", "k in 1..32", "K = 33")),
])
def test_kernel_limits_raise_at_engine_build_on_cuda(cfg_over, variant, dtype, names):
    """On a CUDA device an engine whose kernel path breaks a kernel's
    limits is refused at build, naming the kernel, its limits and the
    variant token; the check needs no card."""
    from retrieval_fuse_tpu_torch.inference import check_kernel_limits
    kw = variant_engine_kwargs(variant)
    cfg = {**CFG, **cfg_over}
    with pytest.raises(ValueError) as err:
        check_kernel_limits(cfg, torch.device("cuda"), kw["attention"], kw["decoder"], dtype,
                            kw["topk_impl"])
    for name in names:
        assert name in str(err.value), (name, str(err.value))
    check_kernel_limits(cfg, torch.device("cpu"), kw["attention"], kw["decoder"], dtype,
                        kw["topk_impl"])


@pytest.mark.parametrize("variant", ["fused+pallasg2+topk1p", "fused+pallasp+topk1p+cdec",
                                     "fused+pallasg+topk1p+packed", "pallas+dconv+fbb",
                                     "phib+fused", "base"])
def test_flagship_geometry_is_inside_the_kernel_limits(variant):
    from retrieval_fuse_tpu_torch.inference import check_kernel_limits
    kw = variant_engine_kwargs(variant)
    for dtype in (torch.bfloat16, torch.float32):
        check_kernel_limits({**CFG, "nf": 16, "K": 4}, torch.device("cuda"), kw["attention"],
                            kw["decoder"], dtype)
