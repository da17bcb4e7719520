"""The host side of the tensor-core kernels (csrc/decoder_tail.cu, the
bf16 bodies of csrc/attention.cuh and csrc/attention_wgmma.cuh and
csrc/knn.cu), on the CPU: which
instruction path a launch is reported to take, and that CPU tensors take
none. The kernels
themselves run in tests/test_torch_port_cuda.py, on a CUDA card.
"""

import numpy as np
import pytest
import torch

from retrieval_fuse_tpu_torch.models.attention import AttentionFeatureEncoder
from retrieval_fuse_tpu_torch.ops import _build
from retrieval_fuse_tpu_torch.ops import decoder_tail as dt
from retrieval_fuse_tpu_torch.ops import patch_attention as pa
from retrieval_fuse_tpu_torch.ops import streaming_knn as sk
from test_torch_port_models import torch_threads  # noqa: F401 (autouse fixture)


@pytest.mark.parametrize("dtype, nf, want", [
    (torch.bfloat16, 16, "mma.bf16"), (torch.bfloat16, 8, "fma.f32"),
    (torch.bfloat16, 4, "fma.f32"), (torch.float32, 16, "fma.f32"),
    (torch.float32, 4, "fma.f32"), (torch.bfloat16, 12, "mma.bf16"),
    (torch.float32, 12, "fma.f32")])
def test_decoder_tail_math_follows_the_dispatch(dtype, nf, want):
    """csrc/decoder_tail.cu sends bf16 at nf 12 and 16 to the tensor-core
    body and every other width and type it takes to the float32-FMA body."""
    assert nf in dt.KERNEL_NF
    assert dt.kernel_math(dtype, nf) == want


@pytest.mark.parametrize("kernel, dtype, want", [
    ("patch_attention", torch.bfloat16, "wgmma.bf16"),
    ("gathered_attention", torch.bfloat16, "wgmma.bf16"),
    ("gathered_attention_v1", torch.bfloat16, "mma.bf16"),
    ("patch_attention", torch.float32, "fma.f32"),
    ("gathered_attention", torch.float32, "fma.f32"),
    ("gathered_attention_v1", torch.float32, "fma.f32")])
def test_attention_math_follows_the_dispatch(kernel, dtype, want):
    """The three attention kernels send bf16 to the tensor cores (the
    shipped instances of patch_attention and gathered_attention by wgmma, v1
    by mma.sync) and keep float32 on the FMA body."""
    assert kernel in _build.KERNELS
    assert pa.kernel_math(kernel, dtype) == want


@pytest.mark.parametrize("kernel", ["patch_attention", "gathered_attention",
                                    "gathered_attention_v1"])
@pytest.mark.parametrize("dtype, want", [(torch.bfloat16, "mma.bf16"), (torch.float32, "fma.f32")],
                         ids=["bf16", "f32"])
def test_general_attention_math_keeps_mma_sync(kernel, dtype, want):
    """The general instances (attention_general.cuh) keep the mma.sync body
    in bf16 and the FMA body in float32."""
    assert pa.kernel_math(kernel, dtype, general=True) == want


def test_attention_math_knows_only_the_attention_kernels():
    with pytest.raises(ValueError, match="no attention kernel"):
        pa.kernel_math("decoder_tail", torch.bfloat16)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_staged_kernel_on_cpu_tensors_takes_the_plain_version(dtype):
    """gathered_patch_attention_v1 on CPU tensors: the plain version's rows
    and selections, no launch counted, no instruction path reported; K = 8 is
    inside the bf16 kernel's range and past the float32 kernel's staging,
    which only a CUDA launch checks."""
    rng = np.random.default_rng(1)
    theta, phi = (AttentionFeatureEncoder(128, 32).to(dtype) for _ in range(2))
    xt = torch.from_numpy(rng.standard_normal((2, 64, 128)).astype(np.float32)).to(dtype)
    bank = torch.from_numpy(rng.standard_normal((9, 64, 128)).astype(np.float32)).to(dtype)
    idx = torch.from_numpy(rng.integers(0, 9, (2, 8)).astype(np.int32))
    before = (pa.gathered_patch_attention_v1.launches, pa.gathered_patch_attention_v1.math)
    with torch.no_grad():
        out, sel = pa.gathered_patch_attention_v1(xt, bank, idx, theta, phi, 8,
                                                  return_selection=True)
        want, want_sel = pa.gathered_patch_attention_v1_plain(xt, bank, idx, theta, phi, 8)
    assert torch.equal(out, want) and torch.equal(sel, want_sel)
    assert before == (pa.gathered_patch_attention_v1.launches,
                      pa.gathered_patch_attention_v1.math)


def test_cpu_tensors_take_the_plain_versions_and_report_no_path():
    """On CPU tensors a wrapper runs its plain version: no launch is counted
    and the instruction path of the last launch stays as it was."""
    rng = np.random.default_rng(0)
    theta, phi = AttentionFeatureEncoder(128, 32), AttentionFeatureEncoder(128, 32)
    x = torch.from_numpy(rng.standard_normal((5, 128)).astype(np.float32)).bfloat16()
    p = torch.from_numpy(rng.standard_normal((5, 2, 128)).astype(np.float32)).bfloat16()
    hn = torch.zeros((1, 3, 3, 3, 128), dtype=torch.bfloat16)
    w2, wh = torch.zeros((3, 3, 3, 16, 16), dtype=torch.bfloat16), torch.zeros(16)
    before = (pa.patch_attention.launches, pa.patch_attention.math,
              dt.decoder_tail.launches, dt.decoder_tail.math)
    with torch.no_grad():
        out = pa.patch_attention(x, p, theta.bfloat16(), phi.bfloat16(), 2)
        tail = dt.decoder_tail(hn, w2, wh, 0.5)
    assert out.shape == x.shape and tail.shape == (1, 1, 1, 1, 8)
    assert before == (pa.patch_attention.launches, pa.patch_attention.math,
                      dt.decoder_tail.launches, dt.decoder_tail.math)


@pytest.mark.parametrize("dtype, want", [(torch.bfloat16, "mma.bf16"),
                                         (torch.float32, "mma.3xtf32")])
def test_knn_math_follows_the_dtype(dtype, want):
    """csrc/knn.cu scores bf16 rows with bf16 mma and float32 rows with three
    TF32 products; both on the tensor cores."""
    assert "knn" in _build.KERNELS and dtype in sk.KERNEL_DTYPES
    assert sk.kernel_math(dtype) == want


def test_knn_math_knows_only_the_kernels_dtypes():
    with pytest.raises(ValueError, match="no kernel path"):
        sk.kernel_math(torch.float16)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_knn_on_cpu_tensors_takes_the_plain_version(dtype):
    """The plain version's output, no launch counted, no path reported."""
    rng = np.random.default_rng(2)
    q = torch.from_numpy(rng.standard_normal((7, 96)).astype(np.float32)).to(dtype)
    db = torch.from_numpy(rng.standard_normal((50, 96)).astype(np.float32)).to(dtype)
    before = (sk.streaming_knn_sims.launches, sk.streaming_knn_sims.math)
    v, i = sk.streaming_knn_sims(q, db, 10)
    pv, pi = sk.streaming_knn_sims_plain(q, db, 10)
    assert torch.equal(v, pv) and torch.equal(i, pi)
    assert before == (sk.streaming_knn_sims.launches, sk.streaming_knn_sims.math)
