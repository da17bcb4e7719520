"""The host side of csrc/attention_wgmma.cuh, on the CPU: the shared-memory
image that `ops.patch_attention._pack_wgmma` writes for one attention MLP,
read back through a Python mirror of the addresses wgmma's matrix
descriptors give (`wgmma_step_descriptor`, `wgmma_b_address`), and when
the operands are packed: at every launch, or once for an MLP that a
serving engine froze (`freeze_operands`). The kernel itself runs in
tests/test_torch_port_cuda.py, on a CUDA card.
"""

import copy
import re
from pathlib import Path

import numpy as np
import pytest
import torch

from retrieval_fuse_tpu_torch.models.attention import AttentionFeatureEncoder
from retrieval_fuse_tpu_torch.ops import patch_attention as pa
from test_torch_port_models import torch_threads  # noqa: F401 (autouse fixture)

CUH = Path(pa.__file__).resolve().parents[1] / "csrc" / "attention_wgmma.cuh"
LAYERS = ("fc0", "fc1", "fc2", "out")


def seeded_mlp(f: int, seed: int = 0) -> AttentionFeatureEncoder:
    m = AttentionFeatureEncoder(f, pa.KERNEL_EMBED)
    g = np.random.default_rng(seed + f)
    for p in m.parameters():
        p.data = torch.from_numpy(g.standard_normal(tuple(p.shape)).astype(np.float32))
    return m


def bits(t: torch.Tensor) -> np.ndarray:
    """A bf16 tensor's 16-bit patterns."""
    return t.contiguous().view(torch.int16).numpy()


@pytest.mark.parametrize("f", pa.SHIPPED_WIDTHS)
def test_image_holds_every_weight_exactly_once(f):
    """The weights' part of the image is a permutation of `_pack`'s (in,
    out) concatenation (each weight at one place, no place empty), the
    biases follow as float32 bytes, and the image is WgImage<F>::kBytes
    long."""
    m = seeded_mlp(f)
    idx = pa._wgmma_index(f).numpy()
    total = f * 128 + 2 * 128 * 128 + 128 * 32
    assert idx.shape == (total,) and np.array_equal(np.sort(idx), np.arange(total))
    weights, biases = pa._pack(m, torch.bfloat16)
    img = pa._pack_wgmma(m)
    assert img.dtype == torch.bfloat16 and img.numel() * 2 == 2 * total + 416 * 4
    assert np.array_equal(bits(img[:total]), bits(weights)[idx])
    assert torch.equal(img[total:].view(torch.float32), biases)
    assert (img.numel() * 2) % pa.WGMMA_CORE_BYTES == 0


@pytest.mark.parametrize("f", pa.SHIPPED_WIDTHS)
def test_descriptor_addresses_read_every_weight(f):
    """For every layer, k16 step s, k of the step and column n, the byte the
    descriptor of step s gives for B[k][n] holds W[k'][n] of that layer (k'
    = layer0_row(16s + k) in layer 0, 16s + k in the others), and the
    addresses cover the layer's bytes once each."""
    m = seeded_mlp(f, seed=1)
    img = bits(pa._pack_wgmma(m))
    layers = pa.wgmma_layers(f)
    assert [kin for _, kin, _ in layers] == [f, 128, 128, 128]
    for (start, kin, n_out), name in zip(layers, LAYERS):
        w = bits(getattr(m, name).weight.detach().T.contiguous().to(torch.bfloat16))  # (in, out)
        seen = np.zeros(kin * n_out, dtype=np.int64)
        kk, n = np.meshgrid(np.arange(16), np.arange(n_out), indexing="ij")
        for s in range(kin // 16):
            addr = pa.wgmma_b_address(*pa.wgmma_step_descriptor(start, n_out, s), kk, n)
            assert (addr % 2 == 0).all()
            kap = 16 * s + kk
            rows = pa.layer0_row(kap) if name == "fc0" else kap
            assert np.array_equal(img[addr // 2], w[rows, n]), (name, s)
            np.add.at(seen, (addr - start) // 2, 1)
        assert (seen == 1).all(), name


@pytest.mark.parametrize("f", pa.SHIPPED_WIDTHS)
def test_layer0_order_is_a_permutation_of_the_rows(f):
    """load_rows16's k order takes every input feature once."""
    assert np.array_equal(np.sort(pa.layer0_row(np.arange(f))), np.arange(f))


def test_cuh_names_the_mirrored_constants():
    """The constants that `wgmma_b_address` and `wgmma_step_descriptor`
    mirror are the ones csrc/attention_wgmma.cuh builds its descriptors
    from."""
    src = CUH.read_text()
    core = re.search(r"constexpr int kCoreBytes = (\d+);", src)
    row = re.search(r"constexpr int kCoreRowBytes = (\d+);", src)
    lbo = re.search(r"constexpr int kLbo\(int n\) \{ return n \* (\d+); \}", src)
    step = re.search(r"constexpr int kStepBytes\(int n\) \{ return n \* (\d+); \}", src)
    assert core and row and lbo and step
    assert int(core.group(1)) == pa.WGMMA_CORE_BYTES
    assert int(row.group(1)) == pa.WGMMA_CORE_ROW_BYTES
    assert pa.wgmma_step_descriptor(0, 128, 1) == (int(step.group(1)) * 128,
                                                   int(lbo.group(1)) * 128,
                                                   pa.WGMMA_CORE_BYTES)
    assert "wg_desc(b + s * kStepBytes(N), kLbo(N), kCoreBytes)" in src


LAYOUTS = [("wgmma", torch.bfloat16), ("in_out", torch.float32), ("general", torch.bfloat16)]


def pack_now(m, dtype, layout):
    return pa._pack_wgmma(m) if layout == "wgmma" else pa._pack(m, dtype, layout == "general")


def same_bytes(got, want) -> bool:
    """Operands equal bit for bit (the image's bias bytes read as bf16 may
    be NaNs)."""
    got, want = (t if isinstance(t, tuple) else (t,) for t in (got, want))
    return len(got) == len(want) and all(
        torch.equal(a.view(torch.uint8), b.view(torch.uint8)) for a, b in zip(got, want))


@pytest.mark.parametrize("layout, dtype", LAYOUTS)
def test_pack_cache_refreshes_after_an_update(layout, dtype):
    """An MLP that is not frozen packs at every launch, so that the
    operands hold its weights after any update: a write through `p.data`
    (which counts on no version), an update under torch.no_grad(), new
    storage and load_state_dict."""
    m = seeded_mlp(96, seed=2)
    first = pa.packed(m, dtype, layout)
    assert same_bytes(first, pack_now(m, dtype, layout))
    m.fc1.weight.data.add_(1.0)
    second = pa.packed(m, dtype, layout)
    assert not same_bytes(second, first) and same_bytes(second, pack_now(m, dtype, layout))
    with torch.no_grad():
        m.fc0.bias.mul_(3.0)
    m.out.bias.data = m.out.bias.data + 2.0
    third = pa.packed(m, dtype, layout)
    assert not same_bytes(third, second) and same_bytes(third, pack_now(m, dtype, layout))
    m.load_state_dict(seeded_mlp(96, seed=3).state_dict())
    assert same_bytes(pa.packed(m, dtype, layout), pack_now(seeded_mlp(96, seed=3), dtype, layout))


@pytest.mark.parametrize("layout, dtype", LAYOUTS)
def test_frozen_operands_pack_once_and_refuse_updates(layout, dtype):
    """A frozen MLP packs at its first launch and then returns those
    operands (nothing packed); an update it can see (in place under
    torch.no_grad(), new storage, load_state_dict) raises rather than serve
    the old weights; a copy of it is not frozen."""
    frozen = seeded_mlp(64, seed=4)
    pa.freeze_operands(frozen)
    first = pa.packed(frozen, dtype, layout)
    assert same_bytes(first, pack_now(frozen, dtype, layout))
    assert pa.packed(frozen, dtype, layout) is first
    copied = copy.deepcopy(frozen)
    assert pa.packed(copied, dtype, layout) is not pa.packed(copied, dtype, layout)
    for update in (lambda m: m.fc1.weight.mul_(2.0),
                   lambda m: setattr(m.out.bias, "data", m.out.bias.data + 1.0),
                   lambda m: m.load_state_dict(seeded_mlp(64, seed=5).state_dict())):
        m = seeded_mlp(64, seed=4)
        pa.freeze_operands(m)
        pa.packed(m, dtype, layout)
        with torch.no_grad():
            update(m)
        with pytest.raises(RuntimeError, match="changed after the freeze"):
            pa.packed(m, dtype, layout)


def test_engine_freezes_its_attention_mlps():
    """The serving engine owns its attention weights (loaded from its own
    copy of the params) and freezes them, so that its calls pack nothing;
    the module that params came from stays unfrozen."""
    from retrieval_fuse_tpu_torch import models as tm
    from retrieval_fuse_tpu_torch.inference import RetrieveRefineEngine
    from test_torch_port_models import CFG
    params = tm.init_params(CFG, 0)
    eng = RetrieveRefineEngine(CFG, params, np.zeros((4, 16), np.float32), device="cpu",
                               feature_bank=np.zeros((4, 8, 8, 8, CFG["nf"]), np.float32),
                               compute_dtype=torch.float32, attention="gathered2")
    blk = eng.attention.attention_blocks_layer
    for m in (blk.theta, blk.phi):
        assert pa.packed(m, torch.bfloat16, "wgmma") is pa.packed(m, torch.bfloat16, "wgmma")
