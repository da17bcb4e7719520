"""The PyTorch port's modules against their flax counterparts.

Each flax module gets a param tree of numpy values, which also goes through
the port's weight bridge (utils/flax_import) into its counterpart, and the
same numpy inputs go through both; float32, atol 1e-4. Also: the package imports without
JAX and without the JAX package, and its entry points refuse to run on the
CPU unless asked.
"""

import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from retrieval_fuse_tpu.models import (
    get_retrieval_networks, get_unet_backbone, get_decoder, get_retrieval_backbone,
    get_attention_block)
from retrieval_fuse_tpu.models.attention import AttentionBlock as JaxAttentionBlock
from retrieval_fuse_tpu.ops.fold3d import unfold3d as jax_unfold3d, fold3d as jax_fold3d
from retrieval_fuse_tpu_torch import models as tm
from retrieval_fuse_tpu_torch.ops.fold3d import unfold3d, fold3d
from retrieval_fuse_tpu_torch.utils.flax_import import flax_to_state_dict

#: torch's threads in each port test module. Tier-1 runs six xdist workers
#: on the box's cores; torch's default of one thread a core in each of them
#: oversubscribes the cores, and every parallel region then waits for
#: threads that are not running
TORCH_THREADS = 2


@pytest.fixture(scope="module", autouse=True)
def torch_threads():
    """TORCH_THREADS torch threads for the module's tests (the other port
    test modules import this fixture); the worker's setting is restored
    after them."""
    saved = torch.get_num_threads()
    torch.set_num_threads(TORCH_THREADS)
    yield
    torch.set_num_threads(saved)


CFG = {
    "task": "superresolution", "K": 2, "nf": 4, "unet_num_level": 4, "layer_order": "gcr",
    "retrieval_fmaps": 4, "retrieval_num_level": 4, "attn_normalize": True,
    "attn_use_switching": True, "attn_retrieval_mode": True, "attn_no_output_mapping": True,
    "attn_blend": True, "attn_patch_extent": 4, "attn_num_patch": 16,
    "retrieval_model": {"network_input": "2+1", "network_target": "16+8",
                        "nf_input": 4, "nf_target": 4, "latent_dim": 16},
    "dataset_train": {"input_chunk_size": 8, "target_chunk_size": 64,
                      "input_mean": 0.3, "input_std": 0.15,
                      "target_mean": 0.06, "target_std": 0.01,
                      "voxel_size_input": 0.166667, "voxel_size_target": 0.020834},
}


def flax_params(module, *inputs, seed=0):
    """Params for a flax module without running its (slow, eager) init:
    shapes from jax.eval_shape, values from numpy. Kernels U(±1/√fan_in),
    biases U(±0.1), GroupNorm scales U(0.5, 1.5), so that every leaf's
    layout is exercised by the bridge."""
    key = jax.random.PRNGKey(0)
    shapes = jax.eval_shape(module.init, {"params": key, "gumbel": key}, *inputs)["params"]
    rng = np.random.default_rng(seed)

    def fill(path, leaf):
        name = path[-1].key
        if name == "kernel":
            bound = 1.0 / np.sqrt(np.prod(leaf.shape[:-1]))
            return rng.uniform(-bound, bound, leaf.shape).astype(np.float32)
        if name == "scale":
            return rng.uniform(0.5, 1.5, leaf.shape).astype(np.float32)
        return rng.uniform(-0.1, 0.1, leaf.shape).astype(np.float32)

    return jax.tree_util.tree_map_with_path(fill, shapes)


def flax_apply(module, params, *inputs):
    return np.asarray(jax.jit(module.apply)({"params": params}, *map(jnp.asarray, inputs)))


def _port(module, flax_params):
    module.load_state_dict(flax_to_state_dict(flax_params))
    return module.eval()


def _run(module, *xs):
    with torch.no_grad():
        return module(*[torch.from_numpy(x) for x in xs]).numpy()


@pytest.mark.parametrize("name, shape", [
    ("fenc_input", (3, 4, 4, 4, 1)),
    ("unet_backbone", (2, 8, 8, 8, 1)),
    ("decoder", (1, 32, 32, 32, 4)),
    ("retrieval_backbone", (2, 16, 16, 16, 1)),
])
def test_module_matches_flax(name, shape):
    """Encoder, backbone (UNet3D + two DecoderNoJoining), final decoder and
    retrieval backbone (truncated UNet3D with a StepDownDoubleConv) vs flax."""
    flax_mod = {"fenc_input": lambda: get_retrieval_networks(CFG["retrieval_model"])[0],
                "unet_backbone": lambda: get_unet_backbone(CFG),
                "decoder": lambda: get_decoder(CFG),
                "retrieval_backbone": lambda: get_retrieval_backbone(CFG)}[name]()
    x = np.random.default_rng(1).standard_normal(shape).astype(np.float32)
    params = flax_params(flax_mod, x)
    want = flax_apply(flax_mod, params, x)
    got = _run(_port(tm.build_modules(CFG)[name], params), x)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, atol=1e-4)


@pytest.mark.parametrize("retrieval_mode", [True, False], ids=["hard", "softmax"])
def test_attention_block_matches_flax(retrieval_mode):
    """AttentionBlock with deterministic selection (hard argmax) and the
    sharp-softmax mode. Normal inputs keep the ReLU switch open."""
    rng = np.random.default_rng(2)
    K, e, c, n = 3, 2, 4, 40
    x = rng.standard_normal((n, e, e, e, c)).astype(np.float32)
    p = rng.standard_normal((n, K, e, e, e, c)).astype(np.float32)
    blk = JaxAttentionBlock(num_output_channels=c, patch_extent=e, K=K,
                            retrieval_mode=retrieval_mode, deterministic_selection=True)
    params = flax_params(blk, x, p)
    want = flax_apply(blk, params, x, p)
    port = _port(tm.AttentionBlock(c, e, K, retrieval_mode=retrieval_mode), params)
    got = _run(port, x, p)
    np.testing.assert_allclose(got, want, atol=1e-4)
    assert not np.allclose(got, x)  # the switch is open somewhere


def test_patched_attention_block_matches_flax():
    rng = np.random.default_rng(3)
    x = rng.standard_normal((1, 8, 8, 8, 4)).astype(np.float32)
    xr = rng.standard_normal((2, 8, 8, 8, 4)).astype(np.float32)
    cfg = dict(CFG, attn_num_patch=4)
    flax_mod = get_attention_block(cfg, deterministic_selection=True)
    params = flax_params(flax_mod, x, xr)
    want = flax_apply(flax_mod, params, x, xr)
    got = _run(_port(tm.get_attention_block(cfg), params), x, xr)
    np.testing.assert_allclose(got, want, atol=1e-4)
    assert not np.allclose(got, x)


def test_fold3d_matches_jax():
    x = np.random.default_rng(4).standard_normal((2, 8, 8, 8, 3)).astype(np.float32)
    got = unfold3d(torch.from_numpy(x), 2)
    np.testing.assert_array_equal(got.numpy(), np.asarray(jax_unfold3d(jnp.asarray(x), 2)))
    np.testing.assert_array_equal(fold3d(got, 4, 2).numpy(),
                                  np.asarray(jax_fold3d(jnp.asarray(got.numpy()), 4, 2)))
    np.testing.assert_array_equal(fold3d(got, 4, 2).numpy(), x)


def test_sharpness_pinned_to_jax_constant():
    """The port reads the softmax sharpness from the attention config
    (cf_feat·e³·4); the JAX kernel paths hardcode 32·e³·4. Equal (1024) for
    the shipped cf_feat=32, e=2."""
    blk = tm.get_attention_block(CFG).attention_blocks_layer
    e = CFG["attn_patch_extent"] // 2
    assert blk.cf_feat == 32 and e == 2
    assert blk.sharpness == float(32 * e ** 3 * 4) == 1024.0


def test_seeded_params_are_reproducible():
    a, b = tm.init_params(CFG, 7), tm.init_params(CFG, 7)
    c = tm.init_params(CFG, 8)
    w = "unet.encoders_0.basic_module.SingleConv1.conv.weight"
    assert torch.equal(a["unet_backbone"][w], b["unet_backbone"][w])
    assert not torch.equal(a["unet_backbone"][w], c["unet_backbone"][w])
    bound = 1.0 / np.sqrt(27)  # in_channels 1, 3³ kernel
    assert float(a["unet_backbone"][w].abs().max()) <= bound


def test_package_imports_without_jax():
    """With jax, flax and PyYAML blocked, every port module imports, and no
    module of the JAX package is loaded."""
    code = (
        "import sys\n"
        "sys.modules['jax'] = None\n"
        "sys.modules['flax'] = None\n"
        "sys.modules['yaml'] = None\n"
        "import retrieval_fuse_tpu_torch.inference, retrieval_fuse_tpu_torch.serve\n"
        "import retrieval_fuse_tpu_torch.utils.flax_import, retrieval_fuse_tpu_torch.ops._build\n"
        "import retrieval_fuse_tpu_torch.retrieval.cli, retrieval_fuse_tpu_torch.data.synthetic\n"
        "import retrieval_fuse_tpu_torch.evaluation.metrics, retrieval_fuse_tpu_torch.config\n"
        "import retrieval_fuse_tpu_torch.native, retrieval_fuse_tpu_torch.evaluation.mesh\n"
        "import retrieval_fuse_tpu_torch.evaluation.mesh_metrics\n"
        "import retrieval_fuse_tpu_torch.evaluation.cli, retrieval_fuse_tpu_torch.data.prep\n"
        "import retrieval_fuse_tpu_torch.utils.visualization, retrieval_fuse_tpu_torch.ops.patcher\n"
        "import retrieval_fuse_tpu_torch.utils.reference_import\n"
        "bad = [m for m in sys.modules if m == 'retrieval_fuse_tpu'"
        " or m.startswith('retrieval_fuse_tpu.')]\n"
        "assert not bad, bad\n"
        "print('ok')\n")
    root = Path(__file__).resolve().parents[1]
    env = dict(os.environ, PYTHONPATH=str(root))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         env=env, cwd=root, timeout=120)
    assert out.returncode == 0 and out.stdout.strip() == "ok", out.stderr


def test_entry_point_without_device_raises_on_cpu_only_host():
    from retrieval_fuse_tpu_torch.device import resolve_device
    from retrieval_fuse_tpu_torch.inference import RetrieveRefineEngine
    if torch.cuda.is_available():
        pytest.skip("this host has CUDA: the default device is the card")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        resolve_device(None)
    db = np.zeros((4, 16), np.float32)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        RetrieveRefineEngine(CFG, tm.init_params(CFG, 0), db,
                             feature_bank=np.zeros((4, 8, 8, 8, 4), np.float32))
    assert resolve_device("cpu") == torch.device("cpu")
