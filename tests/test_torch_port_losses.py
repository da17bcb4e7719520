"""The port's losses, IoU matrix, Sobel operators, initialisers and
learning-rate schedule against the JAX package's, on the CPU.

Same numpy inputs through both; float32, rtol 1e-5 for values and for
gradients (torch.autograd against jax.grad), gradients finite at zero
rows and zero normals. torch.optim.Adam with the trainers' weight decay is
held for 5 steps against the JAX package's torch_adam from equal gradients.
"""

import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from retrieval_fuse_tpu.models import losses as jl
from retrieval_fuse_tpu.ops import sobel as jsobel
from retrieval_fuse_tpu.train import schedule as jsched
from retrieval_fuse_tpu.utils.misc import get_iou_matrix as jax_iou
from retrieval_fuse_tpu_torch.models import losses as tl
from retrieval_fuse_tpu_torch.ops import init as tinit
from retrieval_fuse_tpu_torch.ops import sobel as tsobel
from retrieval_fuse_tpu_torch.train import schedule as tsched
from retrieval_fuse_tpu_torch.utils.misc import get_iou_matrix
from test_torch_port_models import torch_threads  # noqa: F401 (autouse fixture)

RTOL = 1e-5


def value_and_grads(fn_torch, fn_jax, arrays, argnums):
    """(torch value, torch grads, jax value, jax grads) of fn over `arrays`,
    differentiated in the arguments `argnums`."""
    ts = [torch.tensor(a, requires_grad=i in argnums) for i, a in enumerate(arrays)]
    v = fn_torch(*ts)
    v.backward()
    jv, jg = jax.value_and_grad(fn_jax, argnums=argnums)(*map(jnp.asarray, arrays))
    # no .grad where the torch function holds an input constant (jax: zeros)
    grads = [np.zeros_like(arrays[i]) if ts[i].grad is None else ts[i].grad.numpy()
             for i in argnums]
    return float(v.detach()), grads, float(jv), [np.asarray(g) for g in jg]


def assert_same(fn_torch, fn_jax, arrays, argnums=(0, 1), atol=1e-7):
    v, g, jv, jg = value_and_grads(fn_torch, fn_jax, arrays, argnums)
    assert np.isfinite(v)
    np.testing.assert_allclose(v, jv, rtol=RTOL)
    for a, b in zip(g, jg):
        assert np.all(np.isfinite(a))
        np.testing.assert_allclose(a, b, rtol=RTOL, atol=atol)


def pairs(seed, n=6, c=16, zero_rows=0):
    rng = np.random.default_rng(seed)
    zis, zjs = (rng.standard_normal((n, c)).astype(np.float32) for _ in range(2))
    if zero_rows:
        zis[-zero_rows:] = 0.0
    return rng, zis, zjs


@pytest.mark.parametrize("iou", [False, True], ids=["plain", "iou-scaled"])
@pytest.mark.parametrize("zero_rows", [0, 2])
def test_nt_xent_matches_jax(iou, zero_rows):
    rng, zis, zjs = pairs(0, zero_rows=zero_rows)
    arrays = [zis, zjs]
    if iou:
        arrays.append(np.tile(rng.random((6, 6)).astype(np.float32), (2, 2)))
    assert_same(lambda *a: tl.nt_xent_loss(a[0], a[1], 0.2, *a[2:]),
                lambda *a: jl.nt_xent_loss(a[0], a[1], 0.2, *a[2:]), arrays)


@pytest.mark.parametrize("valid", [[1, 1, 1, 1, 1, 1], [1, 0, 1, 1, 0, 1], [0] * 6])
def test_nt_xent_masked_matches_jax(valid):
    _, zis, zjs = pairs(1, zero_rows=1)
    v = np.array(valid, bool)
    assert_same(lambda a, b: tl.nt_xent_loss_masked(a, b, torch.from_numpy(v), 0.1),
                lambda a, b: jl.nt_xent_loss_masked(a, b, jnp.asarray(v), 0.1), [zis, zjs])


def test_patch_style_loss_matches_jax():
    _, zis, zjs = pairs(2)
    assert_same(tl.patch_style_loss, jl.patch_style_loss, [zis, zjs], atol=1e-6)


def test_cosine_similarity_matches_jax_with_zero_normals():
    rng = np.random.default_rng(3)
    p, t = (rng.standard_normal((2, 4, 4, 4, 3)).astype(np.float32) for _ in range(2))
    p[0, :2] = 0.0
    t[1, 0] = 0.0
    assert_same(tl.get_cosine_similarity, jl.get_cosine_similarity, [p, t])
    z = np.zeros_like(p)
    assert float(tl.get_cosine_similarity(torch.from_numpy(z), torch.from_numpy(t))) == 0.0


def test_iou_matrix_matches_jax():
    occ = np.random.default_rng(4).random((5, 6, 6, 6, 1)) < 0.3
    occ[2] = False
    want = np.asarray(jax_iou(jnp.asarray(occ)))
    got = get_iou_matrix(torch.from_numpy(occ))
    assert got.dtype == torch.float32 and got.shape == (5, 5)
    np.testing.assert_allclose(got.numpy(), want, rtol=RTOL)
    np.testing.assert_array_equal(get_iou_matrix(torch.from_numpy(occ[..., 0])).numpy(),
                                  got.numpy())


@pytest.mark.parametrize("op", ["compute_normals", "compute_laplacian"])
def test_sobel_matches_jax(op):
    rng = np.random.default_rng(5)
    vol = (rng.random((2, 7, 6, 5, 1)) * 0.06).astype(np.float32)
    want = np.asarray(getattr(jsobel, op)(jnp.asarray(vol), 0.0625))
    got = getattr(tsobel, op)(torch.from_numpy(vol), 0.0625)
    assert tuple(got.shape) == want.shape
    np.testing.assert_allclose(got.numpy(), want, rtol=RTOL, atol=1e-6)


@pytest.mark.parametrize("generator", ["numpy", "torch"])
def test_init_functions(generator):
    def gen(seed):
        return np.random.default_rng(seed) if generator == "numpy" \
            else torch.Generator().manual_seed(seed)

    b = tinit.torch_bias_init(torch.empty(4000), fan_in=27, generator=gen(0))
    bound = 1 / np.sqrt(27)
    assert float(b.abs().max()) <= bound and float(b.abs().max()) > 0.9 * bound
    assert torch.equal(b, tinit.torch_bias_init(torch.empty(4000), 27, generator=gen(0)))
    w = tinit.dirac_noise_init(torch.empty(6, 4, 1, 1, 1), 0.01, generator=gen(1))
    eye = np.zeros((6, 4))
    eye[np.arange(4), np.arange(4)] = 1.0
    noise = w[:, :, 0, 0, 0].numpy() - eye
    assert np.abs(noise).max() < 0.06 and 0.005 < noise.std() < 0.015
    w3 = tinit.dirac_noise_init(torch.empty(3, 3, 3, 3, 3), 0.0, generator=gen(2))
    assert float(w3.sum()) == 3.0 and all(float(w3[i, i, 1, 1, 1]) == 1.0 for i in range(3))
    n = tinit.normal_init(torch.empty(20000), 0.01, generator=gen(3))
    assert abs(float(n.std()) - 0.01) < 5e-4 and abs(float(n.mean())) < 5e-4


def test_dirac_init_matches_jax_structure():
    """The JAX initialiser's kernel (kD, kH, kW, I, O) without noise is the
    port's (O, I, kD, kH, kW) transposed."""
    from retrieval_fuse_tpu.ops.init import dirac_noise_init
    want = np.asarray(dirac_noise_init(0.0)(jax.random.PRNGKey(0), (3, 3, 3, 4, 6)))
    got = tinit.dirac_noise_init(torch.empty(6, 4, 3, 3, 3), 0.0)
    np.testing.assert_array_equal(got.permute(2, 3, 4, 1, 0).numpy(), want)


def test_schedule_matches_jax():
    for milestones in (None, [], [50, 75], [2, 3]):
        for epoch in range(0, 80, 3):
            for step in (0, 1, 17, 749, 1498, 1499, 1500, 4000):
                assert tsched.current_lr(1e-4, milestones, step, epoch) == \
                    jsched.current_lr(1e-4, milestones, step, epoch)
            assert tsched.multistep_lr(1e-4, milestones, 0.5, epoch) == \
                jsched.multistep_lr(1e-4, milestones, 0.5, epoch)


def test_adam_matches_jax_torch_adam():
    """torch.optim.Adam(weight_decay=5e-5) with the learning rate set into
    param_groups before each step, against schedule.torch_adam_core scaled
    by the same per-step rates, from equal gradients, 5 steps."""
    rng = np.random.default_rng(6)
    w0 = rng.standard_normal((3, 5)).astype(np.float32)
    grads = rng.standard_normal((5, 3, 5)).astype(np.float32)
    lrs = [tsched.current_lr(1e-2, [2, 3], s, s) for s in range(5)]
    w = torch.tensor(w0, requires_grad=True)
    opt = torch.optim.Adam([w], lr=1e-2, weight_decay=tsched.WEIGHT_DECAY)
    tx = jsched.torch_adam_core(weight_decay=5e-5)
    params = jnp.asarray(w0)
    state = tx.init(params)
    for g, lr in zip(grads, lrs):
        tsched.set_lr(opt, lr)
        w.grad = torch.from_numpy(g.copy())
        opt.step()
        updates, state = tx.update(jnp.asarray(g), state, params)
        params = optax.apply_updates(params, jsched.scale_updates_by_lr(updates, lr))
        np.testing.assert_allclose(w.detach().numpy(), np.asarray(params), rtol=RTOL, atol=1e-7)


def test_new_modules_import_without_jax():
    """With jax, flax, optax, orbax and PyYAML blocked, the modules of the
    training slice import, and no module of the JAX package is loaded."""
    code = (
        "import sys\n"
        "for m in ('jax', 'flax', 'optax', 'orbax', 'yaml'):\n"
        "    sys.modules[m] = None\n"
        "import retrieval_fuse_tpu_torch.train.retrieval_trainer\n"
        "import retrieval_fuse_tpu_torch.train.schedule, retrieval_fuse_tpu_torch.serve\n"
        "import retrieval_fuse_tpu_torch.models.losses, retrieval_fuse_tpu_torch.ops.sobel\n"
        "import retrieval_fuse_tpu_torch.ops.init, retrieval_fuse_tpu_torch.config.arguments\n"
        "import retrieval_fuse_tpu_torch.utils.logger, retrieval_fuse_tpu_torch.models.unet\n"
        "import retrieval_fuse_tpu_torch.train.refinement_trainer\n"
        "import retrieval_fuse_tpu_torch.retrieval.engine, retrieval_fuse_tpu_torch.data.scene\n"
        "bad = [m for m in sys.modules if m == 'retrieval_fuse_tpu'"
        " or m.startswith('retrieval_fuse_tpu.')]\n"
        "assert not bad, bad\n"
        "print('ok')\n")
    root = Path(__file__).resolve().parents[1]
    env = dict(os.environ, PYTHONPATH=str(root))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         env=env, cwd=root, timeout=120)
    assert out.returncode == 0 and out.stdout.strip() == "ok", out.stderr
