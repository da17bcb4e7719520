"""The port's chamfer (ops/chamfer.py, the plain version of the chamfer
kernel) and rough metrics (evaluation/metrics.py) against the JAX package's,
on the CPU, with the same seeded numpy inputs.

Chamfer: against the JAX `chamfer_masked` / `chamfer_batch` and against
`pallas_chamfer(..., interpret=True)`; ragged counts, capacities that are
no tile multiple, one empty set (the 1e30 of the JAX kernel). On voxel
(integer) coordinates every term is exact, so the per-point minima are
bit-equal and only the means carry summation-order rounding (rtol 1e-6);
on float coordinates rtol 1e-5. Metrics: rtol 1e-6, float32 reductions in
another order. The CUDA kernel is held against the same plain version in
test_torch_port_cuda.py; here the identities its inner loop and its split of
the streamed set rest on are pinned by a PyTorch function written in the
kernel's order.
"""

import warnings

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from retrieval_fuse_tpu.evaluation import metrics as jm
from retrieval_fuse_tpu.ops import chamfer as jc
from retrieval_fuse_tpu.ops.pallas_chamfer import pallas_chamfer
from retrieval_fuse_tpu_torch.evaluation import metrics as tmet
from retrieval_fuse_tpu_torch.ops import chamfer as tc
from retrieval_fuse_tpu_torch.ops.streaming_chamfer import (
    BIG, chamfer_minima, chamfer_minima_plain)
from test_torch_port_models import torch_threads  # noqa: F401 (autouse fixture)

# (n_a, n_b) per pair; caps 300 and 517 are no multiple of any tile
COUNTS = [(300, 517), (1, 2), (77, 400), (250, 0), (0, 13)]
CAP_A, CAP_B = 300, 517


def point_pairs(seed: int, integer: bool):
    """(B, cap, 3) float32 buffers with ragged valid counts (zeros beyond)."""
    rng = np.random.default_rng(seed)
    a = np.zeros((len(COUNTS), CAP_A, 3), np.float32)
    b = np.zeros((len(COUNTS), CAP_B, 3), np.float32)
    for i, (na, nb) in enumerate(COUNTS):
        for buf, n in ((a, na), (b, nb)):
            pts = rng.integers(0, 64, (n, 3)) if integer else rng.standard_normal((n, 3)) * 4
            buf[i, :n] = pts
    n_a = np.array([c[0] for c in COUNTS], np.int32)
    n_b = np.array([c[1] for c in COUNTS], np.int32)
    return a, n_a, b, n_b


def as_torch(*arrays):
    return [torch.from_numpy(x) for x in arrays]


@pytest.mark.parametrize("integer", [True, False], ids=["voxel", "float"])
def test_chamfer_batch_matches_jax(integer):
    a, n_a, b, n_b = point_pairs(0, integer)
    want = np.asarray(jc.chamfer_batch(jnp.asarray(a), jnp.asarray(n_a), jnp.asarray(b),
                                       jnp.asarray(n_b)))
    got = tc.chamfer_batch(*as_torch(a, n_a, b, n_b))
    assert got.dtype == torch.float32 and got.shape == (len(COUNTS),)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6 if integer else 1e-5)
    # one set empty: 1e30 (the JAX _BIG), counted by no metric
    assert got[3] == pytest.approx(1e30, rel=1e-5) and got[4] == pytest.approx(1e30, rel=1e-5)


@pytest.mark.parametrize("integer", [True, False], ids=["voxel", "float"])
def test_chamfer_masked_matches_jax_and_pallas(integer):
    a, n_a, b, n_b = point_pairs(1, integer)
    rtol = 1e-6 if integer else 1e-5
    for i in range(len(COUNTS)):
        got = float(tc.chamfer_masked(torch.from_numpy(a[i]), int(n_a[i]),
                                      torch.from_numpy(b[i]), int(n_b[i])))
        want = float(jc.chamfer_masked(jnp.asarray(a[i]), jnp.int32(n_a[i]),
                                       jnp.asarray(b[i]), jnp.int32(n_b[i])))
        kernel = float(pallas_chamfer(jnp.asarray(a[i]), int(n_a[i]), jnp.asarray(b[i]),
                                      int(n_b[i]), tile=256, interpret=True))
        np.testing.assert_allclose(got, want, rtol=rtol)
        np.testing.assert_allclose(got, kernel, rtol=rtol)


def test_minima_bit_equal_on_voxel_coordinates():
    """The kernel's function: per-point minima, BIG at and past each count
    and where the other set is empty; exact against the JAX distances."""
    a, n_a, b, n_b = point_pairs(2, integer=True)
    min_ab, min_ba = chamfer_minima(*as_torch(a, n_a, b, n_b))
    assert min_ab.shape == (len(COUNTS), CAP_A) and min_ba.shape == (len(COUNTS), CAP_B)
    for i, (na, nb) in enumerate(COUNTS):
        assert (min_ab[i, na:] == BIG).all() and (min_ba[i, nb:] == BIG).all()
        if na == 0 or nb == 0:
            assert (min_ab[i] == BIG).all() and (min_ba[i] == BIG).all()
            continue
        d = np.asarray(jc.masked_pairwise_sqdist(jnp.asarray(a[i, :na]), jnp.asarray(b[i, :nb])))
        np.testing.assert_array_equal(min_ab[i, :na].numpy(), d.min(axis=1))
        np.testing.assert_array_equal(min_ba[i, :nb].numpy(), d.min(axis=0))


def _kernel_order_one_way(q: torch.Tensor, o: torch.Tensor, splits: int) -> torch.Tensor:
    """min over o of the squared distance from each point of q (n, 3), as
    csrc/chamfer.cu computes it: the other set in `splits` even runs; in a
    run the minimum of |v|² - 2q·v, summed onto |v|² one coordinate at a time
    from z to x; then max(|q|² + min, 0), BIG for an empty run; the runs'
    results merged by min."""
    norm2 = lambda p: p[:, 0] * p[:, 0] + p[:, 1] * p[:, 1] + p[:, 2] * p[:, 2]
    n_o = o.shape[0]
    run = -(-n_o // splits)
    m = -2.0 * q
    best = torch.full((q.shape[0],), BIG)
    for s in range(splits):
        v = o[min(s * run, n_o):min(s * run + run, n_o)]
        if v.shape[0] == 0:
            continue
        inner = norm2(v)[None, :] + m[:, 2:3] * v[None, :, 2]
        inner = inner + m[:, 1:2] * v[None, :, 1]
        inner = inner + m[:, 0:1] * v[None, :, 0]
        best = torch.minimum(best, torch.clamp(norm2(q) + inner.amin(dim=1), min=0.0))
    return best


def chamfer_minima_kernel_order(a, n_a, b, n_b, splits: int):
    """chamfer_minima in the order of csrc/chamfer.cu's arithmetic."""
    min_ab = torch.full(a.shape[:2], BIG)
    min_ba = torch.full(b.shape[:2], BIG)
    for i, (na, nb) in enumerate(zip(n_a.tolist(), n_b.tolist())):
        min_ab[i, :na] = _kernel_order_one_way(a[i, :na], b[i, :nb], splits)
        min_ba[i, :nb] = _kernel_order_one_way(b[i, :nb], a[i, :na], splits)
    return min_ab, min_ba


@pytest.mark.parametrize("splits", [1, 2, 8])
@pytest.mark.parametrize("integer", [True, False], ids=["voxel", "float"])
def test_kernel_order_minima_equal_the_plain_version(integer, splits):
    """The clamp and |q|² moved out of the minimum, and the other set cut in
    runs whose minima are merged (a run shorter than the others, sets smaller
    than the number of runs, an empty set): bit-equal to the plain version on
    voxel coordinates, where every term is an exact integer, and within 1e-5
    on float coordinates."""
    args = as_torch(*point_pairs(9, integer))
    got = chamfer_minima_kernel_order(*args, splits)
    want = chamfer_minima_plain(*args)
    for g, w in zip(got, want):
        assert torch.equal(g == BIG, w == BIG)
        if integer:
            assert torch.equal(g, w)
        else:
            torch.testing.assert_close(g, w, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("integer", [True, False], ids=["voxel", "float"])
def test_kernel_order_chamfer_matches_jax_and_pallas(integer):
    a, n_a, b, n_b = point_pairs(10, integer)
    rtol = 1e-6 if integer else 1e-5
    ta, tn_a, tb, tn_b = as_torch(a, n_a, b, n_b)
    got = tc._symmetric(chamfer_minima_kernel_order(ta, tn_a, tb, tn_b, 4), tn_a, tn_b).numpy()
    want = np.asarray(jc.chamfer_batch(jnp.asarray(a), jnp.asarray(n_a), jnp.asarray(b),
                                       jnp.asarray(n_b)))
    np.testing.assert_allclose(got, want, rtol=rtol)
    for i in range(len(COUNTS)):
        kernel = float(pallas_chamfer(jnp.asarray(a[i]), int(n_a[i]), jnp.asarray(b[i]),
                                      int(n_b[i]), tile=256, interpret=True))
        np.testing.assert_allclose(got[i], kernel, rtol=rtol)


def test_masked_pairwise_sqdist_matches_jax():
    rng = np.random.default_rng(3)
    a = rng.standard_normal((33, 3)).astype(np.float32) * 5
    b = rng.standard_normal((21, 3)).astype(np.float32) * 5
    want = np.asarray(jc.masked_pairwise_sqdist(jnp.asarray(a), jnp.asarray(b)))
    got = tc.masked_pairwise_sqdist(*as_torch(a, b)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-4)
    assert (got >= 0).all()


@pytest.mark.parametrize("capacity", [5000, 100], ids=["fits", "truncates"])
def test_occupancy_to_point_buffer_matches_jax(capacity):
    occ = np.random.default_rng(4).random((10, 12, 14)) < 0.3
    want_buf, want_n = jc.occupancy_to_point_buffer(occ, capacity)
    got_buf, got_n = tc.occupancy_to_point_buffer(torch.from_numpy(occ), capacity)
    assert got_n == want_n == min(int(occ.sum()), capacity)
    np.testing.assert_array_equal(got_buf.numpy(), want_buf)


def occupancy_batch(seed: int = 5):
    """(6, 12, 12, 12, 1) booleans: random densities, one sample with an
    empty prediction and target (empty union), one with an empty
    prediction only, and a sixth row that n_valid=5 trims."""
    rng = np.random.default_rng(seed)
    dens = rng.uniform(0.05, 0.4, (6, 1, 1, 1, 1))
    preds = rng.random((6, 12, 12, 12, 1)) < dens
    target = rng.random((6, 12, 12, 12, 1)) < dens
    preds[1] = target[1] = False
    preds[3] = False
    return preds, target


@pytest.mark.parametrize("name", ["IoU", "Precision", "Recall", "Chamfer3D"])
def test_metrics_match_jax(name):
    preds, target = occupancy_batch()
    kw = {"capacity": 1024} if name == "Chamfer3D" else {}  # 12³ grids fit
    want, got = getattr(jm, name)(**kw), getattr(tmet, name)(device="cpu", **kw)
    for m in (want, got):
        m.update(preds, target, n_valid=5)
        m.update(preds[:2], target[:2])
    assert got.total == want.total
    np.testing.assert_allclose(got.compute(), want.compute(), rtol=1e-6)


def test_chamfer3d_auto_grows_past_capacity():
    preds, target = occupancy_batch(6)
    preds, target = preds[:1], target[:1]  # one pair: the JAX side scores 16384² distances
    want = jm.Chamfer3D(capacity=64)
    got = tmet.Chamfer3D(capacity=64, device="cpu")
    for m in (want, got):
        m.update(preds, target)
    assert got.capacity == want.capacity == 16384
    np.testing.assert_allclose(got.compute(), want.compute(), rtol=1e-6)


def test_chamfer3d_warns_when_truncating():
    preds, target = occupancy_batch(7)
    want = jm.Chamfer3D(capacity=64, auto_grow=False)
    got = tmet.Chamfer3D(capacity=64, auto_grow=False, device="cpu")
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        want.update(preds, target)
        got.update(preds, target)
    assert sum("truncated in raster order" in str(w.message) for w in caught) == 2
    assert got.capacity == 64
    np.testing.assert_allclose(got.compute(), want.compute(), rtol=1e-6)


def test_batch_occupancy_metrics_matches_jax():
    rng = np.random.default_rng(8)
    pred_df = rng.uniform(0, 0.06, (5, 10, 10, 10, 1)).astype(np.float32)
    target_df = rng.uniform(0, 0.06, (5, 10, 10, 10, 1)).astype(np.float32)
    pred_df[2] = target_df[2] = 1.0  # empty union
    want = jm.batch_occupancy_metrics(pred_df, target_df, 0.02, n_valid=4)
    got = tmet.batch_occupancy_metrics(pred_df, target_df, 0.02, n_valid=4, device="cpu")
    assert got.keys() == want.keys()
    for key in want:
        assert got[key][1] == want[key][1]
        np.testing.assert_allclose(got[key][0], want[key][0], rtol=1e-6)


def test_metrics_default_to_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tmet.Chamfer3D()
