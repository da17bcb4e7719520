"""The port's data-parallel mesh (retrieval_fuse_tpu_torch/parallel/) on the
CPU: ranks of a gloo process group, one process each.

The ranks start once for the module (parallel/launch.spawn_ranks, ~10 s),
and run, in the package's own code (parallel/steps.py), the sharded kNN,
what each rank sees of a global batch, one step of each trainer and one
serving call; the one-process references run meanwhile in this process,
and a 2-rank `entry.dryrun_multichip` beside them. The cases read the
results.

Held: the sharded kNN against the JAX package's sharded_exact_knn (on the
conftest's virtual CPU devices), indices exact and distances within 1e-6,
on integer rows whose similarities are exact in float32, with ties inside
and across shards, short and empty last shards; shard_batch and
make_global_batch against JAX's rank-major (host-major) layout; the
divisibility rule of mesh_for_batch; a 2-rank step of each trainer against
the port's one-process step on the same global batch in float64 (relative
1e-10 on the losses, and on every gradient as a share of its sub-network's
largest: a conv bias before a BatchNorm has a gradient of rounding noise
only), with a BatchNorm target encoder, IoU-scaled NT-Xent, Gumbel
selection and a padded global batch; 2-rank serving against one process
(float32, 1e-5). Tier-1 holds the one-process steps against the JAX
package.
"""

import ast
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from retrieval_fuse_tpu.ops.knn import sharded_exact_knn as jax_sharded_knn
from retrieval_fuse_tpu.parallel.mesh import get_mesh as jax_mesh, shard_batch as jax_shard
from retrieval_fuse_tpu_torch.data import PatchedSceneDataset, SceneHandler
from retrieval_fuse_tpu_torch.data.loader import collate
from retrieval_fuse_tpu_torch.data.synthetic import make_synthetic_config
from retrieval_fuse_tpu_torch.entry import DRYRUN_SERVING, dryrun_multichip
from retrieval_fuse_tpu_torch.inference import FAST_VARIANT
from retrieval_fuse_tpu_torch.ops.knn import merge_candidates, shard_bounds, shard_candidates
from retrieval_fuse_tpu_torch.parallel import launch, steps
from retrieval_fuse_tpu_torch.parallel.mesh import Mesh
from test_torch_port_models import TORCH_THREADS, torch_threads  # noqa: F401 (autouse fixture)

RANKS = 2
#: float64 steps, 2 ranks against one process
F64_RTOL = 1e-10
#: the ranks' kNN calls: (k, database rows)
RANK_KNN = ((4, 61), (10, 61), (3, 5))
SERVING_TOL = 1e-5


def integer_rows(rng, n: int, d: int = 8) -> np.ndarray:
    """Rows of small integers: every similarity is an exact float32 integer,
    so both packages rank alike and ties are many."""
    return rng.integers(-2, 3, (n, d)).astype(np.float32)


def knn_data(n: int, seed: int = 0):
    """(queries, rows) with a row copied across each boundary of 2, 3 and 4
    shards, so that equal rows sit in different shards."""
    rng = np.random.default_rng(seed)
    rows = integer_rows(rng, n)
    for shards in (2, 3, 4):
        size = -(-n // shards)
        for b in range(size, n, size):
            rows[b] = rows[b - 1]
    return integer_rows(rng, 24), rows


def retrieval_config(root) -> dict:
    cfg = make_synthetic_config(root, task="superresolution")
    cfg["retrieval_training"].update(batch_size=4, iou_scaling=True)
    cfg["retrieval_model"].update(nf_input=4, nf_target=4, latent_dim=16,
                                  network_target="16+8N")
    return cfg


def refinement_config(root) -> dict:
    cfg = make_synthetic_config(root, task="superresolution")
    cfg.update(nf=4, K=2, batch_size=2, unet_num_level=4, retrieval_fmaps=4,
               retrieval_num_level=4, seed=3)
    for d in ("dataset_train", "dataset_val"):
        cfg[d].update(patch_size_input=8, patch_context_input=0, patch_size_target=64,
                      patch_context_target=0, patch_stride=64)
    return cfg


def global_batch(cfg: dict, n_items: int, size: int, keys) -> dict:
    """`n_items` train items collated into `size` rows (the tail padded)."""
    ds = PatchedSceneDataset("train", cfg["dataset_train"], SceneHandler("train", cfg))
    batch = collate([ds[i] for i in range(n_items)], size)
    return {k: batch[k] for k in keys}


@pytest.fixture(scope="module")
def runs(synth_superres_root, tmp_path_factory):
    tmp = tmp_path_factory.mktemp("parallel")
    mp = pytest.MonkeyPatch()
    mp.setenv("OMP_NUM_THREADS", str(TORCH_THREADS))  # the spawned ranks' torch threads
    try:
        rcfg, fcfg = retrieval_config(synth_superres_root), refinement_config(synth_superres_root)
        rbatch = global_batch(rcfg, 3, 4, ("input", "target"))
        fbatch = global_batch(fcfg, 1, 2, ("input", "target", "retrieval"))
        noise = np.random.default_rng(5).normal(0, 0.05, fbatch["target"].shape)
        fbatch["target"] = fbatch["target"] + noise.astype(np.float32)
        x = np.random.default_rng(6).random((4, 8, 8, 8, 1)).astype(np.float32) * 0.5
        layout = {"input": np.arange(4 * 3, dtype=np.float32).reshape(4, 3),
                  "mask": np.array([True, False, True, True])}
        work = str(tmp)
        calls = [(steps.sharded_knn, (*knn_data(n), k)) for k, n in RANK_KNN]
        calls += [(steps.batch_layout, (layout,)),
                  (steps.retrieval_step, (rcfg, rbatch, "float64", "cpu", work)),
                  (steps.refinement_step, (fcfg, fbatch, [1, 0], 3, "float64", "cpu", work)),
                  (steps.serving_hold, (DRYRUN_SERVING, x, FAST_VARIANT))]
        with ThreadPoolExecutor(2) as pool:
            ranks = pool.submit(launch.spawn_ranks, steps.counted_calls, RANKS, "cpu", (calls,))
            dryrun = pool.submit(dryrun_multichip, RANKS, "cpu")
            out = {"layout": layout,
                   "retrieval": steps.retrieval_step(None, rcfg, rbatch, "float64", "cpu", work),
                   "refinement": steps.refinement_step(None, fcfg, fbatch, 1, 3, "float64",
                                                       "cpu", work)}
            results = ranks.result()
            out["dryrun"] = dryrun.result()
        names = [f"knn{k}_{n}" for k, n in RANK_KNN] + [
            "layout", "retrieval", "refinement", "serving"]
        out["ranks"] = [dict(zip(names, (result for result, _ in r))) for r in results]
        yield out
    finally:
        mp.undo()


def jax_knn(queries, rows, k: int, n_dev: int):
    idx, d = jax_sharded_knn(jnp.asarray(queries), jnp.asarray(rows), k, jax_mesh(n_dev))
    return np.asarray(idx), np.asarray(d)


def share(got: dict, want: dict) -> float:
    """The largest |got - want| over each tensor, as a share of the largest
    magnitude in its sub-network (the key's first component)."""
    scale = {}
    for key, w in want.items():
        net = key.split(".")[0]
        scale[net] = max(scale.get(net, 0.0), float(w.abs().max()))
    assert sorted(got) == sorted(want)
    return max(float((got[k].double() - w.double()).abs().max()) / scale[k.split(".")[0]]
               for k, w in want.items())


@pytest.mark.parametrize("n, k", [(61, 1), (61, 4), (61, 8), (61, 10), (13, 8), (9, 4)])
def test_merged_shard_candidates_match_jax_sharded_knn(n, k):
    """Four shards in one process (shard_candidates, then merge_candidates
    over their lists side by side) against JAX's sharded_exact_knn on a
    4-device mesh: 13 rows leave the last shard one row, 9 rows none."""
    queries, rows = knn_data(n)
    q = torch.from_numpy(queries)
    size = -(-n // 4)
    lists = [shard_candidates(q, torch.from_numpy(rows[a:b]), k, a, size)
             for a, b in (shard_bounds(n, 4, s) for s in range(4))]
    idx, d = merge_candidates(torch.cat([s for s, _ in lists], dim=1),
                              torch.cat([i for _, i in lists], dim=1), k)
    jidx, jd = jax_knn(queries, rows, k, 4)
    assert idx.dtype == torch.int32 and np.array_equal(idx.numpy(), jidx)
    np.testing.assert_allclose(d.numpy(), jd, rtol=0, atol=1e-6)
    assert int(idx.max()) < n


@pytest.mark.parametrize("k, n", RANK_KNN)
def test_sharded_knn_over_two_ranks_matches_jax(runs, k, n):
    """sharded_exact_knn on 2 ranks (each searching its row block) against
    JAX's on a 2-device mesh; both ranks return the merged lists. With 5
    rows and k 3 the second rank's block is short."""
    queries, rows = knn_data(n)
    jidx, jd = jax_knn(queries, rows, k, RANKS)
    for rank in runs["ranks"]:
        idx, d, _ = rank[f"knn{k}_{n}"]
        assert np.array_equal(idx.numpy(), jidx)
        np.testing.assert_allclose(d.numpy(), jd, rtol=0, atol=1e-6)


def test_shard_batch_takes_each_ranks_block_as_jax_shards_it(runs):
    """Rank r's rows of a global batch are device r's shard of JAX's
    shard_batch on a 2-device mesh (contiguous blocks in rank order);
    process_local_batch_slice says where they start."""
    layout = runs["layout"]
    sharded = jax_shard(dict(layout), jax_mesh(RANKS))
    for r, rank in enumerate(runs["ranks"]):
        got = rank["layout"]
        for key, arr in sharded.items():
            shard = next(s for s in arr.addressable_shards if s.device == jax.devices()[r])
            assert np.array_equal(got["local"][key].numpy(), np.asarray(shard.data)), key
        assert got["slice"] == (2 * r, 2)


def test_make_global_batch_gathers_every_rank_in_rank_order(runs):
    for rank in runs["ranks"]:
        for key, want in runs["layout"].items():
            got = rank["layout"]["global"][key]
            assert np.array_equal(got.numpy(), want), key


def test_mesh_for_batch_refuses_a_batch_the_ranks_do_not_divide(runs):
    """JAX's multi-process rule: the world size must divide the global batch;
    a process group cannot shrink to fit it."""
    for r, rank in enumerate(runs["ranks"]):
        answers = rank["layout"]["mesh_for_batch"]
        assert answers[2] == answers[4] == (r, RANKS)
        for rows in (1, 3):
            assert "not divisible by 2 processes" in answers[rows]
    mesh = Mesh(None, 0, 1, torch.device("cpu"))
    assert mesh.rows(5) == slice(0, 5) and mesh.shape == {"data": 1}
    with pytest.raises(ValueError, match="do not split"):
        Mesh(None, 0, 2, torch.device("cpu")).rows(5)


def test_retrieval_step_on_two_ranks_equals_one_process(runs):
    """One retrieval step (BatchNorm target encoder, IoU-scaled NT-Xent over
    the global batch, Adam) of the global batch of 3 items padded to 4: on 2
    ranks of 2 rows, the loss, the summed gradients and the state after the
    step (BatchNorm running statistics from the global batch's statistics,
    the Adam update) equal the one-process step's."""
    want = runs["retrieval"]
    assert any(k.endswith("running_var") for k in want["state"])
    for rank in runs["ranks"]:
        got = rank["retrieval"]
        assert got["loss"] == pytest.approx(want["loss"], rel=F64_RTOL)
        assert got["contrastive"] == pytest.approx(want["contrastive"], rel=F64_RTOL)
        assert share(got["grads"], want["grads"]) <= F64_RTOL
        assert share(got["state"], want["state"]) <= F64_RTOL


def test_refinement_step_on_two_ranks_equals_one_process(runs):
    """The phase-3 loss, its six parts and the gradients of all four
    sub-networks of the global batch of 2 (one row a rank, the Gumbel draw
    the global batch's): each rank's share of the L1 and normal terms and of
    the capped contrastive slices sums to the one-process loss."""
    want = runs["refinement"]
    assert sorted(want["grads"]) and want["aux"]["contrastive"] > 0
    for rank in runs["ranks"]:
        got = rank["refinement"]
        assert got["loss"] == pytest.approx(want["loss"], rel=F64_RTOL)
        for k, v in want["aux"].items():
            assert got["aux"][k] == pytest.approx(v, rel=F64_RTOL), k
        assert share(got["grads"], want["grads"]) <= F64_RTOL


def test_refinement_val_losses_mask_the_padding_in_its_ranks_block(runs):
    """val_losses of the global batch whose second row (rank 1's only row)
    is padding: the global row mask is rank-major, the L1 mean divides by
    the global valid count, and the losses equal the one-process ones with
    the same row masked."""
    want = runs["refinement"]["val"]
    for rank in runs["ranks"]:
        for k, v in want.items():
            assert rank["refinement"]["val"][k] == pytest.approx(v, rel=F64_RTOL), k


def test_sharded_serving_equals_one_process(runs):
    """FAST_VARIANT in float32 on a batch of 4 split over 2 ranks: every rank
    returns the whole batch, within SERVING_TOL of the one-process engine
    on the same rank (parallel/steps.serving_hold), near `base`."""
    for rank in runs["ranks"]:
        got = rank["serving"]
        assert got["shape"] == (4, 64, 64, 64, 1) and got["finite"]
        assert got["max_abs_vs_one"] <= SERVING_TOL and got["mae_vs_base"] <= SERVING_TOL


def test_dryrun_multichip_on_two_cpu_ranks(runs):
    """entry.dryrun_multichip(2) on the CPU: a finite phase-3 loss, finite
    reduced metrics, and each sharded serving path within its tolerance of
    the unsharded `base` engine (it raises otherwise)."""
    out = runs["dryrun"]
    assert out["ranks"] == RANKS and out["backend"] == "gloo"
    assert np.isfinite(out["loss"]) and all(np.isfinite(v) for v in out["metrics"].values())
    assert sorted(out["serving_max_abs"]) == sorted(
        ["fused+pallasg2+topk1p", "fused+pallasp+topk1p+dconv+fbb", "fused+pallasp+topk1p+cdec"])


def test_parallel_modules_import_no_jax():
    """The new modules import neither jax nor the JAX package."""
    root = Path(__file__).parents[1] / "retrieval_fuse_tpu_torch"
    for path in [*sorted((root / "parallel").glob("*.py")), root / "entry.py"]:
        for node in ast.walk(ast.parse(path.read_text())):
            names = ([a.name for a in node.names] if isinstance(node, ast.Import)
                     else [node.module or ""] if isinstance(node, ast.ImportFrom) else [])
            for name in names:
                top = name.split(".")[0]
                assert top not in ("jax", "jaxlib", "flax", "retrieval_fuse_tpu"), (path, name)
    assert launch.rank_backend(2, "cpu") == "gloo"
