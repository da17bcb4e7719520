"""One step of each trainer, and one serving call, on a given global batch:
on a rank of a mesh (its rows; parallel/launch.spawn_ranks runs them) or,
with mesh None, in one process. The two are the same function of the global
batch, so each data-parallel path is held by comparing them.

Each returns plain values (the losses and the gradients on the CPU), so
that a rank can hand them back to the process that spawned it.
`counted_calls` runs several of them in one start of the ranks, each with
the kernel wrappers' launch counts set to 0 just before it and read just
after (the counts live in the rank's process).
"""

from __future__ import annotations

import os
import time

import numpy as np
import torch

from retrieval_fuse_tpu_torch.parallel.mesh import shard_batch

DTYPES = {"float32": torch.float32, "float64": torch.float64, "bfloat16": torch.bfloat16}


def _counters() -> dict:
    """The kernel wrappers, by the names chip_smoke.py reports them under
    ("knn" float32 rows, "knn_bf16" bf16 rows: one wrapper)."""
    from retrieval_fuse_tpu_torch.ops import decoder_tail as dt
    from retrieval_fuse_tpu_torch.ops import patch_attention as pa
    from retrieval_fuse_tpu_torch.ops.streaming_chamfer import chamfer_minima
    from retrieval_fuse_tpu_torch.ops.streaming_knn import streaming_knn_sims
    from retrieval_fuse_tpu_torch.ops.topk import topk
    return {"topk": topk, "knn": streaming_knn_sims, "attention": pa.gathered_patch_attention,
            "attention_v1": pa.gathered_patch_attention_v1,
            "patch_attention": pa.patch_attention, "decoder_tail": dt.decoder_tail,
            "chamfer": chamfer_minima}


def launch_counts() -> dict:
    """{kernel: launches since the counts were last set to 0}."""
    counts = {name: c.launches for name, c in _counters().items()}
    knn = _counters()["knn"].dtype_launches
    counts["knn"], counts["knn_bf16"] = knn[torch.float32], knn[torch.bfloat16]
    return counts


def reset_launch_counts() -> None:
    for c in _counters().values():
        c.launches = 0
    for dtype in _counters()["knn"].dtype_launches:
        _counters()["knn"].dtype_launches[dtype] = 0


def _sync(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def counted_calls(mesh, calls: list) -> list:
    """[(fn(mesh, *args), its kernel launch counts) for (fn, args) in
    calls]: several paths in one start of the ranks, each counted alone."""
    out = []
    for fn, args in calls:
        _sync(mesh.device)
        reset_launch_counts()
        result = fn(mesh, *args)
        _sync(mesh.device)
        out.append((result, launch_counts()))
    return out


def _local(batch: dict, mesh, device, dtype) -> dict:
    rows = shard_batch(batch, mesh) if mesh is not None else {
        k: torch.as_tensor(v).to(device) for k, v in batch.items()}
    return {k: (v.to(dtype) if v.is_floating_point() else v) for k, v in rows.items()}


def _cpu(named) -> dict:
    return {k: v.detach().cpu().clone() for k, v in named}


def retrieval_step(mesh, config: dict, batch: dict, dtype: str = "float32", device="cpu",
                   workdir: str | None = None) -> dict:
    """One RetrievalTrainer step (`_train_step`, Adam included) at the
    config's base learning rate on the global `batch` ({"input", "target"}
    numpy arrays of config's retrieval_training.batch_size rows). Returns
    the loss, the summed gradients, and the encoders' buffers (BatchNorm
    running statistics) and parameters after the step."""
    from retrieval_fuse_tpu_torch.train.retrieval_trainer import RetrievalTrainer
    cwd = os.getcwd()
    os.chdir(workdir or cwd)
    try:
        tr = RetrievalTrainer(config, device=device, mesh=mesh)
        dt = DTYPES[dtype]
        for net in tr.encoders.values():
            net.to(dt)
        tr.optimizer = tr._new_optimizer()
        total, contrastive = tr._train_step(_local(batch, mesh, tr.device, dt), tr.base_lr)
        return {"loss": float(total), "contrastive": float(contrastive),
                "grads": _cpu((f"{n}.{k}", p.grad) for n, net in tr.encoders.items()
                              for k, p in net.named_parameters()),
                "state": _cpu((f"{n}.{k}", v) for n, net in tr.encoders.items()
                              for k, v in net.state_dict().items())}
    finally:
        os.chdir(cwd)


def refinement_step(mesh, config: dict, batch: dict, valid: int | list, phase: int = 3,
                    dtype: str = "float32", device="cpu", workdir: str | None = None) -> dict:
    """The RefinementTrainer's gradients of `phase` (compute_gradients,
    without the Adam update) on the global `batch` ({"input", "target",
    "retrieval"} numpy arrays of config's batch_size rows), with the
    trainer's own Gumbel draw, then val_losses of the same batch with the
    rows after each rank's first valid[r] masked (`valid`: one count a rank,
    or one count for one process). Returns the losses and the gradients."""
    from retrieval_fuse_tpu_torch.train.refinement_trainer import RefinementTrainer
    cwd = os.getcwd()
    os.chdir(workdir or cwd)
    try:
        tr = RefinementTrainer(config, device=device, mesh=mesh)
        dt = DTYPES[dtype]
        for net in tr.nets.values():
            net.to(dt)
        tr.set_phase(phase)
        local = _local(batch, mesh, tr.device, dt)
        total, aux = tr.compute_gradients(local)
        n_valid = valid[tr.rank] if isinstance(valid, (list, tuple)) else valid
        gen = torch.Generator(device=tr.device)
        gen.manual_seed(11)
        _, val = tr.val_losses(local, tr._global_rowmask(n_valid),
                               tr.gumbel_draw(tr.local_batch, gen))
        return {"loss": float(total), "aux": {k: float(v) for k, v in aux.items()},
                "val": {k: float(v) for k, v in val.items()},
                "grads": {f"{n}.{k}": g.cpu() for n, gs in tr.gradients().items()
                          for k, g in gs.items()}}
    finally:
        os.chdir(cwd)


def serving_hold(mesh, config: dict, x: np.ndarray, variant: str, dtype: str = "float32",
                 seed: int = 0, params: dict | None = None, database=None, rows: int = 96,
                 iters: int = 0) -> dict:
    """`variant` in `dtype` on the global batch `x`, its rows split over the
    mesh, against the same engine in this one process on the whole batch
    and against `base` (one process): entry.build_flagship's engines of
    `config` with `params` and `database` (seeded ones of `rows` rows when
    None) and bank tiles from `seed`, all on one feature bank. Returns the
    output's shape, whether it is finite, max |diff| and MAE against the
    one-process engine and against `base`, and with `iters` the ms a call
    of the mesh's engine. Only the mesh's calls are counted: the launch
    counts start again after the references."""
    from retrieval_fuse_tpu_torch.entry import build_flagship
    from retrieval_fuse_tpu_torch.models import init_params
    dt, dev = DTYPES[dtype], mesh.device
    params = params or init_params(config, seed)
    base = build_flagship(dt, dev, seed=seed, variant="base", rows=rows, config=config,
                          params=params, database=database)
    kwargs = dict(variant=variant, config=config, params=params, database=base.database,
                  feature_bank=base.feature_bank)
    one = build_flagship(dt, dev, **kwargs)
    sharded = build_flagship(dt, mesh=mesh, **kwargs)
    want, want_base = one(x), base(x)
    _sync(dev)
    reset_launch_counts()
    got = sharded(x)
    _sync(dev)
    t0 = time.perf_counter()
    for _ in range(iters):
        sharded(x)
    _sync(dev)
    return {"shape": tuple(got.shape), "finite": bool(torch.isfinite(got).all()),
            "max_abs_vs_one": float((got - want).abs().max()),
            "mae_vs_one": float((got - want).abs().mean()),
            "mae_vs_base": float((got - want_base).abs().mean()),
            "max_abs_vs_base": float((got - want_base).abs().max()),
            "ms": (time.perf_counter() - t0) / iters * 1e3 if iters else None}


def sharded_knn(mesh, queries: np.ndarray, database: np.ndarray, k: int,
                dtype: str = "float32", streaming: bool | None = None, iters: int = 0):
    """ops.knn.sharded_exact_knn of numpy queries and rows in `dtype` on the
    mesh (`streaming` forces the shards' path): (int32 indices, sq_dists)
    on the CPU and, with `iters`, ms a call over that many more calls."""
    from retrieval_fuse_tpu_torch.ops.knn import sharded_exact_knn
    q = torch.from_numpy(queries).to(DTYPES[dtype])
    rows = torch.from_numpy(database).to(DTYPES[dtype])
    idx, d = sharded_exact_knn(q, rows, k, mesh, streaming)
    _sync(mesh.device)
    t0 = time.perf_counter()
    for _ in range(iters):
        sharded_exact_knn(q, rows, k, mesh, streaming)
    _sync(mesh.device)
    return idx.cpu(), d.cpu(), (time.perf_counter() - t0) / iters * 1e3 if iters else None


def fit_steps(mesh, kind: str, config: dict, steps: int, workdir: str | None = None) -> dict:
    """One epoch of at most `steps` steps through the `kind` ("retrieval" or
    "refinement", phase 3) trainer's fit, no validation and no checkpoint:
    the steps taken and the last loss."""
    from retrieval_fuse_tpu_torch.train.refinement_trainer import RefinementTrainer
    from retrieval_fuse_tpu_torch.train.retrieval_trainer import RetrievalTrainer
    cwd = os.getcwd()
    os.chdir(workdir or cwd)
    try:
        never = 10 ** 9
        if kind == "retrieval":
            tr = RetrievalTrainer(config, mesh=mesh)
            tr.fit(1, val_check_interval=never, save_epoch=never,
                   run_retrieval_validation=False, max_steps_per_epoch=steps)
        else:
            tr = RefinementTrainer(config, mesh=mesh)
            tr.set_phase(3)
            tr.fit(1, save_epoch=never, val_check_interval=never, max_steps_per_epoch=steps)
        return {"steps": tr.global_step}
    finally:
        os.chdir(cwd)


def loader_rows(mesh, n_items: int, local_batch: int) -> dict:
    """This rank's epoch of data/loader.batch_iterator over `n_items` items
    sharded over the mesh: its steps, and the items of its rows that count
    (`valid`; wrapped filler and padding excluded)."""
    from retrieval_fuse_tpu_torch.data.loader import batch_iterator
    items = [{"i": np.array([i])} for i in range(n_items)]
    steps, counted = 0, []
    for batch in batch_iterator(items, local_batch, shuffle=True, seed=1, prefetch=0,
                                process_index=mesh.rank, process_count=mesh.size):
        steps += 1
        counted.extend(int(i) for i in batch["i"][: batch["valid"], 0])
    return {"steps": steps, "items": counted}


def serve_main(mesh, argv: list) -> list:
    """serve.main(argv) on this rank (the group is running: it takes the
    mesh of its --batch_size)."""
    from retrieval_fuse_tpu_torch import serve
    return serve.main(argv)
def batch_layout(mesh, batch: dict) -> dict:
    """What this rank sees of a global `batch` of numpy arrays: its rows
    (shard_batch), the batch gathered back from every rank's rows
    (make_global_batch), its (start, size) (process_local_batch_slice), and
    mesh_for_batch's answer (a Mesh, or the error it raises) for each row
    count of the batch up to its size."""
    from retrieval_fuse_tpu_torch.parallel.mesh import (
        make_global_batch, mesh_for_batch, process_local_batch_slice)
    local = shard_batch(batch, mesh)
    answers = {}
    for rows in range(1, len(next(iter(batch.values()))) + 1):
        try:
            m = mesh_for_batch(rows, device=mesh.device)
            answers[rows] = (m.rank, m.size)
        except ValueError as e:
            answers[rows] = str(e)
    return {"local": {k: v.cpu() for k, v in local.items()},
            "global": {k: v.cpu() for k, v in make_global_batch(local, mesh).items()},
            "slice": process_local_batch_slice(len(next(iter(batch.values()))), mesh),
            "mesh_for_batch": answers}
