"""Rough metrics over boolean occupancy grids, as in the JAX package's
evaluation/metrics.py:

  * IoU: per-sample intersection / (union + 1e-5), samples with an empty
    union skipped;
  * Chamfer3D: symmetric chamfer over occupied-voxel coordinates
    (ops/chamfer.chamfer_batch: the chamfer kernel on the card), counted
    only for samples whose two point sets are both non-empty;
  * Precision / Recall: intersection over pred / target counts (+ 1e-5).

Each metric is an accumulator whose `update` reduces one batch with torch
ops on the metric's device (CUDA unless device="cpu" is asked for) and
`compute()` finalizes. Point sets are built on that device and never leave
it to be scored.
"""

from __future__ import annotations

import warnings

import numpy as np
import torch

from retrieval_fuse_tpu_torch.device import resolve_device
from retrieval_fuse_tpu_torch.ops.chamfer import chamfer_batch, occupancy_to_point_buffer

CAPACITY_STEP = 16384


def _as_bool(x, device) -> torch.Tensor:
    t = x if isinstance(x, torch.Tensor) else torch.from_numpy(np.asarray(x))
    return t.to(device).bool()


def _flat(preds: torch.Tensor, target: torch.Tensor):
    return preds.reshape(preds.shape[0], -1), target.reshape(target.shape[0], -1)


def _iou_update(preds: torch.Tensor, target: torch.Tensor):
    p, t = _flat(preds, target)
    inter = (p & t).sum(dim=1)
    union = (p | t).sum(dim=1)
    valid = union > 0
    iou = torch.where(valid, inter / (union + 1e-5), 0.0)
    return iou.sum(), valid.sum()


def _precision_update(preds: torch.Tensor, target: torch.Tensor):
    p, t = _flat(preds, target)
    inter = (p & t).sum(dim=1)
    return (inter / (p.sum(dim=1) + 1e-5)).sum(), p.shape[0]


def _recall_update(preds: torch.Tensor, target: torch.Tensor):
    p, t = _flat(preds, target)
    inter = (p & t).sum(dim=1)
    return (inter / (t.sum(dim=1) + 1e-5)).sum(), t.shape[0]


def _maybe_trim(preds, target, n_valid):
    if n_valid is not None:
        preds = preds[:n_valid]
        target = target[:n_valid]
    return preds, target


class _SumMetric:
    """sum/total accumulator with update/compute/reset/merge."""

    def __init__(self, device=None):
        self.device = resolve_device(device)
        self.reset()

    def reset(self):
        self.value_sum = 0.0
        self.total = 0.0

    def compute(self) -> float:
        return self.value_sum / self.total if self.total > 0 else float("nan")

    def merge(self, other: "_SumMetric"):
        self.value_sum += other.value_sum
        self.total += other.total

    def all_reduce(self, mesh) -> None:
        """Sum the accumulated value and count over the ranks of `mesh`
        (parallel/mesh.py), as JAX's sharded validation reduces them;
        nothing without one."""
        from retrieval_fuse_tpu_torch.parallel.mesh import all_reduce_sum
        if mesh is None:
            return
        sums = torch.tensor([self.value_sum, self.total], dtype=torch.float64,
                            device=mesh.device)
        self.value_sum, self.total = all_reduce_sum(sums, mesh).tolist()

    def _reduce(self, fn, preds, target, n_valid):
        preds, target = _maybe_trim(_as_bool(preds, self.device), _as_bool(target, self.device),
                                    n_valid)
        s, n = fn(preds, target)
        self.value_sum += float(s)
        self.total += float(n)


class IoU(_SumMetric):
    def update(self, preds, target, n_valid: int | None = None):
        self._reduce(_iou_update, preds, target, n_valid)

    __call__ = update


class Precision(_SumMetric):
    def update(self, preds, target, n_valid: int | None = None):
        self._reduce(_precision_update, preds, target, n_valid)

    __call__ = update


class Recall(_SumMetric):
    def update(self, preds, target, n_valid: int | None = None):
        self._reduce(_recall_update, preds, target, n_valid)

    __call__ = update


class Chamfer3D(_SumMetric):
    """Symmetric chamfer over occupied-voxel coordinates.

    Point buffers have a fixed capacity (default 16384); exact whenever a
    sample's occupied count fits. capacity=None sizes the buffers from the
    data; with a fixed capacity `auto_grow` (default) bumps it to fit in
    16384-point steps, and auto_grow=False truncates in raster order with a
    warning."""

    def __init__(self, capacity: int | None = CAPACITY_STEP, auto_grow: bool = True,
                 device=None):
        super().__init__(device)
        self.capacity = capacity or CAPACITY_STEP
        self.auto_grow = auto_grow or capacity is None

    def update(self, preds, target, n_valid: int | None = None):
        preds, target = _maybe_trim(_as_bool(preds, self.device), _as_bool(target, self.device),
                                    n_valid)
        b = preds.shape[0]
        if preds.shape[-1] == 1:  # (B, D, H, W, 1) -> (B, D, H, W)
            preds = preds.reshape((b,) + preds.shape[-4:-1])
        preds, target = preds.reshape(b, *preds.shape[1:4]), target.reshape(b, *preds.shape[1:4])
        counts = torch.stack([preds.reshape(b, -1).sum(dim=1),
                              target.reshape(b, -1).sum(dim=1)], dim=1)
        needed = int(counts.max()) if b else 0
        if needed > self.capacity:
            if self.auto_grow:
                self.capacity = -(-needed // CAPACITY_STEP) * CAPACITY_STEP
            else:
                warnings.warn(
                    f"Chamfer3D: {needed} occupied voxels exceed capacity {self.capacity}; "
                    f"point sets truncated in raster order: the chamfer value is "
                    f"approximate. Pass capacity=None to auto-size.", stacklevel=2)
        bufs_p, ns_p, bufs_t, ns_t = [], [], [], []
        for i in range(b):
            bp, np_ = occupancy_to_point_buffer(preds[i], self.capacity)
            bt, nt_ = occupancy_to_point_buffer(target[i], self.capacity)
            bufs_p.append(bp)
            ns_p.append(np_)
            bufs_t.append(bt)
            ns_t.append(nt_)
        # chamfer(target -> pred), counted only where both sets are non-empty
        valid = [p_ > 0 and t_ > 0 for p_, t_ in zip(ns_p, ns_t)]
        if not any(valid):
            return
        as_counts = lambda ns: torch.tensor(ns, dtype=torch.int32, device=self.device)
        cds = chamfer_batch(torch.stack(bufs_t), as_counts(ns_t),
                            torch.stack(bufs_p), as_counts(ns_p))
        self.value_sum += float(cds[torch.tensor(valid, device=self.device)].sum())
        self.total += float(sum(valid))

    __call__ = update


def batch_occupancy_metrics(pred_df, target_df, threshold: float, n_valid: int | None = None,
                            device=None):
    """One-shot IoU / precision / recall (sum, count) pairs for a df batch
    at `threshold`."""
    dev = resolve_device(device)

    def occ(x):
        t = x if isinstance(x, torch.Tensor) else torch.from_numpy(np.asarray(x))
        return t.to(dev) <= threshold

    preds, target = _maybe_trim(occ(pred_df), occ(target_df), n_valid)
    out = {}
    for name, fn in (("iou", _iou_update), ("precision", _precision_update),
                     ("recall", _recall_update)):
        s, n = fn(preds, target)
        out[name] = (float(s), float(n))
    return out
