"""Load the actual reference implementation (/root/reference, PyTorch) for
reference-in-the-loop golden parity tests.

The reference's model modules are pure torch and import cleanly. Its data /
retrieval / metric modules import native dependencies that are absent from
this image (pyflann, trimesh, marching_cubes, pyrender, torchmetrics, the CUDA
chamfer extension); those are stubbed in sys.modules — none of the code under
test touches them. `torch.Tensor.cuda` is patched to identity so CPU tensors
pass through the reference's `.cuda(device)` calls (model/loss.py:57).
"""

from __future__ import annotations

import sys
import types

REFERENCE_ROOT = "/root/reference"


def _stub(name: str, **attrs) -> types.ModuleType:
    mod = sys.modules.get(name)
    if mod is None:
        mod = types.ModuleType(name)
        sys.modules[name] = mod
    for k, v in attrs.items():
        setattr(mod, k, v)
    return mod


def _make_metric_stub():
    """Minimal torchmetrics.Metric stand-in: the reference's util/metrics.py
    subclasses it and the trainers put instances into torch.nn.ModuleList, so
    it must be an nn.Module."""
    import torch

    class _StubMetric(torch.nn.Module):
        def __init__(self, *args, **kwargs):
            super().__init__()

        def add_state(self, name, default=None, dist_reduce_fx=None):
            setattr(self, name, default)

    return _StubMetric


def _make_lightning_stub():
    """Minimal pytorch_lightning stand-in (not installed in this image): just
    enough for the reference's LightningModule subclasses to construct and for
    their training_step methods to run outside a Trainer — save_hyperparameters
    stores the config as `hparams`, `log` is a no-op."""
    import torch

    class _StubLightningModule(torch.nn.Module):
        def save_hyperparameters(self, config):
            object.__setattr__(self, "_rf_hparams", dict(config))

        @property
        def hparams(self):
            return self._rf_hparams

        def log(self, *args, **kwargs):
            pass

    return _StubLightningModule


def load_reference() -> None:
    """Idempotent: put /root/reference on sys.path and stub its absent native
    dependencies. After this, `import model`, `import dataset.scene`,
    `import util.retrieval` etc. load the REAL reference code."""
    if REFERENCE_ROOT not in sys.path:
        sys.path.insert(0, REFERENCE_ROOT)

    import torch
    if not getattr(torch.Tensor.cuda, "_rf_identity", False):
        def _cuda(self, *args, **kwargs):
            return self
        _cuda._rf_identity = True
        torch.Tensor.cuda = _cuda

    # pyflann: `from pyflann import *` + FLANN() constructed lazily
    _stub("pyflann", FLANN=object, set_distance_type=lambda *a, **k: None)
    # trimesh (+ the submodules the reference imports at module scope)
    tm = _stub("trimesh")
    tm.sample = _stub("trimesh.sample")
    tm.voxel = _stub("trimesh.voxel")
    tm.voxel.ops = _stub("trimesh.voxel.ops")
    _stub("marching_cubes")
    _stub("pyrender")
    mm = _stub("torchmetrics")
    mm.metric = _stub("torchmetrics.metric", Metric=_make_metric_stub())
    _stub("pytorch_lightning", LightningModule=_make_lightning_stub())
    _stub("wandb", log=lambda *a, **k: None, Image=object)
    ext = _stub("external")
    ext.ChamferDistancePytorch = _stub("external.ChamferDistancePytorch")
    ext.ChamferDistancePytorch.chamfer3D = _stub(
        "external.ChamferDistancePytorch.chamfer3D",
        dist_chamfer_3D=types.SimpleNamespace(chamfer_3DDist=object))


def deterministic_gumbel_hard():
    """Context manager: replace torch's gumbel_softmax with a noise-free hard
    argmax (straight-through), matching our AttentionBlock's
    deterministic_selection=True path — the only way to compare the
    retrieval-mode attention across frameworks without sharing an RNG."""
    import contextlib
    import torch
    import torch.nn.functional as F

    @contextlib.contextmanager
    def ctx():
        orig = F.gumbel_softmax

        def det(logits, tau=1.0, hard=True, dim=-1):
            y_soft = (logits / tau).softmax(dim)
            index = y_soft.max(dim, keepdim=True)[1]
            y_hard = torch.zeros_like(logits).scatter_(dim, index, 1.0)
            return y_hard + y_soft - y_soft.detach() if hard else y_soft

        F.gumbel_softmax = det
        torch.nn.functional.gumbel_softmax = det
        try:
            yield
        finally:
            F.gumbel_softmax = orig
            torch.nn.functional.gumbel_softmax = orig

    return ctx()
