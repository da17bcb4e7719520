"""Retrieval training, as in the JAX package's train/retrieval_trainer.py.

Ported so far: `get_metrics_for_retrieval`, which the retrieval CLI's
`evaluate` runs. The trainer itself comes with the trainers slice (ROADMAP
Queue 1 item 15).
"""

from __future__ import annotations

import numpy as np

from retrieval_fuse_tpu_torch.evaluation.metrics import Chamfer3D, IoU, Precision, Recall


def get_metrics_for_retrieval(retrievals: np.ndarray, dataset, device=None) -> list[float]:
    """[iou, chamfer, precision, recall] of the 1-NN composed scenes against
    the targets, occupancy at 0.75 voxel; one update per scene, on `device`."""
    metrics = [IoU(device), Chamfer3D(device=device), Precision(device), Recall(device)]
    thr = 0.75 * dataset.target_voxel_size
    for idx, scene in enumerate(dataset.scenes):
        nn1 = (retrievals[idx, 0] <= thr)[None, ..., None]
        target = (dataset.get_scene_target(scene) <= thr)[None, ..., None]
        for metric in metrics:
            metric.update(nn1, target)
    return [m.compute() for m in metrics]
