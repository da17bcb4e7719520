"""Losses, as in the JAX package's models/losses.py: NT-Xent contrastive
(optionally with the IoU-scaled temperature of the negatives, or over a
masked subset of rows), the Gram-matrix style loss and the normal cosine
similarity.

Static shapes throughout, as in JAX: negatives are gathered by a fixed
index matrix and masked rows are excluded by -1e30 logits, so the values
and gradients equal the JAX package's. Norms go through a "double where":
a zero row is replaced by a finite dummy before its norm, so its gradient
stays finite where d‖x‖/dx is not.
"""

from __future__ import annotations

import functools

import numpy as np
import torch


@functools.lru_cache(maxsize=64)
def _negative_column_indices(batch_size: int) -> np.ndarray:
    """For each row i of the (2N, 2N) similarity matrix, the 2N-2 column
    indices that are negatives: everything except i and i±N."""
    n2 = 2 * batch_size
    mask = (1 - (np.eye(n2) + np.eye(n2, n2, k=-batch_size)
                 + np.eye(n2, n2, k=batch_size))).astype(bool)
    return np.stack([np.where(mask[i])[0] for i in range(n2)]).astype(np.int64)


def _unit_rows(x: torch.Tensor, eps_sq: float) -> torch.Tensor:
    """x's rows over max(‖row‖², eps_sq)^½."""
    return x * torch.rsqrt(torch.clamp(torch.sum(x * x, dim=1, keepdim=True), min=eps_sq))


def _cosine_similarity_matrix(reps: torch.Tensor) -> torch.Tensor:
    valid = torch.sum(reps * reps, dim=1, keepdim=True) > 0
    normed = _unit_rows(torch.where(valid, reps, torch.ones_like(reps)), 1e-16)
    normed = torch.where(valid, normed, torch.zeros_like(normed))
    return normed @ normed.T


def _positives_and_negatives(zis: torch.Tensor, zjs: torch.Tensor):
    """(similarity matrix of [zjs; zis], positives (2N, 1), negative
    column indices (2N, 2N-2), negatives (2N, 2N-2))."""
    n = zis.shape[0]
    sim = _cosine_similarity_matrix(torch.cat([zjs, zis], dim=0))
    positives = torch.cat([torch.diagonal(sim, offset=n),
                           torch.diagonal(sim, offset=-n)]).reshape(2 * n, 1)
    cols = torch.from_numpy(_negative_column_indices(n)).to(sim.device)
    return sim, positives, cols, torch.gather(sim, 1, cols)


def nt_xent_loss(zis: torch.Tensor, zjs: torch.Tensor, temperature: float,
                 iou_matrix: torch.Tensor | None = None, sig_scale: float = 80.0,
                 sig_shift: float = -65.0) -> torch.Tensor:
    """SimCLR NT-Xent of (N, C) paired embeddings: cross-entropy of each
    row's positive against its 2N-2 negatives, summed and divided by 2N.

    iou_matrix: (2N, 2N) pairwise IoU (the (N, N) matrix tiled 2x2); when
    given, a negative's temperature is tau + (1 - tau) * sigmoid(IoU * 80 - 65),
    which softly discounts geometrically overlapping negatives."""
    n = zis.shape[0]
    _, positives, cols, negatives = _positives_and_negatives(zis, zjs)
    if iou_matrix is None:
        logits = torch.cat([positives, negatives], dim=1) / temperature
    else:
        negative_ious = torch.gather(iou_matrix, 1, cols)
        neg_temp = temperature + (1 - temperature) * torch.sigmoid(
            negative_ious * sig_scale + sig_shift)
        logits = torch.cat([positives / temperature, negatives / neg_temp], dim=1)
    return torch.sum(torch.logsumexp(logits, dim=1) - logits[:, 0]) / (2 * n)


def nt_xent_loss_masked(zis: torch.Tensor, zjs: torch.Tensor, valid: torch.Tensor,
                        temperature: float) -> torch.Tensor:
    """NT-Xent over the rows where `valid` (N,) is True: invalid rows are no
    one's negatives and contribute no term. Returns the cross-entropy sum
    over 2 * n_valid (1 when no row is valid)."""
    valid = valid.bool()
    valid2 = torch.cat([valid, valid])
    sim, positives, cols, negatives = _positives_and_negatives(zis, zjs)
    col_valid = torch.gather(valid2[None, :].expand(sim.shape), 1, cols)
    negatives = torch.where(col_valid, negatives, torch.full_like(negatives, -1e30))
    logits = torch.cat([positives, negatives], dim=1) / temperature
    ce = torch.logsumexp(logits, dim=1) - logits[:, 0]
    loss = torch.sum(torch.where(valid2, ce, torch.zeros_like(ce)))
    return loss / torch.clamp(2 * torch.sum(valid), min=1)


def patch_style_loss(zis: torch.Tensor, zjs: torch.Tensor) -> torch.Tensor:
    """Mean squared difference of the Gram matrices, zjs's held constant."""
    gmi = zis @ zis.T
    gmj = (zjs @ zjs.T).detach()
    return torch.mean((gmi - gmj) ** 2)


def get_cosine_similarity(pred_norms: torch.Tensor, target_norms: torch.Tensor) -> torch.Tensor:
    """Mean cosine similarity of (B, D, H, W, 3) normal fields over the
    voxels where both normals are nonzero (0 when there is none)."""
    total, count = cosine_similarity_sums(pred_norms, target_norms)
    return total / torch.clamp(count, min=1)


def cosine_similarity_sums(pred_norms: torch.Tensor, target_norms: torch.Tensor):
    """(sum of the cosine similarities, count) over the voxels where both
    normals are nonzero: get_cosine_similarity's numerator and denominator,
    which a data-parallel step sums over the ranks."""
    p = pred_norms.reshape(-1, 3)
    t = target_norms.reshape(-1, 3)
    valid = (torch.sum(p * p, dim=1) > 0) & (torch.sum(t * t, dim=1) > 0)
    v = valid[:, None]
    p_safe = torch.where(v, p, torch.ones_like(p))
    t_safe = torch.where(v, t, torch.ones_like(t))
    cos = torch.sum(_unit_rows(p_safe, 1e-24) * _unit_rows(t_safe, 1e-24), dim=1)
    return torch.sum(torch.where(valid, cos, torch.zeros_like(cos))), torch.sum(valid)
