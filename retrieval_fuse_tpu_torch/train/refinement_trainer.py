"""Refinement trainer, as in the JAX package's train/refinement_trainer.py:
the 3D U-Net backbone, K-way attention fusion over the retrieved volumes and
the upsampling decoder, trained in a 4-phase curriculum.

Phases (PHASE_TRAINABLE): 0 trains the backbone and the decoder on the
input alone; 1 the retrieval backbone, autoencoding the target through the
decoder; 2 the attention's feature MLPs, on the occupancy-gated contrastive
loss; 3 everything, on the fused prediction with the two side tasks and the
contrastive loss. Each phase has its own `torch.optim.Adam` (weight decay
0) over its trainable sub-networks only: a frozen one keeps
`requires_grad=False`, gets no update and keeps no moment. `set_phase`
starts a fresh optimizer, as the reference resets its state at each phase
boundary. MultiStepLR milestones apply in phase 3 only, with no warm-up.

The attention block selects with Gumbel noise in training, as the JAX
trainer does (`deterministic_attention=False`); serving selects
deterministically. The noise comes from explicit generators: train draws
from one seeded with `seed` at each `fit`, validation from one seeded with
11. One eager step: the phase's loss, `loss.backward()`,
`optimizer.step()`, on the trainer's device (the CUDA card unless "cpu" is
asked for). A train step launches none of the port's kernels; validation
scores with the chamfer kernel on the card (evaluation/metrics.Chamfer3D).

Options of the config: `mixed_precision` casts the parameters and the batch
to bf16 inside the step (the loss, the gradients and the optimizer stay
float32), `remat` recomputes the decoder and the shape encoder in the
backward pass (torch.utils.checkpoint), and `frozen_phase_cache` runs phase
2 on features computed once per `fit` (held on the device when they fit
4 GB).

With `enable_vis`, each validation ends in `run_visualization("val")` (and
"train" unless `disable_train_vis`): the vis split's fused predictions,
targets and inputs, stitched per scene, as OBJ meshes under
runs/<experiment>/vis_<split>/<global_step // 1000>/.

With a `mesh` (parallel/mesh.py: one process per card), `batch_size` is
the global batch and each rank trains on its contiguous 1/W of it (the
loader's process sharding, host-major). Each rank's loss is its share of
the global batch's loss, so that the shares and their gradients sum over
the ranks to the one-process step's: the L1 terms are this rank's sums over
the global row (or valid-row) count, the normals' cosine term divides by
the global count of valid voxels, and the contrastive loss counts the
slices that the global slice order admits under CONTRASTIVE_CAP. The
gradients are summed over the ranks; the reported losses are the global
ones. Each rank draws the Gumbel noise of the whole global batch and keeps
its own rows, so its rows get the one-process step's noise. Validation
runs each rank's shard, masks wrapped filler rows, divides by the global
valid count and sums the metrics over the ranks; the phase-2 cache holds
each rank's shard. Rank 0 alone writes logs, checkpoints and meshes.
"""

from __future__ import annotations

from pathlib import Path

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from retrieval_fuse_tpu_torch.data import SceneHandler, PatchedSceneDataset, batch_iterator
from retrieval_fuse_tpu_torch.device import resolve_device
from retrieval_fuse_tpu_torch.evaluation.metrics import Chamfer3D, IoU, Precision, Recall
from retrieval_fuse_tpu_torch.models import (
    get_attention_block, get_decoder, get_retrieval_backbone, get_unet_backbone,
    init_module_params)
from retrieval_fuse_tpu_torch.models.losses import cosine_similarity_sums, nt_xent_loss_masked
from retrieval_fuse_tpu_torch.ops.fold3d import fold3d, unfold3d
from retrieval_fuse_tpu_torch.ops.sobel import compute_normals
from retrieval_fuse_tpu_torch.parallel.mesh import (
    all_reduce_sum, data_parallel_jit, gather_rows, is_writer, make_global_batch, replicate)
from retrieval_fuse_tpu_torch.train import schedule as sched
from retrieval_fuse_tpu_torch.train.checkpoint import (
    load_checkpoint, load_subnet_params, save_checkpoint)
from retrieval_fuse_tpu_torch.utils.logger import MetricsLogger

SUBNETS = ("unet_backbone", "decoder", "retrieval_backbone", "patched_attention_block")

# per-phase trainable sub-networks
PHASE_TRAINABLE = {
    0: ("unet_backbone", "decoder"),
    1: ("retrieval_backbone",),
    2: ("patched_attention_block",),
    3: SUBNETS,
}

#: occupied patches the contrastive loss takes at most, summed over slices
CONTRASTIVE_CAP = 1280
#: bytes the frozen phase-2 cache may take on the device
CACHE_BUDGET_BYTES = 4 * 1024 ** 3
VAL_SEED = 11  # the validation's Gumbel draws
VIS_SEED = 3  # run_visualization's Gumbel draws


class _Method(nn.Module):
    """`module.<method>` as a forward, so that functional_call can run a
    method other than forward with substituted parameters."""

    def __init__(self, module: nn.Module, method: str):
        super().__init__()
        self.module, self.method = module, method

    def forward(self, *args):
        return getattr(self.module, self.method)(*args)


class RefinementTrainer:

    def __init__(self, config: dict, device=None, enable_vis: bool = False,
                 deterministic_attention: bool = False, mesh=None):
        """`deterministic_attention` (default False): the attention block
        selects by Gumbel-softmax in training, as the JAX trainer's does,
        while serving (models.get_attention_block's default) selects the
        argmax. True makes training select deterministically too.
        `enable_vis`: each validation ends with run_visualization.
        `mesh`: train data-parallel over its ranks, on its device."""
        self.config = config
        self.enable_vis = enable_vis
        self.mesh = mesh
        self.device = mesh.device if mesh is not None else resolve_device(device)
        self.mixed_precision = bool(config.get("mixed_precision", False))
        self.remat = bool(config.get("remat", False))
        self.K = config["K"]
        self.phase = config.get("current_phase", 0)
        self.base_lr = config["lr"]
        self.milestones = config.get("scheduler")
        self.batch_size = config["batch_size"]  # the global batch
        self.world = mesh.size if mesh is not None else 1
        self.rank = mesh.rank if mesh is not None else 0
        self.local_batch = self.batch_size // self.world
        self.seed = config.get("seed", 0) or 0

        self.unet_backbone = get_unet_backbone(config)
        self.decoder = get_decoder(config)
        self.retrieval_backbone = get_retrieval_backbone(config)
        self.patched_attention_block = get_attention_block(
            config, deterministic_selection=deterministic_attention)
        self.nets = {name: getattr(self, name) for name in SUBNETS}
        rng = np.random.default_rng(self.seed)
        for net in self.nets.values():
            net.load_state_dict(init_module_params(net, rng))
            net.to(self.device)
        self._load_subnet_ckpts_if_needed(config)
        if mesh is not None:
            for net in self.nets.values():
                replicate(net, mesh)
        # the loss's backward, its gradients summed over the mesh's ranks
        self._backward = data_parallel_jit(torch.Tensor.backward, mesh,
                                           self.trainable_parameters)
        # bf16 parameter casts of the current step (mixed precision), by net
        self._cast = None
        self._methods = {}

        self.scene_handlers = {"train": SceneHandler("train", config),
                               "val": SceneHandler("val", config)}
        self.train_dataset = self.dataset("train")
        self.val_dataset = self.dataset("val")
        sh = self.scene_handlers["train"]
        dtr = config["dataset_train"]
        self.target_trunc = float(sh.target_trunc)
        self.target_voxel_size = float(sh.target_voxel_size)
        self.target_mean, self.target_std = dtr["target_mean"], dtr["target_std"]
        self.weight_occupied = config["weight_occupied"]
        self.w_rec, self.w_norm = config["loss_reconstruction"], config["loss_normal"]
        self.w_attn = config["loss_attn_contrastive"]
        self.w_side_retr = config["loss_side_task_retr"]
        self.w_side_unet = config["loss_side_task_unet"]
        self.attn_temperature = config["attn_temprature"]
        # target chunks unfold into R³ 16³ patches (R = 4 for 64³ chunks)
        self.n_fold = dtr["target_chunk_size"] // 16

        self.generator = self._generator(self.seed)
        self.global_step = 0
        self.set_phase(self.phase)

    def dataset(self, split: str) -> PatchedSceneDataset:
        """The patched dataset of `split` ("train", "val", "train_eval", ...)."""
        base = split.split("_")[0]
        return PatchedSceneDataset(split, self.config[f"dataset_{base}"],
                                   self.scene_handlers[base])

    def _generator(self, seed: int) -> torch.Generator:
        gen = torch.Generator(device=self.device)
        gen.manual_seed(seed)
        return gen

    # ------------------------------------------------------------------ setup

    def _load_subnet_ckpts_if_needed(self, config: dict) -> None:
        """Per-subnet warm starts from full refinement checkpoints."""
        if config.get("resume"):
            return
        starts = (("unet_backbone_decoder_ckpt", ("unet_backbone", "decoder")),
                  ("retrieval_backbone_ckpt", ("retrieval_backbone",)),
                  ("attention_block_ckpt", ("patched_attention_block",)))
        for key, names in starts:
            if config.get(key):
                for name in names:
                    self.nets[name].load_state_dict(load_subnet_params(config[key], name))

    def params(self) -> dict:
        """{subnet: state_dict} of the four sub-networks."""
        return {name: net.state_dict() for name, net in self.nets.items()}

    def load_params(self, params: dict) -> None:
        for name, net in self.nets.items():
            net.load_state_dict(params[name])

    def trainable_parameters(self) -> list:
        return [p for name in PHASE_TRAINABLE[self.phase]
                for p in self.nets[name].parameters()]

    def set_phase(self, phase: int) -> None:
        """Switch curriculum phase: the phase's sub-networks trainable, the
        others frozen, and a new optimizer with a fresh state."""
        self.phase = phase
        self.config["current_phase"] = phase
        for name, net in self.nets.items():
            net.requires_grad_(name in PHASE_TRAINABLE[phase])
            net.zero_grad(set_to_none=True)
        self.optimizer = torch.optim.Adam(self.trainable_parameters(), lr=self.base_lr,
                                          weight_decay=0.0)

    # --------------------------------------------------------------- forwards

    def _call(self, name: str, *args, method: str = "forward"):
        """Sub-network `name`'s `method` on args, with the bf16 casts of
        its parameters inside a mixed-precision step."""
        net = self.nets[name]
        if self._cast is None:
            return getattr(net, method)(*args)
        if method == "forward":
            return torch.func.functional_call(net, self._cast[name], args)
        key = (name, method)
        if key not in self._methods:
            self._methods[key] = _Method(net, method)
        cast = {f"module.{k}": v for k, v in self._cast[name].items()}
        return torch.func.functional_call(self._methods[key], cast, args)

    def _apply_decoder(self, x: torch.Tensor) -> torch.Tensor:
        """The final decoder; under remat its activations are recomputed in
        the backward pass."""
        if self.remat:
            return checkpoint(self._call, "decoder", x, use_reentrant=False)
        return self._call("decoder", x)

    def forward_backbone(self, batch: dict) -> torch.Tensor:
        return self._apply_decoder(self._call("unet_backbone", batch["input"]))

    def _encode(self, vol: torch.Tensor) -> torch.Tensor:
        feats = self._call("retrieval_backbone", unfold3d(vol, 16))
        return fold3d(feats, self.n_fold, 8)

    def _encode_shape_volumes(self, vol: torch.Tensor) -> torch.Tensor:
        """(N, 64, 64, 64, 1) -> (N, 32, 32, 32, nf) feature volumes via the
        retrieval backbone over unfolded 16³ patches."""
        if self.remat:
            return checkpoint(self._encode, vol, use_reentrant=False)
        return self._encode(vol)

    def forward_retrieval(self, batch: dict) -> torch.Tensor:
        """Target autoencoding through the retrieval feature backbone."""
        feats = self._call("retrieval_backbone", unfold3d(batch["target"], 16))
        return fold3d(self._apply_decoder(feats), self.n_fold, 16)

    def forward_attention(self, batch: dict):
        """The contrastive features only (phase 2)."""
        x_ = self._call("unet_backbone", batch["input"])
        x_target = self._encode_shape_volumes(batch["target"])
        pred_shape_ = self._apply_decoder(x_)
        occ = self.occupancy_from_prediction(self.network_pred_to_df(pred_shape_))
        return self._attn_get_features(x_, x_target, occ)

    def _attn_get_features(self, x_pred, x_target, occupancy):
        return self._call("patched_attention_block", x_pred, x_target, occupancy,
                          method="get_features")

    def gumbel_draw(self, batch_size: int, generator: torch.Generator | None = None):
        """The attention's Gumbel noise for this rank's `batch_size` rows: a
        uniform (B·R³, K) draw in [1e-20, 1) from `generator` (the
        trainer's by default); None with deterministic selection. Under a
        mesh the draw is the global batch's (W·B rows) and this rank keeps
        its block."""
        attn = self.patched_attention_block.attention_blocks_layer
        if attn.deterministic_selection or not attn.retrieval_mode:
            return None
        rows = batch_size * self.patched_attention_block.num_patch_x ** 3
        u = torch.rand((rows * self.world, self.K), generator=generator or self.generator,
                       device=self.device)
        return u[self.rank * rows: (self.rank + 1) * rows].clamp_(min=1e-20)

    def forward_full(self, batch: dict, gumbel_uniform_draw: torch.Tensor | None = None):
        """The full fusion forward: backbone features attend over K
        retrieval feature volumes; retrievals and target are encoded
        jointly in one batch through the retrieval backbone. Returns
        (pred_shape, pred_shape_back, pred_shape_retr, the attention's
        theta / phi features, their occupancy). The Gumbel noise is drawn
        from the trainer's generator unless given."""
        b = batch["input"].shape[0]
        if gumbel_uniform_draw is None:
            gumbel_uniform_draw = self.gumbel_draw(b)
        x_back = self._call("unet_backbone", batch["input"])
        retrievals = self.get_retrievals(batch["retrieval"])
        x_rpt = self._encode_shape_volumes(torch.cat([retrievals, batch["target"]], dim=0))
        x_retrieval, x_target = x_rpt[: b * self.K], x_rpt[b * self.K:]
        x = self._call("patched_attention_block", x_back, x_retrieval, gumbel_uniform_draw)
        pred_shape = self._apply_decoder(x)
        pred_shape_retr = fold3d(self._apply_decoder(unfold3d(x_target, 8)), self.n_fold, 16)
        pred_shape_back = self._apply_decoder(x_back)
        occ = self.occupancy_from_prediction(self.network_pred_to_df(pred_shape_back))
        fpred, ftgt, occ_attn = self._attn_get_features(x_back, x_target, occ)
        return pred_shape, pred_shape_back, pred_shape_retr, fpred, ftgt, occ_attn

    # ----------------------------------------------------------- value algebra

    def get_retrievals(self, retrievals: torch.Tensor) -> torch.Tensor:
        """(B, K_all, S, S, S) -> (B·K, S, S, S, 1)."""
        b, _, s = retrievals.shape[0:3]
        return retrievals[:, : self.K].reshape(b * self.K, s, s, s, 1)

    def denormalize_target(self, t):
        return t * self.target_std + self.target_mean

    def normalized_target_to_network_pred(self, target):
        return 2 * (self.denormalize_target(target) / self.target_trunc) - 1

    def network_pred_to_df(self, clamped_out):
        return (clamped_out + 1) * self.target_trunc / 2

    def occupancy_from_prediction(self, pred_shape_df: torch.Tensor) -> torch.Tensor:
        """(B, S, S, S, 1) df -> the 2³ max-pooled occupancy (B, S/2, S/2,
        S/2, 1), bool, with no gradient."""
        occ = (pred_shape_df <= self.target_voxel_size * 0.75).float()
        pooled = F.max_pool3d(occ.permute(0, 4, 1, 2, 3), kernel_size=2, stride=2)
        return (pooled.permute(0, 2, 3, 4, 1) > 0).detach()

    # ----------------------------------------------------------------- losses

    def augment_batch_data(self, batch: dict) -> dict:
        """Add normals, weights and the empty mask. As the reference does,
        both masks compare the normalised target against the unnormalised
        truncation."""
        target = batch["target"]
        batch = dict(batch)
        batch["normals"] = compute_normals(self.denormalize_target(target), self.target_trunc)
        batch["weights"] = 1.0 + (target < self.target_trunc).float() * (self.weight_occupied - 1)
        batch["empty"] = target >= self.target_trunc
        return batch

    def adjust_weights(self, pred_empty: torch.Tensor, batch: dict) -> torch.Tensor:
        w = batch["weights"]
        return torch.where(batch["empty"] & pred_empty, torch.zeros_like(w), w)

    def loss_shape(self, pred_shape: torch.Tensor, batch: dict, n_valid=None):
        """(total, l1, normal): weighted L1 in tanh space and the normals'
        cosine loss. With `n_valid` (a padded validation batch whose padded
        rows' weights and normals are zeroed) the L1 mean is over the real
        rows only: `n_valid` counts them over the global batch. Under a
        mesh each value is this rank's share: the shares sum over the ranks
        to the global batch's loss."""
        zero = pred_shape.new_zeros(())
        loss_l1 = loss_normal = zero
        if self.w_rec > 0:
            pred_empty = self.network_pred_to_df(pred_shape) >= self.target_trunc
            weights = self.adjust_weights(pred_empty, batch)
            loss_l1 = torch.mean(torch.abs(
                pred_shape - self.normalized_target_to_network_pred(batch["target"])) * weights)
            if n_valid is not None:
                loss_l1 = loss_l1 * pred_shape.shape[0] / torch.clamp(n_valid, min=1)
            else:
                loss_l1 = loss_l1 / self.world
        if self.w_norm > 0:
            pred_normals = compute_normals(self.network_pred_to_df(pred_shape), self.target_trunc)
            cos_sum, count = cosine_similarity_sums(pred_normals, batch["normals"])
            count = all_reduce_sum(count.to(cos_sum.dtype), self.mesh)
            loss_normal = 1 / self.world - cos_sum / torch.clamp(count, min=1)
        total = self.w_rec * loss_l1 + self.w_norm * loss_normal
        return total, loss_l1, loss_normal

    def compute_sliced_attn_nt_xent_loss(self, batch_size: int, x_attn_fpred, x_attn_ftgt,
                                         occupancy_attn) -> torch.Tensor:
        """The occupancy-gated contrastive loss over `batch_size` slices of
        the patches: a slice counts if it holds an occupied patch and the
        occupied patches of the slices counted before it and its own stay
        within CONTRASTIVE_CAP (in slice order); the loss is the sum of the
        counted slices' masked NT-Xent. Under a mesh the slice order is the
        global batch's: this rank's slices follow those of the ranks before
        it, and the sum is this rank's share."""
        n = x_attn_fpred.shape[0]
        split = n // batch_size
        fpred = x_attn_fpred.reshape(batch_size, split, -1)
        ftgt = x_attn_ftgt.reshape(batch_size, split, -1)
        occ = occupancy_attn.reshape(batch_size, split)
        include, total = [], 0
        for count in gather_rows(occ.sum(dim=1), self.mesh).tolist():
            take = count > 0 and total + count <= CONTRASTIVE_CAP
            total += count if take else 0
            include.append(take)
        include = include[self.rank * batch_size: (self.rank + 1) * batch_size]
        per_slice = torch.func.vmap(
            lambda a, b, v: nt_xent_loss_masked(a, b, v, self.attn_temperature))(fpred, ftgt, occ)
        include = torch.tensor(include, device=per_slice.device)
        return torch.sum(torch.where(include, per_slice, torch.zeros_like(per_slice)))

    # ------------------------------------------------------------- train steps

    def _phase_loss(self, phase: int, batch: dict, gumbel_uniform_draw=None):
        """(total, aux) of `phase` on an augmented batch."""
        if phase == 0:
            total, l1, n = self.loss_shape(self.forward_backbone(batch), batch)
            return total, {"l1": l1, "normal": n}
        if phase == 1:
            total, l1, n = self.loss_shape(self.forward_retrieval(batch), batch)
            return total, {"l1": l1, "normal": n}
        if phase == 2:
            fpred, ftgt, occ = self.forward_attention(batch)
            total = self.compute_sliced_attn_nt_xent_loss(
                batch["target"].shape[0] * 8, fpred, ftgt, occ)
            return total, {"contrastive": total}
        pred_shape, pred_back, pred_retr, fpred, ftgt, occ = self.forward_full(
            batch, gumbel_uniform_draw)
        t_fuse, l1_fuse, n_fuse = self.loss_shape(pred_shape, batch)
        t_back, _, _ = self.loss_shape(pred_back, batch)
        t_retr, _, _ = self.loss_shape(pred_retr, batch)
        contrastive = self.compute_sliced_attn_nt_xent_loss(
            pred_retr.shape[0] * 8, fpred, ftgt, occ)
        total = (t_fuse + contrastive * self.w_attn + t_retr * self.w_side_retr
                 + t_back * self.w_side_unet)
        return total, {"fuse": t_fuse, "l1_fuse": l1_fuse, "normal_fuse": n_fuse,
                       "back": t_back, "retr": t_retr, "contrastive": contrastive}

    def _with_precision(self, loss_fn, batch: dict):
        """loss_fn(batch) -> (total, aux), with the parameters and the
        batch's floats cast to bf16 under mixed precision; total and aux
        come back float32."""
        if not self.mixed_precision:
            return loss_fn(batch)
        self._cast = {name: {k: (v.bfloat16() if v.is_floating_point() else v)
                             for k, v in [*net.named_parameters(), *net.named_buffers()]}
                      for name, net in self.nets.items()}
        try:
            batch = {k: (v.bfloat16() if v.is_floating_point() else v) for k, v in batch.items()}
            total, aux = loss_fn(batch)
        finally:
            self._cast = None
        return total.float(), {k: v.float() for k, v in aux.items()}

    def compute_gradients(self, batch: dict, gumbel_uniform_draw=None, cached: bool = False):
        """The current phase's loss on a device batch (input, target,
        retrieval; with cached, phase 2's loss on cached features: x_back,
        x_target, occ) under the precision setting, and its backward: the
        trainable parameters' .grad hold the gradients (`gradients`).
        Returns the detached (total, aux). `train_step` is this and one Adam
        step. Under a mesh the gradients and the returned losses are summed
        over the ranks: the global batch's."""
        self.optimizer.zero_grad(set_to_none=True)
        if cached:
            total, aux = self._with_precision(self._cached_phase2_loss, batch)
        else:
            total, aux = self._with_precision(
                lambda b: self._phase_loss(self.phase, b, gumbel_uniform_draw),
                self.augment_batch_data(batch))
        self._backward(total)
        return self._global_losses(total.detach(), {k: v.detach() for k, v in aux.items()})

    def _global_losses(self, total: torch.Tensor, aux: dict):
        """(total, aux) summed over the ranks, in one collective (as they
        are without a mesh)."""
        if self.mesh is None:
            return total, aux
        sums = all_reduce_sum(torch.stack([total, *aux.values()]), self.mesh)
        return sums[0], dict(zip(aux, sums[1:]))

    def gradients(self) -> dict:
        """{subnet: {key: a copy of its .grad}} of the current phase's
        trainable sub-networks; a tensor off the loss's path has none."""
        return {name: {k: p.grad.detach().clone() for k, p in self.nets[name].named_parameters()
                       if p.grad is not None}
                for name in PHASE_TRAINABLE[self.phase]}

    def train_step(self, batch: dict, lr: float, gumbel_uniform_draw=None,
                   cached: bool = False):
        """One optimizer step of the current phase at `lr`:
        compute_gradients, then Adam."""
        sched.set_lr(self.optimizer, lr)
        out = self.compute_gradients(batch, gumbel_uniform_draw, cached)
        self.optimizer.step()
        return out

    # -------------------------------------------------- frozen-phase cache
    #
    # In phase 2 only the attention block trains; the backbone, the decoder
    # (the occupancy gate) and the retrieval backbone's target encodes are
    # frozen. Computing them once per phase makes the phase-2 step
    # get_features -> NT-Xent. Enabled by the config's `frozen_phase_cache`.

    def _frozen_features(self, batch: dict):
        x_ = self._call("unet_backbone", batch["input"])
        x_target = self._encode_shape_volumes(batch["target"])
        pred_shape_ = self._call("decoder", x_)
        return x_, x_target, self.occupancy_from_prediction(self.network_pred_to_df(pred_shape_))

    def build_phase2_cache(self, budget_bytes: int = CACHE_BUDGET_BYTES):
        """One frozen forward over the train set. Returns a dict of
        (N, ...) tensors on the device (x_back, x_target: (N, S/2, S/2, S/2,
        nf), bf16 under mixed precision, else float32; occ (N, S/2, S/2,
        S/2, 1) bool) when they fit `budget_bytes`, else a list of host
        item dicts (float32 numpy). Under a mesh, of this rank's shard of
        the train set (its wrapped filler included, so that every rank
        holds as many items and takes as many steps)."""
        n = -(-len(self.train_dataset) // self.world)
        fg = self.config["dataset_train"]["target_chunk_size"] // 2
        nf = self.config["nf"]
        fdt = torch.bfloat16 if self.mixed_precision else torch.float32
        itemsize = torch.finfo(fdt).bits // 8
        per_item = 2 * fg ** 3 * nf * itemsize + fg ** 3
        on_device = n > 0 and n * per_item <= budget_bytes
        if on_device:
            cache = {"x_back": torch.empty((n, fg, fg, fg, nf), dtype=fdt, device=self.device),
                     "x_target": torch.empty((n, fg, fg, fg, nf), dtype=fdt, device=self.device),
                     "occ": torch.empty((n, fg, fg, fg, 1), dtype=torch.bool, device=self.device)}
        items, start = [], 0
        with torch.no_grad():
            for batch in self._batches(self.train_dataset, shuffle=False):
                db = self._device_batch(batch, with_retrieval=False)
                feats = dict(zip(("x_back", "x_target", "occ"), self._frozen_features(db)))
                v = min(self.local_batch, n - start)  # the shard's rows, not the padding
                if on_device:
                    for k, t in feats.items():
                        cache[k][start:start + v] = t[:v]
                else:
                    host = {k: t[:v].cpu().numpy() for k, t in feats.items()}
                    items.extend({k: a[i] for k, a in host.items()} for i in range(v))
                start += v
        return cache if on_device else items

    def _cached_phase2_loss(self, cb: dict):
        fpred, ftgt, occ_attn = self._attn_get_features(cb["x_back"], cb["x_target"], cb["occ"])
        total = self.compute_sliced_attn_nt_xent_loss(
            cb["x_back"].shape[0] * 8, fpred, ftgt, occ_attn)
        return total, {"contrastive": total}

    # ------------------------------------------------------------------ loops

    def _batches(self, dataset, **kwargs):
        """batch_iterator over this rank's shard of `dataset` (all of it
        without a mesh), in batches of its rows of the global batch."""
        return batch_iterator(dataset, self.local_batch, process_index=self.rank,
                              process_count=self.world, **kwargs)

    def _device_batch(self, batch: dict, with_retrieval: bool = True) -> dict:
        """A loader batch on the device: this rank's rows of the global batch."""
        keys = ("input", "target", "retrieval") if with_retrieval else ("input", "target")
        return {k: torch.from_numpy(np.asarray(batch[k])).to(self.device) for k in keys}

    def _cached_device_batch(self, batch: dict) -> dict:
        """A batch of host cache items on the device."""
        return {k: torch.from_numpy(batch[k]).to(self.device) for k in ("x_back", "x_target", "occ")}

    def _global_rowmask(self, n_valid_local: int) -> torch.Tensor:
        """(W·B,) bool validity of the global batch's rows, rank-major as the
        rows themselves: each rank's rows are valid up to its own count, so
        its padding lies in its own block."""
        local = torch.arange(self.local_batch, device=self.device) < int(n_valid_local)
        if self.mesh is None:
            return local
        return make_global_batch({"rowmask": local}, self.mesh)["rowmask"]

    def _current_lr(self, epoch: int) -> float:
        """MultiStepLR milestones apply in phase 3 only, with no warm-up."""
        return sched.current_lr(self.base_lr, self.milestones if self.phase == 3 else None,
                                self.global_step, epoch, warmup_steps=0)

    def _epoch_batches(self, epoch: int, cache):
        """(device batch, cached) pairs of one epoch: the train set
        shuffled with `epoch` as seed, the last partial batch dropped; the
        cached phase-2 features when `cache` is given."""
        bs = self.local_batch
        if isinstance(cache, dict):
            n_items = cache["occ"].shape[0]
            perm = np.random.default_rng(epoch).permutation(n_items)
            for s in range(0, n_items - bs + 1, bs):
                idx = torch.from_numpy(perm[s:s + bs]).to(self.device)
                yield {k: v[idx] for k, v in cache.items()}, True
            return
        if cache is None:
            for batch in self._batches(self.train_dataset, shuffle=True, drop_last=True,
                                       seed=epoch):
                yield self._device_batch(batch), False
            return
        for batch in batch_iterator(cache, bs, shuffle=True, drop_last=True, seed=epoch):
            yield self._cached_device_batch(batch), True

    def fit(self, max_epochs: int, save_epoch: int = 1, val_check_interval: int = 1,
            max_steps_per_epoch: int | None = None, logger=None):
        writer = is_writer(self.mesh)
        own_logger = logger is None and writer
        logger = logger or (MetricsLogger(self.config["experiment"]) if writer else None)
        self.generator = self._generator(self.seed)
        cache = None
        if self.phase == 2 and self.config.get("frozen_phase_cache"):
            cache = self.build_phase2_cache()
        for epoch in range(max_epochs):
            n = 0
            total = aux = None
            for db, cached in self._epoch_batches(epoch, cache):
                lr = self._current_lr(epoch)
                total, aux = self.train_step(db, lr, cached=cached)
                self.global_step += 1
                n += 1
                if max_steps_per_epoch and n >= max_steps_per_epoch:
                    break
            if total is not None and logger:
                logger.log({"train/total_loss": float(total), "phase": self.phase,
                            "lr": lr, "epoch": epoch,
                            **{f"train/{k}": float(v) for k, v in aux.items()}},
                           step=self.global_step)
            if (epoch + 1) % max(1, int(val_check_interval)) == 0:
                self.validate(logger)
            if (epoch + 1) % save_epoch == 0 and writer:
                self.save(epoch)
        if own_logger:
            logger.close()
        return self

    # -------------------------------------------------------------- validation

    def _val_batch_limit(self, n_items: int) -> int | None:
        """`val_check_percent` -> the most validation batches per split (of
        this rank's shard)."""
        pct = float(self.config.get("val_check_percent", 1.0) or 1.0)
        if pct >= 1.0:
            return None
        n_batches = -(-(-(-n_items // self.world)) // self.local_batch)
        return max(1, int(n_batches * pct))

    def val_losses(self, batch: dict, rowmask: torch.Tensor, gumbel_uniform_draw=None):
        """(pred_shape, {shape, l1, normal, attn_contrastive}) of a device
        batch with the collate padding masked out: the padded rows' weights
        and normals are zeroed (out of the weighted L1 and the normals'
        valid mask), their patches leave the contrastive occupancy gate, and
        the L1 mean is over the real rows. `rowmask` (B,) bool marks them;
        under a mesh it is the global batch's (W·B,) mask (_global_rowmask),
        whose count divides, and the losses returned are the global
        batch's."""
        with torch.no_grad():
            batch = self.augment_batch_data(batch)
            b = batch["target"].shape[0]
            n_valid = rowmask.sum()
            if self.mesh is not None:
                rowmask = rowmask[self.mesh.rows(rowmask.shape[0])]
            rm = rowmask.to(batch["target"].dtype).reshape(b, 1, 1, 1, 1)
            batch["weights"] = batch["weights"] * rm
            batch["normals"] = batch["normals"] * rm
            pred_shape, _, pred_retr, fpred, ftgt, occ = self.forward_full(
                batch, gumbel_uniform_draw)
            total, l1, normal = self.loss_shape(pred_shape, batch, n_valid=n_valid)
            occ = occ & rowmask.repeat_interleave(occ.shape[0] // b)
            contrastive = self.compute_sliced_attn_nt_xent_loss(
                pred_retr.shape[0] * 8, fpred, ftgt, occ)
            total, losses = self._global_losses(
                total, {"l1": l1, "normal": normal, "attn_contrastive": contrastive})
        return pred_shape, {"shape": total, **losses}

    def validate(self, logger=None, max_batches: int | None = None) -> dict:
        """The rough metrics (IoU, chamfer, precision, recall, F1) of the
        fused prediction and of the 1-NN retrieval, over val and
        train_eval, with the per-batch validation losses; prints the
        summary table. Returns {"val_fuse" | "val_nn1" | "train_fuse" |
        "train_nn1": {metric: value}}."""
        metric_sets = {}
        gen = self._generator(VAL_SEED)
        thr = self.target_voxel_size * 0.75
        for split_key, ds in (("val", self.val_dataset), ("train", self.dataset("train_eval"))):
            limit = max_batches if max_batches is not None else self._val_batch_limit(len(ds))
            metrics_fuse = [IoU(self.device), Chamfer3D(device=self.device),
                            Precision(self.device), Recall(self.device)]
            metrics_nn1 = [IoU(self.device), Chamfer3D(device=self.device),
                           Precision(self.device), Recall(self.device)]
            loss_sums, n_loss = {}, 0
            for bi, batch in enumerate(self._batches(ds, shuffle=False)):
                if limit and bi >= limit:
                    break
                db = self._device_batch(batch)
                pred_shape, losses = self.val_losses(
                    db, self._global_rowmask(batch["valid"]),
                    self.gumbel_draw(self.local_batch, gen))
                for lk, lv in losses.items():
                    loss_sums[lk] = loss_sums.get(lk, 0.0) + float(lv)
                n_loss += 1
                pred_df = self.network_pred_to_df(pred_shape)
                target_occ = self.denormalize_target(db["target"]) <= thr
                nn1 = self.denormalize_target(db["retrieval"][:, :1])
                nn1_occ = (nn1 <= thr).permute(0, 2, 3, 4, 1)
                for m in metrics_fuse:
                    m.update(pred_df <= thr, target_occ, n_valid=batch["valid"])
                for m in metrics_nn1:
                    m.update(nn1_occ, target_occ, n_valid=batch["valid"])
            for m in metrics_fuse + metrics_nn1:
                m.all_reduce(self.mesh)
            metric_sets[f"{split_key}_fuse"] = metrics_fuse
            metric_sets[f"{split_key}_nn1"] = metrics_nn1
            if logger and n_loss:
                logger.log({f"{split_key}_full/{lk}": v / n_loss for lk, v in loss_sums.items()},
                           step=self.global_step)
        table = [["split", "shape", "iou (rough)", "cd (rough)", "precision (rough)",
                  "recall (rough)", "f1 (rough)"]]
        results = {}
        for key, ms in metric_sets.items():
            iou, cd, precision, recall = [m.compute() for m in ms]
            f1 = (2 * precision * recall / (precision + recall) if precision + recall > 0
                  else float("nan"))
            split, pred_type = key.rsplit("_", 1)
            table.append([split, pred_type, iou, cd, precision, recall, f1])
            results[key] = {"iou": iou, "cd": cd, "precision": precision, "recall": recall,
                            "f1": f1}
            if logger:
                logger.log({f"{key}/{m}": v for m, v in results[key].items()},
                           step=self.global_step)
        if not is_writer(self.mesh):
            return results
        print(format_table(table))
        if self.enable_vis:
            self.run_visualization("val")
            if not self.config.get("disable_train_vis", True):
                self.run_visualization("train")
        return results

    def run_visualization(self, out_tag: str = "val") -> Path:
        """forward_full over the `<out_tag>_vis` split (Gumbel draws seeded
        with VIS_SEED), the predictions stitched per scene, and
        <scene>_gt.obj, _fuse.obj and _input.obj written under
        runs/<experiment>/vis_<out_tag>/<global_step // 1000>/, whose path
        it returns. The meshes come from the split's own SceneHandler."""
        ds = self.dataset(f"{out_tag}_vis")
        gen = self._generator(VIS_SEED)
        pred_shapes = []
        with torch.no_grad():
            for batch in batch_iterator(ds, self.batch_size, shuffle=False):
                pred_shape = self.forward_full(self._device_batch(batch),
                                               self.gumbel_draw(self.batch_size, gen))[0]
                pred_df = self.network_pred_to_df(pred_shape)[..., 0].float().cpu().numpy()
                pred_shapes.append(pred_df[: batch["valid"]].astype(np.float16))
        combined_pred = ds.combine_retrievals(np.concatenate(pred_shapes)[:, None], 0)
        combined_inputs = ds.combine_inputs()
        combined_targets = ds.combine_targets()
        out = (Path("runs") / self.config["experiment"] / f"vis_{out_tag}"
               / f"{self.global_step // 1000:05d}")
        out.mkdir(exist_ok=True, parents=True)
        handler = self.scene_handlers.get(out_tag, self.scene_handlers["val"])
        for scene in combined_targets:
            handler.visualize_target_chunk(combined_targets[scene].astype(np.float32),
                                           out / f"{scene}_gt.obj", device=self.device)
            handler.visualize_target_chunk(combined_pred[scene].astype(np.float32),
                                           out / f"{scene}_fuse.obj", device=self.device)
            handler.visualize_input_chunk(combined_inputs[scene].astype(np.float32),
                                          out / f"{scene}_input.obj")
        return out

    # ------------------------------------------------------------ checkpoints

    def optimizer_state(self) -> dict:
        """The optimizer's moments by parameter name: {"phase": phase,
        "state": {"<subnet>.<key>": {"step", "exp_avg", "exp_avg_sq"}}};
        parameters without a step yet are left out."""
        state = {}
        for name in PHASE_TRAINABLE[self.phase]:
            for key, p in self.nets[name].named_parameters():
                if p in self.optimizer.state:
                    state[f"{name}.{key}"] = {k: v.detach().cpu()
                                              for k, v in self.optimizer.state[p].items()}
        return {"phase": self.phase, "state": state}

    def load_optimizer_state(self, opt_state: dict) -> None:
        """Load optimizer_state()'s dict into the current phase's optimizer:
        moments of the phase's trainable tensors only (a tensor that never
        had a gradient has none)."""
        names = {f"{name}.{key}": p for name in PHASE_TRAINABLE[self.phase]
                 for key, p in self.nets[name].named_parameters()}
        extra = sorted(set(opt_state["state"]) - set(names))
        if extra or not opt_state["state"]:
            raise ValueError(
                f"the optimizer state (phase {opt_state.get('phase')}) holds "
                f"{len(extra)} tensors not trainable in phase {self.phase}, e.g. {extra[:2]}")
        for key in opt_state["state"]:
            p = names[key]
            self.optimizer.state[p] = {
                k: (v if k == "step" else v.to(device=p.device, dtype=p.dtype))
                for k, v in opt_state["state"][key].items()}

    def save(self, epoch: int) -> Path:
        return save_checkpoint(Path("runs") / self.config["experiment"], epoch, self.params(),
                               extra={"global_step": self.global_step, "phase": self.phase},
                               opt_state=self.optimizer_state())

    def load(self, ckpt_path, params_only: bool = True) -> None:
        """The four sub-networks from a checkpoint and its global step; a
        fresh optimizer, or with params_only=False the checkpoint's
        optimizer state, in the phase it was saved in."""
        restored = load_checkpoint(ckpt_path)
        self.load_params(restored["params"])
        if params_only:
            self.set_phase(self.phase)
        else:
            if "opt_state" not in restored:
                raise FileNotFoundError(f"{ckpt_path} holds no optimizer state")
            self.set_phase(int(restored["opt_state"]["phase"]))
            self.load_optimizer_state(restored["opt_state"])
        self.global_step = int(restored.get("meta", {}).get("global_step", 0))


def format_table(rows: list) -> str:
    """Rows (the first the header) as a psql-style text table, floats to
    four decimals."""
    cells = [[f"{v:.4f}" if isinstance(v, float) else str(v) for v in row] for row in rows]
    widths = [max(len(row[i]) for row in cells) for i in range(len(cells[0]))]
    rule = "+" + "+".join("-" * (w + 2) for w in widths) + "+"

    def line(row):
        return "| " + " | ".join(c.rjust(w) if i >= 2 else c.ljust(w)
                                 for i, (c, w) in enumerate(zip(row, widths))) + " |"
    return "\n".join([rule, line(cells[0]), rule, *map(line, cells[1:]), rule])


def train_refinement_phases(config: dict, max_steps_per_epoch: int | None = None,
                            enable_vis: bool = False, device=None,
                            mesh=None) -> RefinementTrainer:
    """The phase-chained curriculum: cumulative epochs from phase_change_epochs
    and max_epoch, a fresh optimizer at each phase boundary, `sanity_steps`
    validation batches first, and a checkpoint at each phase's end (rank 0
    writes under a `mesh`)."""
    phase_epochs = list(config.get("phase_change_epochs", [30, 25, 5]))
    max_epochs = phase_epochs + [config.get("max_epoch", 100)]
    for i in range(len(max_epochs) - 1):
        max_epochs[i + 1] = max_epochs[i] + max_epochs[i + 1]
    start_phase = config.get("current_phase", 0)

    trainer = RefinementTrainer(config, device=device, enable_vis=enable_vis, mesh=mesh)
    logger = MetricsLogger(config["experiment"]) if is_writer(mesh) else None
    if config.get("sanity_steps", 0) and config["sanity_steps"] > 0:
        trainer.validate(logger, max_batches=int(config["sanity_steps"]))
    val_every = max(1, int(config.get("val_check_interval", 1)))
    prev_epochs = 0 if start_phase == 0 else max_epochs[start_phase - 1]
    for phase in range(start_phase, 4):
        trainer.set_phase(phase)
        trainer.fit(max_epochs[phase] - prev_epochs, save_epoch=config.get("save_epoch", 1),
                    val_check_interval=val_every, max_steps_per_epoch=max_steps_per_epoch,
                    logger=logger)
        prev_epochs = max_epochs[phase]
        if logger:
            trainer.save(prev_epochs - 1)
    if logger:
        logger.close()
    return trainer


def main(argv=None):
    """The refinement trainer's CLI, with the JAX package's flags (plus
    `--device`):

        python -m retrieval_fuse_tpu_torch.train.refinement_trainer --config C.yaml \\
            [--phase_change_epochs 30 25 5] [--max_epoch N] [--sanity_steps S] \\
            [--resume runs/<exp>/ckpt_epoch=E] [--no_retrievals] [--device cpu]

    The retrievals are the composed volumes of `--retrieval_ckpt` (the
    retrieval CLI's `compose`); `--no_retrievals` trains on trunc-filled
    dummies instead (the flag, absent, overrides the YAML's value). With
    `--resume` it trains on from the checkpoint with the visualisations on
    (`--sanity_steps -1`: validates once, meshes included, and stops), as
    the JAX CLI does. Started by torchrun with several processes, it trains
    data-parallel (one card a process) over the global batch `batch_size`."""
    from retrieval_fuse_tpu_torch.config.arguments import parse_arguments
    from retrieval_fuse_tpu_torch.parallel.mesh import (
        broadcast_object, initialize_from_environment, mesh_for_batch)
    from retrieval_fuse_tpu_torch.utils.logger import FilesystemLogger

    config = parse_arguments(argv)
    initialize_from_environment(config.get("device"))
    mesh = mesh_for_batch(config["batch_size"], config.get("device"))
    device = mesh.device if mesh else resolve_device(config.get("device"))  # before any write
    config["experiment"] = broadcast_object(config["experiment"], mesh)
    np.random.seed(config["seed"])
    if is_writer(mesh):
        FilesystemLogger(config)
    if not config.get("resume"):
        return train_refinement_phases(config, device=device, mesh=mesh)
    trainer = RefinementTrainer(config, device=device, enable_vis=True, mesh=mesh)
    trainer.load(config["resume"])
    if config.get("sanity_steps") == -1:
        trainer.validate()
        return trainer
    if config.get("sanity_steps", 0) and config["sanity_steps"] > 0:
        trainer.validate(max_batches=int(config["sanity_steps"]))
    trainer.fit(max_epochs=config["max_epoch"], save_epoch=config["save_epoch"],
                val_check_interval=max(1, int(config.get("val_check_interval", 1))))
    return trainer


if __name__ == "__main__":
    main()
