"""Retrieval-network trainer, as in the JAX package's
train/retrieval_trainer.py: contrastive embedding of input and target
patches.

Adam (weight decay 5e-5, coupled) with MultiStepLR(0.5) and a 1500-step
linear warm-up (train/schedule.py), optional Gaussian input and code noise,
NT-Xent with the optional IoU-scaled temperature, and a validation stage
that rebuilds the patch dictionary, runs retrieval for train_eval (with and
without same-scene exclusion) and val, logs the four rough metrics and,
with `enable_vis`, writes the val_vis scenes' input, 1-NN retrieval and
target meshes with one rendered preview (PNG) per scene.

One eager step: both encoders, the loss, `loss.backward()`,
`optimizer.step()`, on the trainer's device (the CUDA card unless "cpu" is
asked for). The retrieval validation runs the port's dictionary, kNN (the
kNN or topk kernel on the card) and chamfer kernel on that device.

With a `mesh` (parallel/mesh.py: one process per card), `batch_size` is
the global batch and each rank loads and encodes its contiguous 1/W of it
(the loader's process sharding). The NT-Xent loss is the global batch's:
each rank gathers every rank's embeddings (and, with IoU scaling, the
occupancies) and computes the same (2B, 2B) loss, differentiating into its
own rows only; the BatchNorm encoders take the global batch's statistics;
the ranks' gradients are summed, so each step equals the one-process step
on the global batch. Noise is drawn for the global batch and each rank
keeps its rows. Rank 0 alone writes logs, checkpoints, the dictionary and
the visualisations; the retrieval validation searches the dictionary
sharded over the ranks (ops/knn.sharded_exact_knn).
"""

from __future__ import annotations

from pathlib import Path

import numpy as np
import torch

from retrieval_fuse_tpu_torch.data import SceneHandler, PatchedSceneDataset, batch_iterator
from retrieval_fuse_tpu_torch.device import resolve_device
from retrieval_fuse_tpu_torch.evaluation.metrics import Chamfer3D, IoU, Precision, Recall
from retrieval_fuse_tpu_torch.models import get_retrieval_networks, init_module_params
from retrieval_fuse_tpu_torch.models.encoders import set_batchnorm_mesh
from retrieval_fuse_tpu_torch.models.losses import nt_xent_loss
from retrieval_fuse_tpu_torch.parallel.mesh import (
    barrier, data_parallel_jit, gather_rows, is_writer, replicate)
from retrieval_fuse_tpu_torch.retrieval.dictionary import create_dictionary, make_encoder_apply
from retrieval_fuse_tpu_torch.retrieval.engine import RetrievalInterface
from retrieval_fuse_tpu_torch.train import schedule as sched
from retrieval_fuse_tpu_torch.train.checkpoint import load_checkpoint, save_checkpoint
from retrieval_fuse_tpu_torch.utils.logger import MetricsLogger, log_images
from retrieval_fuse_tpu_torch.utils.misc import get_iou_matrix

ENCODERS = ("fenc_input", "fenc_target")


class RetrievalTrainer:

    def __init__(self, config: dict, device=None, enable_vis: bool = False, mesh=None):
        """`enable_vis`: the retrieval validation also writes the val_vis
        scenes' meshes and previews (main turns it on, as the JAX CLI
        does). `mesh`: train data-parallel over its ranks, on its device."""
        self.config = config
        self.mesh = mesh
        self.device = mesh.device if mesh is not None else resolve_device(device)
        self.enable_vis = enable_vis
        rt = config["retrieval_training"]
        self.temperature = rt["temprature"]
        self.base_lr = rt["lr"]
        self.milestones = rt["scheduler"]
        self.batch_size = rt["batch_size"]  # the global batch
        self.world = mesh.size if mesh is not None else 1
        self.rank = mesh.rank if mesh is not None else 0
        self.local_batch = self.batch_size // self.world
        self.iou_scaling = rt["iou_scaling"]
        self.w_contrastive = rt["loss"]["contrastive"]
        self.latent_dim = config["retrieval_model"]["latent_dim"]
        dtr = config["dataset_train"]
        self.target_mean, self.target_std = dtr["target_mean"], dtr["target_std"]
        # the raw config value, not its float16 round-trip: the reference's
        # IoU gate reads voxel_size_target directly
        self.occ_threshold = 0.75 * dtr["voxel_size_target"]
        self.input_noise_std = rt["input_noise"] * dtr["voxel_size_target"]
        self.code_noise_std = rt["code_noise"]

        self.scene_handlers = {"train": SceneHandler("train", config),
                               "val": SceneHandler("val", config)}
        self.train_dataset = self.dataset("train")
        self.retrieval_handler = RetrievalInterface(config["query"], self.latent_dim,
                                                    device=self.device, mesh=mesh)

        seed = config.get("seed", 0) or 0
        rng = np.random.default_rng(seed)
        self.encoders = dict(zip(ENCODERS, get_retrieval_networks(config["retrieval_model"])))
        for net in self.encoders.values():
            net.load_state_dict(init_module_params(net, rng))
            net.to(self.device)
            if mesh is not None:
                replicate(net, mesh)
                set_batchnorm_mesh(net, mesh)
        self.fenc_input = self.encoders["fenc_input"]
        self.fenc_target = self.encoders["fenc_target"]
        self.optimizer = self._new_optimizer()
        # the loss's backward, its gradients summed over the mesh's ranks
        self._backward = data_parallel_jit(
            torch.Tensor.backward, mesh, lambda: self.optimizer.param_groups[0]["params"])
        # the input and code noise (0 in every shipped config)
        self.noise = torch.Generator(device=self.device)
        self.noise.manual_seed(seed)
        self.current_learning_rate = self.base_lr
        self.global_step = 0

    def dataset(self, split: str) -> PatchedSceneDataset:
        """The patched dataset of `split` ("train", "val", "train_eval", ...)."""
        base = split.split("_")[0]
        return PatchedSceneDataset(split, self.config[f"dataset_{base}"],
                                   self.scene_handlers[base])

    def _new_optimizer(self) -> torch.optim.Adam:
        params = [p for net in self.encoders.values() for p in net.parameters()]
        return torch.optim.Adam(params, lr=self.base_lr, weight_decay=sched.WEIGHT_DECAY)

    def params(self) -> dict:
        """{'fenc_input': state_dict, 'fenc_target': state_dict}."""
        return {name: net.state_dict() for name, net in self.encoders.items()}

    def load_params(self, params: dict) -> None:
        """Load both encoders' state_dicts (running BatchNorm statistics
        included) and start a new optimizer."""
        for name, net in self.encoders.items():
            net.load_state_dict(params[name])
        self.optimizer = self._new_optimizer()

    # ------------------------------------------------------------------ steps

    def _randn(self, shape) -> torch.Tensor:
        """Standard normal noise for this rank's rows: drawn for the global
        batch (W times the rows) and this rank's block kept, so that the
        global batch's rows get the one-process step's noise."""
        noise = torch.randn((shape[0] * self.world,) + tuple(shape[1:]), generator=self.noise,
                            device=self.device)
        return noise[self.rank * shape[0]: (self.rank + 1) * shape[0]]

    def _embed(self, batch: dict, train: bool):
        """(f_in, f_tgt, the target the encoder saw): both embeddings
        (B, latent) L2-normalised, noised in training where configured."""
        target = batch["target"]
        if train and self.input_noise_std > 0:
            target = target + self._randn(target.shape) * self.input_noise_std
        f_in = self.fenc_input(batch["input"])
        f_tgt = self.fenc_target(target)
        f_in = f_in.reshape(f_in.shape[0], -1)
        f_tgt = f_tgt.reshape(f_tgt.shape[0], -1)
        f_in = f_in / torch.clamp(torch.linalg.vector_norm(f_in, dim=1, keepdim=True), min=1e-12)
        f_tgt = f_tgt / torch.clamp(torch.linalg.vector_norm(f_tgt, dim=1, keepdim=True),
                                    min=1e-12)
        if train and self.code_noise_std > 0:
            f_in = f_in + self._randn(f_in.shape) * self.code_noise_std
            f_tgt = f_tgt + self._randn(f_tgt.shape) * self.code_noise_std
        return f_in, f_tgt, target

    def _loss_fn(self, batch: dict, train: bool):
        """(total loss, contrastive loss). The IoU temperatures come from the
        target the encoder saw (noised in training, as the reference noises
        the batch in place before it computes them). Under a mesh, the
        embeddings and occupancies are the global batch's, gathered in rank
        order."""
        f_in, f_tgt, target = self._embed(batch, train)
        f_in, f_tgt = gather_rows(f_in, self.mesh), gather_rows(f_tgt, self.mesh)
        iou_matrix = None
        if self.iou_scaling:
            occ = target * self.target_std + self.target_mean <= self.occ_threshold
            occ = gather_rows(occ.to(torch.uint8), self.mesh).bool()
            iou_matrix = get_iou_matrix(occ[..., 0]).repeat(2, 2)
        contrastive = nt_xent_loss(f_in, f_tgt, self.temperature, iou_matrix)
        return contrastive * self.w_contrastive, contrastive

    def _train_step(self, batch: dict, lr: float):
        """One optimizer step at learning rate `lr`; the gradients (summed
        over the ranks under a mesh) stay in the parameters' .grad. Returns
        the (total, contrastive) loss before the step."""
        sched.set_lr(self.optimizer, lr)
        for net in self.encoders.values():
            net.train()
        self.optimizer.zero_grad(set_to_none=True)
        total, contrastive = self._loss_fn(batch, train=True)
        self._backward(total)
        self.optimizer.step()
        return total.detach(), contrastive.detach()

    def _eval_step(self, batch: dict):
        for net in self.encoders.values():
            net.eval()
        with torch.no_grad():
            return self._loss_fn(batch, train=False)

    def _device_batch(self, batch: dict) -> dict:
        return {k: torch.from_numpy(batch[k]).to(self.device) for k in ("input", "target")}

    # ------------------------------------------------------------------ loops

    def _batches(self, dataset, **kwargs):
        """batch_iterator over this rank's shard of `dataset`, in batches of
        its rows of the global batch."""
        return batch_iterator(dataset, self.local_batch, process_index=self.rank,
                              process_count=self.world, **kwargs)

    def fit(self, max_epochs: int, val_check_interval: int = 1, save_epoch: int = 1,
            run_retrieval_validation: bool = True, max_steps_per_epoch: int | None = None):
        writer = is_writer(self.mesh)
        logger = MetricsLogger(self.config["experiment"]) if writer else None
        run_dir = Path("runs") / self.config["experiment"]
        for epoch in range(max_epochs):
            n = 0
            total = contrastive = None
            lr = self.current_learning_rate
            for batch in self._batches(self.train_dataset, shuffle=True, drop_last=True,
                                       seed=epoch):
                lr = sched.current_lr(self.base_lr, self.milestones, self.global_step, epoch)
                self.current_learning_rate = lr
                total, contrastive = self._train_step(self._device_batch(batch), lr)
                self.global_step += 1
                n += 1
                if max_steps_per_epoch and n >= max_steps_per_epoch:
                    break
            if total is not None and logger:
                logger.log({"train/total_loss": float(total),
                            "train/contrastive_loss": float(contrastive),
                            "learning_rate": lr, "epoch": epoch}, step=self.global_step)
            if (epoch + 1) % max(1, int(val_check_interval)) == 0:
                self.validate(epoch, logger, run_retrieval_validation)
            if (epoch + 1) % save_epoch == 0 and writer:
                self.save(run_dir, epoch)
        if logger:
            logger.close()
        return self

    def validate(self, epoch: int, logger=None, run_retrieval_validation: bool = True,
                 max_batches: int | None = None) -> float:
        """Mean val loss over the val batches (the last one padded, as the
        loader pads it), then the retrieval validation."""
        ds_val = self.dataset("val")
        totals = []
        if max_batches is None:
            max_batches = self._val_batch_limit(len(ds_val))
        for bi, batch in enumerate(self._batches(ds_val, shuffle=False, drop_last=False)):
            if max_batches is not None and bi >= max_batches:
                break
            totals.append(float(self._eval_step(self._device_batch(batch))[0]))
        if logger:
            logger.log({"val/total_loss": float(np.mean(totals)), "epoch": epoch},
                       step=self.global_step)
        if run_retrieval_validation:
            self.retrieval_validation(epoch, logger)
        return float(np.mean(totals)) if totals else float("nan")

    def _val_batch_limit(self, n_items: int) -> int | None:
        """`val_check_percent` -> the most validation batches to run (of
        this rank's shard)."""
        pct = float(self.config.get("val_check_percent", 1.0) or 1.0)
        if pct >= 1.0:
            return None
        n_batches = -(-(-(-n_items // self.world)) // self.local_batch)
        return max(1, int(n_batches * pct))

    # ------------------------------------------------ full retrieval pipeline

    def encoder_apply_fns(self):
        """Apply functions of both encoders (eval mode, no grad, on the
        trainer's device): numpy batch -> output tensor."""
        return (make_encoder_apply(self.fenc_input, self.device),
                make_encoder_apply(self.fenc_target, self.device))

    def retrieval_validation(self, epoch: int, logger=None) -> dict:
        """Dictionary -> kNN -> compose -> metrics for train_eval (without
        and with the query's own scene) and val, then, with enable_vis, the
        val_vis meshes and previews (their count logged by log_images);
        returns {split: [iou, cd, precision, recall]}. Under a mesh, rank 0
        builds the dictionary and writes the visualisations, and the kNN is
        sharded over the ranks; every rank returns the metrics."""
        output_dir = (Path("runs") / self.config["experiment"] / "visualization"
                      / f"epoch_{epoch:04d}")
        output_dir.mkdir(exist_ok=True, parents=True)
        ds_train, ds_val, ds_train_eval = (self.dataset(s) for s in ("train", "val", "train_eval"))
        encode_in, encode_tgt = self.encoder_apply_fns()
        if is_writer(self.mesh):
            create_dictionary(encode_tgt, self.config["dictionary"], self.latent_dim, ds_train,
                              output_dir)
        barrier(self.mesh)
        results = {}
        for key, ds, ignore_source in [("train", ds_train_eval, True),
                                       ("traingt", ds_train_eval, False),
                                       ("val", ds_val, False)]:
            retrievals = self.retrieval_handler.create_mapping_and_retrieve_nearest_scenes_for_all(
                encode_in, output_dir, ds_train_eval, ds, 1, ignore_source)
            metrics = get_metrics_for_retrieval(retrievals, ds, device=self.device)
            results[key] = (retrievals, metrics)
            if logger:
                logger.log({f"{key}/{m}": v for m, v in
                            zip(["iou", "cd", "precision", "recall"], metrics)},
                           step=self.global_step)
            print(f"[{key}] rough IoU: {metrics[0]:.3f} | CD: {metrics[1]:.3f} | "
                  f"P: {metrics[2]:.3f} | R: {metrics[3]:.3f}")
        if self.enable_vis and is_writer(self.mesh):
            self._visualize(output_dir, ds_val, results["val"][0])
            if logger:
                log_images(logger, output_dir / "render_val_vis", step=self.global_step)
        barrier(self.mesh)
        return {key: metrics for key, (_, metrics) in results.items()}

    def _visualize(self, output_dir: Path, ds_val, val_retrievals) -> None:
        """The val_vis scenes, stitched from their chunks: <scene>_gt.obj
        (target), _pred.obj (the 1-NN retrieval) and _input.obj (input
        voxels) under <output_dir>/visualization_val_vis, and one rendered
        preview each under <output_dir>/render_val_vis."""
        from retrieval_fuse_tpu_torch.utils.visualization import render_visualizations_to_image
        ds_vis = self.dataset("val_vis")
        vis_idx = [ds_val.scenes.index(x) for x in ds_vis.scenes]
        combined_retrievals = ds_vis.combine_retrievals(val_retrievals[vis_idx], 0)
        combined_inputs = ds_vis.combine_inputs()
        combined_targets = ds_vis.combine_targets()
        mesh_dir = output_dir / "visualization_val_vis"
        mesh_dir.mkdir(exist_ok=True, parents=True)
        handler = self.scene_handlers["val"]
        for scene in combined_retrievals:
            handler.visualize_target_chunk(combined_targets[scene].astype(np.float32),
                                           mesh_dir / f"{scene}_gt.obj", device=self.device)
            handler.visualize_target_chunk(combined_retrievals[scene].astype(np.float32),
                                           mesh_dir / f"{scene}_pred.obj", device=self.device)
            handler.visualize_input_chunk(combined_inputs[scene].astype(np.float32),
                                          mesh_dir / f"{scene}_input.obj")
        render_visualizations_to_image(mesh_dir, output_dir / "render_val_vis")

    # ------------------------------------------------------------ checkpoints

    def save(self, run_dir, epoch: int) -> Path:
        return save_checkpoint(run_dir, epoch, self.params(),
                               extra={"global_step": self.global_step})

    def load(self, ckpt_path) -> None:
        """Both encoders from a checkpoint, a new optimizer, and the saved
        global step."""
        restored = load_checkpoint(ckpt_path)
        self.load_params(restored["params"])
        self.global_step = int(restored.get("meta", {}).get("global_step", 0))


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


def main(argv=None):
    """The retrieval trainer's CLI, with the JAX package's flags (plus
    `--device`):

        python -m retrieval_fuse_tpu_torch.train.retrieval_trainer --config C.yaml \\
            [--max_epoch N] [--sanity_steps S] [--val_check_interval I] [--device cpu]

    Started by torchrun with several processes, it trains data-parallel
    (one card a process) over the global batch
    `retrieval_training.batch_size`. The retrieval validation writes the
    val_vis meshes and previews (enable_vis), as the JAX CLI's does."""
    from retrieval_fuse_tpu_torch.config.arguments import parse_arguments
    from retrieval_fuse_tpu_torch.parallel.mesh import (
        broadcast_object, initialize_from_environment, mesh_for_batch)
    from retrieval_fuse_tpu_torch.utils.logger import FilesystemLogger

    config = parse_arguments(argv)
    initialize_from_environment(config.get("device"))
    mesh = mesh_for_batch(config["retrieval_training"]["batch_size"], config.get("device"))
    device = mesh.device if mesh else resolve_device(config.get("device"))  # before any write
    config["experiment"] = broadcast_object(config["experiment"], mesh)
    config["no_retrievals"] = True
    np.random.seed(config["seed"])
    if is_writer(mesh):
        FilesystemLogger(config)
    trainer = RetrievalTrainer(config, device=device, enable_vis=True, mesh=mesh)
    if config.get("resume"):
        trainer.load(config["resume"])
    if config.get("sanity_steps"):
        # as Lightning's num_sanity_val_steps: N > 0 runs N val batches before
        # fitting; -1 runs the full validation (with the retrieval pipeline)
        # and stops
        if config["sanity_steps"] == -1:
            trainer.validate(0, run_retrieval_validation=True)
            return trainer
        trainer.validate(0, run_retrieval_validation=False,
                         max_batches=int(config["sanity_steps"]))
    trainer.fit(max_epochs=config["max_epoch"],
                val_check_interval=max(1, int(config.get("val_check_interval", 1))),
                save_epoch=config["save_epoch"])
    return trainer


if __name__ == "__main__":
    main()
