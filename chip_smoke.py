#!/usr/bin/env python3
"""Drive the PyTorch port's serving, retrieval and training paths on one CUDA card.

    python3 chip_smoke.py [--seed 0] [--out chiprun_out/chip_smoke.json]

Builds the port's CUDA kernels from retrieval_fuse_tpu_torch/csrc, builds
the flagship engine (ShapeNetV2 super-resolution 8³ -> 64³, nf=16, K=4,
latent 64, a 27,132-row database and feature bank; random weights and data
from --seed; data are distance fields of random spheres and boxes, as the
JAX package's synthetic scenes), holds each of the seven kernels against
its plain PyTorch version at the serving shapes (the chamfer kernel in
phase 8, the other six here; float32, the algorithm check,
and bf16; the attentions with hard and with softmax selection; the kNN
kernel also at k = 10, D = 96 and a ragged N), times
kernel, plain version, a library call where one exists and the bound,
records which instruction path each attention, decoder-tail and kNN launch
took (bf16 on the tensor cores; float32 on FMAs, or 3xTF32 for the kNN),
then drives the
serving paths, each with the kernel launch counts set to 0 just before and
read just after:
  - serve_directory with the shipped variant (FAST_VARIANT, bf16) at batch
    64 and 128 (the streaming kNN kernel, which bf16 rows take from 1024
    queries), with FAST_VARIANT+denseknn at batch 64 (dense kNN + the topk
    kernel), and with `fused+pallasp+topk1p+cdec` at batch 128;
  - the engine at batch 128 in bf16 and float32 for each of VARIANT_PATHS,
checking each path's TSDF against the plain `base` engine in bf16 (MAE <
1e-3, the budget of the JAX tests) and in float32 (MAE < 1e-5); the
bf16-vs-float32 MAE of FAST_VARIANT is printed.

Then, on a synthetic dataset made on the card (as many train chunks as it
takes for the dictionary to reach the flagship database's 27,132 rows, and
64 val chunks), at the full width of ShapeNetV2's retrieval config
(Patch04 nf 32 and Patch32 nf 8 encoders, latent 64, batch 128, IoU
scaling, Adam with weight decay 5e-5, K = 4; weights from --seed):
  - trains the retrieval network: its first three steps on the card held
    against the same steps on the CPU (float32, TF32 off; losses 1e-5
    relative, step-1 gradients TRAIN_GRAD_TOL of each tensor's largest
    magnitude; no kernel launched), one epoch through the trainer's CLI
    (retrieval_trainer.main, which saves the checkpoint; its `fit` timed
    for steps/s), and one validation: the val loss, then the retrieval validation, which
    must launch the kNN or topk kernel and the chamfer kernel;
  - drives the retrieval pipeline (retrieval/cli.py's map -> compose ->
    evaluate) with the trained checkpoint: the train and val queries run
    through the kNN in 8192-query batches, those of 4096 queries or more
    (the float32 crossover) through the streaming kernel, the rest through
    the topk kernel, and `evaluate` through the chamfer kernel, one launch
    per val scene. It checks the mapping of 2,048 sampled train queries
    against a dense float32 search, the kNN and chamfer launches, the
    metrics against the plain chamfer's and against the trainer's
    validation;
  - trains the refinement network (train/refinement_trainer.py) at the full
    width of ShapeNetV2's refinement config (nf 16, K 4, batch 8; config
    built in code) on the same chunks and the composed retrievals of that
    pipeline: one step of each of the four phases at batch 1 held against
    the CPU (float32, TF32 off; the same Gumbel draw and one-hot
    selections; losses 1e-5 relative; on REFINE_HOLD_DRAWS perturbations of
    an item, so that no 16³ patch is constant, the gradients on every draw
    no further from float64 than REFINE_F64_FACTOR times the CPU float32's
    largest distance over the draws, the card's float64 anchor held against
    the CPU's on draw 0; no kernel launched; the card's step
    with TF32 on outside the bound on every draw), the 4-phase curriculum
    through train_refinement_phases (two epochs of REFINE_STEPS / 2 steps a
    phase, phase 2 on the frozen feature cache; steps/s of each phase's second
    epoch and its losses from the run's metrics.jsonl; phase 2's losses
    non-zero; each phase changed exactly its sub-networks), the phase-2
    cache as fit builds it (on the device), one validation (which must
    launch the chamfer kernel and no other), the checkpoint round trip, the
    cached phase-2 step against the direct one, and each phase's step on a
    resident batch of 8 (CUDA events; the device's idle share from a traced
    step);
  - serves the 64 val input chunks from those artifacts (the dictionary,
    the trained retrieval checkpoint and the refinement checkpoint just
    trained) with FAST_VARIANT: the engine of
    serve.build_engine_from_artifacts through serve_directory at batch 64
    (its alignment guard on the card), held against engines built in
    memory from the same weights, rows and tiles (float32 max |diff| 1e-5;
    bf16 MAE < 1e-3 against `base`), then the serving CLI (serve.main) in
    bf16 and float32 against the engine's TSDFs;
then holds the chamfer kernel against its plain version at the evaluate
shape, on two pairs cut so that the kernel's split of the streamed set is
ragged or mostly empty, and at 128 batched pairs. Phase 9 (run_phase9)
serves the other tasks at full width: the 3DFront surface-reconstruction
engine (nf 12, so the attention kernels run at F = 96 and the decoder tail
at nf 12; soft selection; 128³ occupancy grids voxelised by the port's
SceneHandler from synthetic point clouds; 27,132 database rows and bank
tiles) with `base` and four kernel paths at batch 32 and 64, bf16 and
float32, each held against `base`, timed and counted, through
serve_directory too, and the four widened kernels held against their plain
versions on the engine's rows; then the Matterport3D 16³ super-resolution
engine (F = 128), FAST_VARIANT against `base`. Phase 4g (run_narrow_widths,
after the serving paths) serves the flagship geometry at nf 4 and 8 (F = 32
and 64) through the three attention kernels' paths, held against `base`,
and holds each attention kernel at both widths against its plain version
(float32 with hard and with softmax selection, bf16 with both). Phase 4h
(run_wide_widths, after 4g) runs the kernels past their shipped shapes, on
their general instances: the flagship geometry at nf 24 and K 12 (F = 192,
retrieval f_maps 24) serves FAST_VARIANT, its +denseknn (the topk kernel at
k 12), the cdec path (patch attention and the decoder tail at nf 24) and
v1 at batch 64 and 128 (denseknn at 64) in bf16 and float32, each held
against `base`, counted (every kernel of the path on its general instance,
the plain iterative top-k on no CUDA tensor) and timed; then each widened
kernel is held against its plain version and timed: the attention kernels
on that engine's rows and at F = 432, K = 32, T = 27 and F = 12, K = 1,
T = 8; the decoder tail at nf 24 and 6; topk at k 12 and 32 on 4,096 x
27,132 scores.

Phase 10 (run_phase10, on phase 7's artifacts) makes meshes: 10a serves the
64 val chunks (as 2 x 2 x 2 chunks of 8 scenes) through serve_directory with
and without OBJ meshes and through serve.main --obj, each OBJ held equal to
native marching cubes of the prediction it was made from; 10b recomposes
the served and the ground-truth chunk meshes into scene meshes and runs
`evaluation.cli metrics` (the ground truth against itself gives IoU 1,
Chamfer-L1 0, normal correctness and F-scores 1); 10c, inside 7a and 7d:
the retrieval trainer's validation writes the val_vis meshes and PNG
previews (log_images counts them) and the refinement trainer's
run_visualization writes its meshes, after validations that launch the
kNN or topk and the chamfer kernels; the 2x upsample of
fast_visualization False on the card equals the CPU's; 10d holds 7b's
compose, pasted by the native C++, against the numpy paste.

Phase 11 runs the port's data-parallel paths (parallel/) over two ranks of
a gloo process group that share the one card, each against the same path
in one process (run_phase11, after phase 10 in phase 7's working
directory): 11a the sharded kNN on the flagship's rows (each shard dense +
topk and forced onto the kNN kernel, both dtypes; also four shards merged
in one process), indices equal to the single card's; 11b FAST_VARIANT at
call batch 128 split over the ranks (float32 within 1e-5 of one process,
bf16 within the 1e-3 budget of `base`) and serve.main --f32 on the ranks
against its files in one process; 11c one step of each trainer at its
global batch (losses 1e-5 relative, summed gradients within 7d's bound)
and a short fit of each; then (run_phase11d, after phase 9) 11d entry()'s
forward and dryrun_multichip over two gloo ranks and one NCCL rank. The
ranks' launch counts join the kernels' counts.

Phase 12 (run_phase12; `chip_smoke.py --phase12` builds the kernels and
runs it alone: the whole run with it takes longer than its 1,200 s limit,
PERF.md section 6) trains, maps and serves the other
tasks at their YAMLs' widths and batches: the 3DFront surface-reconstruction
configs (PCPatch48 on 128³ occupancy grids of 500 points, the five-level
nf 12 refinement network, batch 4) and the Matterport3D 16³ ones (nf 16,
batch 8), each on a synthetic dataset made on the card whose dictionary
reaches the streaming kNN's 16,384-row crossover: 12a the retrieval trainer
(step 1 held against float64 as 7d's refinement steps are, steps through
fit at the config's batch, a
resident step's ms and idle share, peak memory), 12b map, compose and
evaluate (the mapping against a dense search, the metrics against the
plain chamfer), 12c the refinement holds (phase 2's occupancy gate held,
then its gradients on float64's gate) and the curriculum (phase 2 must
move the attention), 12d the validation against the plain chamfer, 12e
base and four kernel paths served from the artifacts in bf16 and float32
against `base` and serve.main. Phase 13 (run_phase13, in phase 7's
working directory) runs the real-data parity harness's CLI on phase 7's
artifacts with a stand-in reference (every gate passes), then on a mapping
with one neighbour changed (its top-k gate refuses it).

Prints the card (nvidia-smi name and power limit), one line per check,
a `{"kernels": [...]}` JSON line and, last, `{"ok": true, "device": ...}`.
Any failed check exits non-zero. Needs one CUDA card and PyYAML; exits
non-zero without them, or without the retrieval_fuse_tpu_torch package
beside it.
"""

from __future__ import annotations

import argparse
import contextlib
import copy
import gc
import io
import json
import os
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np

# H100 SXM published peaks (dense), at the 700 W limit
HBM_BYTES_PER_S = 3.35e12
F32_FLOPS = 67e12       # float32 outside the tensor cores
BF16_FLOPS = 989e12     # bf16 tensor cores
TF32_FLOPS = 495e12     # TF32 tensor cores

SEED_BANK_ROWS = 27132  # the ShapeNetV2 database (bench.py:196)
DENSE_BATCH = 64        # Q = 4096 queries: bf16 streams, DENSE_VARIANT takes the topk kernel
STREAM_BATCH = 128      # Q = 8192 queries: the streaming kNN kernel in bf16 and float32
N_CHUNKS = 192          # chunk files served at each batch size (tail padded at 128)
CDEC_VARIANT = "fused+pallasp+topk1p+cdec"
DENSE_VARIANT = "fused+pallasg2+topk1p+denseknn"  # FAST_VARIANT with the dense kNN forced
RETRIEVAL_MIN_ROWS = SEED_BANK_ROWS  # the retrieval pipeline's dictionary reaches this
RETRIEVAL_VAL_CHUNKS = 64
MAP_SAMPLE = 2048       # train queries checked against a dense search
CHAMFER_PAIRS = 128     # the chamfer kernel's batched check
CHAMFER_CAPACITY = 16384
TRAIN_HOLD_STEPS = 3  # train steps held against the CPU
#: step-1 gradients, card against CPU, by target encoder: the largest share
#: of a tensor's largest magnitude held (float32, TF32 off). Measured by
#: tools/torch_port_train_precision.py on the H100 (PERF.md section 6): the
#: plain encoder's worst 2.6e-4 / 2.9e-4 (cuDNN's weight gradients), with
#: TF32 1.1e-2 / 1.3e-2; the BatchNorm one's 4.2e-3 / 3.0e-4 (float32 itself:
#: the CPU lies as far from float64), with TF32 4.0e-2 / 8.0e-2
TRAIN_GRAD_TOL = {"16+8": 1e-3, "16+8N": 1e-2}
#: engine ms per batch-128 call in bf16 while the path's decoder tail and
#: attention body still multiplied bf16 on float32 FMAs (NVIDIA H100 80GB HBM3,
#: 700.00 W), printed beside this run's
FMA_BODY_ENGINE_MS = {"fused+pallasg2+topk1p": 53.80, CDEC_VARIANT: 69.09,
                      "fused+pallasg+topk1p+packed": 51.80}
#: kernel ms before five kernels were redesigned (same card and limit),
#: printed beside this run's: gathered attention v1 in bf16 on float32 FMAs
#: with K tiles staged by cp.async; the chamfer kernel with one block per 512
#: points walking the whole other set, per evaluate call and at 128 batched
#: pairs; the streaming kNN kernel on float32 register FMAs, float32 rows;
#: gathered attention v2 and patch attention in bf16 on the mma.sync body,
#: 16 rows a warp, before the wgmma body (PERF.md's kernel table)
EARLIER_KERNEL_MS = {"attention_v1": 13.109, "chamfer": 1.288, "chamfer_batch": 3.457,
                     "knn": 1.696, "attention": 1.139, "patch_attention": 1.122}
#: the engine's other serving paths, each run at STREAM_BATCH in bf16 and
#: float32 -> the kernels it must launch there (the streaming kNN kernel is
#: auto-selected at Q=8192: `knn` is its float32 launch, `knn_bf16` its bf16)
VARIANT_PATHS = {
    CDEC_VARIANT: ("knn_bf16", "knn", "patch_attention", "decoder_tail"),
    "fused+pallasg+topk1p+packed": ("knn_bf16", "knn", "attention_v1"),
    "pallas+dconv+fbb": ("knn_bf16", "knn", "patch_attention"),
    "fused+flatg+pallasp": ("knn_bf16", "knn", "patch_attention"),
    "phib+fused": ("knn_bf16", "knn"),
    "approxk+fused": ("knn_bf16", "knn"),
}
#: the streaming kNN kernel's off-flagship check: k = 10 (what `--K 5` asks
#: of `map`), a width other than 64, N no multiple of any tile
KNN_OFF_SHAPE = dict(q=1000, n=27129, d=96, k=10)
#: the kNN kernel's hold against its plain version: max |similarity diff|
KNN_SIM_TOL = 2e-6
#: ... and the least share of queries whose order it holds (no two of the top
#: k+1 similarities within KNN_TIE_GAP); 97.3% at the off-flagship k = 10
KNN_MIN_ORDER_CLEAR = 0.95
#: similarities closer than this may be ranked either way by float32 sums
#: taken in another order
KNN_TIE_GAP = 1e-5
#: phase 9a: the surface-reconstruction variants served beside `base`, their
#: batches and the 128³ occupancy grids made for them; 9b's batch
SURFACE_VARIANTS = ("fused+pallasg2+topk1p", "fused+pallasg2+topk1p+cdec",
                    "fused+pallasp+topk1p", "fused+pallasg+topk1p")
SURFACE_BATCHES = (32, 64)
SURFACE_CHUNKS = 64
SUPERRES16_BATCH = 64
#: phase 4g: the flagship geometry at nf 4 and 8 (attention rows of F = 32
#: and 64), each attention kernel's variant -> the kernel's record key
NARROW_NF = (4, 8)
#: whether 4g's seeded weights (flagship_params, seed + nf) negate phi's
#: output layer: the attention's switch is then open on most rows (a CPU
#: reading on 4 chunks: nf 4 99.8% negated, 1.8% not; nf 8 0.0% negated,
#: 100% not)
NARROW_NEGATE_PHI = {4: True, 8: False}
NARROW_VARIANTS = {"fused+pallasg2+topk1p": "attention", "fused+pallasg+topk1p": "attention_v1",
                   "fused+pallasp+topk1p+cdec": "patch_attention"}
#: the float32 softmax attention hold (softmax_f64_hold): sharpness 1024 turns
#: a score's float32 rounding (~1e-7) into weight differences of ~1e-4, so the
#: kernel's float32 output is held against the plain version run in float64,
#: no further from it than SOFTMAX_F64_FACTOR times the plain float32's own
#: distance plus SOFTMAX_F64_FLOOR (max |diff| over all rows): 7d's factor,
#: taken from no reading. A known-worse arithmetic, the bf16 path's (the plain
#: version on bf16 operands: weights and hidden activations rounded to bf16,
#: float32 sums, a bf16 output), must lie outside the bound. Rounding the
#: weights alone is no control on the engines' rows: their weights and rows
#: are bf16 values already (it read 7.0e-6 against a bound of 2.2e-5 at 4g's
#: nf 4).
#: Hard selection: max |diff| 1e-4 on the rows whose selections agree
SOFTMAX_F64_FACTOR, SOFTMAX_F64_FLOOR = 3.0, 1e-6
#: phase 10: scenes of 2 x 2 x 2 val chunks (the recompose naming) and how
#: many of them the mesh metrics sweep; scenes whose compose is held
MESH_SCENE_SIDE = 2
METRIC_SCENES = 2
COMPOSE_HOLD_SCENES = 4


def flagship_config() -> dict:
    """The JAX package's flagship serving geometry (bench.py:145-158)."""
    return {
        "task": "superresolution", "K": 4, "nf": 16, "unet_num_level": 4,
        "layer_order": "gcr", "retrieval_fmaps": 16, "retrieval_num_level": 4,
        "attn_normalize": True, "attn_use_switching": True, "attn_retrieval_mode": True,
        "attn_no_output_mapping": True, "attn_blend": True,
        "attn_patch_extent": 4, "attn_num_patch": 16,
        "retrieval_model": {"network_input": "2+1", "network_target": "16+8",
                            "nf_input": 32, "nf_target": 8, "latent_dim": 64},
        "dataset_train": {"input_chunk_size": 8, "target_chunk_size": 64,
                          "input_mean": 0.3095340441938771, "input_std": 0.14730652990291243,
                          "target_mean": 0.059954833543534335, "target_std": 0.010110036361741626,
                          "voxel_size_input": 0.166667, "voxel_size_target": 0.020834},
    }


def surface_config() -> dict:
    """The serving keys of the JAX package's
    config/surface_reconstruction/3DFront/refinement_128_064.yaml merged with
    retrieval_128_064.yaml (on their base/ files), built in code and pinned
    to the YAMLs by a test: nf 12 (F = nf·e³ = 96), five U-Net levels,
    retrieval f_maps 12, K 4 (the refinement config's; the retrieval YAML's
    query K is 1), soft selection, `pc_32+8` inputs (48³ windows at stride
    32 on 128³ occupancy grids padded with empty space), latent 64; the
    engine's retrieval geometry is the input code's and the 16³ target
    patches'."""
    return {
        "task": "surface_reconstruction", "K": 4, "nf": 12, "unet_num_level": 5,
        "layer_order": "gcr", "retrieval_fmaps": 12, "retrieval_num_level": 4,
        "attn_normalize": True, "attn_use_switching": True, "attn_retrieval_mode": False,
        "attn_no_output_mapping": True, "attn_blend": True,
        "attn_patch_extent": 4, "attn_num_patch": 16,
        "retrieval_patch_size_input": 32, "retrieval_patch_context_input": 8,
        "retrieval_patch_size_target": 16,
        "retrieval_model": {"network_input": "pc_32+8", "network_target": "16+4",
                            "nf_input": 10, "nf_target": 12, "latent_dim": 64},
        "dataset_train": {"input_chunk_size": 128, "target_chunk_size": 64, "input_mean": 0,
                          "input_std": 1, "target_mean": 0.15015658121788053,
                          "target_std": 0.03573221820637578, "voxel_size_input": 0,
                          "voxel_size_target": 0.054167, "num_points": 500,
                          "input_dir": "pc_20K"},
    }


def superres16_config() -> dict:
    """The serving keys of config/super_resolution/Matterport3D/
    refinement_016_064.yaml merged with retrieval_016_064.yaml, built in code
    and pinned to the YAMLs by a test: 16³ -> 64³, nf 16 (F = 128), `4+2`
    inputs (Patch08, nf_input 32: 8³ windows at stride 4), latent 64, K 4,
    soft selection."""
    return {
        "task": "superresolution", "K": 4, "nf": 16, "unet_num_level": 4,
        "layer_order": "gcr", "retrieval_fmaps": 16, "retrieval_num_level": 4,
        "attn_normalize": True, "attn_use_switching": True, "attn_retrieval_mode": False,
        "attn_no_output_mapping": True, "attn_blend": True,
        "attn_patch_extent": 4, "attn_num_patch": 16,
        "retrieval_patch_size_input": 4, "retrieval_patch_context_input": 2,
        "retrieval_patch_size_target": 16,
        "retrieval_model": {"network_input": "4+2", "network_target": "16+8",
                            "nf_input": 32, "nf_target": 8, "latent_dim": 64},
        "dataset_train": {"input_chunk_size": 16, "target_chunk_size": 64,
                          "input_mean": 35.62394659115317, "input_std": 14.58642912987053,
                          "target_mean": 10.502049923464249, "target_std": 2.3319665041587627,
                          "voxel_size_input": 15.0, "voxel_size_target": 3.75},
    }


def _task_dataset(root, **keys) -> dict:
    """The dataset keys that phase 12's four configs share, pointed at `root`
    (as data/synthetic.make_synthetic_config points them), with `keys`."""
    root = str(root).rstrip("/") + "/"
    return dict({"train_multiplier": 1, "input_ext": ".npz", "target_ext": ".npz",
                 "data_dir": root, "scene_dir": root, "retrieval_dir": root,
                 "splits_dir": "main", "target_chunk_size": 64, "target_dir": "sdf_064",
                 "preload_retrievals": False, "rotation_augment": False}, **keys)


#: the dataset keys of phase 12's tasks that their retrieval and refinement
#: YAMLs share
TASK_DATA = {
    "surface": dict(num_points=500, dataset_name="3DFront", input_chunk_size=128,
                    input_dir="pc_20K", voxel_size_input=0, voxel_size_target=0.054167,
                    input_mean=0, input_std=1, target_mean=0.15015658121788053,
                    target_std=0.03573221820637578),
    "superres16": dict(num_points=0, dataset_name="Matterport3D16", input_chunk_size=16,
                       input_dir="sdf_016", voxel_size_input=15.0, voxel_size_target=3.75,
                       input_mean=35.62394659115317, input_std=14.58642912987053,
                       target_mean=10.502049923464249, target_std=2.3319665041587627),
}


def task_retrieval_config(task: str, root, retrieval_ckpt, k: int = 4) -> dict:
    """The resolved retrieval config of phase 12's `task`, built in code and
    pinned to its YAML by a test: "surface", config/surface_reconstruction/
    3DFront/retrieval_128_064.yaml (PCPatch48 `pc_32+8` nf 10 on 48³
    windows of 128³ occupancy grids from 500 points, Patch24 `16+4` nf 12,
    latent 64, batch 256); "superres16", config/super_resolution/
    Matterport3D/retrieval_016_064.yaml (Patch08 `4+2` nf 32, Patch32
    `16+8` nf 8, IoU scaling, batch 192). K = k, as the retrieval CLI sets
    it. The dataset points at `root`."""
    if task == "surface":
        dataset = _task_dataset(
            root, **TASK_DATA[task], patch_size_input=32, patch_context_input=8,
            patch_size_target=16, patch_context_target=4, patch_stride=16,
            skip_occupancy=False, preload_scenes=True, occupancy_threshold=0)
        model = {"network_input": "pc_32+8", "network_target": "16+4", "nf_input": 10,
                 "nf_target": 12, "latent_dim": 64}
        training = {"batch_size": 256, "scheduler": [70, 80], "iou_scaling": False}
        dictionary, query = {"batch_size": 256, "num_workers": 8}, \
            {"batch_size": 128, "num_workers": 8, "flann_num_workers": 4}
    else:
        dataset = _task_dataset(
            root, **TASK_DATA[task], patch_size_input=4, patch_context_input=2,
            patch_size_target=16, patch_context_target=8, patch_stride=16,
            skip_occupancy=True, preload_scenes=True)
        model = {"network_input": "4+2", "network_target": "16+8", "nf_input": 32,
                 "nf_target": 8, "latent_dim": 64}
        training = {"batch_size": 192, "scheduler": [75, 80], "iou_scaling": True}
        dictionary, query = {"batch_size": 512, "num_workers": 8}, \
            {"batch_size": 512, "num_workers": 8, "flann_num_workers": 0}
    return {
        "task": "surface_reconstruction" if task == "surface" else "superresolution",
        "fast_visualization": True, "no_retrievals": True,
        "retrieval_ckpt": str(retrieval_ckpt), "K": k,
        "dataset_train": dict(dataset, occupancy_threshold=0),
        "dataset_val": dict(dataset, occupancy_threshold=-1),
        "retrieval_model": model,
        "retrieval_training": dict({"lr": 0.0001, "num_workers": 8, "code_noise": 0,
                                    "input_noise": 0, "temprature": 0.2,
                                    "loss": {"contrastive": 1}}, **training),
        "dictionary": dictionary, "query": dict(query, K=k),
    }


def task_refinement_config(task: str, root, retrieval_ckpt) -> dict:
    """The resolved refinement config of phase 12's `task`, built in code
    and pinned to its YAML by a test: "surface", config/
    surface_reconstruction/3DFront/refinement_128_064.yaml (nf 12, five
    U-Net levels on 128³ occupancy grids, retrieval f_maps 12, K 4, soft
    selection, batch 4); "superres16", config/super_resolution/
    Matterport3D/refinement_016_064.yaml (nf 16, 16³ inputs, K 4, soft
    selection, batch 8). The dataset points at `root` and trains on the
    composed retrievals of `retrieval_ckpt` (retrievals on, as the CLI runs
    without --no_retrievals)."""
    surface = task == "surface"
    dataset = _task_dataset(
        root, **TASK_DATA[task], patch_size_input=128 if surface else 16,
        patch_context_input=0, patch_size_target=64, patch_context_target=0,
        patch_stride=64, preload_scenes=False, skip_occupancy=False)
    cfg = {
        "task": "surface_reconstruction" if surface else "superresolution", "K": 4,
        "loss_reconstruction": 1, "loss_normal": 0.5, "loss_attn_contrastive": 0.01,
        "loss_side_task_retr": 1, "loss_side_task_unet": 1, "lr": 0.0001,
        "batch_size": 4 if surface else 8, "num_workers": 8,
        "scheduler": [75, 85] if surface else [105, 115], "attn_temprature": 0.05,
        "weight_occupied": 8, "unet_backbone_decoder_ckpt": None,
        "retrieval_backbone_ckpt": None, "attention_block_ckpt": None,
        "disable_train_vis": True, "disable_attn_vis": True, "fast_visualization": True,
        "nf": 12 if surface else 16, "unet_num_level": 5 if surface else 4,
        "layer_order": "gcr", "retrieval_fmaps": 12 if surface else 16,
        "retrieval_num_level": 4, "attn_patch_extent": 4, "attn_normalize": True,
        "attn_use_switching": True, "attn_retrieval_mode": False,
        "attn_no_output_mapping": True, "attn_blend": True, "attn_num_patch": 16,
        "dataset_train": dict(dataset, occupancy_threshold=0),
        "dataset_val": dict(dataset, occupancy_threshold=-1),
        "no_retrievals": False, "retrieval_ckpt": str(retrieval_ckpt),
    }
    if not surface:  # base/refinement_superresolution.yaml's retrieval keys
        cfg.update(retrieval_model={"network_input": "2+1", "network_target": "16+8",
                                    "nf_input": 32, "nf_target": 8, "latent_dim": 64},
                   dictionary={"batch_size": 512, "num_workers": 4},
                   query={"batch_size": 2048, "num_workers": 4, "flann_num_workers": 4})
    return cfg


def surface_inputs(root, n: int, seed: int, size: int = 128) -> np.ndarray:
    """n size³ occupancy grids (float32 0/1): synthetic point-cloud scenes
    (data/synthetic.py, 20,000 near-surface points each, under `root`),
    voxelised by the port's SceneHandler from 500 points each, as the
    3DFront refinement config's data layer reads them."""
    import random
    from retrieval_fuse_tpu_torch.data import SceneHandler
    from retrieval_fuse_tpu_torch.data.synthetic import (
        generate_synthetic_dataset, make_synthetic_config)
    generate_synthetic_dataset(root, n_train=1, n_val=n, seed=seed,
                               task="surface_reconstruction", input_dir="pc_20K",
                               target_dir="sdf_064")
    cfg = make_synthetic_config(root, task="surface_reconstruction")
    for d in ("dataset_train", "dataset_val"):
        cfg[d].update(num_points=500, patch_size_input=size, patch_context_input=0,
                      input_chunk_size=size, skip_occupancy=True, preload_scenes=False)
    handler = SceneHandler("val", cfg)
    random.seed(seed)  # the point subsets the handler draws
    return np.stack([handler.get_scene_input(s) for s in handler.scenes]).astype(np.float32)


def surface_kernels(variant: str, batch: int, dtypes=("bf16", "f32")) -> tuple:
    """The kernels a phase-9a path must launch at `batch` (64 queries a
    chunk) in `dtypes`: the kNN kernel where the query count reaches its
    crossover (bf16 1024, float32 4096), else the topk kernel with
    `topk1p`; its attention kernel; the decoder tail with `cdec`."""
    q = 64 * batch
    needed = []
    for dtype, knn, crossover in (("bf16", "knn_bf16", 1024), ("f32", "knn", 4096)):
        if dtype not in dtypes:
            continue
        if q >= crossover:
            needed.append(knn)
        elif "topk1p" in variant and "topk" not in needed:
            needed.append("topk")
    for token, kernel in (("pallasg2", "attention"), ("pallasg", "attention_v1"),
                          ("pallasp", "patch_attention")):
        if token in variant.split("+"):
            needed.append(kernel)
            break
    if "cdec" in variant.split("+"):
        needed.append("decoder_tail")
    return tuple(needed)


def draw_primitives(rng, n: int, device, n_prims: int = 3) -> list:
    """For each of n unit chunks, n_prims random spheres or boxes drawn from
    `rng`: [(center, radius, half extent, is_sphere)] per primitive."""
    import torch

    def draw(lo, hi, shape):
        return torch.from_numpy(rng.uniform(lo, hi, shape).astype(np.float32)).to(device)

    prims = []
    for _ in range(n_prims):
        center, radius, half = draw(0.25, 0.75, (n, 1, 3)), draw(0.08, 0.22, (n, 1)), \
            draw(0.06, 0.2, (n, 1, 3))
        prims.append((center, radius, half,
                      torch.from_numpy(rng.integers(0, 2, (n, 1)) == 0).to(device)))
    return prims


def primitives_distance(prims: list, points):
    """(n, P) the unsigned distance of points (1 or n, P, 3) in the unit
    chunk to the union of each chunk's primitives in `prims`."""
    import torch
    d = torch.full((prims[0][0].shape[0], points.shape[1]), float("inf"),
                   device=points.device)
    for center, radius, half, sphere in prims:
        p = points - center
        q = p.abs() - half
        box = q.clamp(min=0).norm(dim=-1) + q.amax(dim=-1).clamp(max=0)
        d = torch.minimum(d, torch.where(sphere, p.norm(dim=-1) - radius, box))
    return d.abs()


def primitives_df(prims: list, res: int, voxel_size: float):
    """The truncated unsigned distance fields (n, res, res, res) of the
    chunks of `prims` sampled at res³, in the units of `voxel_size`."""
    import torch
    device = prims[0][0].device
    c = (torch.arange(res, dtype=torch.float32, device=device) + 0.5) / res
    g = torch.stack(torch.meshgrid(c, c, c, indexing="ij"), -1).reshape(1, -1, 3)
    trunc = float(np.float16(voxel_size * 3))
    return torch.clamp(primitives_distance(prims, g) * (voxel_size * res), max=trunc) \
        .reshape(-1, res, res, res)


def primitives_points(prims: list, rng, n_points: int, res: int, oversample: int = 20):
    """(n, n_points, 3) float32 near-surface points of each chunk of
    `prims` in [0, res) coordinates: of n_points * oversample uniform draws
    from `rng`, the n_points nearest the surface (data/synthetic.py's
    rejection sampling)."""
    import torch
    n, device = prims[0][0].shape[0], prims[0][0].device
    out = []
    for i in range(n):
        one = [tuple(t[i:i + 1] for t in prim) for prim in prims]
        pts = torch.from_numpy(rng.uniform(0, 1, (1, n_points * oversample, 3))
                               .astype(np.float32)).to(device)
        near = primitives_distance(one, pts)[0].topk(n_points, largest=False).indices
        out.append(pts[0, near] * res)
    return torch.stack(out)


def synthetic_df(rng, n: int, res: int, voxel_size: float, device, n_prims: int = 3):
    """n truncated unsigned distance fields (res³, channels-last without the
    channel) of unions of random spheres and boxes in a unit chunk: the
    scenes of the JAX package's data/synthetic.py, drawn from `rng`."""
    return primitives_df(draw_primitives(rng, n, device, n_prims), res, voxel_size)


def flagship_params(cfg: dict, seed: int, negate_phi: bool = True) -> dict:
    """Seeded random state_dicts (PyTorch's default law, models.init_params),
    with `negate_phi` phi's output layer negated, so that theta and phi
    embeddings point the same way on average at the flagship config: the
    attention's ReLU switch opens and its selection does real work on most
    rows. Phase 9's configs need no negation (it shuts their switch)."""
    from retrieval_fuse_tpu_torch.models import init_params
    params = init_params(cfg, seed)
    if negate_phi:
        negate_phi_out(params)
    return params


def negate_phi_out(params: dict) -> None:
    """Negate phi's output layer in the state_dicts `params`, in place."""
    blk = params["patched_attention_block"]
    for key in ("attention_blocks_layer.phi.out.weight", "attention_blocks_layer.phi.out.bias"):
        blk[key] = -blk[key]


def flagship_data(cfg: dict, rng, n: int, device):
    """(database (n, 64) random unit rows as numpy, patch bank (n, 16, 16, 16)
    on `device`: the 16³ tiles, in row-major order, of synthetic 64³
    target-resolution scenes)."""
    db = rng.standard_normal((n, 64), dtype=np.float32)
    db /= np.linalg.norm(db, axis=1, keepdims=True)
    scenes = synthetic_df(rng, n // 64 + 1, 64, cfg["dataset_train"]["voxel_size_target"],
                          device)
    bank = scenes.reshape(-1, 4, 16, 4, 16, 4, 16).permute(0, 1, 3, 5, 2, 4, 6) \
        .reshape(-1, 16, 16, 16)[:n].contiguous()
    return db, bank


def retrieval_config(root, retrieval_ckpt, k: int = 4) -> dict:
    """The resolved config of the JAX package's
    config/super_resolution/ShapeNetV2/retrieval_008_064.yaml (on
    base/retrieval_superresolution.yaml), built in code, so that no YAML
    parser is needed: inputs 2+1 (4³ patches, Patch04, nf 32), targets 16+8
    (32³ patches, Patch32, nf 8), latent 64, patch stride 16, dictionary
    batch 512, K = k as the retrieval CLI sets it. The dataset points at
    `root`, as data/synthetic.make_synthetic_config points it."""
    root = str(root).rstrip("/") + "/"
    dataset = {
        "num_points": 0, "skip_occupancy": False, "train_multiplier": 1,
        "patch_size_input": 2, "patch_context_input": 1, "patch_size_target": 16,
        "patch_context_target": 8, "patch_stride": 16, "input_ext": ".npz",
        "target_ext": ".npz", "data_dir": root, "scene_dir": root, "retrieval_dir": root,
        "dataset_name": "SynthSet", "input_chunk_size": 8, "target_chunk_size": 64,
        "input_dir": "sdf_008", "target_dir": "sdf_064", "splits_dir": "main",
        "voxel_size_input": 0.166667, "voxel_size_target": 0.020834, "preload_scenes": True,
        "preload_retrievals": False, "input_mean": 0.34774827082940146,
        "input_std": 0.16208995673899929, "target_mean": 0.060043341595512584,
        "target_std": 0.009982546908894512, "rotation_augment": False,
    }
    return {
        "task": "superresolution", "fast_visualization": True, "no_retrievals": True,
        "retrieval_ckpt": str(retrieval_ckpt), "K": k,
        "dataset_train": dict(dataset, occupancy_threshold=0),
        "dataset_val": dict(dataset, occupancy_threshold=-1),
        "retrieval_model": {"network_input": "2+1", "network_target": "16+8",
                            "nf_input": 32, "nf_target": 8, "latent_dim": 64},
        "retrieval_training": {"lr": 0.0001, "num_workers": 8, "code_noise": 0,
                               "input_noise": 0, "batch_size": 128, "scheduler": [50, 75],
                               "temprature": 0.2, "iou_scaling": True,
                               "loss": {"contrastive": 1}},
        "dictionary": {"batch_size": 512, "num_workers": 8},
        "query": {"batch_size": 512, "num_workers": 8, "K": k, "flann_num_workers": 0},
    }


def serving_config(root, retrieval_ckpt) -> dict:
    """retrieval_config with the refinement networks of
    config/super_resolution/ShapeNetV2/refinement_008_064.yaml (on
    base/refinement_superresolution.yaml): the keys the serving engine
    reads, which are flagship_config's, merged as
    data/synthetic.make_synthetic_config merges the two YAMLs (the
    retrieval config's keys win)."""
    cfg = retrieval_config(root, retrieval_ckpt)
    for key, value in flagship_config().items():
        if key not in ("dataset_train", "retrieval_model"):
            cfg.setdefault(key, value)
    return cfg


def first_batches(dataset, batch_size: int, n: int) -> list:
    """The first n batches of the trainer's epoch-0 order (shuffled with
    seed 0, last partial batch dropped), made on this thread."""
    from retrieval_fuse_tpu_torch.data import batch_iterator
    it = batch_iterator(dataset, batch_size, shuffle=True, drop_last=True, seed=0, prefetch=0)
    return [b for _, b in zip(range(n), it)]


def batchnorm_fed_biases(net) -> set:
    """Names of the conv biases that a BatchNorm follows: their gradient is
    zero in exact arithmetic, so both devices' are rounding noise."""
    if not getattr(net, "use_batchnorm", False):
        return set()
    return {f"conv{j}.bias" for j in range(net.n_conv)}


def hold_train_steps(cfg: dict, dev, n_steps: int):
    """The retrieval trainer's first n_steps steps on the card against the
    same steps of the port on the CPU: the same seeded weights (the
    trainer's init from cfg["seed"]), the same batches and learning rates,
    float32 with TF32 off. The loss of each step within 1e-5 relative, the
    step-1 gradients within TRAIN_GRAD_TOL (by target encoder) of each
    tensor's largest magnitude (those of batchnorm_fed_biases below 1e-2 of
    the encoder's largest gradient), and the card's step-1 gradients with
    TF32 on outside that tolerance on some tensor (the hold can tell TF32).
    Returns (the card's trainer after the steps, losses, worst gradient
    error relative to its tensor's largest magnitude, TF32's)."""
    import torch
    from retrieval_fuse_tpu_torch.train import schedule as sched
    from retrieval_fuse_tpu_torch.train.retrieval_trainer import RetrievalTrainer
    card, cpu = RetrievalTrainer(cfg, device=dev), RetrievalTrainer(cfg, device="cpu")
    grad_tol = TRAIN_GRAD_TOL[cfg["retrieval_model"]["network_target"]]
    losses, grad_err, tf32_err = [], 0.0, 0.0
    for i, batch in enumerate(first_batches(card.train_dataset, card.batch_size, n_steps)):
        lr = sched.current_lr(card.base_lr, card.milestones, i, 0)
        if i == 0:  # step 1 with TF32 on, from the same weights and statistics
            saved = {name: copy.deepcopy(net.state_dict()) for name, net in card.encoders.items()}
            with tf32():
                for net in card.encoders.values():
                    net.train().zero_grad(set_to_none=True)
                card._loss_fn(card._device_batch(batch), train=True)[0].backward()
            grads_tf32 = {name: {k: p.grad.detach().cpu() for k, p in net.named_parameters()}
                          for name, net in card.encoders.items()}
            for name, net in card.encoders.items():
                net.load_state_dict(saved[name])
        got = float(card._train_step(card._device_batch(batch), lr)[0])
        want = float(cpu._train_step(cpu._device_batch(batch), lr)[0])
        check(np.isfinite(got) and abs(got - want) <= 1e-5 * abs(want),
              f"train step {i + 1}: loss {got} on the card, {want} on the CPU")
        losses.append((got, want))
        if i == 0:
            for name, net in card.encoders.items():
                theirs = dict(cpu.encoders[name].named_parameters())
                net_scale = max(float(p.grad.abs().max()) for p in theirs.values())
                before_bn = batchnorm_fed_biases(net)
                for key, param in net.named_parameters():
                    g, w = param.grad.cpu(), theirs[key].grad
                    if key in before_bn:
                        noise = max(float(g.abs().max()), float(w.abs().max()))
                        check(noise <= 1e-2 * net_scale,
                              f"train step 1: gradient of {name}.{key} (before a BatchNorm) "
                              f"is {noise:.2e}, not below 1e-2 of {net_scale:.2e}")
                        continue
                    scale = float(w.abs().max())
                    err = float((g - w).abs().max()) / max(scale, 1e-30)
                    check(torch.isfinite(g).all().item() and err <= grad_tol,
                          f"train step 1: gradient of {name}.{key} differs by {err:.2e} of "
                          f"its largest magnitude {scale:.2e}")
                    grad_err = max(grad_err, err)
                    tf32_err = max(tf32_err, float((grads_tf32[name][key] - w).abs().max())
                                   / max(scale, 1e-30))
            check(tf32_err > grad_tol,
                  f"train step 1: with TF32 on the card's gradients lie within {tf32_err:.2e} "
                  f"of the CPU's, inside the tolerance {grad_tol:g}: the hold cannot tell TF32")
        card.global_step = cpu.global_step = i + 1
    return card, losses, grad_err, tf32_err


#: phase 7d, the refinement trainer: steps of each curriculum phase (two
#: epochs of REFINE_STEPS / 2), and the held batch's perturbation
#: (normalised units)
REFINE_STEPS = 12
REFINE_HOLD_NOISE = 0.05
#: the held networks' decoder output bias: seeded random weights predict no
#: occupied voxel (tanh ~ 0 is 1.5 voxels), so phase 2's occupancy gate
#: would close; at -0.5 it opens on part of the patches
REFINE_HOLD_DECODER_BIAS = -0.5
#: one step of each phase at batch 1 (float32, TF32 off), on each of
#: REFINE_HOLD_DRAWS perturbations of the held item: on every draw the
#: card's gradients may lie no further from the float64 gradients of the
#: same step than REFINE_F64_FACTOR times the largest distance of the CPU's
#: float32 ones over the draws, plus REFINE_F64_FLOOR (grad_share). The
#: factor is PR 8's, from tools/torch_port_train_precision.py --refine on the
#: H100 (PERF.md section 6): card / CPU float32 lie 1.06e-2 / 9.95e-3 (phase
#: 0), 2.68e-3 / 3.45e-3 (1), 6.2e-5 / 6.2e-5 (2) and 1.34e-2 / 1.37e-2 (3)
#: from float64, and the card with TF32 on 3.7-10x the bound (the hold
#: checks on every draw that TF32 stays outside it). Over ten seeds of data
#: one CPU float32 sample lay 1.86e-3 to 7.16e-3 from float64 on phase 3
#: and the card 0.98-3.8x that sample (seed 4 failed), so the bound takes
#: the largest of several samples. The float64 step of every draw runs on
#: the card (a CPU float64 step takes 2-20 s a phase at these widths); on
#: draw 0 of each phase it is held against the CPU's float64 step
REFINE_F64_FACTOR, REFINE_F64_FLOOR = 3.0, 1e-5
#: the card's float64 gradients against the CPU's (grad_share): an anchor
#: off by this moves a distance from float64 by at most this, a tenth of
#: REFINE_F64_FLOOR, the least bound a phase can have
REFINE_F64_ANCHOR_TOL = 1e-6
#: the perturbations held, draw 0 the one held before there were several.
#: Three, the fewest that the largest of several takes: each further draw
#: adds to each refinement hold (7d, 12c) four CPU float32 steps of 0.2-4 s
#: (a CPU reading at 16³ and 128³ inputs), and 7d's hold may grow by 60 s
REFINE_HOLD_DRAWS = 3


def refinement_config(root, retrieval_ckpt) -> dict:
    """The resolved config of the JAX package's
    config/super_resolution/ShapeNetV2/refinement_008_064.yaml (on
    base/refinement_superresolution.yaml), built in code: nf 16, K 4, batch
    8, lr 1e-4, four U-Net levels, retrieval f_maps 16 and four levels,
    attention temperature 0.05, weight_occupied 8 and the YAML's loss
    weights; 8³ inputs and 64³ target chunks. The dataset points at `root`
    and trains on the composed retrievals of `retrieval_ckpt` (retrievals
    on, as the CLI runs without --no_retrievals)."""
    root = str(root).rstrip("/") + "/"
    dataset = {
        "num_points": 0, "skip_occupancy": False, "train_multiplier": 1,
        "patch_size_input": 8, "patch_context_input": 0, "patch_size_target": 64,
        "patch_context_target": 0, "patch_stride": 64, "input_ext": ".npz",
        "target_ext": ".npz", "data_dir": root, "scene_dir": root, "retrieval_dir": root,
        "dataset_name": "SynthSet", "input_chunk_size": 8, "target_chunk_size": 64,
        "input_dir": "sdf_008", "target_dir": "sdf_064", "splits_dir": "main",
        "voxel_size_input": 0.166667, "voxel_size_target": 0.020834, "preload_scenes": False,
        "preload_retrievals": False, "input_mean": 0.3095340441938771,
        "input_std": 0.14730652990291243, "target_mean": 0.059954833543534335,
        "target_std": 0.010110036361741626, "rotation_augment": False,
    }
    return {
        "task": "superresolution", "K": 4, "loss_reconstruction": 1, "loss_normal": 0.5,
        "loss_attn_contrastive": 0.01, "loss_side_task_retr": 1, "loss_side_task_unet": 1,
        "lr": 0.0001, "batch_size": 8, "num_workers": 8, "scheduler": [110, 125],
        "attn_temprature": 0.05, "weight_occupied": 8, "unet_backbone_decoder_ckpt": None,
        "retrieval_backbone_ckpt": None, "attention_block_ckpt": None,
        "disable_train_vis": True, "disable_attn_vis": True, "fast_visualization": True,
        "dataset_train": dict(dataset, occupancy_threshold=0),
        "dataset_val": dict(dataset, occupancy_threshold=-1),
        "retrieval_model": {"network_input": "2+1", "network_target": "16+8",
                            "nf_input": 32, "nf_target": 8, "latent_dim": 64},
        "dictionary": {"batch_size": 512, "num_workers": 4},
        "query": {"batch_size": 2048, "num_workers": 4, "flann_num_workers": 4},
        "nf": 16, "num_points": 0, "unet_num_level": 4, "layer_order": "gcr",
        "retrieval_fmaps": 16, "retrieval_num_level": 4, "attn_normalize": True,
        "attn_use_switching": True, "attn_retrieval_mode": True,
        "attn_no_output_mapping": True, "attn_blend": True, "attn_patch_extent": 4,
        "attn_num_patch": 16, "no_retrievals": False, "retrieval_ckpt": str(retrieval_ckpt),
    }


def write_composed_retrievals(cfg: dict, rng, k: int = 4) -> None:
    """Composed retrievals for every scene of cfg's dataset where
    cfg["retrieval_ckpt"]'s `compose` would put them: k other scenes'
    targets, drawn from `rng` (the tools' data when no retrieval run made
    any)."""
    from retrieval_fuse_tpu_torch.utils.misc import get_retrievals_dir
    dtr = cfg["dataset_train"]
    tdir = Path(dtr["data_dir"]) / dtr["target_dir"] / dtr["dataset_name"]
    targets = {p.stem: np.load(p)["arr"] for p in sorted(tdir.glob("*.npz"))}
    out = get_retrievals_dir(cfg) / "compose"
    out.mkdir(parents=True, exist_ok=True)
    for scene in targets:
        others = rng.choice([o for o in targets if o != scene], k, replace=False)
        np.savez_compressed(out / f"{scene}.npz",
                            np.stack([targets[o] for o in others]).astype(np.float16))

def perturb_batch(batch: dict, rng, noise: float) -> dict:
    """`batch` with N(0, noise) added to its target and retrievals
    (normalised units), so that every 16³ patch varies. On a constant patch
    the retrieval U-Net's GroupNorm chain amplifies float32 rounding (each
    group's variance far below eps 1e-5) into O(1) features, which differ on
    every device and in every implementation (PERF.md section 6)."""
    out = dict(batch)
    for key in ("target", "retrieval"):
        out[key] = (batch[key] + rng.normal(0, noise, batch[key].shape)).astype(np.float32)
    return out


def grad_share(got: dict, want: dict) -> tuple[float, str]:
    """The largest max |got - want| over a tensor, as a share of its
    sub-network's largest |want|, and that tensor's name; got and want are
    {subnet: {key: gradient}}. A sub-network whose gradient is zero
    throughout adds nothing."""
    worst, where = 0.0, ""
    for name, sd in want.items():
        scale = max(float(g.abs().max()) for g in sd.values()) or float("inf")
        check(sorted(got[name]) == sorted(sd), f"{name}: the devices' gradients differ in keys")
        for key, w in sd.items():
            share = float((got[name][key].cpu().double() - w.cpu().double()).abs().max()) / scale
            if share > worst:
                worst, where = share, f"{name}.{key}"
    return worst, where


def open_occupancy_gate(trainer) -> None:
    """Set the decoder's output bias to REFINE_HOLD_DECODER_BIAS."""
    import torch
    with torch.no_grad():
        trainer.decoder.final_conv.bias.fill_(REFINE_HOLD_DECODER_BIAS)

def gumbel_selection(tr, batch: dict, u):
    """(the attention's one-hot selection of each of forward_full's B·R³
    patches, the smallest gap between the top two Gumbel-perturbed scores)
    on a device batch, with the uniform draw u (B·R³, K)."""
    import torch
    from retrieval_fuse_tpu_torch.models.attention import l2_normalize
    from retrieval_fuse_tpu_torch.ops.fold3d import unfold3d
    blk = tr.patched_attention_block
    att, e, r, k, nf = blk.attention_blocks_layer, blk.patch_extent, blk.num_patch_x, blk.K, blk.nf
    with torch.no_grad():
        b = batch["input"].shape[0]
        x_back = tr._call("unet_backbone", batch["input"])
        x_rpt = tr._encode_shape_volumes(torch.cat([tr.get_retrievals(batch["retrieval"]),
                                                    batch["target"]], dim=0))
        x = unfold3d(x_back, e)
        p = unfold3d(x_rpt[: b * k], e).reshape(-1, k, r ** 3, e, e, e, nf) \
            .permute(0, 2, 1, 3, 4, 5, 6).reshape(-1, e, e, e, nf)
        xf = l2_normalize(att.theta(x), 1)
        pf = l2_normalize(att.phi(p).reshape(x.shape[0], k, -1), 2)
        scores = torch.einsum("bf,bkf->bk", xf, pf) * 25.0
        u = u.to(scores.device)
        perturbed = scores - torch.log(-torch.log(u + 1e-20))
        top2 = perturbed.topk(2, dim=1).values
    return perturbed.argmax(dim=1).cpu(), float((top2[:, 0] - top2[:, 1]).min())


def step_gradients(tr, phase: int, batch: dict, u=None, float64: bool = False,
                   cached: bool = False):
    """(loss, aux, {subnet: {key: gradient}}) of the trainer's train step of
    `phase` on a device batch without its Adam update (set_phase, then
    compute_gradients: what train_step runs before optimizer.step()); with
    float64, the sub-networks and the batch in float64 for the call."""
    tr.set_phase(phase)
    with in_float64(tr) if float64 else contextlib.nullcontext():
        if float64:
            batch = {k: (v.double() if v.is_floating_point() else v) for k, v in batch.items()}
        total, aux = tr.compute_gradients(batch, u, cached)
        return total, aux, tr.gradients()


@contextlib.contextmanager
def in_float64(tr):
    """The trainer's sub-networks in float64 in the block."""
    for net in tr.nets.values():
        net.double()
    try:
        yield
    finally:
        for net in tr.nets.values():
            net.float()


def frozen_phase2(tr, batch: dict, float64: bool = False) -> tuple[dict, object]:
    """(the frozen phase-2 features of a device batch as the trainer's
    cached step takes them, {x_back, x_target, occ}, from its own
    _frozen_features; the decoder's df that its occupancy gate occ
    thresholds), with float64 in float64."""
    import torch
    with in_float64(tr) if float64 else contextlib.nullcontext(), torch.no_grad():
        if float64:
            batch = {k: (v.double() if v.is_floating_point() else v) for k, v in batch.items()}
        x_back, x_target, occ = tr._frozen_features(batch)
        df = tr.network_pred_to_df(tr._call("decoder", x_back))
    return {"x_back": x_back, "x_target": x_target, "occ": occ}, df


def flip_summary(dist: float, near, floor: float) -> dict:
    """A branch reading of one arithmetic against float64's (hold_branch):
    its value's largest distance from float64's (dist), and, over the
    decisions it takes the other way (near: float64's distance from the
    decision's boundary at each), their count, the farthest and the four
    nearest; `floor` is float64's own float32 rounding, the least bound."""
    near = sorted(float(x) for x in near)
    return {"dist": float(dist), "flips": len(near), "far": near[-1] if near else 0.0,
            "nearest": near[:4], "floor": float(floor)}


def gate_summary(occ, df, occ64, df64, threshold: float) -> dict:
    """The occupancy gate `occ` (2³-pooled, as occupancy_from_prediction
    makes it from the df `df`) against the float64 gate occ64 of df64, as
    flip_summary reads it in df units: max |df - df64|, and at each gate
    voxel that differs the smallest |df64 - threshold| over its 2³ df
    voxels (how near float64 came to deciding the other way); the floor one
    float32 rounding (machine epsilon) of float64's largest df."""
    import torch.nn.functional as F
    near = (df64.detach().double() - threshold).abs().permute(0, 4, 1, 2, 3)
    near = (-F.max_pool3d(-near, kernel_size=2, stride=2)).permute(0, 2, 3, 4, 1)
    dist = (df.detach().double().cpu() - df64.detach().double().cpu()).abs().max()
    eps = float(np.finfo(np.float32).eps)
    return flip_summary(dist, near.cpu()[occ.cpu() != occ64.cpu()],
                        eps * float(df64.abs().max()))


class Branches:
    """The branch that each ReLU / LeakyReLU call of a step takes (the sign
    of its input), recorded from one run of the step and imposed on
    another, call by call in order. A piecewise-linear network's gradient
    jumps where a unit changes branch: an input within rounding of 0 in
    float64 may land on the other side in float32 and move the gradient by
    the jump, not by the rounding. So two arithmetics' gradients compare
    like with like on one branch. A replay reads, as flip_summary, its
    inputs' largest distance from the recorded ones as a share of the
    recorded call's largest |input|, and at each unit whose own sign
    differs from the recorded branch the recorded |input| as that share
    (how near the recorded run came to the kink); the floor is one float32
    rounding (machine epsilon)."""

    def __init__(self):
        self.calls = []  # (branch, recorded input, its largest |input|), a call

    @staticmethod
    @contextlib.contextmanager
    def _patched(act):
        import torch.nn.functional as F
        saved = F.relu, F.leaky_relu
        F.relu = lambda x, inplace=False: act(x, 0.0)
        F.leaky_relu = lambda x, negative_slope=0.01, inplace=False: act(x, negative_slope)
        try:
            yield
        finally:
            F.relu, F.leaky_relu = saved

    @contextlib.contextmanager
    def record(self):
        """Run the block on its own branches, recording them."""
        import torch
        self.calls = []

        def act(x, slope):
            xd = x.detach()
            self.calls.append((xd > 0, xd, float(xd.abs().max()) or 1.0))
            return torch.where(xd > 0, x, x * slope)

        with self._patched(act):
            yield

    @contextlib.contextmanager
    def replay(self):
        """Run the block on the recorded branches; yields the reading, filled
        when the block ends."""
        import torch
        calls, dist, near = iter(self.calls), [0.0], []

        def act(x, slope):
            branch, x_rec, scale = next(calls)
            xd, branch = x.detach(), branch.to(x.device)
            x_rec = x_rec.to(x.device, torch.float64)
            dist[0] = max(dist[0], float((xd.double() - x_rec).abs().max()) / scale)
            near.extend((x_rec[(xd > 0) != branch].abs() / scale).tolist())
            return torch.where(branch, x, x * slope)

        reading = {}
        with self._patched(act):
            yield reading
        check(next(calls, None) is None, "a replay made fewer activation calls than its record")
        reading.update(flip_summary(dist[0], near, float(np.finfo(np.float32).eps)))


@contextlib.contextmanager
def tf32():
    """TF32 on for cuDNN's convolutions and for matmuls in the block (the
    port runs with both off: device.resolve_device)."""
    import torch
    saved = torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = True
    try:
        yield
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = saved


def step_read(card, cpu, phase: int, batch: dict, u, dev, anchor: bool) -> dict:
    """One train step of `phase` on a held draw (a host batch), the Gumbel
    uniform draw u: the losses on the card and the CPU (float32), and
    grad_share from the card's float64 gradients of the card's float32
    ones (card_f64), the CPU's (cpu_f64), the card's with TF32 on
    (tf32_f64) and the card's from the CPU's (card_cpu); with `anchor`, the
    card's float64 gradients from the CPU's float64 ones (f64_card_cpu)."""
    on_card, on_cpu = card._device_batch(batch), cpu._device_batch(batch)
    got = step_gradients(card, phase, on_card, u.to(dev))
    with tf32():
        got_tf32 = step_gradients(card, phase, on_card, u.to(dev))
    ref = step_gradients(card, phase, on_card, u.to(dev), float64=True)[2]
    want = step_gradients(cpu, phase, on_cpu, u)
    (card64, where), (tf32_64, tf32_where) = grad_share(got[2], ref), grad_share(got_tf32[2], ref)
    out = dict(loss=float(got[0]), loss_cpu=float(want[0]), card_f64=card64,
               cpu_f64=grad_share(want[2], ref)[0], card_cpu=grad_share(got[2], want[2])[0],
               worst=where, tf32_f64=tf32_64, tf32_worst=tf32_where)
    if anchor:
        ref_cpu = step_gradients(cpu, phase, on_cpu, u, float64=True)[2]
        out["f64_card_cpu"], out["f64_worst"] = grad_share(ref, ref_cpu)
    return out


def phase2_read(card, cpu, batch: dict, anchor: bool) -> dict:
    """Phase 2's step on a held draw (a host batch), read as
    hold_refine_steps holds it. Phase 2's loss is piecewise smooth: its
    gradients jump where the occupancy gate or a LeakyReLU of the
    attention's theta / phi MLPs changes branch. So each arithmetic (the
    card's float32, "card"; the CPU's, "cpu"; the card's with TF32 on,
    "tf32") makes its frozen features and df
    (frozen_phase2) and its gate is read against the card's float64 one
    (gate_summary); then the trainer's cached phase-2 step
    (compute_gradients(cached=True)) runs on its own x_back / x_target, on
    float64's gate and float64's LeakyReLU branches (Branches, recorded
    from the card's float64 cached step): its loss, its activations' reading
    (`activations`) and its gradients' grad_share from the float64 step,
    under step_read's keys. With `anchor`, the CPU's float64 cached step on
    its own features, gate and branches against the card's float64
    (f64_card_cpu), and the CPU's float64 gate against the card's."""
    on_card, on_cpu = card._device_batch(batch), cpu._device_batch(batch)
    thr = card.target_voxel_size * 0.75
    f64, df64 = frozen_phase2(card, on_card, float64=True)
    feats = {"card": frozen_phase2(card, on_card), "cpu": frozen_phase2(cpu, on_cpu)}
    with tf32():
        feats["tf32"] = frozen_phase2(card, on_card)
    gate, branches = f64["occ"], Branches()
    with branches.record():
        ref_loss, _, ref = step_gradients(card, 2, f64, cached=True, float64=True)

    def common(tr, fz):
        """(loss, gradients, activations' reading) of the cached step on
        fz's features, float64's gate and float64's branches."""
        with branches.replay() as act:
            loss, _, got = step_gradients(tr, 2, dict(fz, occ=gate.to(tr.device)), cached=True)
        return float(loss), got, act

    out = {"threshold": thr, "ref_loss": float(ref_loss), "gate": {}, "activations": {},
           "losses": {}, "shares": {}}
    grads = {}
    for key, (fz, df) in feats.items():
        tr = cpu if key == "cpu" else card
        out["gate"][key] = gate_summary(fz["occ"], df, gate, df64, thr)
        with tf32() if key == "tf32" else contextlib.nullcontext():
            out["losses"][key], grads[key], out["activations"][key] = common(tr, fz)
        out["shares"][key] = grad_share(grads[key], ref)
    (out["card_f64"], out["worst"]), (out["tf32_f64"], out["tf32_worst"]) = (
        out["shares"]["card"], out["shares"]["tf32"])
    out.update(loss=out["losses"]["card"], loss_cpu=out["losses"]["cpu"],
               cpu_f64=out["shares"]["cpu"][0],
               card_cpu=grad_share(grads["card"], grads["cpu"])[0])
    if anchor:
        c64, cdf64 = frozen_phase2(cpu, on_cpu, float64=True)
        cpu_ref = step_gradients(cpu, 2, c64, cached=True, float64=True)[2]
        out["f64_card_cpu"], out["f64_worst"] = grad_share(ref, cpu_ref)
        out["cpu64"] = gate_summary(c64["occ"], cdf64, gate, df64, thr)
    return out


def hold_branch(reads: list, what: str, label: str) -> float:
    """One kind of discrete decision of a held step over the draws
    (reads[r][what]: a flip_summary by arithmetic, "card", "cpu" and
    "tf32"): its bound is REFINE_F64_FACTOR times the CPU float32's largest
    dist over the draws, plus the floor. On every draw the card's dist lies
    within it and TF32's outside it, and every decision that the card's or
    the CPU's float32 takes the other way from float64 has float64 within
    the bound of the decision's boundary (a flip farther out is a decision
    that does not follow its value). Returns the bound."""
    bound_ = (REFINE_F64_FACTOR * max(d[what]["cpu"]["dist"] for d in reads)
              + max(d[what]["cpu"]["floor"] for d in reads))
    for r, d in enumerate(reads):
        got = d[what]
        check(got["card"]["dist"] <= bound_,
              f"{label} draw {r}: the card's {what} lie {got['card']['dist']:.2e} from "
              f"float64's, the CPU's {got['cpu']['dist']:.2e} (bound {bound_:.2e})")
        check(got["tf32"]["dist"] > bound_,
              f"{label} draw {r}: the card's {what} with TF32 on lie {got['tf32']['dist']:.2e} "
              f"from float64's, inside the bound {bound_:.2e}: the check cannot tell TF32")
        for key in ("card", "cpu"):
            check(got[key]["far"] <= bound_,
                  f"{label} draw {r}: the {key}'s float32 {what} decide {got[key]['flips']} "
                  f"times the other way from float64, float64 up to {got[key]['far']:.2e} from "
                  f"the boundary, beyond the bound {bound_:.2e}")
    return bound_


def refine_hold_items(cfg: dict, dev, seed: int, draws: int) -> tuple:
    """What hold_refine_steps holds: (a refinement trainer of cfg at batch 1
    on the card, one on the CPU, both from the seeded weights with the
    occupancy gate opened; the seeded weights before it was opened; the
    first train item; its `draws` perturbations; the Gumbel uniform draw),
    drawn from a generator seeded with `seed` (draw 0, then the Gumbel
    draw, then the other draws)."""
    import torch
    from retrieval_fuse_tpu_torch.train.refinement_trainer import RefinementTrainer
    cfg1 = dict(cfg, batch_size=1)
    card = RefinementTrainer(dict(cfg1), device=dev)
    cpu = RefinementTrainer(dict(cfg1), device="cpu")
    init = {n: {k: v.cpu().clone() for k, v in sd.items()} for n, sd in card.params().items()}
    for tr in (card, cpu):
        open_occupancy_gate(tr)
    rng = np.random.default_rng(seed)
    raw = first_batches(card.train_dataset, 1, 1)[0]
    held = [perturb_batch(raw, rng, REFINE_HOLD_NOISE)]
    rows = card.patched_attention_block.num_patch_x ** 3
    u = torch.from_numpy(rng.uniform(1e-20, 1.0, (rows, card.K)).astype(np.float32))
    held += [perturb_batch(raw, rng, REFINE_HOLD_NOISE) for _ in range(draws - 1)]
    return card, cpu, init, raw, held, u


def hold_refine_steps(cfg: dict, dev, seed: int, draws: int = REFINE_HOLD_DRAWS) -> dict:
    """One step of each phase of the refinement trainer on the card
    against the same step on the CPU, at batch 1, float32, TF32 off: the
    same seeded weights (the decoder's output bias at
    REFINE_HOLD_DECODER_BIAS), the same Gumbel uniform draw, on `draws`
    perturbations of the first train item (perturb_batch, from a generator
    seeded with `seed`; draw 0 first, then the Gumbel draw, then the
    others). On every draw the one-hot selections of phase 3 agree (where
    the attention selects by Gumbel noise) and each loss lies within 1e-5
    relative of the CPU's. The bound of a phase is
    REFINE_F64_FACTOR times the largest distance of the CPU's float32
    gradients from the float64 ones over the draws, plus REFINE_F64_FLOOR
    (grad_share over the phase's trainable sub-networks; float64 on the
    card, held on draw 0 within REFINE_F64_ANCHOR_TOL of the CPU's float64);
    on every draw the card's float32 gradients lie inside it and the card's
    with TF32 on outside it. Phases 3, 0 and 1 run the whole step in each
    arithmetic (step_read). Phase 2's loss is piecewise smooth in the
    frozen features (the occupancy gate, the LeakyReLUs of theta / phi), so
    it is held in parts (phase2_read): its branches (hold_branch, on the
    gate's df and on the LeakyReLU inputs: each float32 within the bound of
    float64, TF32 outside, every decision taken the other way a near-tie
    within the bound of its boundary), then its gradients on float64's
    gate and branches through the trainer's cached phase-2 step, each
    arithmetic on its own frozen features. Also reads the card-vs-CPU
    phase-3 loss on the unperturbed item (not held). Returns the readings
    (each phase's largest distances over the draws, TF32's smallest, phase
    2's branch bounds under "branch", and the draws') and, under "init",
    the seeded weights before the gate was opened (those a trainer of `cfg`
    starts from)."""
    import torch
    card, cpu, init, raw, held, u = refine_hold_items(cfg, dev, seed, draws)
    rows = card.patched_attention_block.num_patch_x ** 3
    out = {"phases": {}, "init": init, "draws": draws, "patches": rows,
           "selection_min_gap": None}
    if card.patched_attention_block.attention_blocks_layer.retrieval_mode:
        gaps = []  # the Gumbel hard selection; soft selection draws none
        for r, batch in enumerate(held):
            sel_card, gap = gumbel_selection(card, card._device_batch(batch), u)
            sel_cpu, gap_cpu = gumbel_selection(cpu, cpu._device_batch(batch), u)
            agree = float((sel_card == sel_cpu).float().mean())
            check(agree == 1.0, f"refine hold draw {r}: the phase-3 selections agree on "
                                f"{agree:.5f} of patches")
            gaps.append(min(gap, gap_cpu))
        out["selection_min_gap"] = min(gaps)
    for phase in (3, 0, 1, 2):
        reads = []
        for r, batch in enumerate(held):
            if phase == 2:
                reads.append(phase2_read(card, cpu, batch, anchor=r == 0))
            else:
                reads.append(step_read(card, cpu, phase, batch, u, dev, anchor=r == 0))
            d = reads[-1]
            check(np.isfinite(d["loss"]) and d["loss_cpu"] > 0
                  and abs(d["loss"] - d["loss_cpu"]) <= 1e-5 * d["loss_cpu"],
                  f"refine hold phase {phase} draw {r}: loss {d['loss']} on the card, "
                  f"{d['loss_cpu']} on the CPU")
            if r == 0:
                check(d["f64_card_cpu"] <= REFINE_F64_ANCHOR_TOL,
                      f"refine hold phase {phase}: the card's float64 gradients lie "
                      f"{d['f64_card_cpu']:.2e} from the CPU's (worst {d['f64_worst']}), beyond "
                      f"{REFINE_F64_ANCHOR_TOL:g}")
        branch = None if phase != 2 else {
            what: hold_branch(reads, what, "refine hold phase 2") for what in ("gate", "activations")}
        bound_ = REFINE_F64_FACTOR * max(d["cpu_f64"] for d in reads) + REFINE_F64_FLOOR
        for r, d in enumerate(reads):
            check(d["card_f64"] <= bound_,
                  f"refine hold phase {phase} draw {r}: the card's gradients lie "
                  f"{d['card_f64']:.2e} from float64 (worst {d['worst']}), the CPU's "
                  f"{d['cpu_f64']:.2e} (bound {bound_:.2e})")
            check(d["tf32_f64"] > bound_,
                  f"refine hold phase {phase} draw {r}: the card's gradients with TF32 on lie "
                  f"{d['tf32_f64']:.2e} from float64, inside the bound {bound_:.2e}: the hold "
                  "cannot tell TF32")
        worst = max(reads, key=lambda d: d["card_f64"])
        tf32_near = min(reads, key=lambda d: d["tf32_f64"])
        out["phases"][phase] = dict(
            loss=reads[0]["loss"], loss_cpu=reads[0]["loss_cpu"], bound=bound_,
            card_f64=worst["card_f64"], worst=worst["worst"],
            cpu_f64=max(d["cpu_f64"] for d in reads),
            card_cpu=max(d["card_cpu"] for d in reads), tf32_f64=tf32_near["tf32_f64"],
            tf32_worst=tf32_near["tf32_worst"], f64_card_cpu=reads[0]["f64_card_cpu"],
            branch=branch, draws=reads)
    with torch.no_grad():
        plain = [float(tr._phase_loss(3, tr.augment_batch_data(tr._device_batch(raw)),
                                      u.to(tr.device))[0]) for tr in (card, cpu)]
    out["unperturbed_phase3_loss"] = plain
    return out


def retrieval_step_gradients(trainer, batch: dict, dtype) -> tuple[float, dict]:
    """(loss, {encoder: {key: gradient}}) of the retrieval trainer's
    train-mode loss on a device batch, the gradients its train step takes
    before the Adam update, on copies of the encoders in `dtype` (the
    trainer's weights and BatchNorm statistics stay as they were)."""
    nets = {name: copy.deepcopy(net).to(dtype).train()
            for name, net in trainer.encoders.items()}
    saved = trainer.fenc_input, trainer.fenc_target
    trainer.fenc_input, trainer.fenc_target = nets["fenc_input"], nets["fenc_target"]
    try:
        total, _ = trainer._loss_fn({k: v.to(dtype) if v.is_floating_point() else v
                                     for k, v in batch.items()}, train=True)
        total.backward()
    finally:
        trainer.fenc_input, trainer.fenc_target = saved
    grads = {name: {key: p.grad.detach() for key, p in net.named_parameters()}
             for name, net in nets.items()}
    return float(total.detach()), grads


def hold_task_train_step(cfg: dict, dev, draws: int = REFINE_HOLD_DRAWS) -> dict:
    """The retrieval trainer's step-1 gradients on the card under the rule
    of hold_refine_steps, on each of the first `draws` batches of cfg's
    epoch-0 order (the same seeded weights, float32, TF32 off): each loss
    within 1e-5 relative of the CPU's; the bound REFINE_F64_FACTOR times the
    largest distance of the CPU's float32 gradients from the CPU's float64
    ones over the draws, plus REFINE_F64_FLOOR (grad_share over both
    encoders); on every draw the card's float32 gradients inside it and the
    card's with TF32 on outside it. The encoders are piecewise linear in
    their (Leaky)ReLUs, so every arithmetic's step runs on the branches of
    the CPU's float64 step (Branches), which are held first (hold_branch on
    the activations' inputs). Returns the readings (largest distances over
    the draws, TF32's smallest, the branches' bound, and the draws')."""
    import torch
    from retrieval_fuse_tpu_torch.train.retrieval_trainer import RetrievalTrainer
    card, cpu = RetrievalTrainer(cfg, device=dev), RetrievalTrainer(cfg, device="cpu")
    reads = []
    for r, batch in enumerate(first_batches(cpu.train_dataset, cpu.batch_size, draws)):
        on_card, on_cpu = card._device_batch(batch), cpu._device_batch(batch)
        branches, act = Branches(), {}
        with branches.record():
            ref = retrieval_step_gradients(cpu, on_cpu, torch.float64)[1]
        with branches.replay() as act["card"]:
            loss, got = retrieval_step_gradients(card, on_card, torch.float32)
        with tf32(), branches.replay() as act["tf32"]:
            got_tf32 = retrieval_step_gradients(card, on_card, torch.float32)[1]
        with branches.replay() as act["cpu"]:
            loss_cpu, want = retrieval_step_gradients(cpu, on_cpu, torch.float32)
        check(np.isfinite(loss) and abs(loss - loss_cpu) <= 1e-5 * abs(loss_cpu),
              f"retrieval hold draw {r}: loss {loss} on the card, {loss_cpu} on the CPU")
        (card64, where), (cpu64, _) = grad_share(got, ref), grad_share(want, ref)
        reads.append(dict(loss=loss, loss_cpu=loss_cpu, card_f64=card64, cpu_f64=cpu64,
                          worst=where, tf32_f64=grad_share(got_tf32, ref)[0], activations=act))
    act_bound = hold_branch(reads, "activations", "retrieval hold")
    bound_ = REFINE_F64_FACTOR * max(d["cpu_f64"] for d in reads) + REFINE_F64_FLOOR
    for r, d in enumerate(reads):
        check(d["card_f64"] <= bound_,
              f"retrieval hold draw {r}: the card's gradients lie {d['card_f64']:.2e} from "
              f"float64 (worst {d['worst']}), the CPU's {d['cpu_f64']:.2e} (bound {bound_:.2e})")
        check(d["tf32_f64"] > bound_,
              f"retrieval hold draw {r}: the card's gradients with TF32 on lie "
              f"{d['tf32_f64']:.2e} from float64, inside the bound {bound_:.2e}: the hold "
              "cannot tell TF32")
    return dict(bound=bound_, card_f64=max(d["card_f64"] for d in reads),
                cpu_f64=max(d["cpu_f64"] for d in reads),
                tf32_f64=min(d["tf32_f64"] for d in reads), activation_bound=act_bound,
                draws=reads)


def branch_line(reading: dict, bound_: float) -> str:
    """A hold_branch reading (flip_summary by arithmetic) as one line."""
    e = lambda xs: [float(f"{x:.2e}") for x in xs]  # noqa: E731
    tf32_x = reading["tf32"]["dist"] / bound_ if bound_ else float("inf")
    return ", ".join(
        f"{k} {v['dist']:.2e} ({v['flips']} flips, nearest {e(v['nearest'])}"
        + (f", farthest {v['far']:.2e})" if v["flips"] else ")")
        for k, v in reading.items()) + f" (bound {bound_:.2e}; TF32 {tf32_x:.1f}x)"


def log_phase2_branches(rec: dict, card: str) -> None:
    """Print phase 2's branch readings and gradients (phase2_read) by draw."""
    for r, d in enumerate(rec["draws"]):
        log(f"    draw {r} gate (threshold {d['threshold']:.6g}, max |df - df64| and flips "
            f"against float64's gate, float64's distance from the threshold at each): "
            + branch_line(d["gate"], rec["branch"]["gate"]) + (
            "" if "cpu64" not in d else
            f"; the CPU's float64 gate {d['cpu64']['flips']} flips from the card's (df "
            f"{d['cpu64']['dist']:.1e} apart)") + f" [{card}]")
        log(f"    draw {r} theta / phi LeakyReLU inputs on float64's branches (from float64's, "
            f"as a share of the call's largest; flips: units on the other side of 0): "
            + branch_line(d["activations"], rec["branch"]["activations"]))
        log(f"    draw {r} gradients on float64's gate and branches, from float64: " + ", ".join(
            f"{k} {v[0]:.2e}" for k, v in d["shares"].items()))


def log_refine_hold(hold: dict, label: str, card: str) -> None:
    """Print a refinement hold's readings (hold_refine_steps)."""
    gap = hold["selection_min_gap"]
    log(f"{label} card vs CPU (batch 1, float32, TF32 off, {hold['draws']} perturbations of "
        f"the first train item by N(0, {REFINE_HOLD_NOISE})): " + (
            "soft selection" if gap is None else
            f"phase-3 Gumbel selections agree on all {hold['patches']} patches of every draw, "
            f"smallest top-two gap of the perturbed scores {gap:.3e}") + "; float64 on the "
        f"card, within {max(r['f64_card_cpu'] for r in hold['phases'].values()):.1e} of the "
        f"CPU's on draw 0 (<= {REFINE_F64_ANCHOR_TOL:g})")
    for phase, rec in sorted(hold["phases"].items()):
        log(f"  phase {phase}: loss {rec['loss']:.6f} (CPU {rec['loss_cpu']:.6f}, within 1e-5 "
            f"relative on every draw); gradients from float64, as a share of their "
            f"sub-network's largest, by draw: card "
            f"{[float(f'{d['card_f64']:.2e}') for d in rec['draws']]} (bound "
            f"{rec['bound']:.2e}; worst {rec['worst']}), CPU float32 "
            f"{[float(f'{d['cpu_f64']:.2e}') for d in rec['draws']]}; card vs CPU "
            f"{rec['card_cpu']:.2e}; card with TF32 on "
            f"{[float(f'{d['tf32_f64']:.2e}') for d in rec['draws']]} (nearest "
            f"{rec['tf32_f64'] / rec['bound']:.1f}x the bound) [{card}]")
        if rec["branch"] is not None:
            log_phase2_branches(rec, card)
    a, b = hold["unperturbed_phase3_loss"]
    log(f"  unperturbed item (constant 16³ patches), not held: phase-3 loss {a:.6f} on the "
        f"card, {b:.6f} on the CPU ({abs(a - b) / abs(b):.1e} relative)")


def device_busy(fn) -> tuple[float, float]:
    """(ms of CUDA kernels, ms of wall) of one call of fn after one warm-up,
    traced with torch.profiler; the idle share is 1 - kernels / wall."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    busy = sum(e.device_time_total for e in prof.events() if e.device_type == DeviceType.CUDA)
    return busy / 1e3, wall


def patch_occupancy(df64, voxel_size: float, context: int = 8):
    """(n,) the number of dictionary rows each 64³ target chunk gives: its
    16+`context` patches (windows of 16 + 2 context at stride 16 on the
    chunk padded by `context`) that hold a voxel at or below 1.5 voxel
    sizes, the occupancy rule of SceneHandler on the float16 scene. The
    padding is above the threshold."""
    import torch
    thr = float(np.float32(1.5) * np.float32(np.float16(voxel_size)))
    occ = df64.half().float() <= thr
    counts = torch.zeros(df64.shape[0], dtype=torch.int64, device=df64.device)
    spans = [(max(s - context, 0), s + 16 + context) for s in (0, 16, 32, 48)]
    for x0, x1 in spans:
        for y0, y1 in spans:
            for z0, z1 in spans:
                counts += occ[:, x0:x1, y0:y1, z0:z1].flatten(1).any(dim=1)
    return counts


def write_retrieval_dataset(root, rng, min_rows: int, n_val: int, device) -> dict:
    """A synthetic super-resolution dataset under `root`, in the layout of
    the JAX package's data/synthetic.py (splits, sdf_064 targets, sdf_008
    inputs of the same spheres and boxes), made on the device and written
    with np.savez: train chunks, 64 at a time, until their patches give at
    least `min_rows` dictionary rows, then n_val val chunks."""
    from retrieval_fuse_tpu_torch.data.synthetic import write_splits
    root = Path(root)
    cfg = retrieval_config(root, "unused")["dataset_train"]
    vs_in, vs_tgt = cfg["voxel_size_input"], cfg["voxel_size_target"]
    for sub in ("sdf_008", "sdf_064"):
        (root / sub / "SynthSet").mkdir(parents=True, exist_ok=True)
    names, rows, n_train = [], 0, None
    while n_train is None or len(names) < n_train + n_val:
        n = 64 if n_train is None else n_train + n_val - len(names)
        prims = draw_primitives(rng, n, device)
        tgt, inp = primitives_df(prims, 64, vs_tgt), primitives_df(prims, 8, vs_in)
        if n_train is None:
            rows += int(patch_occupancy(tgt, vs_tgt).sum())
        tgt, inp = tgt.cpu().numpy(), inp.cpu().numpy()
        for i in range(n):
            name = f"synth__{len(names):04d}"
            np.savez(root / "sdf_064" / "SynthSet" / f"{name}.npz", arr=tgt[i])
            np.savez(root / "sdf_008" / "SynthSet" / f"{name}.npz", arr=inp[i])
            names.append(name)
        if n_train is None and rows >= min_rows:
            n_train = len(names)
    write_splits(root, "SynthSet", "main", names[:n_train], names[n_train:])
    return {"train": names[:n_train], "val": names[n_train:], "rows": rows}


#: phase 12: the point-cloud inputs' points a chunk (the pc_20K layout:
#: SceneHandler doubles a cloud of fewer), and the size of the pool of point
#: subsets its voxeliser draws from (random_indices/<num_points>.npz)
TASK_CLOUD_POINTS = 20000
TASK_INDEX_POOL = 1024


def write_task_dataset(task: str, root, rng, min_rows: int, n_val: int, device,
                       per_draw: int = 64) -> dict:
    """A synthetic dataset of phase 12's `task` under `root`, in the layout
    of the task's config (task_retrieval_config): 64³ targets (sdf_064) of
    random spheres and boxes and, of the same primitives, 16³ distance
    fields (sdf_016, "superres16") or TASK_CLOUD_POINTS near-surface points
    (pc_20K, "surface"), made on the device: train chunks, per_draw at a time,
    until their patches give at least `min_rows` dictionary rows (every
    patch for "superres16", whose config skips the occupancy rule), then
    n_val val chunks. Chunks are named `synth__<i>__0_0_0` (the 3DFront
    and Matterport3D chunk naming). For "surface", also the voxeliser's
    pool of point subsets, TASK_INDEX_POOL draws from `rng`."""
    from retrieval_fuse_tpu_torch.data.synthetic import write_splits
    root = Path(root)
    data = TASK_DATA[task]
    name, vs_in, vs_tgt = data["dataset_name"], data["voxel_size_input"], \
        data["voxel_size_target"]
    for sub in (data["input_dir"], "sdf_064"):
        (root / sub / name).mkdir(parents=True, exist_ok=True)
    names, rows, n_train = [], 0, None
    while n_train is None or len(names) < n_train + n_val:
        n = per_draw if n_train is None else n_train + n_val - len(names)
        prims = draw_primitives(rng, n, device)
        tgt = primitives_df(prims, 64, vs_tgt)
        if n_train is None:
            rows += int(patch_occupancy(tgt, vs_tgt, 4).sum()) if task == "surface" \
                else 64 * n
        if task == "surface":
            inp = primitives_points(prims, rng, TASK_CLOUD_POINTS, 64).cpu().numpy()
        else:
            inp = primitives_df(prims, 16, vs_in).cpu().numpy()
        tgt = tgt.cpu().numpy()
        for i in range(n):
            chunk = f"synth__{len(names):04d}__0_0_0"
            np.savez(root / "sdf_064" / name / f"{chunk}.npz", arr=tgt[i])
            if task == "surface":
                np.savez(root / data["input_dir"] / name / f"{chunk}.npz", inp[i])
            else:
                np.savez(root / data["input_dir"] / name / f"{chunk}.npz", arr=inp[i])
            names.append(chunk)
        if n_train is None and rows >= min_rows:
            n_train = len(names)
    write_splits(root, name, "main", names[:n_train], names[n_train:])
    if task == "surface":
        pool = np.stack([rng.choice(TASK_CLOUD_POINTS, data["num_points"], replace=False)
                         for _ in range(TASK_INDEX_POOL)]).astype(np.int32)
        (root / "random_indices").mkdir(exist_ok=True)
        np.savez_compressed(root / "random_indices" / f"{data['num_points']}.npz", arr=pool)
    return {"train": names[:n_train], "val": names[n_train:], "rows": rows}


class Failed(Exception):
    pass


def check(cond: bool, what: str) -> None:
    if not cond:
        raise Failed(what)


def cuda_ms(fn, iters: int, warmup: int = 1) -> float:
    """Mean device time of fn() over `iters` back-to-back runs (CUDA events)."""
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def log(msg: str) -> None:
    print(msg, flush=True)


def bound(nbytes: float, flops: float, peak: float) -> tuple[float, str]:
    """The least time (ms) the card could take: bytes over the memory rate or
    operations over `peak`, whichever is larger, and which it is."""
    by_bytes, by_ops = nbytes / HBM_BYTES_PER_S, flops / peak
    return 1e3 * max(by_bytes, by_ops), "bytes" if by_bytes >= by_ops else "operations"


def attention_bound(q: int, t: int, k: int, f: int) -> tuple[float, str]:
    """An attention kernel's bound over q tiles of t rows of F = f in bf16,
    each row with k candidate rows: each row and candidate row read once,
    each output row written once, the (q, k) indices read once, against the
    MLP GEMMs of the row and its candidates (F -> 128 -> 128 -> 128 -> 32)
    at the bf16 tensor-core rate."""
    mlp_flops = 2 * (f * 128 + 2 * 128 * 128 + 128 * 32)
    return bound(2 * (2 * q * t * f + q * k * t * f) + q * k * 4,
                 q * t * (1 + k) * mlp_flops, BF16_FLOPS)


def decoder_tail_bound(hn, nf: int) -> tuple[float, str]:
    """The decoder tail's bound on input hn (B, S+2, S+2, S+2, 8·nf): hn read
    once, the (2S)³ float32 outputs written once, the 27-tap conv and the
    head of every 2x-grid voxel at the bf16 tensor-core rate (float32's for
    a float32 input)."""
    b, s2 = hn.shape[0], 2 * (hn.shape[1] - 2)
    peak = BF16_FLOPS if hn.element_size() == 2 else F32_FLOPS
    return bound(hn.numel() * hn.element_size() + b * s2 ** 3 * 4,
                 b * s2 ** 3 * (27 * nf * nf * 2 + 2 * nf), peak)


def softmax_f64_hold(out, plain, args32: tuple) -> dict:
    """The float32 softmax hold of an attention kernel's output `out` on
    `args32` (the plain version's arguments: rows, candidates or bank and
    indices, theta, phi, K): its max |diff| from the plain version run in
    float64 ("err"), the plain float32's ("plain_f32"), the bound
    SOFTMAX_F64_FACTOR x plain_f32 + SOFTMAX_F64_FLOOR, and the negative
    control's distance ("control": the plain version's bf16 path, on the
    operands in bf16)."""
    import torch

    def to64(a):
        return a.double() if isinstance(a, torch.Tensor) and a.is_floating_point() else a

    def to_bf16(a):
        return a.bfloat16() if isinstance(a, torch.Tensor) and a.is_floating_point() else a

    want = plain(*map(to64, args32), False)[0]
    dist = lambda x: float((x.double() - want).abs().max())
    plain32 = dist(plain(*args32, False)[0])
    out = dict(err=dist(out), plain_f32=plain32,
               bound=SOFTMAX_F64_FACTOR * plain32 + SOFTMAX_F64_FLOOR,
               control=dist(plain(*map(to_bf16, args32), False)[0]))
    del want
    return out


def hold_attention(label: str, kernel, plain, args32: tuple, args16: tuple,
                   math16: str, f32_modes: tuple = (None,)) -> tuple[float, float]:
    """An attention kernel against its plain version: float32 in each of
    `f32_modes` (None: the kernel's default selection; True hard, False
    softmax) (selections agree on >= 99.9% of rows; max |diff| <= 1e-4 on
    them, with softmax selection softmax_f64_hold's bound over all rows,
    its negative control outside) and bf16 with hard and
    with softmax selection (argmax candidates agree on >= 99%, mean |diff|
    <= 1e-3 on them: rows differ only where float32 sums taken in another
    order round to a neighbouring bf16 value); the float32 launches must
    report the FMA path and the bf16 launches the path `math16`. Returns
    (float32 max |diff| with hard selection, bf16 share with hard
    selection, the share of rows whose switch is open)."""
    import torch
    err = switch_open = None
    for mode in f32_modes:
        extra, tag = ((), "f32") if mode is None else ((mode,), f"f32 {'hard' if mode else 'softmax'}")
        out, sel = kernel(*args32, *extra, return_selection=True)
        check(kernel.math == "fma.f32", f"{label} {tag}: launch took {kernel.math}")
        want, want_sel = plain(*args32, *extra)
        torch.cuda.synchronize()
        agree = sel.long() == want_sel
        share = float(agree.float().mean())
        diff = (out - want).abs()[agree]
        check(share >= 0.999, f"{label} {tag}: selections agree on {share:.5f}")
        if switch_open is None:
            switch_open = float((want != args32[0]).any(dim=-1).float().mean())
        if mode is False:
            h = softmax_f64_hold(out, plain, args32)
            check(h["err"] <= h["bound"],
                  f"{label} {tag}: max |diff| {h['err']:.2e} from float64, the plain float32 "
                  f"{h['plain_f32']:.2e} (bound {h['bound']:.2e})")
            check(h["control"] > h["bound"],
                  f"{label} {tag}: the bf16 control lies {h['control']:.2e} from float64, "
                  f"inside the bound {h['bound']:.2e}: the hold cannot tell it")
            log(f"{label} {tag}: selections agree on {share:.5%} of rows; max |diff| from "
                f"float64 {h['err']:.2e}, the plain float32's {h['plain_f32']:.2e}, bound "
                f"{h['bound']:.2e}, bf16 control {h['control']:.2e}; switch open on "
                f"{switch_open:.1%} of rows")
            continue
        check(float(diff.max()) <= 1e-4, f"{label} {tag}: max |diff| {float(diff.max())} on "
                                         f"agreeing rows (bound 1e-4)")
        err = float(diff.max())
        log(f"{label} {tag}: selections agree on {share:.5%} of rows, max |diff| "
            f"{float(diff.max()):.2e} (bound 1e-4), mean {float(diff.mean()):.2e} on them; "
            f"switch open on {switch_open:.1%} of rows")
    shares = {}
    for mode, hard in (("hard", True), ("softmax", False)):
        out16, sel16 = kernel(*args16, hard, return_selection=True)
        check(kernel.math == math16,
              f"{label} bf16 {mode}: launch took {kernel.math}, not {math16}")
        want16, want_sel16 = plain(*args16, hard)
        agree16 = sel16.long() == want_sel16
        shares[mode] = float(agree16.float().mean())
        diff16 = (out16.float() - want16.float()).abs()[agree16]
        check(shares[mode] >= 0.99, f"{label} bf16 {mode}: selections agree on {shares[mode]}")
        check(float(diff16.mean()) <= 1e-3,
              f"{label} bf16 {mode}: mean |diff| {float(diff16.mean())} on agreeing rows")
        log(f"{label} bf16 {mode} [{math16}]: selections agree on {shares[mode]:.5%} of rows, "
            f"max |diff| {float(diff16.max()):.2e}, mean {float(diff16.mean()):.2e}")
    return err, shares["hard"], switch_open


#: phase 4c-4e's edge holds of the shipped bf16 attention body (kernels 3
#: and 4 at F = 128, hold_shipped_edges): N = 64·EDGE_TILES + 17 rows (a
#: ragged last tile) and Q = EDGE_TILES + 1 tiles (no multiple of the
#: persistent grid's warpgroups), at K 1 and K 8
EDGE_TILES = 300
#: the least share of an edge hold's rows whose switch is open (an H100 run
#: read 33.6-33.9% at K 1 and 76-77% at K 8 on these seeded rows)
EDGE_SWITCH_OPEN = 0.25


def hold_shipped_edges(dev, seed: int, f: int = 128) -> list[str]:
    """Kernels 3 and 4 against their plain versions on seeded rows and
    weights at the shipped body's edges (EDGE_TILES): hold_attention in
    float32 and in bf16 with hard and softmax selection, at K 1 and K 8,
    each on rows whose switch is open on at least EDGE_SWITCH_OPEN of them
    (at K 1 the selection is always candidate 0, so only the open rows
    hold the kernel). Returns the labels held."""
    import torch
    from retrieval_fuse_tpu_torch.models.attention import AttentionFeatureEncoder
    from retrieval_fuse_tpu_torch.ops import patch_attention as pa
    rng = np.random.default_rng(seed)

    def rows(*shape):
        return torch.from_numpy(rng.standard_normal(shape, dtype=np.float32)).to(dev)

    mlps = []
    for _ in range(2):
        m = AttentionFeatureEncoder(f, 32)
        for prm in m.parameters():
            b = 1.0 / np.sqrt(prm.shape[-1]) if prm.dim() == 2 else 0.1
            prm.data = torch.from_numpy(rng.uniform(-b, b, tuple(prm.shape)).astype(np.float32))
        mlps.append(m.to(dev))
    mlps16 = [copy.deepcopy(m).bfloat16() for m in mlps]
    held = []
    for k in (1, 8):
        n = 64 * EDGE_TILES + 17
        x, p = rows(n, f), rows(n, k, f)
        label = f"patch attention N={n} K={k}"
        opens = [hold_attention(label, pa.patch_attention, pa.patch_attention_plain,
                                (x, p, *mlps, k), (x.bfloat16(), p.bfloat16(), *mlps16, k),
                                pa.kernel_math("patch_attention", torch.bfloat16))[2]]
        q = EDGE_TILES + 1
        xt, bank = rows(q, 64, f), rows(50, 64, f)
        idx = torch.from_numpy(rng.integers(0, 50, (q, k)).astype(np.int32)).to(dev)
        label2 = f"gathered attention Q={q} K={k}"
        opens.append(hold_attention(
            label2, pa.gathered_patch_attention, pa.gathered_patch_attention_plain,
            (xt, bank, idx, *mlps, k), (xt.bfloat16(), bank.bfloat16(), idx, *mlps16, k),
            pa.kernel_math("gathered_attention", torch.bfloat16))[2])
        for lab, share in zip((label, label2), opens):
            check(share >= EDGE_SWITCH_OPEN, f"{lab}: the switch is open on only {share:.1%} "
                                             f"of rows (at least {EDGE_SWITCH_OPEN:.0%})")
        held += [label, label2]
    return held


def unit_rows(rng, n: int, d: int, dtype, device):
    """n random unit rows of width d from `rng`, in dtype on device."""
    import torch
    x = rng.standard_normal((n, d), dtype=np.float32)
    x /= np.linalg.norm(x, axis=1, keepdims=True)
    return torch.from_numpy(x).to(device=device, dtype=dtype)


def knn_bound(q: int, n: int, d: int, k: int, dtype) -> tuple[float, str]:
    """The streaming kNN's bound: 2·Q·N·D flops on the bf16 tensor cores,
    or three TF32 products of that size (3xTF32) for float32 rows; each row
    read once, the (Q, k) values and indices written once."""
    import torch
    bf16 = dtype == torch.bfloat16
    return bound((q + n) * d * (2 if bf16 else 4) + q * k * 8,
                 2 * q * n * d * (1 if bf16 else 3), BF16_FLOPS if bf16 else TF32_FLOPS)


def knn_index_agreement(i, pv, pi, k: int) -> tuple[bool, int, int]:
    """The kernel's (Q, k) indices `i` against the plain version's top k+1
    (similarities `pv`, indices `pi`). Where the k-th and (k+1)-th
    similarities are more than KNN_TIE_GAP apart ("set-clear"), the kernel's
    k rows must be the plain k rows; where all of the top k+1 are
    ("order-clear"), in the same order too. Elsewhere the order of the
    float32 sums decides. Returns (agree, set-clear queries, order-clear
    queries)."""
    import torch
    gaps = pv[:, :-1] - pv[:, 1:] > KNN_TIE_GAP
    set_clear, order_clear = gaps[:, k - 1], gaps.all(dim=1)
    agree = (torch.equal(i[set_clear].sort(dim=1).values,
                         pi[set_clear, :k].sort(dim=1).values)
             and torch.equal(i[order_clear], pi[order_clear, :k]))
    return agree, int(set_clear.sum()), int(order_clear.sum())


def hold_knn(label: str, queries, database, k: int) -> tuple[float, int]:
    """The streaming kNN kernel against its plain version: the rows of
    knn_index_agreement, at least KNN_MIN_ORDER_CLEAR of the queries
    order-clear, max |similarity diff| <= KNN_SIM_TOL, and the launch on the
    dtype's tensor-core path. Returns (max |diff|, queries not order-clear)."""
    import torch
    from retrieval_fuse_tpu_torch.ops.streaming_knn import (
        kernel_math, streaming_knn_sims, streaming_knn_sims_plain)
    v, i = streaming_knn_sims(queries, database, k)
    check(streaming_knn_sims.math == kernel_math(queries.dtype),
          f"{label}: launch took {streaming_knn_sims.math}")
    pv, pi = streaming_knn_sims_plain(queries, database, k + 1)
    torch.cuda.synchronize()
    agree, set_clear, order_clear = knn_index_agreement(i, pv, pi, k)
    q = queries.shape[0]
    check(agree, f"{label}: indices differ off near-ties")
    check(order_clear >= KNN_MIN_ORDER_CLEAR * q,
          f"{label}: only {order_clear} of {q} queries clear of near-ties")
    err = float((v - pv[:, :k]).abs().max())
    check(err <= KNN_SIM_TOL, f"{label}: similarities differ by {err}")
    log(f"{label} [{streaming_knn_sims.math}] Q={q} N={database.shape[0]} "
        f"D={queries.shape[1]} k={k}: the same top-k rows on {set_clear} queries (k-th to "
        f"(k+1)-th gap > {KNN_TIE_GAP:g}), in the same order on {order_clear} (every gap of "
        f"the top k+1 > {KNN_TIE_GAP:g}), of {q}; max |sim diff| {err:.2e} "
        f"(<= {KNN_SIM_TOL:g})")
    return err, q - order_clear


#: float32 operations per valid point pair of the chamfer minima: the depth-3
#: dot product (5), |a|² + |b|² (1), the ×2 and the subtraction (2), the clamp
#: at 0 (1), and one min in each direction (2)
CHAMFER_OPS_PER_PAIR = 11


def chamfer_bound(args: list) -> tuple[float, str]:
    """The chamfer minima's bound for the (points_a, n_a, points_b, n_b)
    calls in `args`, summed: the operations over the valid point pairs of
    this data, the buffers and counts read once, the minima written once."""
    pairs = nbytes = 0
    for a, n_a, b, n_b in args:
        pairs += int((n_a.long() * n_b.long()).sum())
        nbytes += (a.numel() + b.numel()) * 4 + (n_a.numel() + n_b.numel()) * 4 \
            + (a.numel() + b.numel()) // 3 * 4
    return bound(nbytes, CHAMFER_OPS_PER_PAIR * pairs, F32_FLOPS)


def hold_chamfer(label: str, args: list) -> float:
    """The chamfer kernel against its plain version on each call of `args`:
    minima bit-equal (voxel coordinates: every term an exact integer), the
    chamfer values within 1e-6 relative. Returns the max |chamfer diff|."""
    import torch
    from retrieval_fuse_tpu_torch.ops.chamfer import chamfer_batch, chamfer_batch_plain
    from retrieval_fuse_tpu_torch.ops.streaming_chamfer import (
        chamfer_minima, chamfer_minima_plain)
    worst = 0.0
    for call in args:
        got, want = chamfer_minima(*call), chamfer_minima_plain(*call)
        torch.cuda.synchronize()
        check(all(torch.equal(g, w) for g, w in zip(got, want)),
              f"chamfer {label}: minima differ from the plain version's")
        cd, cd_plain = chamfer_batch(*call), chamfer_batch_plain(*call)
        rel = ((cd - cd_plain).abs() / cd_plain.abs().clamp(min=1e-30)).max()
        check(float(rel) <= 1e-6, f"chamfer {label}: values differ by {float(rel)} relative")
        worst = max(worst, float((cd - cd_plain).abs().max()))
    pts = sum(int(c[1].sum()) + int(c[3].sum()) for c in args)
    log(f"chamfer {label}: {len(args)} calls, {pts} points: minima bit-equal, chamfer max "
        f"|diff| {worst:.2e} (<= 1e-6 relative)")
    return worst


class DtypeLaunches:
    """The launches of one dtype of a wrapper that counts them by dtype, as
    a counter with `launches`."""

    def __init__(self, fn, dtype):
        self.fn, self.dtype = fn, dtype

    @property
    def launches(self) -> int:
        return self.fn.dtype_launches[self.dtype]

    @launches.setter
    def launches(self, value: int) -> None:
        self.fn.dtype_launches[self.dtype] = value


class Subset:
    """The items `idx` of a dataset, as a dataset."""

    def __init__(self, dataset, idx):
        self.dataset, self.idx = dataset, idx

    def __len__(self):
        return len(self.idx)

    def __getitem__(self, i):
        return self.dataset[int(self.idx[i])]


def check_mapping(cfg: dict, tree, mapping: dict, dataset, rng, n_sample: int, device,
                  replay_seed: int | None = None) -> int:
    """The retrieval mapping of `n_sample` random train queries against a
    dense float32 search over database.npy (matmul, top 2K, same-scene
    demotion): the K rows (scene and extent) equal and the distances within
    1e-5, on the queries whose top 2K+1 distances are more than 1e-5 apart.
    Returns the number of the others (near-ties, where float32 sums in
    another order may rank otherwise). With `replay_seed` (point-cloud
    inputs, whose voxeliser draws a point subset from Python's `random` for
    every item): the first n_sample train queries, drawn as `map` drew them
    after random.seed(replay_seed), its dictionary's pass over the train
    items first."""
    import torch
    from retrieval_fuse_tpu_torch.ops.knn import demote_same_scene
    from retrieval_fuse_tpu_torch.retrieval.cli import load_encoders_from_checkpoint
    from retrieval_fuse_tpu_torch.retrieval.dictionary import extract_input_features
    k, latent = cfg["K"], cfg["retrieval_model"]["latent_dim"]
    database = np.load(Path(tree) / "database.npy")
    scene_id = {s: i for i, s in enumerate(json.loads((Path(tree) / "index.json").read_text()))}
    encode_in = load_encoders_from_checkpoint(cfg, device)[0]
    if replay_seed is None:
        sub = Subset(dataset, rng.choice(len(dataset), n_sample, replace=False))
    else:
        import random
        random.seed(replay_seed)
        pool = dataset.scene_handler.random_indices_list.shape[0]
        for _ in range(len(dataset)):  # the dictionary's draws
            random.randint(0, pool - 1)
        sub = Subset(dataset, np.arange(n_sample))
    names, feats = extract_input_features(encode_in, cfg["query"], latent, sub)
    with torch.inference_mode():
        db = torch.from_numpy(np.ascontiguousarray(database[:, 7:])).to(device)
        top_s, top_i = torch.topk(torch.from_numpy(feats).to(device) @ db.T, 2 * k + 1, dim=1)
        dist = torch.clamp(2.0 - 2.0 * top_s, min=0.0)
        clear = ((dist[:, 1:] - dist[:, :-1]) > 1e-5).all(dim=1).cpu().numpy()
        q_scene = torch.tensor([scene_id[dataset.get_scene_names_from_patches([n])[0]]
                                for n in names], dtype=torch.int32, device=device)
        db_scene = torch.from_numpy(database[:, 0].astype(np.int32)).to(device)
        idx, d = demote_same_scene(top_i[:, :2 * k].int(), dist[:, :2 * k], db_scene, q_scene, k)
    rows = database[idx.cpu().numpy(), 0:7]
    got = np.stack([mapping[n] for n in names])
    same = (rows == got[..., :7]).all(axis=(1, 2))
    close = (np.abs(d.cpu().numpy() - got[..., 7]) <= 1e-5).all(axis=1)
    check(bool(same[clear].all() and close[clear].all()),
          f"retrieval map: {int((~(same & close))[clear].sum())} of {int(clear.sum())} sampled "
          f"train queries differ from a dense float32 search")
    return int((~clear).sum())


def run_phase9(dev, rng, seed: int, kernels: dict, counters: dict, drive, card: str):
    """Phase 9, the other tasks' networks at full width, on `dev`:
    9a, the 3DFront surface-reconstruction engines (surface_config: nf 12,
    the attention kernels at F = 96, the decoder tail at nf 12) on 128³
    occupancy grids: `base` and SURFACE_VARIANTS at SURFACE_BATCHES in bf16
    and float32, each held against `base` in its dtype (TSDF MAE < 1e-3 and
    < 1e-5) and timed (CUDA events), serve_directory over the grids, and the
    widened kernels held against their plain versions on the engine's rows
    (records `*_f96` and `decoder_tail_nf12` added to `kernels`, beside the
    F = 128 / nf 16 ones); 9b, the Matterport3D 16³ super-resolution engine
    (superres16_config, F = 128), FAST_VARIANT against `base`. Every path
    runs through `drive`. Returns (9a's records, 9b's record, the launches
    of the records that `kernels` had before: 9a's kNN and topk, all of
    9b's); 9a's attention and decoder-tail launches are the widened
    records' own."""
    import torch
    import torch.nn.functional as F
    from retrieval_fuse_tpu_torch.inference import (
        FAST_VARIANT, RetrieveRefineEngine, variant_engine_kwargs)
    from retrieval_fuse_tpu_torch.ops import decoder_tail as dt
    from retrieval_fuse_tpu_torch.ops import patch_attention as pa
    from retrieval_fuse_tpu_torch.ops.fused_decoder import depth_to_space_2x
    from retrieval_fuse_tpu_torch.serve import serve_directory
    t9 = time.perf_counter()
    scfg = surface_config()
    k = scfg["K"]
    sdtr = scfg["dataset_train"]
    # with the seeded weights the switch is open on 99.95% of the rows
    # (a CPU reading at batch 2 on a 1,000-row bank); phi negated, on 0.1%
    s_params = flagship_params(scfg, seed, negate_phi=False)
    s_db, s_bank = flagship_data(scfg, rng, SEED_BANK_ROWS, dev)
    with tempfile.TemporaryDirectory() as tmp:
        grids = surface_inputs(Path(tmp), SURFACE_CHUNKS, seed, sdtr["input_chunk_size"])
        s_engines = {}
        for dtype, tag in ((torch.bfloat16, "bf16"), (torch.float32, "f32")):
            base_ = RetrieveRefineEngine(scfg, s_params, s_db, s_bank, compute_dtype=dtype,
                                         device=dev)
            s_engines["base", tag] = base_
            for variant in SURFACE_VARIANTS:
                s_engines[variant, tag] = RetrieveRefineEngine(
                    scfg, s_params, s_db, compute_dtype=dtype, device=dev,
                    feature_bank=base_.feature_bank, **variant_engine_kwargs(variant))
        del s_bank
        s_fast = s_engines[FAST_VARIANT, "bf16"]
        tcs = sdtr["target_chunk_size"]
        log(f"9a surface reconstruction: {len(grids)} {grids.shape[1]}³ occupancy grids of "
            f"{sdtr['num_points']} points ({float(grids.sum(axis=(1, 2, 3)).mean()):.1f} "
            f"voxels occupied on average), {len(s_engines)} engines, feature bank "
            f"{tuple(s_fast.feature_bank.shape)} ({time.perf_counter() - t9:.1f} s)")
        launches9 = {name: 0 for name in counters}
        surface = {}
        trunc9 = s_fast.target_trunc
        for batch in SURFACE_BATCHES:
            xb = grids[:batch, ..., None]
            base9 = {tag: s_engines["base", tag](xb) for tag in ("bf16", "f32")}
            for tag, o in base9.items():
                check(o.shape == (batch, tcs, tcs, tcs, 1) and torch.isfinite(o).all().item()
                      and float(o.min()) >= -1e-3 and float(o.max()) <= trunc9 + 1e-3,
                      f"surface base {tag} batch {batch}: TSDF out of shape or range")
            for variant in ("base", *SURFACE_VARIANTS):
                needed = surface_kernels(variant, batch)
                got, counts = drive(f"surface {variant} batch {batch}", needed,
                                    lambda: {tag: s_engines[variant, tag](xb)
                                             for tag in ("bf16", "f32")}, launches9)
                rec = {f"mae_vs_base_{tag}": float((got[tag] - base9[tag]).abs().mean())
                       for tag in ("bf16", "f32")}
                check(rec["mae_vs_base_bf16"] < 1e-3,
                      f"surface {variant} batch {batch}: bf16 MAE vs bf16 base "
                      f"{rec['mae_vs_base_bf16']} >= 1e-3")
                check(rec["mae_vs_base_f32"] < 1e-5,
                      f"surface {variant} batch {batch}: f32 MAE vs f32 base "
                      f"{rec['mae_vs_base_f32']} >= 1e-5")
                rec["mae_bf16_vs_f32"] = float((got["bf16"] - base9["f32"]).abs().mean())
                for tag in ("bf16", "f32"):
                    eng = s_engines[variant, tag]
                    rec[f"engine_ms_{tag}"] = cuda_ms(lambda: eng(xb), 2)
                    rec[f"chunks_per_s_{tag}"] = batch / (rec[f"engine_ms_{tag}"] / 1e3)
                rec["launches"] = counts
                surface[f"{variant}@{batch}"] = rec
                log(f"  surface {variant} batch {batch}: engine bf16 "
                    f"{rec['engine_ms_bf16']:.2f} ms = {rec['chunks_per_s_bf16']:.1f} "
                    f"chunks/s, f32 {rec['engine_ms_f32']:.2f} ms; TSDF MAE vs base bf16 "
                    f"{rec['mae_vs_base_bf16']:.2e} (< 1e-3), f32 {rec['mae_vs_base_f32']:.2e} "
                    f"(< 1e-5), bf16 vs f32 base {rec['mae_bf16_vs_f32']:.2e}; launches "
                    f"{counts} [{card}]")
            del base9
        busy, wall = device_busy(lambda: s_fast(grids[:SURFACE_BATCHES[-1], ..., None]))
        surface["idle_share_fast_bf16"] = 1 - busy / wall
        log(f"  surface {FAST_VARIANT} bf16 batch {SURFACE_BATCHES[-1]}: {busy:.2f} ms of "
            f"kernels in {wall:.2f} ms, idle {1 - busy / wall:.1%}")
        # serve_directory over the grids, FAST_VARIANT bf16
        indir, outdir = Path(tmp) / "in9", Path(tmp) / "out9"
        indir.mkdir()
        for j, vol in enumerate(grids):
            np.savez_compressed(indir / f"grid{j:04d}.npz", arr=vol)
        batch = SURFACE_BATCHES[0]
        t0 = time.perf_counter()
        done, counts = drive(f"surface serve {FAST_VARIANT} batch {batch}",
                             ("knn_bf16", "attention"),
                             lambda: serve_directory(s_fast, indir, outdir, batch_size=batch),
                             launches9)
        wall = time.perf_counter() - t0
        check(len(done) == len(grids), f"surface serve: {len(done)} of {len(grids)} grids")
        served = np.stack([np.load(outdir / f"{n_}_pred.npz")["arr"] for n_ in done[:batch]])
        want = s_fast(grids[:batch, ..., None])[..., 0].cpu().numpy()
        served_err = float(np.abs(served.astype(np.float32) - want).mean())
        check(served_err <= 1e-4, f"surface serve: files differ by {served_err}")
        surface["served_chunks_per_s"] = len(done) / wall
        log(f"  surface serve {FAST_VARIANT} batch {batch}: {len(done)} grids, "
            f"{len(done) / wall:.1f} chunks/s through serve_directory; launches {counts}")

        # the widened kernels against their plain versions, on the engine's
        # rows at the larger batch: F = 96, soft selection as served
        batch = SURFACE_BATCHES[-1]
        with torch.inference_mode():
            xb = torch.from_numpy(grids[:batch, ..., None]).to(dev)
            top_idx = s_fast.retrieve(xb)
            x_back = s_fast.unet_backbone(((xb - s_fast.in_mean) / s_fast.in_std).bfloat16())
            xt16 = s_fast._tile_major_rows(x_back).contiguous()
        att = s_fast.attention.attention_blocks_layer
        q, t_rows, f = xt16.shape
        check(f == 96, f"surface: attention rows of F = {f}")
        theta32, phi32 = [copy.deepcopy(m).float() for m in (att.theta, att.phi)]
        pa.freeze_operands(theta32, phi32)  # timed below: packed once
        xt32, bank32, bank16 = xt16.float(), s_fast.feature_bank.float(), s_fast.feature_bank
        bound96 = attention_bound(q, t_rows, k, f)
        n_rows = q * t_rows
        p16 = bank16[top_idx.long()].transpose(1, 2).reshape(n_rows, k, f).contiguous()
        x16 = xt16.reshape(n_rows, f)
        with torch.inference_mode():
            for key, name, fn, plain, a32, a16 in (
                    ("attention_f96", "gathered_patch_attention", pa.gathered_patch_attention,
                     pa.gathered_patch_attention_plain,
                     (xt32, bank32, top_idx, theta32, phi32, k),
                     (xt16, bank16, top_idx, att.theta, att.phi, k)),
                    ("attention_v1_f96", "gathered_patch_attention_v1",
                     pa.gathered_patch_attention_v1, pa.gathered_patch_attention_v1_plain,
                     (xt32, bank32, top_idx, theta32, phi32, k),
                     (xt16, bank16, top_idx, att.theta, att.phi, k)),
                    ("patch_attention_f96", "patch_attention", pa.patch_attention,
                     pa.patch_attention_plain,
                     (x16.float(), p16.float(), theta32, phi32, k),
                     (x16, p16, att.theta, att.phi, k))):
                old = kernels[key.removesuffix("_f96")]
                math16 = pa.kernel_math(Path(old["source"]).stem, torch.bfloat16)
                err, share16, switch_open = hold_attention(f"{name} F=96 Q={q}", fn, plain,
                                                           a32, a16, math16)
                check(switch_open >= 0.5, f"{name} F=96: the switch is open on only "
                                          f"{switch_open:.1%} of the rows")
                kernels[key] = dict(
                    name=f"{name}@F96", route="cuda", math=math16,
                    source=old["source"], replaces=old["replaces"], max_abs_err=err,
                    ms=cuda_ms(lambda: fn(*a16, False), 5),
                    plain_ms=cuda_ms(lambda: plain(*a16, False), 2), library_ms=None,
                    bound_ms=bound96[0], bound_by=bound96[1],
                    f32_ms=cuda_ms(lambda: fn(*a32, False), 2), bf16_agreement=share16,
                    f128_ms=old["ms"],
                    shape=f"{'N=' + str(n_rows) if key.startswith('patch') else 'Q=' + str(q)}"
                          f" T={t_rows} F={f} K={k} bf16 softmax")
            del xt32, bank32, p16, x16
            cdec9 = {tag: s_engines[FAST_VARIANT + "+cdec", tag].fused_decoder
                     for tag in ("bf16", "f32")}
            hn9 = {}
            for tag in ("bf16", "f32"):
                eng = s_engines[FAST_VARIANT, tag]
                xe = ((xb - eng.in_mean) / eng.in_std).to(eng.compute_dtype)
                hn9[tag] = cdec9[tag].tail_input(
                    eng._attend(eng.unet_backbone(xe), eng.retrieve(xb), batch))
            errs = {}
            for tag, tol in (("f32", 1e-4), ("bf16", 1e-2)):
                d = cdec9[tag]
                got = dt.decoder_tail(hn9[tag], d.w2_dhwio, d.w_final, d.bias_h)
                math = {"f32": "fma.f32", "bf16": "mma.bf16"}[tag]
                check(dt.decoder_tail.math == math,
                      f"decoder tail nf 12 {tag}: launch took {dt.decoder_tail.math}")
                want = dt.decoder_tail_plain(hn9[tag], d.w2_dhwio, d.w_final, d.bias_h)
                errs[tag] = float((got - want).abs().max())
                check(errs[tag] <= tol, f"decoder tail nf 12 {tag}: max |diff| {errs[tag]}")
                log(f"decoder tail nf 12 {tag} [{math}] B={batch}: max |diff| "
                    f"{errs[tag]:.2e}")
            d, h16 = cdec9["bf16"], hn9["bf16"]
            nf9, s2 = scfg["nf"], 2 * (h16.shape[1] - 2)
            h2x = depth_to_space_2x(h16[:, 1:-1, 1:-1, 1:-1], nf9).permute(0, 4, 1, 2, 3) \
                .contiguous()
            dargs = (h16, d.w2_dhwio, d.w_final, d.bias_h)
            tail96 = decoder_tail_bound(h16, nf9)
            old = kernels["decoder_tail"]
            kernels["decoder_tail_nf12"] = dict(
                name="decoder_tail@nf12", route="cuda", math="mma.bf16",
                source=old["source"], replaces=old["replaces"], max_abs_err=errs["f32"],
                ms=cuda_ms(lambda: dt.decoder_tail(*dargs), 5),
                plain_ms=cuda_ms(lambda: dt.decoder_tail_plain(*dargs), 2),
                library_ms=cuda_ms(lambda: F.conv3d(h2x, d.w2, padding=1), 5),
                library_call="F.conv3d of conv2 alone on the unpacked tensor (cuDNN)",
                bound_ms=tail96[0], bound_by=tail96[1], bf16_max_abs_err=errs["bf16"],
                f32_ms=cuda_ms(lambda: dt.decoder_tail(
                    hn9["f32"], cdec9["f32"].w2_dhwio, cdec9["f32"].w_final,
                    cdec9["f32"].bias_h), 2),
                nf16_ms=old["ms"], shape=f"B={batch} S={s2 // 2} nf={nf9} bf16")
            del hn9, h2x, xb, x_back, xt16
    for key, name in (("attention_f96", "attention"), ("attention_v1_f96", "attention_v1"),
                      ("patch_attention_f96", "patch_attention"),
                      ("decoder_tail_nf12", "decoder_tail")):
        kr = kernels[key]
        kr["launches"] = launches9[name]
        log(f"{kr['name']} [{kr['math']}]: kernel {kr['ms']:.3f} ms (at F = 128 / nf 16: "
            f"{kr.get('f128_ms', kr.get('nf16_ms')):.3f} ms), plain {kr['plain_ms']:.3f} ms, "
            f"library {'none' if kr['library_ms'] is None else f'{kr['library_ms']:.3f} ms'}, "
            f"bound {kr['bound_ms']:.3f} ms ({kr['bound_by']}), float32 {kr['f32_ms']:.3f} "
            f"ms; {kr['launches']} launches in 9a [{kr['shape']}; {card}]")
    del s_engines, s_fast

    # 9b) 16³ super-resolution (Matterport3D), FAST_VARIANT against base
    mcfg = superres16_config()
    mdtr = mcfg["dataset_train"]
    m_params = flagship_params(mcfg, seed, negate_phi=False)  # switch open on 92% (37%)
    m_db, m_bank = flagship_data(mcfg, rng, SEED_BANK_ROWS, dev)
    m_engines = {}
    for dtype, tag in ((torch.bfloat16, "bf16"), (torch.float32, "f32")):
        m_engines["base", tag] = RetrieveRefineEngine(mcfg, m_params, m_db, m_bank,
                                                      compute_dtype=dtype, device=dev)
        m_engines[FAST_VARIANT, tag] = RetrieveRefineEngine(
            mcfg, m_params, m_db, compute_dtype=dtype, device=dev,
            feature_bank=m_engines["base", tag].feature_bank,
            **variant_engine_kwargs(FAST_VARIANT))
    del m_bank
    batch = SUPERRES16_BATCH
    xb = synthetic_df(rng, batch, 16, mdtr["voxel_size_input"], dev).cpu().numpy()[..., None]
    base16 = {tag: m_engines["base", tag](xb) for tag in ("bf16", "f32")}
    launches9b = {name: 0 for name in counters}
    got, counts = drive(f"superres16 {FAST_VARIANT} batch {batch}", ("knn_bf16", "attention"),
                        lambda: {tag: m_engines[FAST_VARIANT, tag](xb)
                                 for tag in ("bf16", "f32")}, launches9b)
    trunc16 = m_engines["base", "bf16"].target_trunc
    rec = {f"mae_vs_base_{tag}": float((got[tag] - base16[tag]).abs().mean())
           for tag in ("bf16", "f32")}
    for tag, o in got.items():
        check(o.shape == (batch, 64, 64, 64, 1) and torch.isfinite(o).all().item(),
              f"superres16 {tag}: TSDF not finite or of shape {tuple(o.shape)}")
    # the budgets in df units at the flagship's truncation (0.0625),
    # scaled to this config's (11.25)
    flagship_trunc = float(np.float16(flagship_config()["dataset_train"]["voxel_size_target"] * 3))
    scale16 = trunc16 / flagship_trunc
    check(rec["mae_vs_base_bf16"] < 1e-3 * scale16,
          f"superres16: bf16 MAE vs bf16 base {rec['mae_vs_base_bf16']} >= {1e-3 * scale16}")
    check(rec["mae_vs_base_f32"] < 1e-5 * scale16,
          f"superres16: f32 MAE vs f32 base {rec['mae_vs_base_f32']} >= {1e-5 * scale16}")
    eng = m_engines[FAST_VARIANT, "bf16"]
    rec.update(engine_ms_bf16=cuda_ms(lambda: eng(xb), 3), launches=counts,
               truncation=trunc16)
    rec["chunks_per_s_bf16"] = batch / (rec["engine_ms_bf16"] / 1e3)
    log(f"9b superres16 {FAST_VARIANT} batch {batch}: engine bf16 {rec['engine_ms_bf16']:.2f} "
        f"ms = {rec['chunks_per_s_bf16']:.1f} chunks/s; TSDF MAE vs base bf16 "
        f"{rec['mae_vs_base_bf16']:.2e} (< {1e-3 * scale16:.2e}), f32 "
        f"{rec['mae_vs_base_f32']:.2e} (< {1e-5 * scale16:.2e}) of a {trunc16} truncation; "
        f"launches {counts} [{card}]")
    del m_engines, base16, got
    return surface, rec, {name: launches9b[name] + (launches9[name] if name in (
        "topk", "knn", "knn_bf16", "chamfer") else 0) for name in counters}



@contextlib.contextmanager
def timed_attrs(module, names, into: dict):
    """Within the block, each function `names` of `module` adds its seconds
    to into[name] (the module attribute is swapped, so callers that look
    it up at call time are timed; calls on several threads add up their
    seconds)."""
    import threading
    saved = {name: getattr(module, name) for name in names}
    lock = threading.Lock()

    def timed(name, fn):
        def call(*a, **kw):
            t0 = time.perf_counter()
            try:
                return fn(*a, **kw)
            finally:
                with lock:
                    into[name] = into.get(name, 0.0) + time.perf_counter() - t0
        return call

    for name, fn in saved.items():
        setattr(module, name, timed(name, fn))
    try:
        yield into
    finally:
        for name, fn in saved.items():
            setattr(module, name, fn)


def run_phase10(root: Path, dev, scfg: dict, scfg_path: Path, ckpt, fckpt, val_names: list,
                rcfg: dict, maps: dict, datasets: dict, compose: dict, drive, card: str) -> dict:
    """Phase 10, meshes, on phase 7's artifacts in its working directory
    `root` (10c runs inside 7a and 7d):
      10a serving with meshes: the 64 val chunks, renamed as 2 x 2 x 2 chunks
          of 8 scenes (<scene>__<x>_<y>_<z>), through serve_directory with
          and without write_obj on one FAST_VARIANT bf16 engine from the
          artifacts (chunks/s, and the seconds in marching cubes and in OBJ
          writing), then through serve.main --obj, each OBJ held equal to
          native marching cubes + export_obj of the float32 prediction it was
          made from (recorded at the SceneHandler) and every chunk whose
          prediction crosses the level held non-empty;
      10b mesh metrics: the served chunk meshes and the ground-truth meshes
          (visualize_target_chunk of the targets) recomposed into scene
          meshes by `evaluation.cli recompose`, `evaluation.cli metrics` over
          METRIC_SCENES scenes: the ground truth against itself gives IoU 1,
          Chamfer-L1 0, normal correctness 1 and F-scores 1, the served
          meshes finite values in range; seconds per scene;
      10d compose with the C++ paste: COMPOSE_HOLD_SCENES scenes of 7b's
          compose equal the numpy paste's volumes exactly; compose's seconds
          and the paste's share of them (`compose`: 7b's readings).
    Returns the readings."""
    import torch
    from retrieval_fuse_tpu_torch import native, serve
    from retrieval_fuse_tpu_torch.data import SceneHandler
    from retrieval_fuse_tpu_torch.evaluation import cli as eval_cli
    from retrieval_fuse_tpu_torch.inference import FAST_VARIANT
    from retrieval_fuse_tpu_torch.retrieval.engine import create_retrieval_from_mapping
    from retrieval_fuse_tpu_torch.utils.misc import get_retrievals_dir
    t10 = time.perf_counter()
    out = {}
    # 10a) the val chunks as chunks of scenes, served with meshes
    per_scene = MESH_SCENE_SIDE ** 3
    sources = {}
    vin = root / "serve_in_meshes"
    vin.mkdir()
    for j in range(len(val_names) // per_scene):
        for c in range(per_scene):
            x, y, z = (64 * ((c >> b) & 1) for b in (2, 1, 0))
            name = f"synth__s{j:02d}__{x}_{y}_{z}"
            sources[name] = val_names[j * per_scene + c]
            (vin / f"{name}.npz").symlink_to(
                root / "data" / "sdf_008" / "SynthSet" / f"{sources[name]}.npz")
    names = sorted(sources)
    handler = SceneHandler("val", scfg)
    level = float(handler.target_voxel_size * 0.75)
    eng = serve.build_engine_from_artifacts(scfg, ckpt, fckpt, compute_dtype=torch.bfloat16,
                                            device=dev, variant=FAST_VARIANT)
    batch = len(names)
    eng(np.stack([np.load(vin / f"{n}.npz")["arr"] for n in names])[..., None]
        .astype(np.float32))  # warm-up: cuDNN plans, allocator
    serving = {}
    for label, kw in (("npz", {}), ("npz+obj", dict(write_obj=True, scene_handler=handler))):
        spent = {}
        with timed_attrs(native, ("marching_cubes", "export_obj"), spent):
            t0 = time.perf_counter()
            done, counts = drive(f"serve_directory {label}", ("knn_bf16", "attention"),
                                 lambda: serve.serve_directory(eng, vin, root / f"served_{label}",
                                                               batch_size=batch, **kw))
            wall = time.perf_counter() - t0
        check(done == names, f"serve_directory {label}: served {len(done)} of {len(names)}")
        serving[label] = dict(wall_s=wall, chunks_per_s=len(done) / wall, launches=counts,
                              mc_s=spent.get("marching_cubes", 0.0),
                              obj_s=spent.get("export_obj", 0.0))
    rec = serving["npz+obj"]
    rec["mesh_share"] = (rec["mc_s"] + rec["obj_s"]) / rec["wall_s"]
    log(f"serve with meshes (serve_directory, {FAST_VARIANT} bf16, batch {batch}): "
        f"{serving['npz']['chunks_per_s']:.1f} chunks/s without meshes, "
        f"{rec['chunks_per_s']:.1f} with (marching cubes {rec['mc_s']:.2f} s + OBJ writing "
        f"{rec['obj_s']:.2f} s = {rec['mesh_share']:.1%} of {rec['wall_s']:.2f} s); launches "
        f"{rec['launches']} [{card}]")
    del eng
    meshed, visualize = {}, SceneHandler.visualize_target_chunk

    def recording(self, chunk_df, output_path, device=None):
        meshed[Path(output_path).name] = np.array(chunk_df, copy=True)
        return visualize(self, chunk_df, output_path, device=device)

    argv = ["--config", str(scfg_path), "--retrieval_ckpt", str(ckpt), "--refinement_ckpt",
            str(fckpt), "--input", str(vin), "--output", str(root / "cli_obj"), "--batch_size",
            str(batch), "--fast", "--obj"]
    SceneHandler.visualize_target_chunk = recording
    try:
        t0 = time.perf_counter()
        done, counts = drive("serve CLI --obj", ("knn_bf16", "attention"),
                             lambda: serve.main(argv))
        serving["cli_obj"] = dict(wall_s=time.perf_counter() - t0, launches=counts)
    finally:
        SceneHandler.visualize_target_chunk = visualize
    check(done == names and sorted(meshed) == [f"{n}_pred.obj" for n in names],
          f"serve CLI --obj: {len(done)} chunks, {len(meshed)} meshes")
    crossing = faces = 0
    for n in names:
        vol = meshed[f"{n}_pred.obj"]
        check(vol.dtype == np.float32 and vol.shape == (64, 64, 64)
              and np.array_equal(vol.astype(np.float16),
                                 np.load(root / "cli_obj" / f"{n}_pred.npz")["arr"]),
              f"serve CLI --obj {n}: the meshed prediction is not the served one")
        v, t = native.marching_cubes(vol, level)
        native.export_obj(v, t, root / "want.obj")
        check((root / "cli_obj" / f"{n}_pred.obj").read_text() == (root / "want.obj").read_text(),
              f"serve CLI --obj {n}: the OBJ is not marching cubes of its prediction")
        if vol.min() < level < vol.max():
            crossing += 1
            check(len(t) > 0, f"serve CLI --obj {n}: the prediction crosses the level, no mesh")
        faces += len(t)
    check(crossing > 0, "serve CLI --obj: no prediction crosses the level")
    serving["cli_obj"].update(crossing=crossing, faces=faces)
    log(f"serve CLI (serve.main --fast --obj): {len(names)} chunks in "
        f"{serving['cli_obj']['wall_s']:.1f} s wall (engine build included); every OBJ equals "
        f"marching cubes + export_obj of its float32 prediction at level {level:.6f}; "
        f"{crossing} predictions cross the level, all meshed ({faces} triangles); launches "
        f"{counts} [{card}]")
    out["serving"] = serving

    # 10b) recomposed scene meshes and the mesh metrics
    gt_chunks = root / "gt_chunks"
    gt_chunks.mkdir()
    ds_val = datasets["val"]
    for n in names:
        handler.visualize_target_chunk(ds_val.get_scene_target(sources[n]).astype(np.float32),
                                       gt_chunks / f"{n}_gt.obj", device=dev)
    meshes = root / "meshes"
    t0 = time.perf_counter()
    eval_cli.main(["recompose", "--base_path", str(root / "cli_obj"), "--suffix", "_pred.obj",
                   "--output_path", str(meshes / "ours")])
    eval_cli.main(["recompose", "--base_path", str(gt_chunks), "--suffix", "_gt.obj",
                   "--output_path", str(meshes / "gt")])
    recompose_s = time.perf_counter() - t0
    scenes = sorted(p.stem for p in (meshes / "gt").iterdir())
    served = sorted(p.stem for p in (meshes / "ours").iterdir())
    # a scene none of whose served chunks crosses the level has no mesh
    check(scenes == sorted({n.rsplit("__", 1)[0] for n in names}) and served
          and set(served) <= set(scenes), f"recompose: scene meshes {scenes}, served {served}")
    self_dir = root / "meshes_self"
    (self_dir / "ours").mkdir(parents=True)
    (self_dir / "gt").symlink_to(meshes / "gt")
    for sc in scenes:
        (self_dir / "ours" / f"{sc}.obj").symlink_to(meshes / "gt" / f"{sc}.obj")
    metrics, buf = {}, io.StringIO()
    for label, pred_dir in (("served", meshes / "ours"), ("gt_vs_gt", self_dir / "ours")):
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(buf):
            rows = eval_cli.main(["metrics", "--pred_dir", str(pred_dir), "--dataset", "SynthSet",
                                  "--task", "superresolution", "--method", label, "--limit",
                                  str(METRIC_SCENES)])
        dt_ = time.perf_counter() - t0
        want = min(METRIC_SCENES, len(served if label == "served" else scenes))
        check(rows is not None and len(rows) == want,
              f"metrics {label}: {rows} (the sweep skips a scene that raises: {buf.getvalue()})")
        metrics[label] = dict(rows=rows, s_per_scene=dt_ / len(rows))
    for row in metrics["gt_vs_gt"]["rows"]:
        iou, cd, nc, f9, f14 = row[1:6]
        check(iou == 1.0 and cd == 0.0 and abs(nc - 1.0) <= 1e-12 and f9 == 1.0 and f14 == 1.0,
              f"metrics of the ground truth against itself: {row}")
    for row in metrics["served"]["rows"]:
        iou, cd, nc, f9, f14 = row[1:6]
        check(0 <= iou <= 1 and np.isfinite(cd) and cd >= 0 and 0 <= nc <= 1 + 1e-12
              and 0 <= f9 <= 1 and 0 <= f14 <= 1, f"metrics of the served meshes: {row}")
    out["metrics"] = dict(metrics, recompose_s=recompose_s, scenes=len(scenes),
                          served_scenes=len(served))
    log(f"mesh metrics (evaluation.cli): {len(scenes)} ground-truth and {len(served)} served "
        f"scene meshes recomposed from {len(names)} chunk meshes each in {recompose_s:.1f} s; "
        f"ground truth against itself "
        f"[iou, chamfer-L1, normal correctness, F@t9, F@t14] = "
        f"{[float(v) for v in metrics['gt_vs_gt']['rows'][0][1:6]]}; served: "
        f"{[[round(float(v), 4) for v in r[1:6]] for r in metrics['served']['rows']]}; "
        f"{metrics['served']['s_per_scene']:.2f} s a scene, against itself "
        f"{metrics['gt_vs_gt']['s_per_scene']:.2f} s (host) [{card}]")

    # 10d) compose with the C++ paste against the numpy paste
    k = rcfg["K"]
    rdir = get_retrievals_dir(rcfg)
    held, numpy_s, native_s = 0, 0.0, 0.0
    for split in ("train", "val"):
        ds = datasets[split]
        for scene in ds.scenes[:COMPOSE_HOLD_SCENES // 2]:
            saved = np.load(rdir / "compose" / f"{scene}.npz")["arr_0"]
            t0 = time.perf_counter()
            want = create_retrieval_from_mapping(scene, maps[split], k, datasets["train"], ds,
                                                 compose["tree"])
            numpy_s += time.perf_counter() - t0
            t0 = time.perf_counter()
            got = create_retrieval_from_mapping(scene, maps[split], k, datasets["train"], ds,
                                                compose["tree"], use_native=True)
            native_s += time.perf_counter() - t0
            check(np.array_equal(saved, want) and np.array_equal(got, want),
                  f"compose {scene}: the C++ paste's volume differs from the numpy paste's")
            held += 1
    out["compose"] = dict(compose, held=held, numpy_s=numpy_s, native_s=native_s,
                          paste_share=compose["paste_s"] / compose["compose_s"])
    log(f"compose (retrieval CLI, C++ paste): {compose['compose_s']:.1f} s for "
        f"{compose['scenes']} scenes, the paste {compose['paste_s']:.2f} s of it "
        f"({out['compose']['paste_share']:.1%}); {held} scenes equal the numpy paste's "
        f"volumes exactly (numpy {numpy_s:.2f} s, C++ {native_s:.2f} s for them, crops "
        f"included) [{card}]")
    out["phase_s"] = time.perf_counter() - t10
    log(f"phase 10 (meshes): {out['phase_s']:.1f} s")
    return out


def run_narrow_widths(dev, rng, seed: int, kernels: dict, counters: dict, drive, card: str,
                      chunks: np.ndarray) -> dict:
    """Phase 4g, the attention kernels at the widths the decoder tail takes
    besides 12 and 16: the flagship geometry at nf 4 and 8 (F = 32, 64; hard
    selection, K 4, a seeded bank of SEED_BANK_ROWS rows). For each nf:
    `base` and the three attention kernels' paths (NARROW_VARIANTS) at
    STREAM_BATCH in bf16 and float32, each through `drive` (its kernel, and
    the decoder tail for cdec, must launch) and held against `base` (TSDF
    MAE < 1e-3 and < 1e-5); then each kernel against its plain version on
    the FAST_VARIANT engine's rows: float32 with hard and with softmax
    selection, bf16 with both (hold_attention). Adds records
    `<kernel>_f32` / `_f64` to `kernels`, whose launches are this phase's.
    Returns {nf: {variant: TSDF MAEs and ms}}."""
    import torch
    from retrieval_fuse_tpu_torch.inference import RetrieveRefineEngine, variant_engine_kwargs
    from retrieval_fuse_tpu_torch.ops import patch_attention as pa
    out = {}
    xb = chunks[:STREAM_BATCH, ..., None]
    for nf in NARROW_NF:
        cfg = dict(flagship_config(), nf=nf)
        k = cfg["K"]
        params = flagship_params(cfg, seed + nf, negate_phi=NARROW_NEGATE_PHI[nf])
        db, bank = flagship_data(cfg, rng, SEED_BANK_ROWS, dev)
        engines = {}
        for dtype, tag in ((torch.bfloat16, "bf16"), (torch.float32, "f32")):
            base_ = RetrieveRefineEngine(cfg, params, db, bank, compute_dtype=dtype, device=dev)
            engines["base", tag] = base_
            for variant in NARROW_VARIANTS:
                engines[variant, tag] = RetrieveRefineEngine(
                    cfg, params, db, compute_dtype=dtype, device=dev,
                    feature_bank=base_.feature_bank, **variant_engine_kwargs(variant))
        del bank
        with torch.inference_mode():
            want = {tag: engines["base", tag](xb) for tag in ("bf16", "f32")}
        launches, rec = {}, {}
        for variant, key in NARROW_VARIANTS.items():
            needed = (key, "decoder_tail") if variant.endswith("cdec") else (key,)
            launches[variant] = dict.fromkeys(counters, 0)
            got, counts = drive(f"nf {nf} {variant}", needed, lambda: {
                tag: engines[variant, tag](xb) for tag in ("bf16", "f32")},
                into=launches[variant])
            mae = {tag: float((got[tag] - want[tag]).abs().mean()) for tag in got}
            check(all(torch.isfinite(o).all().item() for o in got.values()),
                  f"nf {nf} {variant}: TSDF not finite")
            check(mae["bf16"] < 1e-3 and mae["f32"] < 1e-5,
                  f"nf {nf} {variant}: MAE vs base bf16 {mae['bf16']}, f32 {mae['f32']}")
            eng = engines[variant, "bf16"]
            rec[variant] = dict(mae_vs_base=mae, engine_ms=cuda_ms(lambda: eng(xb), 3),
                                launches=counts)
            log(f"nf {nf} (F = {8 * nf}) {variant} batch {STREAM_BATCH}: TSDF MAE vs base bf16 "
                f"{mae['bf16']:.2e} (< 1e-3), f32 {mae['f32']:.2e} (< 1e-5); engine "
                f"{rec[variant]['engine_ms']:.2f} ms/batch bf16; launches {counts} [{card}]")
        # each kernel against its plain version on the FAST_VARIANT engine's rows
        fast = engines["fused+pallasg2+topk1p", "bf16"]
        with torch.inference_mode():
            x = torch.from_numpy(xb).to(dev)
            top_idx = fast.retrieve(x)
            x_back = fast.unet_backbone(((x - fast.in_mean) / fast.in_std).bfloat16())
            xt16 = fast._tile_major_rows(x_back).contiguous()
        att = fast.attention.attention_blocks_layer
        q, t_rows, f = xt16.shape
        check(f == 8 * nf, f"nf {nf}: attention rows of F = {f}")
        theta32, phi32 = [copy.deepcopy(m).float() for m in (att.theta, att.phi)]
        pa.freeze_operands(theta32, phi32)  # timed below: packed once
        xt32, bank32, bank16 = xt16.float(), fast.feature_bank.float(), fast.feature_bank
        width_bound = attention_bound(q, t_rows, k, f)
        n_rows = q * t_rows
        p16 = bank16[top_idx.long()].transpose(1, 2).reshape(n_rows, k, f).contiguous()
        x16 = xt16.reshape(n_rows, f)
        variant_of = {key: v for v, key in NARROW_VARIANTS.items()}
        with torch.inference_mode():
            for key, name, fn, plain, a32, a16 in (
                    ("attention", "gathered_patch_attention", pa.gathered_patch_attention,
                     pa.gathered_patch_attention_plain,
                     (xt32, bank32, top_idx, theta32, phi32, k),
                     (xt16, bank16, top_idx, att.theta, att.phi, k)),
                    ("attention_v1", "gathered_patch_attention_v1",
                     pa.gathered_patch_attention_v1, pa.gathered_patch_attention_v1_plain,
                     (xt32, bank32, top_idx, theta32, phi32, k),
                     (xt16, bank16, top_idx, att.theta, att.phi, k)),
                    ("patch_attention", "patch_attention", pa.patch_attention,
                     pa.patch_attention_plain,
                     (x16.float(), p16.float(), theta32, phi32, k),
                     (x16, p16, att.theta, att.phi, k))):
                old = kernels[key]
                math16 = pa.kernel_math(Path(old["source"]).stem, torch.bfloat16)
                err, share16, switch_open = hold_attention(
                    f"{name} F={f} Q={q}", fn, plain, a32, a16, math16,
                    f32_modes=(True, False))
                check(switch_open >= 0.5, f"{name} F={f}: the switch is open on only "
                                          f"{switch_open:.1%} of the rows")
                kernels[f"{key}_f{f}"] = dict(
                    name=f"{name}@F{f}", route="cuda", math=math16,
                    source=old["source"], replaces=old["replaces"], max_abs_err=err,
                    launches=launches[variant_of[key]][key],
                    ms=cuda_ms(lambda: fn(*a16), 5), plain_ms=cuda_ms(lambda: plain(*a16), 2),
                    library_ms=None, bound_ms=width_bound[0], bound_by=width_bound[1],
                    f32_ms=cuda_ms(lambda: fn(*a32), 2), bf16_agreement=share16,
                    f128_ms=old["ms"],
                    shape=f"{'N=' + str(n_rows) if key == 'patch_attention' else 'Q=' + str(q)}"
                          f" T={t_rows} F={f} K={k} bf16 hard")
                kr = kernels[f"{key}_f{f}"]
                log(f"{kr['name']} [{math16}]: kernel {kr['ms']:.3f} ms (at F = 128: "
                    f"{kr['f128_ms']:.3f} ms), plain {kr['plain_ms']:.3f} ms, library none, "
                    f"bound {kr['bound_ms']:.3f} ms ({kr['bound_by']}), float32 "
                    f"{kr['f32_ms']:.3f} ms; {kr['launches']} launches in 4g "
                    f"[{kr['shape']}; {card}]")
        del engines, fast, xt32, bank32, bank16, p16, x16, xt16, x_back, want
        out[nf] = rec
    return out


#: phase 4h: the flagship geometry at nf 24 and K 12 (attention rows of
#: F = 8·24 = 192, past what keeps theta and phi whole in a block's shared
#: memory; K past the shipped 8): every attention, decoder-tail and topk
#: launch of its paths runs a general kernel instance. Each path, the batches
#: it is served at, and the kernels it must launch (bf16 and float32 rows
#: together; the streaming kNN kernel is auto-selected at Q >= 1024 in bf16
#: and Q >= 4096 in float32, so from batch 64 in both)
WIDE_NF, WIDE_K = 24, 12
WIDE_PATHS = (("fused+pallasg2+topk1p", (DENSE_BATCH, STREAM_BATCH),
               ("knn_bf16", "knn", "attention")),
              (DENSE_VARIANT, (DENSE_BATCH,), ("topk", "attention")),
              (CDEC_VARIANT, (DENSE_BATCH, STREAM_BATCH),
               ("knn_bf16", "knn", "patch_attention", "decoder_tail")),
              ("fused+pallasg+topk1p", (DENSE_BATCH, STREAM_BATCH),
               ("knn_bf16", "knn", "attention_v1")))
#: the widened attention kernels off the engine, on seeded rows: (F, K, T,
#: queries) of the outer corner (nf 16 at attn_patch_extent 6: F = 16·3³ =
#: 432, K = 32, T = (12/4)³ = 27) and of a narrow unaligned case (rows of 24
#: bytes in bf16, K = 1: candidate 0 is a noisy copy of the query's own tile,
#: so that the switch opens); the decoder tail's other general width; the
#: topk kernel's general k
WIDE_SHAPES = ((432, 32, 27, 1024), (12, 1, 8, 4096))
WIDE_TAIL_NF = 6
WIDE_TOPK_K = (WIDE_K, 32)


def seeded_mlp(f: int, seed: int):
    """An attention MLP (F -> 128 -> 128 -> 128 -> 32) with seeded weights of
    PyTorch's default law, in float32 on the CPU."""
    import torch
    from retrieval_fuse_tpu_torch.models.attention import AttentionFeatureEncoder
    with torch.random.fork_rng(devices=[]):  # the later phases' draws stay as they were
        torch.manual_seed(seed)
        return AttentionFeatureEncoder(f, 32)


def run_wide_widths(dev, rng, seed: int, kernels: dict, counters: dict, drive, card: str,
                    chunks: np.ndarray) -> dict:
    """Phase 4h, the kernels past their shipped shapes. The flagship
    geometry at nf 24, K 12 (WIDE_NF, WIDE_K: a seeded bank of SEED_BANK_ROWS
    rows, seeded weights with phi negated as the flagship's): `base` and
    each of WIDE_PATHS at its batches, bf16 and float32, through `drive`
    (every kernel of the path launched, on its general instance; the plain
    iterative top-k run on no CUDA tensor) and held against `base` (TSDF MAE
    < 1e-3 and < 1e-5). Then each widened kernel against its plain version
    on the card: the three attention kernels on the FAST_VARIANT engine's
    rows (F 192, K 12, T 64) and at WIDE_SHAPES, float32 with hard and with
    softmax selection and bf16 with both (hold_attention; the switch must
    be open on most of the engine's rows); the decoder tail on the cdec
    engine's own input (nf 24) and at nf WIDE_TAIL_NF; the topk kernel at
    WIDE_TOPK_K on the dense path's 4,096 x 27,132 scores (bit-equal, ties
    included). Each is timed beside its plain version, its library call
    where one exists and its bound. Adds the on-path records to `kernels`,
    whose launches are this phase's; returns the paths' and the off-path
    shapes' readings."""
    import torch
    import torch.nn.functional as F
    from retrieval_fuse_tpu_torch import inference
    from retrieval_fuse_tpu_torch.inference import RetrieveRefineEngine, variant_engine_kwargs
    from retrieval_fuse_tpu_torch.ops import decoder_tail as dt
    from retrieval_fuse_tpu_torch.ops import knn as knn_ops
    from retrieval_fuse_tpu_torch.ops import patch_attention as pa
    from retrieval_fuse_tpu_torch.ops.fused_decoder import depth_to_space_2x
    from retrieval_fuse_tpu_torch.ops.topk import topk, topk_plain
    # the retrieval backbone's f_maps follow nf, as in every YAML: its
    # GroupNorms take nf / 2 groups, which must divide its channels
    cfg = dict(flagship_config(), nf=WIDE_NF, K=WIDE_K, retrieval_fmaps=WIDE_NF)
    k, nf, f = WIDE_K, WIDE_NF, 8 * WIDE_NF
    params = flagship_params(cfg, seed + WIDE_NF)
    db, bank = flagship_data(cfg, rng, SEED_BANK_ROWS, dev)
    engines = {}
    for dtype, tag in ((torch.bfloat16, "bf16"), (torch.float32, "f32")):
        base_ = RetrieveRefineEngine(cfg, params, db, bank, compute_dtype=dtype, device=dev)
        engines["base", tag] = base_
        for variant, _, _ in WIDE_PATHS:
            engines[variant, tag] = RetrieveRefineEngine(
                cfg, params, db, compute_dtype=dtype, device=dev,
                feature_bank=base_.feature_bank, **variant_engine_kwargs(variant))
    del bank
    tags = ("bf16", "f32")
    batches = sorted({b for _, bs, _ in WIDE_PATHS for b in bs})
    with torch.inference_mode():
        want = {b: {tag: engines["base", tag](chunks[:b, ..., None]) for tag in tags}
                for b in batches}

    # the plain top-k on a CUDA tensor, counted while a path runs
    plain_topk, plain_on_cuda = knn_ops.iterative_topk, [0]

    def counted_topk(sims, k_):
        plain_on_cuda[0] += int(sims.is_cuda)
        return plain_topk(sims, k_)

    instance_of = {"attention": pa.gathered_patch_attention,
                   "attention_v1": pa.gathered_patch_attention_v1,
                   "patch_attention": pa.patch_attention, "decoder_tail": dt.decoder_tail}
    launches, paths = dict.fromkeys(counters, 0), {}
    for variant, bs, needed in WIDE_PATHS:
        for b in bs:
            xb, label = chunks[:b, ..., None], f"nf {nf} K {k} {variant} batch {b}"
            plain_on_cuda[0] = 0
            knn_ops.iterative_topk = inference.iterative_topk = counted_topk
            try:
                got, counts = drive(label, needed, lambda: {
                    tag: engines[variant, tag](xb) for tag in tags}, into=launches)
            finally:
                knn_ops.iterative_topk = inference.iterative_topk = plain_topk
            check(plain_on_cuda[0] == 0,
                  f"{label}: the plain iterative top-k ran {plain_on_cuda[0]} times on the card")
            for name in needed:
                if name in instance_of:
                    check(instance_of[name].instance == "general",
                          f"{label}: {name} ran its {instance_of[name].instance} instance")
            for tag, o in got.items():
                check(o.shape == (b, 64, 64, 64, 1) and torch.isfinite(o).all().item(),
                      f"{label} {tag}: TSDF not finite or of shape {tuple(o.shape)}")
            mae = {tag: float((got[tag] - want[b][tag]).abs().mean()) for tag in tags}
            check(mae["bf16"] < 1e-3 and mae["f32"] < 1e-5,
                  f"{label}: MAE vs base bf16 {mae['bf16']}, f32 {mae['f32']}")
            eng = engines[variant, "bf16"]
            rec = dict(mae_vs_base=mae, engine_ms=cuda_ms(lambda: eng(xb), 3), launches=counts)
            paths[f"{variant}@{b}"] = rec
            log(f"{label}: TSDF MAE vs base bf16 {mae['bf16']:.2e} (< 1e-3), f32 "
                f"{mae['f32']:.2e} (< 1e-5); engine {rec['engine_ms']:.2f} ms/batch bf16; "
                f"launches {counts}, general instances, no plain top-k on the card [{card}]")

    # each attention kernel against its plain version on the FAST_VARIANT
    # engine's rows at batch 128
    fast = engines["fused+pallasg2+topk1p", "bf16"]
    with torch.inference_mode():
        x = torch.from_numpy(chunks[:STREAM_BATCH, ..., None]).to(dev)
        top_idx = fast.retrieve(x)
        x_back = fast.unet_backbone(((x - fast.in_mean) / fast.in_std).bfloat16())
        xt16 = fast._tile_major_rows(x_back).contiguous()
    att = fast.attention.attention_blocks_layer
    q, t_rows, _ = xt16.shape
    check(xt16.shape[-1] == f, f"nf {nf}: attention rows of F = {xt16.shape[-1]}")
    theta32, phi32 = [copy.deepcopy(m).float() for m in (att.theta, att.phi)]
    cases = [(f"F={f} K={k} T={t_rows} Q={q} (the engine's rows)", "engine",
              xt16, fast.feature_bank, top_idx, att.theta, att.phi, theta32, phi32)]
    for f_, k_, t_, q_ in WIDE_SHAPES:
        g = np.random.default_rng([seed, f_, k_])
        xt_ = torch.from_numpy(g.standard_normal((q_, t_, f_), dtype=np.float32)).to(dev)
        if k_ == 1:  # candidate 0: a noisy copy of the query's own tile
            bank_ = xt_ + 0.5 * torch.from_numpy(
                g.standard_normal((q_, t_, f_), dtype=np.float32)).to(dev)
            idx_ = torch.arange(q_, dtype=torch.int32, device=dev)[:, None]
        else:
            bank_ = torch.from_numpy(g.standard_normal((4 * q_, t_, f_), dtype=np.float32)).to(dev)
            idx_ = torch.from_numpy(g.integers(0, 4 * q_, (q_, k_)).astype(np.int32)).to(dev)
        th, ph = seeded_mlp(f_, seed + 1).to(dev), seeded_mlp(f_, seed + 2).to(dev)
        if k_ == 1:
            ph.load_state_dict(th.state_dict())
        cases.append((f"F={f_} K={k_} T={t_} Q={q_}", f"F{f_}", xt_.bfloat16(), bank_.bfloat16(),
                      idx_, copy.deepcopy(th).bfloat16(), copy.deepcopy(ph).bfloat16(), th, ph))
    shapes = {}
    for label, tag, xt_, bank_, idx_, th16, ph16, th32, ph32 in cases:
        q_, t_, f_ = xt_.shape
        k_ = idx_.shape[1]
        n_ = q_ * t_
        with torch.inference_mode():
            p_ = bank_[idx_.long()].transpose(1, 2).reshape(n_, k_, f_).contiguous()
            x_ = xt_.reshape(n_, f_)
            xt32, bank32 = xt_.float(), bank_.float()
            for key, name, fn, plain, a32, a16 in (
                    ("attention", "gathered_patch_attention", pa.gathered_patch_attention,
                     pa.gathered_patch_attention_plain,
                     (xt32, bank32, idx_, th32, ph32, k_), (xt_, bank_, idx_, th16, ph16, k_)),
                    ("attention_v1", "gathered_patch_attention_v1",
                     pa.gathered_patch_attention_v1, pa.gathered_patch_attention_v1_plain,
                     (xt32, bank32, idx_, th32, ph32, k_), (xt_, bank_, idx_, th16, ph16, k_)),
                    ("patch_attention", "patch_attention", pa.patch_attention,
                     pa.patch_attention_plain,
                     (x_.float(), p_.float(), th32, ph32, k_), (x_, p_, th16, ph16, k_))):
                err, share16, switch_open = hold_attention(
                    f"{name} {label}", fn, plain, a32, a16, "mma.bf16", f32_modes=(True, False))
                check(fn.instance == "general", f"{name} {label}: the {fn.instance} instance")
                if tag == "engine":
                    check(switch_open >= 0.5, f"{name} {label}: the switch is open on only "
                                              f"{switch_open:.1%} of the rows")
                ab = attention_bound(q_, t_, k_, f_)
                old = kernels[key]
                rec = dict(
                    name=f"{name}@F{f_}K{k_}T{t_}", route="cuda", math="mma.bf16",
                    instance="general", source=old["source"], replaces=old["replaces"],
                    max_abs_err=err, ms=cuda_ms(lambda: fn(*a16), 5),
                    plain_ms=cuda_ms(lambda: plain(*a16), 2), library_ms=None, bound_ms=ab[0],
                    bound_by=ab[1], f32_ms=cuda_ms(lambda: fn(*a32), 2),
                    bf16_agreement=share16, switch_open=switch_open,
                    shape=f"{'N=' + str(n_) if key == 'patch_attention' else 'Q=' + str(q_)} "
                          f"T={t_} F={f_} K={k_} bf16 hard")
                if tag == "engine":
                    rec["launches"] = launches[key]
                    kernels[f"{key}_f{f_}"] = rec
                else:
                    shapes[f"{key}_{tag}"] = rec
                log(f"{rec['name']} [mma.bf16, general]: kernel {rec['ms']:.3f} ms, plain "
                    f"{rec['plain_ms']:.3f} ms, library none, bound {rec['bound_ms']:.3f} ms "
                    f"({rec['bound_by']}), float32 {rec['f32_ms']:.3f} ms; switch open on "
                    f"{switch_open:.1%}; launches in 4h "
                    f"{rec.get('launches', 0) if tag == 'engine' else 'none (off the path)'} "
                    f"[{rec['shape']}; {card}]")
            del p_, x_, xt32, bank32
    del cases, xt16, x_back

    # the decoder tail: on the cdec engines' own input (nf 24, batch 128) and
    # at nf WIDE_TAIL_NF on seeded rows
    cdec = {tag: engines[CDEC_VARIANT, tag].fused_decoder for tag in tags}
    with torch.inference_mode():
        hn = {}
        for tag in tags:
            eng = engines["fused+pallasg2+topk1p", tag]
            xb = ((x - eng.in_mean) / eng.in_std).to(eng.compute_dtype)
            hn[tag] = cdec[tag].tail_input(
                eng._attend(eng.unet_backbone(xb), eng.retrieve(x), STREAM_BATCH))
        g = np.random.default_rng([seed, WIDE_TAIL_NF])
        s_ = hn["bf16"].shape[1] - 2
        h6 = torch.zeros((STREAM_BATCH, s_ + 2, s_ + 2, s_ + 2, 8 * WIDE_TAIL_NF), device=dev)
        h6[:, 1:-1, 1:-1, 1:-1] = torch.from_numpy(g.standard_normal(
            (STREAM_BATCH, s_, s_, s_, 8 * WIDE_TAIL_NF), dtype=np.float32)).to(dev)
        w6 = torch.from_numpy(g.standard_normal((3, 3, 3, WIDE_TAIL_NF, WIDE_TAIL_NF),
                                                dtype=np.float32) / np.sqrt(27 * WIDE_TAIL_NF))
        wh6 = torch.from_numpy(g.standard_normal(WIDE_TAIL_NF, dtype=np.float32)
                               / np.sqrt(WIDE_TAIL_NF))
        tails = [("engine", nf, {tag: (hn[tag], cdec[tag].w2_dhwio, cdec[tag].w_final,
                                       cdec[tag].bias_h) for tag in tags}),
                 (f"nf{WIDE_TAIL_NF}", WIDE_TAIL_NF,
                  {tag: (h6.to(dt_), w6.to(dev, dt_), wh6.to(dev, dt_), 0.2) for tag, dt_ in
                   (("bf16", torch.bfloat16), ("f32", torch.float32))})]
        del hn, h6
        for tag, nf_, args in tails:
            errs = {}
            for dtag in ("f32", "bf16"):
                got = dt.decoder_tail(*args[dtag])
                math = dt.kernel_math(args[dtag][0].dtype, nf_, args[dtag][0].shape[1] - 2)
                check(dt.decoder_tail.instance == "general" and dt.decoder_tail.math == math
                      and (dtag == "f32" or math == "mma.bf16"),
                      f"decoder tail nf {nf_} {dtag}: the {dt.decoder_tail.instance} instance, "
                      f"{dt.decoder_tail.math}")
                want_ = dt.decoder_tail_plain(*args[dtag])
                torch.cuda.synchronize()
                diff = (got - want_).abs()
                errs[dtag] = float(diff.max())
                check(errs[dtag] <= (1e-4 if dtag == "f32" else 1e-2),
                      f"decoder tail nf {nf_} {dtag}: max |diff| {errs[dtag]}")
                log(f"decoder tail nf {nf_} {dtag} [{math}, general] B={got.shape[0]} "
                    f"S={got.shape[1]}: max |diff| {errs[dtag]:.2e}, mean {float(diff.mean()):.2e}")
                del got, want_
            h16, w2, wh, bias = args["bf16"]
            s2 = 2 * (h16.shape[1] - 2)
            h2x = depth_to_space_2x(h16[:, 1:-1, 1:-1, 1:-1], nf_).permute(0, 4, 1, 2, 3) \
                .contiguous()
            w_oi = w2.permute(4, 3, 0, 1, 2).contiguous()  # DHWIO -> (out, in, D, H, W)
            tb = decoder_tail_bound(h16, nf_)
            rec = dict(
                name=f"decoder_tail@nf{nf_}", route="cuda", math="mma.bf16", instance="general",
                source=kernels["decoder_tail"]["source"],
                replaces=kernels["decoder_tail"]["replaces"], max_abs_err=errs["f32"],
                bf16_max_abs_err=errs["bf16"],
                ms=cuda_ms(lambda: dt.decoder_tail(*args["bf16"]), 3),
                plain_ms=cuda_ms(lambda: dt.decoder_tail_plain(*args["bf16"]), 2),
                library_ms=cuda_ms(lambda: F.conv3d(h2x, w_oi, padding=1), 5),
                library_call="F.conv3d of conv2 alone on the unpacked tensor (cuDNN)",
                bound_ms=tb[0], bound_by=tb[1],
                f32_ms=cuda_ms(lambda: dt.decoder_tail(*args["f32"]), 2),
                shape=f"B={h16.shape[0]} S={s2 // 2} nf={nf_} bf16")
            if tag == "engine":
                rec["launches"] = launches["decoder_tail"]
                kernels[f"decoder_tail_nf{nf_}"] = rec
            else:
                shapes[f"decoder_tail_{tag}"] = rec
            log(f"{rec['name']} [mma.bf16, general]: kernel {rec['ms']:.3f} ms, plain "
                f"{rec['plain_ms']:.3f} ms, library {rec['library_ms']:.3f} ms (cuDNN conv2 "
                f"alone), bound {rec['bound_ms']:.3f} ms ({rec['bound_by']}), float32 "
                f"{rec['f32_ms']:.3f} ms [{rec['shape']}; {card}]")
            del h2x, args
        del tails

    # the topk kernel at WIDE_TOPK_K on the dense path's scores (batch 64)
    with torch.inference_mode():
        x64 = torch.from_numpy(chunks[:DENSE_BATCH, ..., None]).to(dev)
        sims = fast.embed_queries(x64).float() @ fast._database_f32.T
    qs, ns = sims.shape
    for k_ in WIDE_TOPK_K:
        worst = 0.0
        for label, s_ in (("scores", sims), ("bf16-tied scores", sims.bfloat16().float())):
            v, i = topk(s_, k_)
            pv, pi = topk_plain(s_, k_)
            torch.cuda.synchronize()
            check(torch.equal(i, pi) and torch.equal(v, pv),
                  f"topk k={k_} {label}: kernel differs from plain")
            worst = max(worst, float((v - pv).abs().max()))
            ties = int((s_.topk(k_ + 1).values.diff(dim=1) == 0).any(dim=1).sum())
            log(f"topk k={k_} Q={qs} N={ns} {label}: values and indices bit-equal ({ties} rows "
                f"with tied top-{k_ + 1} scores)")
        tb = bound(qs * ns * 4 + qs * k_ * 8, qs * ns, F32_FLOPS)
        rec = dict(name=f"topk@k{k_}", route="cuda", instance="general",
                   source=kernels["topk"]["source"], replaces=kernels["topk"]["replaces"],
                   max_abs_err=worst, ms=cuda_ms(lambda: topk(sims, k_), 20),
                   plain_ms=cuda_ms(lambda: topk_plain(sims, k_), 3),
                   library_ms=cuda_ms(lambda: torch.topk(sims, k_), 20),
                   bound_ms=tb[0], bound_by=tb[1], shape=f"Q={qs} N={ns} k={k_} f32")
        if k_ == WIDE_K:
            rec["launches"] = launches["topk"]
            kernels[f"topk_k{k_}"] = rec
        else:
            shapes[f"topk_k{k_}"] = rec
        log(f"{rec['name']} [general]: kernel {rec['ms']:.3f} ms, plain {rec['plain_ms']:.3f} ms, "
            f"library {rec['library_ms']:.3f} ms (torch.topk), bound {rec['bound_ms']:.3f} ms "
            f"({rec['bound_by']}) [{rec['shape']}; {card}]")
    del sims, engines, fast, want
    # the float64 holds' blocks stay reserved by the caching allocator; phase
    # 11's ranks need that memory for their own contexts on the card
    gc.collect()
    torch.cuda.empty_cache()
    return dict(paths=paths, shapes=shapes, launches=launches)


#: phase 11: ranks of a process group sharing the one card (gloo), the
#: sharded kNN's queries and k, the shards of its in-process merge, and the
#: trainers' global batches (a rank takes 1/PHASE11_RANKS of each)
PHASE11_RANKS = 2
SHARDED_KNN_QUERIES = 8192
SHARDED_KNN_SHARDS = 4
PHASE11_SERVE_BATCH = 128
PHASE11_REFINE_BATCH = 8


def flat_share(got: dict, want: dict) -> tuple[float, str]:
    """grad_share of two {"<subnet>.<key>": gradient} dicts."""
    def nest(flat):
        out = {}
        for key, g in flat.items():
            net, rest = key.split(".", 1)
            out.setdefault(net, {})[rest] = g
        return out
    return grad_share(nest(got), nest(want))


def run_phase11(root: Path, dev, seed: int, cfg: dict, params: dict, db: np.ndarray,
                rcfg: dict, fcfg: dict, serve_argv: list, serve_ref: Path, grad_bound: float,
                launches: dict, card: str) -> dict:
    """Phase 11a-11c: the data-parallel paths over PHASE11_RANKS gloo ranks
    on the card (parallel/launch.spawn_ranks, one start running every path
    of parallel/steps.py, each counted alone in its rank), each against the
    same path in this one process:
      11a the sharded kNN (the flagship rows, a row copied across each shard
          boundary, SHARDED_KNN_QUERIES unit queries, k = 2K) in float32 and
          bf16, each shard on the dense path + topk.cu and forced onto
          knn.cu; and SHARDED_KNN_SHARDS shards merged in this process;
      11b FAST_VARIANT serving at call batch PHASE11_SERVE_BATCH (its rows
          split over the ranks), both dtypes, against one process (float32
          max |diff| 1e-5) and `base` (bf16 MAE 1e-3); then serve.main
          --f32 on the ranks (rank 0 writes) against serve.main's files in
          one process at batch 64: the ranks' call batch is twice that (the
          tail padded), so that each rank serves 64 chunks a call and takes
          the one process's kNN path (32 chunks are 2,048 float32 queries,
          below the streaming kernel's crossover: the dense search, whose
          float32 sums can order near-equal neighbours otherwise);
      11c one retrieval step at the config's global batch (plain and
          BatchNorm target encoders) and one phase-3 refinement step at
          global batch PHASE11_REFINE_BATCH (float32, TF32 off): losses 1e-5
          relative, summed gradients within `grad_bound` (7d's phase-3
          bound) of the one-process step; a short fit of each trainer
          (equal step counts), and the loader's epoch over 7 items (every
          item counted once, the wrapped filler in no rank's `valid`).
    The ranks' launch counts are added to `launches`. Two processes
    time-slice the card: their ms are no scaling figure."""
    import torch
    from retrieval_fuse_tpu_torch.data import PatchedSceneDataset, SceneHandler
    from retrieval_fuse_tpu_torch.inference import FAST_VARIANT
    from retrieval_fuse_tpu_torch.ops.knn import (
        exact_knn, merge_candidates, shard_bounds, shard_candidates)
    from retrieval_fuse_tpu_torch.ops.streaming_knn import knn_rows, streaming_knn
    from retrieval_fuse_tpu_torch.parallel import steps
    from retrieval_fuse_tpu_torch.parallel.launch import spawn_ranks
    t_phase = time.perf_counter()
    rng = np.random.default_rng(seed + 11)
    w = PHASE11_RANKS
    out = {"ranks": w, "backend": "gloo (two ranks on one card)"}

    # the inputs: kNN rows and queries, serving chunks, the global batches
    n, k = len(db), 2 * cfg["K"]
    rows = db.copy()
    for shards in (w, SHARDED_KNN_SHARDS):
        size = -(-n // shards)
        for b in range(size, n, size):
            rows[b] = rows[b - 1]
    queries = rng.standard_normal((SHARDED_KNN_QUERIES, rows.shape[1])).astype(np.float32)
    queries /= np.linalg.norm(queries, axis=1, keepdims=True)
    chunks = synthetic_df(rng, PHASE11_SERVE_BATCH, 8, cfg["dataset_train"]["voxel_size_input"],
                          dev).cpu().numpy()[..., None]
    cparams = {net: {key: v.cpu() for key, v in sd.items()} for net, sd in params.items()}
    rcfg = dict(rcfg, experiment="chip_smoke_dp_retrieval")
    rbatch = first_batches(PatchedSceneDataset("train", rcfg["dataset_train"],
                                               SceneHandler("train", rcfg)),
                           rcfg["retrieval_training"]["batch_size"], 1)[0]
    rbatch = {key: rbatch[key] for key in ("input", "target")}
    rcfg_bn = copy.deepcopy(rcfg)
    rcfg_bn["retrieval_model"]["network_target"] = "16+8N"
    fcfg8 = dict(fcfg, batch_size=PHASE11_REFINE_BATCH, experiment="chip_smoke_dp_refine")
    fraw = first_batches(PatchedSceneDataset("train", fcfg8["dataset_train"],
                                             SceneHandler("train", fcfg8)),
                         PHASE11_REFINE_BATCH, 1)[0]
    fbatch = {key: fraw[key] for key in ("input", "target", "retrieval")}
    fbatch = perturb_batch(fbatch, rng, REFINE_HOLD_NOISE)
    fvalid = [PHASE11_REFINE_BATCH // w] * w
    work = str(root)
    knn_calls = [(dtype, streaming) for dtype in ("float32", "bfloat16")
                 for streaming in (False, True)]
    calls = [(steps.sharded_knn, (queries, rows, k, dtype, streaming, 5))
             for dtype, streaming in knn_calls]
    calls += [(steps.serving_hold, (cfg, chunks, FAST_VARIANT, dtype, seed, cparams, db, n, 3))
              for dtype in ("bfloat16", "float32")]
    calls += [(steps.retrieval_step, (rcfg, rbatch, "float32", "cuda", work)),
              (steps.retrieval_step, (rcfg_bn, rbatch, "float32", "cuda", work)),
              (steps.refinement_step, (fcfg8, fbatch, fvalid, 3, "float32", "cuda", work)),
              (steps.fit_steps, ("retrieval", rcfg, 2, work)),
              (steps.fit_steps, ("refinement", fcfg8, 2, work)),
              (steps.loader_rows, (7, 2)),
              (steps.serve_main, (serve_argv,))]
    t0 = time.perf_counter()
    ranks = spawn_ranks(steps.counted_calls, w, "cuda", (calls,))
    out["ranks_s"] = time.perf_counter() - t0
    names = [f"knn {dt} {'knn.cu' if st else 'dense'}" for dt, st in knn_calls] + [
        "serve bf16", "serve f32", "retrieval step", "retrieval step BN", "refinement step",
        "retrieval fit", "refinement fit", "loader", "serve.main"]
    res = [dict(zip(names, (r for r, _ in rank))) for rank in ranks]
    counts = {name: {kn: sum(rank[i][1][kn] for rank in ranks) for kn in launches}
              for i, name in enumerate(names)}
    for name, c in counts.items():
        for kn, v in c.items():
            launches[kn] += v
    out["launches"] = {name: {kn: v for kn, v in c.items() if v} for name, c in counts.items()}

    # 11a) the sharded kNN against the single card, and merged in this process
    knn = {}
    for (dtype, streaming), name in zip(knn_calls, names):
        tdt = torch.float32 if dtype == "float32" else torch.bfloat16
        q, r = (torch.from_numpy(a).to(dev, tdt) for a in (queries, rows))
        r = knn_rows(r)
        single = (lambda: streaming_knn(q, r, k)) if streaming else (lambda: exact_knn(q, r, k))
        want = single()[0].cpu()
        size = -(-n // SHARDED_KNN_SHARDS)

        def merged():
            lists = [shard_candidates(q, r[a:b], k, a, size, streaming)
                     for a, b in (shard_bounds(n, SHARDED_KNN_SHARDS, i)
                                  for i in range(SHARDED_KNN_SHARDS))]
            return merge_candidates(torch.cat([s_ for s_, _ in lists], dim=1),
                                    torch.cat([i_ for _, i_ in lists], dim=1), k)
        got4 = merged()[0].cpu()
        needed = ("knn" if tdt == torch.float32 else "knn_bf16") if streaming else "topk"
        check(counts[name][needed] > 0, f"11a {name}: kernel {needed} was not launched")
        for rank in res:
            idx = rank[name][0]
            check(torch.equal(idx, want) and int(idx.min()) >= 0 and int(idx.max()) < n,
                  f"11a {name}: the {w} ranks' indices differ from the single card's on "
                  f"{int((idx != want).any(dim=1).sum())} of {len(want)} queries")
        check(torch.equal(got4, want), f"11a {name}: {SHARDED_KNN_SHARDS} merged shards differ "
                                       f"on {int((got4 != want).any(dim=1).sum())} queries")
        knn[name] = dict(ms_ranks=max(rank[name][2] for rank in res),
                         ms_single=cuda_ms(single, 5),
                         ms_merged_in_process=cuda_ms(merged, 5),
                         ties_across_shards=int(sum((rows[b] == rows[b - 1]).all()
                                                    for b in range(1, n))))
        log(f"11a sharded kNN {name} (Q={SHARDED_KNN_QUERIES}, N={n}, k={k}): indices equal "
            f"to the single card's on {w} gloo ranks and over {SHARDED_KNN_SHARDS} shards "
            f"merged in one process; {knn[name]['ms_ranks']:.3f} ms a call on the ranks, "
            f"{knn[name]['ms_merged_in_process']:.3f} ms merged in one process, "
            f"{knn[name]['ms_single']:.3f} ms single [{card}]")
    out["knn"] = knn

    # 11b) serving with the batch split over the ranks
    serving = {}
    for tag, name, needed in (("bf16", "serve bf16", ("knn_bf16", "attention")),
                              ("f32", "serve f32", ("knn", "attention"))):
        for kn in needed:
            check(counts[name][kn] > 0, f"11b {name}: kernel {kn} was not launched")
        for rank in res:
            h = rank[name]
            check(h["shape"] == (PHASE11_SERVE_BATCH, 64, 64, 64, 1) and h["finite"],
                  f"11b {name}: TSDF of shape {h['shape']}, finite {h['finite']}")
            if tag == "f32":
                check(h["mae_vs_one"] <= 1e-5 and h["max_abs_vs_one"] <= 1e-5,
                      f"11b {name}: MAE {h['mae_vs_one']:.2e}, max |diff| "
                      f"{h['max_abs_vs_one']:.2e} against one process (1e-5)")
            check(h["mae_vs_base"] < 1e-3, f"11b {name}: MAE {h['mae_vs_base']:.2e} against "
                                           f"base (1e-3)")
        serving[tag] = dict(res[0][name], ms_ranks=max(rank[name]["ms"] for rank in res))
        log(f"11b {FAST_VARIANT} {tag}, batch {PHASE11_SERVE_BATCH} over {w} gloo ranks of "
            f"{PHASE11_SERVE_BATCH // w}: max |diff| {serving[tag]['max_abs_vs_one']:.2e}, MAE "
            f"{serving[tag]['mae_vs_one']:.2e} against one process, MAE vs base "
            f"{serving[tag]['mae_vs_base']:.2e}; {serving[tag]['ms_ranks']:.1f} ms a call "
            f"(two processes time-slicing the card) [{card}]")
    done = res[0]["serve.main"]
    check(all(rank["serve.main"] == done for rank in res) and done,
          f"11b serve.main on {w} ranks: served {[len(r['serve.main']) for r in res]}")
    out_dir = Path(serve_argv[serve_argv.index("--output") + 1])
    err = max(float(np.abs(np.load(out_dir / f"{name}_pred.npz")["arr"].astype(np.float32)
                           - np.load(serve_ref / f"{name}_pred.npz")["arr"].astype(np.float32)
                           ).max()) for name in done)
    check(err <= 1e-4, f"11b serve.main on {w} ranks: files differ by {err} from one process's")
    serving["serve_main"] = dict(chunks=len(done), max_err=err, launches=counts["serve.main"])
    log(f"11b serve.main --f32 on {w} ranks (rank 0 writes): {len(done)} files within "
        f"{err:.1e} of one process's serve.main; launches {out['launches']['serve.main']}")
    out["serving"] = serving

    # 11c) the trainers' data-parallel steps against one process on the card
    training = {}
    for name, fn, args in (
            ("retrieval step", steps.retrieval_step, (rcfg, rbatch, "float32", dev, work)),
            ("retrieval step BN", steps.retrieval_step, (rcfg_bn, rbatch, "float32", dev, work)),
            ("refinement step", steps.refinement_step,
             (fcfg8, fbatch, sum(fvalid), 3, "float32", dev, work))):
        want = fn(None, *args)
        rec = {"loss": want["loss"]}
        for r_, rank in enumerate(res):
            got = rank[name]
            rel = abs(got["loss"] - want["loss"]) / abs(want["loss"])
            share, where = flat_share(got["grads"], want["grads"])
            check(rel <= 1e-5, f"11c {name} rank {r_}: loss {got['loss']} against one "
                               f"process's {want['loss']}")
            check(share <= grad_bound, f"11c {name} rank {r_}: gradients {share:.2e} from one "
                                       f"process's ({where}; bound {grad_bound:.2e})")
            rec[f"rank{r_}"] = dict(loss_rel=rel, grad_share=share, worst=where)
        if "val" in want:
            for key, v in want["val"].items():
                got_v = res[0][name]["val"][key]
                check(abs(got_v - v) <= 1e-5 * max(abs(v), 1e-12),
                      f"11c {name}: val loss {key} {got_v} against {v}")
        training[name] = rec
        log(f"11c {name}, global batch {len(next(iter(args[1].values())))} over {w} ranks: "
            f"loss {rec['rank0']['loss_rel']:.1e} relative, gradients "
            f"{max(rec[f'rank{i}']['grad_share'] for i in range(w)):.2e} (bound "
            f"{grad_bound:.2e}) of one process's [{card}]")
    for name in ("retrieval fit", "refinement fit"):
        took = [rank[name]["steps"] for rank in res]
        check(len(set(took)) == 1 and took[0] == 2, f"11c {name}: steps {took}")
    items = sorted(i for rank in res for i in rank["loader"]["items"])
    check(items == list(range(7)) and len({rank["loader"]["steps"] for rank in res}) == 1,
          f"11c loader over {w} ranks: items {items}, steps "
          f"{[rank['loader']['steps'] for rank in res]}")
    training["fit_steps"] = [res[0][name]["steps"] for name in ("retrieval fit", "refinement fit")]
    out["training"] = training
    out["phase_s"] = time.perf_counter() - t_phase
    log(f"phase 11a-c: {out['phase_s']:.1f} s ({out['ranks_s']:.1f} s in the ranks) [{card}]")
    return out


#: phase 12, the other tasks' training and retrieval pipeline at full width:
#: its tasks (task_retrieval_config), the dictionary rows their train chunks
#: reach (the streaming kNN's row crossover, ops/knn's
#: PALLAS_KNN_MIN_ROWS_BATCHED) and their val chunks
TASKS12 = ("surface", "superres16")
TASK_MIN_ROWS = 16384
TASK_VAL_CHUNKS = 16
#: 12a: the retrieval steps through fit at the config's batch, and the
#: batch of the step held against the CPU (~1 s a CPU step of 32 at 48³
#: windows, a CPU reading)
TASK_FIT_STEPS = 3
TASK_HOLD_BATCH = 32
#: 12c: the curriculum's steps a phase (two epochs of half); 12d: the
#: validation's batches a split
TASK_REFINE_STEPS = 2
TASK_VAL_BATCHES = 2
#: the kernels that phase 12 launches (every TPU kernel's port: the kNN
#: kernel in float32 rows, 12b's map)
PHASE12_KERNELS = ("topk", "knn", "attention", "attention_v1", "patch_attention",
                   "decoder_tail", "chamfer")
#: 12c: whether the curriculum's warm start negates phi's output layer
#: (task_warm_start): the seeded attention's switch stays shut through 16³'s
#: curriculum otherwise (open on 0.0% of the val rows in 12e on the H100;
#: the surface's on 88.8%; PERF.md section 6). The seeded weights' own open
#: share does not foretell it: phase 9's seeded 16³ weights, not negated,
#: are open on 92% of rows
TASK_NEGATE_PHI = {"surface": False, "superres16": True}
#: 12e: the paths served from the artifacts, `base` first
TASK_SERVE_VARIANTS = ("base", "fused+pallasg2+topk1p", "fused+pallasg2+topk1p+cdec",
                       "fused+pallasp+topk1p", "fused+pallasg+topk1p")


def task_warm_start(task: str, init: dict) -> dict:
    """The curriculum's start in 12c: the seeded weights `init` with the
    occupancy gate opened as hold_refine_steps opens it (the decoder's
    output bias at REFINE_HOLD_DECODER_BIAS: the seeded decoder predicts no
    occupied voxel, so that phase 2's contrastive loss is 0 and the
    validation's predictions empty), and phi's output layer negated where
    TASK_NEGATE_PHI says (negate_phi_out, as flagship_params does)."""
    import torch
    warm = copy.deepcopy(init)
    bias = warm["decoder"]["final_conv.bias"]
    warm["decoder"]["final_conv.bias"] = torch.full_like(bias, REFINE_HOLD_DECODER_BIAS)
    if TASK_NEGATE_PHI[task]:
        negate_phi_out(warm)
    return warm


def run_phase12(dev, seed: int, counters: dict, drive, card: str) -> tuple[dict, dict]:
    """Phase 12: run_task12 on each of TASKS12, in a working directory of
    its own, on data drawn from a generator of its own. Returns (the
    records by task, the launches of the phase)."""
    results, launches12 = {}, {name: 0 for name in counters}
    for i, task in enumerate(TASKS12):
        t0, cwd = time.perf_counter(), os.getcwd()
        with tempfile.TemporaryDirectory() as tmp:
            os.chdir(tmp)
            try:
                results[task] = run_task12(task, Path(tmp), dev, np.random.default_rng([seed, 12, i]),
                                           seed + i, counters, drive, card, launches12)
            finally:
                os.chdir(cwd)
        results[task]["phase_s"] = time.perf_counter() - t0
        log(f"phase 12 {task}: {results[task]['phase_s']:.1f} s; sub-phases (s) "
            f"{ {k: round(v, 1) for k, v in results[task]['seconds'].items()} } [{card}]")
    return results, launches12


def run_task12(task: str, root: Path, dev, rng, seed: int, counters: dict, drive, card: str,
               launches: dict) -> dict:
    """Phase 12 on one task's configs at their YAML widths and batches
    (task_retrieval_config, task_refinement_config), in the working
    directory `root`, on write_task_dataset's data (TASK_MIN_ROWS
    dictionary rows, TASK_VAL_CHUNKS val chunks):
    12a, the retrieval trainer: step 1 at TASK_HOLD_BATCH held against the
    CPU's float64 (hold_task_train_step), TASK_FIT_STEPS steps through fit at the config's
    batch (steps/s; its checkpoint), a step on a resident batch (ms, idle
    share) and the peak memory; 12b, retrieval/cli.py's map, compose and
    evaluate on that checkpoint (s a mode; map's launches of the kNN
    kernels; the mapping against a dense search, check_mapping; the metrics
    against the plain chamfer's, 1e-6 relative); 12c, the refinement
    trainer on 12b's composed retrievals: each phase's step held against the
    CPU (hold_refine_steps), the curriculum through train_refinement_phases
    (two epochs of TASK_REFINE_STEPS / 2 steps a phase; steps/s of each
    second epoch; phase 2's losses > 0; each phase changed exactly its
    sub-networks), a phase-3 step on a resident batch (ms, idle share), the
    peak memory; 12d, its validation through the chamfer kernel against the
    plain chamfer (1e-6 relative); 12e, serving the val chunks from the
    artifacts (serve.build_engine_from_artifacts) with TASK_SERVE_VARIANTS
    in bf16 and float32, each against `base` in its dtype (MAE < 1e-3 and
    1e-5, in df units at the flagship's truncation scaled to the task's
    for the 16³ task, as phase 9 holds it), the share of rows whose
    attention switch is open, and serve.main in bf16 against the engine.
    Every path runs through `drive`, its launches into `launches`."""
    import random

    import torch
    import yaml
    from retrieval_fuse_tpu_torch import serve
    from retrieval_fuse_tpu_torch.data import PatchedSceneDataset, SceneHandler, batch_iterator
    from retrieval_fuse_tpu_torch.evaluation import metrics as metrics_mod
    from retrieval_fuse_tpu_torch.inference import FAST_VARIANT
    from retrieval_fuse_tpu_torch.ops import patch_attention as pa
    from retrieval_fuse_tpu_torch.ops.chamfer import chamfer_batch_plain
    from retrieval_fuse_tpu_torch.ops.knn import use_streaming_knn
    from retrieval_fuse_tpu_torch.retrieval.cli import retrievals_to_disk
    from retrieval_fuse_tpu_torch.retrieval.engine import query_batch_size
    from retrieval_fuse_tpu_torch.train.checkpoint import load_checkpoint, save_checkpoint
    from retrieval_fuse_tpu_torch.train.refinement_trainer import train_refinement_phases
    from retrieval_fuse_tpu_torch.train.retrieval_trainer import (
        RetrievalTrainer, get_metrics_for_retrieval)
    from retrieval_fuse_tpu_torch.utils.misc import get_retrievals_dir, get_tree_path
    rec = {"seconds": {}}
    secs = rec["seconds"]
    counts_now = lambda: {name: c.launches for name, c in counters.items()}  # noqa: E731
    t0 = time.perf_counter()
    made = write_task_dataset(task, root / "data", rng, TASK_MIN_ROWS, TASK_VAL_CHUNKS, dev)
    secs["data"] = time.perf_counter() - t0
    log(f"12 {task}: {len(made['train'])} train chunks ({made['rows']} dictionary rows) and "
        f"{len(made['val'])} val chunks made and written in {secs['data']:.1f} s")

    # 12a) the retrieval trainer at the config's batch
    t0 = time.perf_counter()
    tcfg = dict(task_retrieval_config(task, root / "data", ""), seed=seed,
                experiment=f"p12_{task}")
    hcfg = copy.deepcopy(tcfg)
    hcfg["retrieval_training"]["batch_size"] = TASK_HOLD_BATCH
    before = counts_now()
    hold = hold_task_train_step(hcfg, dev)
    check(counts_now() == before, f"12a {task}: the held train step launched a kernel")
    secs["12a_hold"] = time.perf_counter() - t0
    log(f"12a {task} train step 1 at batch {TASK_HOLD_BATCH} on the card against the CPU "
        f"(float32, TF32 off, {len(hold['draws'])} batches): losses within 1e-5 relative; "
        f"gradients from the CPU's float64, as a share of their encoder's largest, by batch: "
        f"card {[float(f'{d['card_f64']:.2e}') for d in hold['draws']]} (bound "
        f"{hold['bound']:.2e}), CPU float32 "
        f"{[float(f'{d['cpu_f64']:.2e}') for d in hold['draws']]}, card with TF32 on "
        f"{[float(f'{d['tf32_f64']:.2e}') for d in hold['draws']]}, all on the float64 step's "
        f"activation branches [{card}]")
    for r, d in enumerate(hold["draws"]):
        log(f"  batch {r} (Leaky)ReLU inputs from float64's, as a share of the call's largest: "
            + branch_line(d["activations"], hold["activation_bound"]))
    t0 = time.perf_counter()
    trainer = RetrievalTrainer(tcfg, device=dev)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t_fit = time.perf_counter()
    _, counts = drive(f"12a {task} fit", (), lambda: trainer.fit(
        1, val_check_interval=100, run_retrieval_validation=False,
        max_steps_per_epoch=TASK_FIT_STEPS), launches)
    torch.cuda.synchronize()
    fit_s = time.perf_counter() - t_fit
    ckpt = (Path("runs") / tcfg["experiment"] / "ckpt_epoch=0").resolve()
    check(trainer.global_step == TASK_FIT_STEPS and not counts and (ckpt / "params.pt").exists(),
          f"12a {task} fit: {trainer.global_step} steps, launches {counts}, checkpoint {ckpt}")
    resident = trainer._device_batch(first_batches(trainer.train_dataset, trainer.batch_size,
                                                   1)[0])
    step = lambda: trainer._train_step(resident, trainer.current_learning_rate)  # noqa: E731
    busy, wall = device_busy(step)
    rec["retrieval_training"] = dict(
        batch=trainer.batch_size, hold_batch=TASK_HOLD_BATCH, hold=hold,
        fit_steps=TASK_FIT_STEPS, fit_s=fit_s,
        steps_per_s=TASK_FIT_STEPS / fit_s, step_ms=wall, step_kernel_ms=busy,
        idle=1 - busy / wall,
        peak_gb=torch.cuda.max_memory_allocated() / 2 ** 30, train_patches=len(trainer.train_dataset))
    r = rec["retrieval_training"]
    log(f"12a {task} retrieval training: {TASK_FIT_STEPS} steps of batch {r['batch']} through fit "
        f"in {fit_s:.2f} s = {r['steps_per_s']:.2f} steps/s (loader, first-step set-up and "
        f"checkpoint included); a step on a resident batch {wall:.1f} ms (traced, "
        f"synchronised), {busy:.1f} ms of it kernels, idle {r['idle']:.1%}; peak memory "
        f"{r['peak_gb']:.2f} GiB [{card}]")
    del trainer, resident
    secs["12a"] = time.perf_counter() - t0

    # 12b) map, compose and evaluate with the trained checkpoint
    rcfg = task_retrieval_config(task, root / "data", ckpt)
    outs, rec["pipeline"] = {}, {}
    random.seed(seed)  # the surface inputs' point subsets, replayed by check_mapping
    for mode, needed in (("map", ("knn", "topk")), ("compose", ()),
                         ("evaluate", ("chamfer",))):
        t0 = time.perf_counter()
        outs[mode], counts = drive(f"12b {task} {mode}", needed,
                                   lambda: retrievals_to_disk(mode, rcfg, device=dev), launches)
        secs[f"12b_{mode}"] = time.perf_counter() - t0
        rec["pipeline"][f"{mode}_s"] = secs[f"12b_{mode}"]
        rec["pipeline"][f"{mode}_launches"] = counts
        log(f"12b {task} {mode}: {secs[f'12b_{mode}']:.1f} s; launches {counts} [{card}]")
    t0 = time.perf_counter()
    tree, rdir = Path(get_tree_path(rcfg)), get_retrievals_dir(rcfg)
    n_rows = np.load(tree / "database.npy", mmap_mode="r").shape[0]
    maps = {split: np.load(rdir / f"map_{split}.npy", allow_pickle=True)[()]
            for split in ("train", "val")}
    q_batch = query_batch_size(n_rows)
    streamed = sum(use_streaming_knn(n_rows, n_queries=min(q_batch, len(m) - s))
                   for m in maps.values() for s in range(0, len(m), q_batch))
    map_launches = rec["pipeline"]["map_launches"]
    check(n_rows >= TASK_MIN_ROWS and streamed >= 1 and map_launches.get("knn") == streamed,
          f"12b {task} map: {n_rows} rows, {map_launches} for {streamed} query batches at or "
          "above the crossover")
    ds_train = PatchedSceneDataset("train", rcfg["dataset_train"], SceneHandler("train", rcfg))
    near = check_mapping(rcfg, tree, maps["train"], ds_train, rng, MAP_SAMPLE, dev,
                         replay_seed=seed if task == "surface" else None)
    rec["pipeline"].update(database_rows=n_rows, queries={k: len(m) for k, m in maps.items()},
                           streamed_batches=streamed, map_near_ties=near,
                           metrics=outs["evaluate"])
    log(f"12b {task} map: {n_rows} database rows; {len(maps['train'])} train and "
        f"{len(maps['val'])} val queries; the streaming kNN kernel (knn.cu, float32 rows) took "
        f"{streamed} query batches of {q_batch} ({map_launches.get('knn', 0)} launches), the "
        f"dense search + topk.cu the rest ({map_launches.get('topk', 0)} launches); "
        f"{MAP_SAMPLE} {'first' if task == 'surface' else 'sampled'} train queries equal a "
        f"dense float32 search ({near} near-ties excluded)")
    ds_val = PatchedSceneDataset("val", rcfg["dataset_val"], SceneHandler("val", rcfg))
    nn1 = np.stack([np.load(rdir / "compose" / f"{s}.npz")["arr_0"][:1] for s in ds_val.scenes])
    chamfer_kernel = metrics_mod.chamfer_batch
    try:
        metrics_mod.chamfer_batch = chamfer_batch_plain
        plain_metrics = get_metrics_for_retrieval(nn1, ds_val, device=dev)
    finally:
        metrics_mod.chamfer_batch = chamfer_kernel
    for got, want in zip(outs["evaluate"], plain_metrics):
        check(np.isfinite(got) and abs(got - want) <= 1e-6 * abs(want),
              f"12b {task} evaluate: metrics {outs['evaluate']} against {plain_metrics} with "
              "the plain chamfer")
    log(f"12b {task} evaluate: [iou, chamfer, precision, recall] = {outs['evaluate']}, equal "
        f"to the plain chamfer's within 1e-6 relative")
    del ds_train, ds_val
    secs["12b_checks"] = time.perf_counter() - t0

    # 12c) the refinement trainer on 12b's composed retrievals
    t0 = time.perf_counter()
    fcfg = dict(task_refinement_config(task, root / "data", ckpt), seed=seed,
                experiment=f"p12r_{task}")
    before = counts_now()
    hold = hold_refine_steps(fcfg, dev, seed + 12)
    init = hold.pop("init")
    check(counts_now() == before, f"12c {task}: the held refinement steps launched a kernel")
    log_refine_hold(hold, f"12c {task} refine steps", card)
    rec["refine_hold"] = hold
    secs["12c_hold"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    half = TASK_REFINE_STEPS // 2
    warm = task_warm_start(task, init)
    wpath = save_checkpoint(Path("runs") / f"p12w_{task}", 0, warm)
    ccfg = dict(fcfg, phase_change_epochs=[2, 2, 2], max_epoch=2, save_epoch=2,
                val_check_interval=100, unet_backbone_decoder_ckpt=str(wpath),
                attention_block_ckpt=str(wpath))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    refiner, counts = drive(f"12c {task} curriculum", (), lambda: train_refinement_phases(
        ccfg, max_steps_per_epoch=half, device=dev), launches)
    check(not counts, f"12c {task}: the curriculum launched kernels: {counts}")
    run_dir = Path("runs") / ccfg["experiment"]
    recs = [r_ for r_ in map(json.loads, (run_dir / "metrics.jsonl").read_text().splitlines())
            if "train/total_loss" in r_]
    check([(r_["phase"], r_["epoch"]) for r_ in recs]
          == [(ph, e) for ph in range(4) for e in range(2)],
          f"12c {task} curriculum: train records {[(r_['phase'], r_['epoch']) for r_ in recs]}")
    rec["curriculum"] = {"batch": refiner.batch_size, "steps_per_epoch": half}
    for ph in range(4):
        r0, r1 = recs[2 * ph], recs[2 * ph + 1]
        losses = [r0["train/total_loss"], r1["train/total_loss"]]
        check(all(np.isfinite(losses)) and (ph != 2 or min(losses) > 0),
              f"12c {task} phase {ph}: losses {losses}" + (
                  " (a zero phase-2 loss: the contrastive gate is shut)" if ph == 2 else ""))
        dt_ = r1["_time"] - r0["_time"]
        rec["curriculum"][ph] = dict(epoch_s=dt_, steps_per_s=half / dt_, losses=losses)
        log(f"12c {task} phase {ph} through fit: its second epoch, {half} steps of batch "
            f"{refiner.batch_size}, {half / dt_:.2f} steps/s (loader included); loss "
            f"{losses[0]:.4f} -> {losses[1]:.4f} [{card}]")
    ends = {ph: load_checkpoint(run_dir / f"ckpt_epoch={2 * ph + 1}")["params"]
            for ph in (1, 2, 3)}
    for label, old, new_, want in (
            ("phases 0-1", warm, ends[1], {"unet_backbone", "decoder", "retrieval_backbone"}),
            ("phase 2", ends[1], ends[2], {"patched_attention_block"}),
            ("phase 3", ends[2], ends[3], set(init))):
        moved = {n for n, sd in new_.items()
                 if any(not torch.equal(v.cpu(), old[n][k].cpu()) for k, v in sd.items())}
        check(moved == want, f"12c {task} curriculum: {label} changed {sorted(moved)}, not "
                             f"{sorted(want)}")
    fckpt = (run_dir / "ckpt_epoch=7").resolve()
    batch = refiner._device_batch(next(iter(batch_iterator(
        refiner.train_dataset, refiner.batch_size, shuffle=False, prefetch=0))))
    refiner.set_phase(3)
    step = lambda: refiner.train_step(batch, refiner.base_lr)  # noqa: E731
    busy, wall = device_busy(step)
    rec["curriculum"].update(step3_ms=wall, step3_kernel_ms=busy, idle3=1 - busy / wall,
                             peak_gb=torch.cuda.max_memory_allocated() / 2 ** 30)
    c = rec["curriculum"]
    log(f"12c {task} curriculum: phases 0-1 changed the backbone, the decoder and the "
        f"retrieval backbone, phase 2 the attention alone, phase 3 all four; a phase-3 step of "
        f"batch {refiner.batch_size} on a resident batch {wall:.1f} ms (traced, synchronised), "
        f"{busy:.1f} ms of it kernels, idle {c['idle3']:.1%}; peak memory "
        f"{c['peak_gb']:.2f} GiB [{card}]")
    del batch
    secs["12c_curriculum"] = time.perf_counter() - t0

    # 12d) the refinement validation through the chamfer kernel, each call
    # held against the plain chamfer on the same point sets (the surface
    # inputs' point subsets come from `random` on the loader's thread, so a
    # second validation would not see the same inputs)
    t0 = time.perf_counter()
    pairs = []

    def held_chamfer(*args):
        got_ = chamfer_kernel(*args)
        pairs.append((got_.cpu(), chamfer_batch_plain(*args).cpu()))
        return got_

    random.seed(seed)  # the point subsets the surface inputs' voxeliser draws
    try:
        metrics_mod.chamfer_batch = held_chamfer
        got, counts = drive(f"12d {task} validation", ("chamfer",),
                            lambda: refiner.validate(max_batches=TASK_VAL_BATCHES), launches)
    finally:
        metrics_mod.chamfer_batch = chamfer_kernel
    check(set(counts) == {"chamfer"} and len(pairs) == counts["chamfer"],
          f"12d {task}: validation launched {counts}, {len(pairs)} chamfer calls")
    for a, b in pairs:
        check(torch.allclose(a, b, rtol=1e-6, atol=0.0, equal_nan=True),
              f"12d {task} validation: the chamfer kernel's {a.tolist()} against the plain "
              f"chamfer's {b.tolist()}")
    for key, m in got.items():
        check(all(np.isfinite(m[name]) for name in ("iou", "cd", "precision", "recall")),
              f"12d {task} validation {key}: {m}")
    rec["validation"] = dict(metrics=got, launches=counts)
    secs["12d"] = time.perf_counter() - t0
    log(f"12d {task} validation (the first {TASK_VAL_BATCHES} batches of "
        f"{len(refiner.val_dataset)} val and {len(refiner.dataset('train_eval'))} train_eval "
        f"chunks): each chamfer call equal to the plain chamfer's within 1e-6 relative; "
        f"val_fuse {got['val_fuse']}; launches {counts}; "
        f"{secs['12d']:.1f} s [{card}]")
    del refiner

    # 12e) serving from the artifacts: the dictionary, 12a's and 12c's
    # checkpoints; the val chunks' inputs as the engines take them
    t0 = time.perf_counter()
    scfg = dict(rcfg)
    for key, value in fcfg.items():
        if key not in ("seed", "experiment"):
            scfg.setdefault(key, value)
    vin = root / "serve_in"
    vin.mkdir()
    names = sorted(made["val"])
    if task == "surface":
        random.seed(seed)
        handler = SceneHandler("val", fcfg)
        xv = np.stack([handler.get_scene_input(n_) for n_ in names]).astype(np.float32)
        for n_, grid in zip(names, xv):
            np.savez_compressed(vin / f"{n_}.npz", arr=grid)
    else:
        src = root / "data" / TASK_DATA[task]["input_dir"] / TASK_DATA[task]["dataset_name"]
        for n_ in names:
            (vin / f"{n_}.npz").symlink_to(src / f"{n_}.npz")
        xv = np.stack([np.load(vin / f"{n_}.npz")["arr"] for n_ in names]).astype(np.float32)
    xv = xv[..., None]
    engines = {}
    for dtype, tag in ((torch.bfloat16, "bf16"), (torch.float32, "f32")):
        for v in TASK_SERVE_VARIANTS:
            engines[v, tag] = serve.build_engine_from_artifacts(
                scfg, ckpt, fckpt, compute_dtype=dtype, device=dev, variant=v,
                verify_alignment=v == "base")
    torch.cuda.synchronize()
    secs["12e_build"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    trunc = engines["base", "f32"].target_trunc
    flagship_trunc = float(np.float16(flagship_config()["dataset_train"]["voxel_size_target"] * 3))
    scale = trunc / flagship_trunc if task == "superres16" else 1.0
    base_out = {}
    rec["serving"] = {}
    for v in TASK_SERVE_VARIANTS:
        got, counts = drive(f"12e {task} {v}", surface_kernels(v, len(xv)),
                            lambda: {tag: engines[v, tag](xv) for tag in ("bf16", "f32")},
                            launches)
        base_out = base_out or got
        r_ = {"launches": counts}
        for tag, o in got.items():
            check(o.shape == (len(xv), 64, 64, 64, 1) and torch.isfinite(o).all().item()
                  and float(o.min()) >= -1e-3 * scale and float(o.max()) <= trunc + 1e-3 * scale,
                  f"12e {task} {v} {tag}: TSDF out of shape or range")
            r_[f"mae_vs_base_{tag}"] = float((o - base_out[tag]).abs().mean())
            eng = engines[v, tag]
            r_[f"engine_ms_{tag}"] = cuda_ms(lambda: eng(xv), 2)
        check(r_["mae_vs_base_bf16"] < 1e-3 * scale,
              f"12e {task} {v}: bf16 MAE vs bf16 base {r_['mae_vs_base_bf16']} >= {1e-3 * scale}")
        check(r_["mae_vs_base_f32"] < 1e-5 * scale,
              f"12e {task} {v}: f32 MAE vs f32 base {r_['mae_vs_base_f32']} >= {1e-5 * scale}")
        rec["serving"][v] = r_
        log(f"12e {task} {v} batch {len(xv)}: engine bf16 {r_['engine_ms_bf16']:.2f} ms, f32 "
            f"{r_['engine_ms_f32']:.2f} ms; TSDF MAE vs base bf16 {r_['mae_vs_base_bf16']:.2e} "
            f"(< {1e-3 * scale:.2e}), f32 {r_['mae_vs_base_f32']:.2e} (< {1e-5 * scale:.2e}); "
            f"launches {counts} [{card}]")
    eng = engines[FAST_VARIANT, "f32"]
    with torch.inference_mode():
        xb = torch.from_numpy(xv).to(dev)
        xt = eng._tile_major_rows(eng.unet_backbone((xb - eng.in_mean) / eng.in_std))
        att = eng.attention.attention_blocks_layer
        out, _ = pa.gathered_patch_attention_plain(
            xt, eng.feature_bank, eng.retrieve(xb), att.theta, att.phi, fcfg["K"],
            retrieval_mode=eng.attn_retrieval_mode, sharpness=eng.sharpness)
        rec["serving"]["switch_open"] = float((out != xt).any(dim=-1).float().mean())
    check(rec["serving"]["switch_open"] >= 0.5,
          f"12e {task}: the trained attention's switch is open on "
          f"{rec['serving']['switch_open']:.1%} of the rows: the kernel paths compare x with x")
    secs["12e_paths"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    scfg_path = root / "serving.yaml"
    scfg_path.write_text(yaml.safe_dump({k: v for k, v in scfg.items() if k != "retrieval_ckpt"}))
    argv = ["--config", str(scfg_path), "--retrieval_ckpt", str(ckpt), "--refinement_ckpt",
            str(fckpt), "--input", str(vin), "--output", str(root / "cli_bf16"), "--batch_size",
            str(len(xv)), "--fast"]
    done, counts = drive(f"12e {task} serve CLI",
                         surface_kernels(FAST_VARIANT, len(xv), ("bf16",)),
                         lambda: serve.main(argv), launches)
    files = np.stack([np.load(root / "cli_bf16" / f"{n_}_pred.npz")["arr"] for n_ in done])
    with torch.inference_mode():
        want = engines[FAST_VARIANT, "bf16"](xv)[..., 0].float().cpu().numpy()
    err = float(np.abs(files.astype(np.float32) - want).max())
    check(done == names and err <= 1e-3 * trunc,
          f"12e {task} serve CLI: {len(done)} chunks, files differ by {err} from the engine")
    del engines, base_out, got, xb, xt, out
    secs["12e_cli"] = time.perf_counter() - t0
    rec["serving"].update(cli_max_err=err, cli_s=secs["12e_cli"], chunks=len(xv))
    log(f"12e {task}: the trained attention's switch open on "
        f"{rec['serving']['switch_open']:.1%} of the val rows; serve.main --fast: "
        f"{len(done)} chunks in {secs['12e_cli']:.1f} s (engine build included), files within "
        f"{err:.1e} of the engine (float16 files); launches {counts} [{card}]")
    return rec


#: phase 13: the val chunks of the forward gate
PARITY_CHUNKS = 2


def run_phase13(root: Path, dev, rcfg: dict, fcfg: dict, ckpt, fckpt, card: str) -> dict:
    """Phase 13, the real-data parity harness (retrieval_fuse_tpu_torch.
    parity_real) run as its CLI on phase 7's artifacts, in phase 7's
    working directory `root`: reference-layout checkpoints exported from 7a's
    retrieval and 7d's refinement weights (utils/reference_import's
    export_*), 7b's map_val.npy as the stand-in reference mapping (every
    gate must pass: top-k identity 1.0, the forward within the 1e-3 MAE
    budget) and a copy of it with one row's scene index changed (the top-k
    gate must refuse it: a non-zero exit). The forward gate's reference is a
    stand-in: the port's refinement forward on the CPU in float64 on the
    imported weights (the reference implementation is not on this
    machine)."""
    import torch
    import yaml
    from retrieval_fuse_tpu_torch import parity_real
    from retrieval_fuse_tpu_torch.train.checkpoint import load_checkpoint
    from retrieval_fuse_tpu_torch.train.refinement_trainer import RefinementTrainer
    from retrieval_fuse_tpu_torch.utils.misc import get_retrievals_dir
    from retrieval_fuse_tpu_torch.utils import reference_import as ri
    t13 = time.perf_counter()
    work = root / "parity"
    work.mkdir()
    fsd = ri.export_refinement_state_dict(load_checkpoint(fckpt)["params"], fcfg["task"],
                                          fcfg["attn_patch_extent"])
    for name, sd in (("retrieval", ri.export_retrieval_state_dict(
            load_checkpoint(ckpt)["params"])), ("refinement", fsd)):
        torch.save({"state_dict": {k: torch.from_numpy(v) for k, v in sd.items()}},
                   work / f"{name}.ckpt")
    for name, c in (("refinement", fcfg), ("retrieval", rcfg)):
        (work / f"{name}.yaml").write_text(yaml.safe_dump(
            {k: v for k, v in c.items() if k not in ("seed", "experiment")}))
    stand_in = RefinementTrainer(dict(fcfg), device="cpu", deterministic_attention=True)
    stand_in.load_params(ri.import_refinement_checkpoint(
        fsd, fcfg["task"], fcfg["dataset_train"]["input_chunk_size"], fcfg["attn_patch_extent"]))
    for net in stand_in.nets.values():
        net.double()

    def cpu_float64_forward(batch: dict) -> np.ndarray:
        with torch.no_grad():
            db = {k: torch.from_numpy(np.asarray(batch[k])).double()
                  for k in ("input", "target", "retrieval")}
            return stand_in.network_pred_to_df(stand_in.forward_full(db)[0]).numpy()

    map_val = get_retrievals_dir(rcfg) / "map_val.npy"
    common = ["--config", str(work / "refinement.yaml"), "--retrieval_config",
              str(work / "retrieval.yaml"), "--retrieval_ckpt", str(work / "retrieval.ckpt"),
              "--tree_path", str(work / "tree")]
    log("13 parity_real: the forward gate's reference is a stand-in (the port's forward on "
        "the CPU in float64); the reference implementation's module is not on this machine")
    t0 = time.perf_counter()
    rc = parity_real.main(common + [
        "--refinement_ckpt", str(work / "refinement.ckpt"), "--reference_map", str(map_val),
        "--n_chunks", str(PARITY_CHUNKS), "--out", str(work / "report.json")],
        reference_forward=cpu_float64_forward)
    report = json.loads((work / "report.json").read_text())
    out = {"passing_s": time.perf_counter() - t0, "rc": rc, "report": report}
    check(rc == 0 and report["ok"] and report["topk"]["topk_match_rate"] == 1.0
          and report["forward"]["tsdf_mae"] <= 1e-3 and report["forward"]["chunks"]
          == PARITY_CHUNKS, f"13 parity_real on the port's own artifacts: exit {rc}, {report}")
    mapping = np.load(map_val, allow_pickle=True)[()]
    first = sorted(mapping)[0]
    altered = dict(mapping)
    altered[first] = mapping[first].copy()
    altered[first][0, 0] += 1  # the first neighbour's scene index
    np.save(work / "map_altered.npy", altered)
    t0 = time.perf_counter()
    rc2 = parity_real.main(common + ["--reference_map", str(work / "map_altered.npy"),
                                     "--out", str(work / "report_altered.json")])
    report2 = json.loads((work / "report_altered.json").read_text())
    out.update(refusing_s=time.perf_counter() - t0, rc_altered=rc2, report_altered=report2)
    check(rc2 != 0 and not report2["ok"] and report2["topk"]["topk_match_rate"] < 1.0
          and report2["topk"]["first_mismatch_patch"] == first,
          f"13 parity_real on an altered map: exit {rc2}, {report2}")
    out["phase_s"] = time.perf_counter() - t13
    log(f"13 parity_real (the CLI's main): on the port's artifacts exit {rc}: top-k match "
        f"rate {report['topk']['topk_match_rate']:.4f} over {report['topk']['patches_compared']} "
        f"val patches, forward TSDF MAE {report['forward']['tsdf_mae']:.2e} over "
        f"{PARITY_CHUNKS} chunks against the stand-in (budget 1e-3), metrics "
        f"{report['forward']['metrics']}; on a map with one row's scene index changed exit "
        f"{rc2}, match rate {report2['topk']['topk_match_rate']:.6f}; {out['phase_s']:.1f} s "
        f"[{card}]")
    return out


def run_phase11d(launches: dict, card: str) -> dict:
    """Phase 11d: entry()'s fn on the card, dryrun_multichip over two gloo
    ranks sharing the card and over one NCCL rank (the mesh code under
    NCCL at world size 1); the dryruns' launch counts added to `launches`."""
    import torch
    from retrieval_fuse_tpu_torch.entry import dryrun_multichip, entry
    t0 = time.perf_counter()
    fn, example = entry()
    with torch.inference_mode():
        y = fn(*example)
    check(tuple(y.shape) == (8, 64, 64, 64, 1) and y.dtype == torch.float32
          and torch.isfinite(y).all().item(), f"11d entry(): {tuple(y.shape)} {y.dtype}")
    out = {"entry": dict(shape=tuple(y.shape), dtype=str(y.dtype))}
    log(f"11d entry(): fn(raw (8, 8, 8, 8, 1)) -> {tuple(y.shape)} {y.dtype}")
    for n, backend in ((PHASE11_RANKS, "gloo"), (1, "nccl")):
        got = dryrun_multichip(n, "cuda")
        check(got["backend"] == backend and np.isfinite(got["loss"]),
              f"11d dryrun_multichip({n}): {got}")
        for kn in ("topk", "attention", "patch_attention", "decoder_tail"):
            check(got["launches"].get(kn, 0) > 0, f"11d dryrun({n}): {kn} was not launched")
        for kn, v in got["launches"].items():
            launches[kn] += v
        out[f"dryrun{n}"] = got
        log(f"11d dryrun_multichip({n}) on the card ({backend}): loss {got['loss']:.4f}, "
            f"serving max |diff| from base {got['serving_max_abs']}, launches "
            f"{ {kn: v for kn, v in got['launches'].items() if v} }")
    out["phase_s"] = time.perf_counter() - t0
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out", default="chiprun_out/chip_smoke.json")
    ap.add_argument("--phase12", action="store_true",
                    help="build the kernels and run phase 12 alone (the other tasks' training, "
                         "pipeline and serving), which the whole run leaves out: with it the "
                         "whole run takes longer than its 1,200 s limit")
    args = ap.parse_args(argv)

    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    try:
        from retrieval_fuse_tpu_torch.device import resolve_device
        from retrieval_fuse_tpu_torch.inference import (
            FAST_VARIANT, RetrieveRefineEngine, variant_engine_kwargs)
        from retrieval_fuse_tpu_torch.ops import _build
        from retrieval_fuse_tpu_torch.ops import decoder_tail as dt
        from retrieval_fuse_tpu_torch.ops import patch_attention as pa
        from retrieval_fuse_tpu_torch.ops.fused_decoder import depth_to_space_2x
        from retrieval_fuse_tpu_torch.ops.knn import use_streaming_knn
        from retrieval_fuse_tpu_torch.ops.streaming_knn import (
            kernel_math as knn_math, streaming_knn_sims, streaming_knn_sims_plain)
        from retrieval_fuse_tpu_torch.ops.topk import topk, topk_plain
        from retrieval_fuse_tpu_torch import serve
        from retrieval_fuse_tpu_torch.serve import serve_directory
        from retrieval_fuse_tpu_torch.data import PatchedSceneDataset, SceneHandler, batch_iterator
        from retrieval_fuse_tpu_torch.evaluation import metrics as metrics_mod
        from retrieval_fuse_tpu_torch.ops.chamfer import (
            chamfer_batch_plain, occupancy_to_point_buffer)
        from retrieval_fuse_tpu_torch.ops.streaming_chamfer import (
            chamfer_minima, chamfer_minima_plain)
        from retrieval_fuse_tpu_torch.retrieval.cli import retrievals_to_disk
        from retrieval_fuse_tpu_torch.retrieval.engine import query_batch_size
        from retrieval_fuse_tpu_torch.train.checkpoint import load_checkpoint
        from retrieval_fuse_tpu_torch.train.retrieval_trainer import (
            RetrievalTrainer, get_metrics_for_retrieval, main as train_main)
        from retrieval_fuse_tpu_torch.train.refinement_trainer import (
            RefinementTrainer, train_refinement_phases)
        from retrieval_fuse_tpu_torch.utils.misc import get_retrievals_dir, get_tree_path
        from retrieval_fuse_tpu_torch.utils.logger import MetricsLogger
        from retrieval_fuse_tpu_torch.utils.visualization import trilinear_upsample_2x
        from retrieval_fuse_tpu_torch import native
        import yaml  # the trainer's and the serving CLI's configs
    except ImportError as e:
        print(f"chip_smoke: the port package or PyYAML is missing ({e})", file=sys.stderr)
        return 1
    import torch.nn.functional as F

    results: dict = {"seed": args.seed}
    t_start = time.perf_counter()

    def stamp(label: str) -> None:
        """The script's wall time so far, at the end of a phase."""
        results.setdefault("elapsed_s", {})[label] = time.perf_counter() - t_start
        log(f"[{time.perf_counter() - t_start:.1f} s since the start: {label}]")

    try:
        # 1) the card
        try:
            smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                                  "--format=csv,noheader"], capture_output=True, text=True,
                                 timeout=60)
            card = smi.stdout.strip().splitlines()[0] if smi.returncode == 0 else ""
        except (OSError, subprocess.TimeoutExpired):
            card = ""
        card = card or "nvidia-smi gave no card name and power limit"
        log(card)
        results["card"] = card
        dev = resolve_device("cuda")
        results["torch"] = f"{torch.__version__} cuda {torch.version.cuda}"

        # 2) the kernels, built from the checkout's sources, all at once
        t0 = time.perf_counter()
        reports = _build.build_all()
        results["build_s"] = time.perf_counter() - t0
        log(f"build: {len(reports)} kernel libraries in {results['build_s']:.1f} s "
            f"-> {_build.BUILD_DIR}")
        for name, rep in reports.items():
            for line in rep.splitlines():
                if "registers" in line or "spill" in line:
                    log(f"  ptxas {name}: {line.strip()}")

        stamp("build")
        # the launch counters of every kernel wrapper, and `drive`, which runs
        # a path with them at 0 and checks what it launched
        counters = {"topk": topk, "knn": DtypeLaunches(streaming_knn_sims, torch.float32),
                    "knn_bf16": DtypeLaunches(streaming_knn_sims, torch.bfloat16),
                    "attention": pa.gathered_patch_attention,
                    "attention_v1": pa.gathered_patch_attention_v1,
                    "patch_attention": pa.patch_attention, "decoder_tail": dt.decoder_tail,
                    "chamfer": chamfer_minima}
        launches = {name: 0 for name in counters}

        def drive(label: str, needed, fn, into=launches):
            """Run one path with every launch count at 0 just before it; check
            that it launched the kernels it needs; add its counts up (in
            `into`)."""
            torch.cuda.synchronize()
            for c in counters.values():
                c.launches = 0
            out = fn()
            torch.cuda.synchronize()
            counts = {name: c.launches for name, c in counters.items()}
            for name in needed:
                check(counts[name] > 0, f"{label}: kernel {name} was not launched")
            for name in counts:
                into[name] += counts[name]
            return out, {name: c for name, c in counts.items() if c}

        if args.phase12:
            t12 = time.perf_counter()
            results["tasks"], results["launches12"] = run_phase12(
                dev, args.seed, counters, drive, card)
            check(all(results["launches12"][name] > 0 for name in PHASE12_KERNELS),
                  f"phase 12 launched {results['launches12']}: not every one of "
                  f"{PHASE12_KERNELS}")
            log(f"phase 12: {time.perf_counter() - t12:.1f} s; launches "
                f"{results['launches12']} [{card}]")
            out = Path(args.out)
            out.parent.mkdir(parents=True, exist_ok=True)
            out.write_text(json.dumps(results, indent=1, default=str))
            return 0

        # 3) the flagship engines: base, FAST_VARIANT and VARIANT_PATHS, in
        # bf16 and float32, all on base's feature bank
        cfg = flagship_config()
        rng = np.random.default_rng(args.seed)
        params = flagship_params(cfg, args.seed)
        n = SEED_BANK_ROWS
        db, patch_bank = flagship_data(cfg, rng, n, dev)
        dtr = cfg["dataset_train"]
        engines, times = {}, {}
        for dtype, tag in ((torch.bfloat16, "bf16"), (torch.float32, "f32")):
            t0 = time.perf_counter()
            base_ = RetrieveRefineEngine(cfg, params, db, patch_bank, compute_dtype=dtype,
                                         device=dev)
            torch.cuda.synchronize()
            times[tag] = time.perf_counter() - t0
            check(torch.isfinite(base_.feature_bank).all().item(), f"{tag} feature bank")
            engines["base", tag] = base_
            for variant in (FAST_VARIANT, DENSE_VARIANT, *VARIANT_PATHS):
                engines[variant, tag] = RetrieveRefineEngine(
                    cfg, params, db, compute_dtype=dtype, device=dev,
                    feature_bank=base_.feature_bank, **variant_engine_kwargs(variant))
        del patch_bank
        fast, fast32 = engines[FAST_VARIANT, "bf16"], engines[FAST_VARIANT, "f32"]
        results["feature_bank_s"] = times
        log(f"engines: feature bank precompute of {n} tiles: bf16 {times['bf16']:.2f} s, "
            f"f32 {times['f32']:.2f} s; {len(engines)} engines")

        chunks = synthetic_df(rng, N_CHUNKS, 8, dtr["voxel_size_input"], dev).cpu().numpy()
        base_out = {}

        def tsdf_check(variant: str, xb) -> dict:
            """`variant`'s TSDF against the plain `base` engine's on the batch
            xb: MAE < 1e-3 in bf16, < 1e-5 in float32; the bf16-vs-float32
            MAE is reported."""
            key = xb.shape[0]
            if key not in base_out:
                base_out[key] = {tag: engines["base", tag](xb) for tag in ("bf16", "f32")}
            got = {tag: engines[variant, tag](xb) for tag in ("bf16", "f32")}
            for tag, o in got.items():
                check(o.shape == (key, 64, 64, 64, 1) and torch.isfinite(o).all().item(),
                      f"{variant} {tag}: TSDF not finite or of shape {tuple(o.shape)}")
            maes = {f"mae_vs_base_{tag}": float((got[tag] - base_out[key][tag]).abs().mean())
                    for tag in ("bf16", "f32")}
            # reported: with random weights at this width it is bf16 rounding
            # amplified by the untrained network, the same in the JAX engine
            maes["mae_bf16_vs_f32_base"] = float((got["bf16"] - base_out[key]["f32"]).abs().mean())
            check(maes["mae_vs_base_bf16"] < 1e-3,
                  f"{variant} batch {key}: bf16 MAE vs bf16 base {maes['mae_vs_base_bf16']} >= 1e-3")
            check(maes["mae_vs_base_f32"] < 1e-5,
                  f"{variant} batch {key}: f32 MAE vs f32 base {maes['mae_vs_base_f32']} >= 1e-5")
            log(f"  TSDF MAE (df units), {variant} batch {key}: vs base bf16 "
                f"{maes['mae_vs_base_bf16']:.2e} (< 1e-3), f32 {maes['mae_vs_base_f32']:.2e} "
                f"(< 1e-5); bf16 vs f32 base {maes['mae_bf16_vs_f32_base']:.2e}")
            return maes

        kernels = {}
        k = cfg["K"]

        # 4a) topk at the dense path's shape (DENSE_VARIANT at batch 64: Q = 4096)
        with torch.inference_mode():
            x64 = torch.from_numpy(chunks[:DENSE_BATCH, ..., None]).to(dev)
            sims = fast.embed_queries(x64).float() @ fast._database_f32.T
        q = sims.shape[0]
        worst = 0.0
        for label, s in (("scores", sims), ("bf16-tied scores", sims.bfloat16().float())):
            v, i = topk(s, k)
            pv, pi = topk_plain(s, k)
            torch.cuda.synchronize()
            check(torch.equal(i, pi) and torch.equal(v, pv),
                  f"topk {label}: kernel differs from plain")
            worst = max(worst, float((v - pv).abs().max()))
            ties = int((s.topk(k + 1).values.diff(dim=1) == 0).any(dim=1).sum())
            log(f"topk Q={q} N={n} {label}: values and indices bit-equal "
                f"({ties} rows with tied top-{k + 1} scores)")
        topk_bound = bound(q * n * 4 + q * k * 8, q * n, F32_FLOPS)
        kernels["topk"] = dict(
            name="topk", route="cuda", source="retrieval_fuse_tpu_torch/csrc/topk.cu",
            replaces="retrieval_fuse_tpu/ops/pallas_topk.py:32", max_abs_err=worst,
            ms=cuda_ms(lambda: topk(sims, k), 20),
            plain_ms=cuda_ms(lambda: topk_plain(sims, k), 5),
            library_ms=cuda_ms(lambda: torch.topk(sims, k), 20),
            bound_ms=topk_bound[0], bound_by=topk_bound[1], shape=f"Q={q} N={n} k={k} f32")
        del sims

        # 4b) streaming kNN at the streaming path's shape (batch 128: Q = 8192),
        # on each engine's own rows: float32 (3xTF32) and bf16 (bf16 mma)
        with torch.inference_mode():
            x128 = torch.from_numpy(chunks[:STREAM_BATCH, ..., None]).to(dev)
        for key, eng in (("knn", fast32), ("knn_bf16", fast)):
            with torch.inference_mode():
                z = eng.embed_queries(x128).contiguous()
            db_rows = eng.database
            err, near = hold_knn(f"streaming kNN {key}", z, db_rows, k)
            kb = knn_bound(z.shape[0], n, 64, k, z.dtype)
            kernels[key] = dict(
                name=f"streaming_{key}", route="cuda", math=knn_math(z.dtype),
                source="retrieval_fuse_tpu_torch/csrc/knn.cu",
                replaces="retrieval_fuse_tpu/ops/pallas_knn.py:49", max_abs_err=err,
                ms=cuda_ms(lambda: streaming_knn_sims(z, db_rows, k), 20),
                plain_ms=cuda_ms(lambda: streaming_knn_sims_plain(z, db_rows, k), 5),
                library_ms=cuda_ms(lambda: torch.topk(z.float() @ eng._database_f32.T, k), 20),
                library_call="float32 matmul of the same rows + torch.topk",
                earlier_ms=EARLIER_KERNEL_MS["knn"], near_ties=near,
                bound_ms=kb[0], bound_by=kb[1],
                shape=f"Q={z.shape[0]} N={n} D=64 k={k} {str(z.dtype)[6:]}")
            # off the flagship: k = 10, D = 96, N no multiple of any tile
            off = KNN_OFF_SHAPE
            off_rng = np.random.default_rng(args.seed + 2)
            qo, dbo = (unit_rows(off_rng, m, off["d"], z.dtype, dev) for m in (off["q"], off["n"]))
            err_off, _ = hold_knn(f"streaming kNN {key} off the flagship", qo, dbo, off["k"])
            kernels[key]["max_abs_err"] = max(err, err_off)
            del z, qo, dbo

        # 4c-4e) the three attention kernels at batch 128 (Q = 8192 tiles of
        # 64 rows), on the FAST_VARIANT engine's rows and retrievals; kernels
        # 3 and 4 run the wgmma body in bf16, v1 the mma.sync one
        WGMMA = pa.kernel_math("gathered_attention", torch.bfloat16)
        check(WGMMA == pa.kernel_math("patch_attention", torch.bfloat16) == "wgmma.bf16",
              f"the shipped bf16 attention body is reported as {WGMMA}")
        with torch.inference_mode():
            top_idx = fast.retrieve(x128)
            x_back = fast.unet_backbone(((x128 - fast.in_mean) / fast.in_std).bfloat16())
            xt16 = fast._tile_major_rows(x_back).contiguous()
        att = fast.attention.attention_blocks_layer
        q, t_rows, f = xt16.shape
        theta32, phi32 = [copy.deepcopy(m).float() for m in (att.theta, att.phi)]
        pa.freeze_operands(theta32, phi32)  # timed below: packed once, as the engine's
        xt32, bank32 = xt16.float(), fast.feature_bank.float()
        bank16 = fast.feature_bank
        attn_bound = attention_bound(q, t_rows, k, f)
        with torch.inference_mode():
            # gathered attention v2 (kernel 3)
            err, share16, _ = hold_attention(
                f"gathered attention Q={q}", pa.gathered_patch_attention,
                pa.gathered_patch_attention_plain,
                (xt32, bank32, top_idx, theta32, phi32, k),
                (xt16, bank16, top_idx, att.theta, att.phi, k), WGMMA)
            args16 = (xt16, bank16, top_idx, att.theta, att.phi, k)
            kernels["attention"] = dict(
                name="gathered_patch_attention", route="cuda", math=WGMMA,
                source="retrieval_fuse_tpu_torch/csrc/gathered_attention.cu",
                replaces="retrieval_fuse_tpu/ops/pallas_attention.py:249", max_abs_err=err,
                ms=cuda_ms(lambda: pa.gathered_patch_attention(*args16), 5),
                plain_ms=cuda_ms(lambda: pa.gathered_patch_attention_plain(*args16), 3),
                library_ms=None, bound_ms=attn_bound[0], bound_by=attn_bound[1],
                f32_ms=cuda_ms(lambda: pa.gathered_patch_attention(
                    xt32, bank32, top_idx, theta32, phi32, k), 3),
                earlier_ms=EARLIER_KERNEL_MS["attention"],
                bf16_agreement=share16, shape=f"Q={q} T={t_rows} F={f} K={k} bf16")

            # gathered attention v1 (kernel 5): the same function and inputs
            err, share16, _ = hold_attention(
                f"gathered attention v1 Q={q}", pa.gathered_patch_attention_v1,
                pa.gathered_patch_attention_v1_plain,
                (xt32, bank32, top_idx, theta32, phi32, k), args16, "mma.bf16")
            kernels["attention_v1"] = dict(
                name="gathered_patch_attention_v1", route="cuda", math="mma.bf16",
                source="retrieval_fuse_tpu_torch/csrc/gathered_attention_v1.cu",
                replaces="retrieval_fuse_tpu/ops/pallas_attention.py:151", max_abs_err=err,
                ms=cuda_ms(lambda: pa.gathered_patch_attention_v1(*args16), 5),
                plain_ms=cuda_ms(lambda: pa.gathered_patch_attention_v1_plain(*args16), 3),
                library_ms=None, bound_ms=attn_bound[0], bound_by=attn_bound[1],
                f32_ms=cuda_ms(lambda: pa.gathered_patch_attention_v1(
                    xt32, bank32, top_idx, theta32, phi32, k), 3),
                earlier_ms=EARLIER_KERNEL_MS["attention_v1"],
                bf16_agreement=share16, shape=f"Q={q} T={t_rows} F={f} K={k} bf16")

            # patch attention (kernel 4) at the `pallasp` shape: N = Q·T rows,
            # each with its K candidate rows gathered (K and T swapped)
            n_rows = q * t_rows
            p16 = bank16[top_idx.long()].transpose(1, 2).reshape(n_rows, k, f).contiguous()
            x16 = xt16.reshape(n_rows, f)
            err, share16, _ = hold_attention(
                f"patch attention N={n_rows}", pa.patch_attention, pa.patch_attention_plain,
                (x16.float(), p16.float(), theta32, phi32, k),
                (x16, p16, att.theta, att.phi, k), WGMMA)
            pargs16 = (x16, p16, att.theta, att.phi, k)
            kernels["patch_attention"] = dict(
                name="patch_attention", route="cuda", math=WGMMA,
                source="retrieval_fuse_tpu_torch/csrc/patch_attention.cu",
                replaces="retrieval_fuse_tpu/ops/pallas_attention.py:46", max_abs_err=err,
                ms=cuda_ms(lambda: pa.patch_attention(*pargs16), 5),
                plain_ms=cuda_ms(lambda: pa.patch_attention_plain(*pargs16), 3),
                library_ms=None, bound_ms=attn_bound[0], bound_by=attn_bound[1],
                f32_ms=cuda_ms(lambda: pa.patch_attention(
                    x16.float(), p16.float(), theta32, phi32, k), 3),
                earlier_ms=EARLIER_KERNEL_MS["patch_attention"],
                bf16_agreement=share16, shape=f"N={n_rows} K={k} F={f} bf16")
            del xt32, bank32, p16
            # the shipped body's edges: a ragged last tile, K 1 and K 8
            t0 = time.perf_counter()
            held = hold_shipped_edges(dev, args.seed + 3)
            log(f"edge holds ({', '.join(held)}): {time.perf_counter() - t0:.2f} s")

        # 4f) the decoder tail (kernel 6) at batch 128 on the input the cdec
        # decoder makes from the FAST_VARIANT engine's fused features
        with torch.inference_mode():
            cdec = {tag: engines[CDEC_VARIANT, tag].fused_decoder for tag in ("bf16", "f32")}
            hn = {}
            for tag, eng in (("bf16", fast), ("f32", fast32)):
                xb = ((x128 - eng.in_mean) / eng.in_std).to(eng.compute_dtype)
                hn[tag] = cdec[tag].tail_input(
                    eng._attend(eng.unet_backbone(xb), eng.retrieve(x128), STREAM_BATCH))
            errs = {}
            for tag in ("f32", "bf16"):
                d = cdec[tag]
                got = dt.decoder_tail(hn[tag], d.w2_dhwio, d.w_final, d.bias_h)
                math = {"f32": "fma.f32", "bf16": "mma.bf16"}[tag]
                check(dt.decoder_tail.math == math,
                      f"decoder tail {tag}: launch took {dt.decoder_tail.math}, not {math}")
                want = dt.decoder_tail_plain(hn[tag], d.w2_dhwio, d.w_final, d.bias_h)
                torch.cuda.synchronize()
                diff = (got - want).abs()
                errs[tag] = float(diff.max())
                check(errs[tag] <= (1e-4 if tag == "f32" else 1e-2),
                      f"decoder tail {tag}: max |diff| {errs[tag]}")
                log(f"decoder tail {tag} [{math}] B={STREAM_BATCH} S={hn[tag].shape[1] - 2}: "
                    f"max |diff| {errs[tag]:.2e}, mean {float(diff.mean()):.2e}")
            d, h16 = cdec["bf16"], hn["bf16"]
            b_, s2 = h16.shape[0], 2 * (h16.shape[1] - 2)
            nf = cfg["nf"]
            # the library yardstick: cuDNN's conv3d of conv2 alone on the
            # unpacked (B, nf, 2S, 2S, 2S) tensor, as the plain decoder runs it
            h2x = depth_to_space_2x(h16[:, 1:-1, 1:-1, 1:-1], nf).permute(0, 4, 1, 2, 3) \
                .contiguous()
            dargs = (h16, d.w2_dhwio, d.w_final, d.bias_h)
            tail_bound = decoder_tail_bound(h16, nf)
            kernels["decoder_tail"] = dict(
                name="decoder_tail", route="cuda", math="mma.bf16",
                source="retrieval_fuse_tpu_torch/csrc/decoder_tail.cu",
                replaces="retrieval_fuse_tpu/ops/pallas_decoder.py:94", max_abs_err=errs["f32"],
                ms=cuda_ms(lambda: dt.decoder_tail(*dargs), 5),
                plain_ms=cuda_ms(lambda: dt.decoder_tail_plain(*dargs), 3),
                library_ms=cuda_ms(lambda: F.conv3d(h2x, d.w2, padding=1), 10),
                library_call="F.conv3d of conv2 alone on the unpacked tensor (cuDNN)",
                bound_ms=tail_bound[0], bound_by=tail_bound[1], bf16_max_abs_err=errs["bf16"],
                f32_ms=cuda_ms(lambda: dt.decoder_tail(
                    hn["f32"], cdec["f32"].w2_dhwio, cdec["f32"].w_final, cdec["f32"].bias_h), 3),
                shape=f"B={b_} S={s2 // 2} nf={nf} bf16")
            del hn, h2x
        for kr in kernels.values():
            lib_ms = "none" if kr["library_ms"] is None else f"{kr['library_ms']:.3f} ms"
            math = f" [{kr['math']}]" if "math" in kr else ""
            if "earlier_ms" in kr:
                math += f" ({kr['earlier_ms']:.3f} ms before its redesign)"
            log(f"{kr['name']}{math}: kernel {kr['ms']:.3f} ms, plain {kr['plain_ms']:.3f} ms, "
                f"library {lib_ms}, bound {kr['bound_ms']:.3f} ms ({kr['bound_by']}) "
                f"[{kr['shape']}; {card}]")

        stamp("kernels 4a-4f")
        # 5) serve through serve_directory: FAST_VARIANT bf16 at batch 64 and
        # 128, DENSE_VARIANT at batch 64, and the cdec variant at batch 128
        serving = {}
        with tempfile.TemporaryDirectory() as tmp:
            indir = Path(tmp) / "in"
            indir.mkdir()
            for j, vol in enumerate(chunks):
                np.savez_compressed(indir / f"chunk{j:04d}.npz", arr=vol)
            for variant, batch, needed in (
                    (FAST_VARIANT, DENSE_BATCH, ("knn_bf16", "attention")),
                    (DENSE_VARIANT, DENSE_BATCH, ("topk", "attention")),
                    (FAST_VARIANT, STREAM_BATCH, ("knn_bf16", "attention")),
                    (CDEC_VARIANT, STREAM_BATCH, ("knn_bf16", "patch_attention",
                                                  "decoder_tail"))):
                eng = engines[variant, "bf16"]
                eng(chunks[:batch, ..., None])  # warm-up: cuDNN plans, allocator
                outdir = Path(tmp) / f"out-{variant}-{batch}"
                t0 = time.perf_counter()
                done, counts = drive(f"serve {variant} batch {batch}", needed,
                                     lambda: serve_directory(eng, indir, outdir,
                                                             batch_size=batch))
                wall = time.perf_counter() - t0
                check(len(done) == len(chunks), f"batch {batch}: served {len(done)} chunks")
                preds = [np.load(outdir / f"{s}_pred.npz")["arr"] for s in done]
                for p_ in preds:
                    check(p_.shape == (64, 64, 64) and np.isfinite(p_).all()
                          and p_.min() >= -1e-3 and p_.max() <= fast.target_trunc + 1e-3,
                          f"batch {batch}: served TSDF out of shape or range")
                xb = chunks[:batch, ..., None]
                engine_ms = cuda_ms(lambda: eng(xb), 5)
                served = np.stack(preds[:batch]).astype(np.float32)
                # float16 files; cuDNN may pick another algorithm between calls
                served_err = float(np.abs(served - eng(xb)[..., 0].cpu().numpy()).mean())
                check(served_err <= 1e-4, f"batch {batch}: served files differ by {served_err}")
                rec = dict(served_chunks_per_s=len(done) / wall, engine_ms=engine_ms,
                           engine_chunks_per_s=batch / (engine_ms / 1e3), launches=counts)
                if variant == FAST_VARIANT:
                    rec.update(tsdf_check(variant, xb))
                serving[f"{variant}@{batch}"] = rec
                was = ""
                if batch == STREAM_BATCH and variant in FMA_BODY_ENGINE_MS:
                    rec["fma_body_engine_ms"] = FMA_BODY_ENGINE_MS[variant]
                    was = (f" ({FMA_BODY_ENGINE_MS[variant]:.2f} ms with the float32-FMA "
                           f"tail and attention body)")
                log(f"serve {variant} batch {batch}: {len(done)} chunks, "
                    f"{len(done) / wall:.1f} chunks/s through serve_directory (npz I/O "
                    f"included), engine {engine_ms:.2f} ms/batch{was} = "
                    f"{batch / (engine_ms / 1e3):.1f} chunks/s; launches {counts} [{card}]")
        results["serving"] = serving

        # 6) the engine's other serving paths at batch 128, bf16 and float32
        xb = chunks[:STREAM_BATCH, ..., None]
        paths = {}
        for variant, needed in VARIANT_PATHS.items():
            _, counts = drive(variant, needed, lambda: [engines[variant, tag](xb)
                                                        for tag in ("bf16", "f32")])
            rec = tsdf_check(variant, xb)
            eng = engines[variant, "bf16"]
            rec.update(engine_ms=cuda_ms(lambda: eng(xb), 3), launches=counts)
            rec["engine_chunks_per_s"] = STREAM_BATCH / (rec["engine_ms"] / 1e3)
            paths[variant] = rec
            was = ""
            if variant in FMA_BODY_ENGINE_MS:
                rec["fma_body_engine_ms"] = FMA_BODY_ENGINE_MS[variant]
                was = f" ({FMA_BODY_ENGINE_MS[variant]:.2f} ms on float32 FMAs)"
            log(f"path {variant} batch {STREAM_BATCH}: engine {rec['engine_ms']:.2f} ms/batch{was} "
                f"bf16 = {rec['engine_chunks_per_s']:.1f} chunks/s; launches {counts} [{card}]")
        results["paths"] = paths

        stamp("serving 5-6")
        # 4g) the attention kernels at F = 32 and 64: the flagship geometry at
        # nf 4 and 8, served (through `drive`) and held against the plain
        # versions; its draws come from a generator of its own, so that the
        # later phases' data are what they were without it
        t4g = time.perf_counter()
        results["narrow_widths"] = run_narrow_widths(
            dev, np.random.default_rng([args.seed, 4]), args.seed, kernels, counters, drive,
            card, chunks)
        results["phase4g_s"] = time.perf_counter() - t4g
        log(f"phase 4g (nf 4 and 8): {results['phase4g_s']:.1f} s")

        stamp("4g")
        # 4h) the kernels past their shipped shapes: the flagship geometry at
        # nf 24, K 12 through its paths, and each widened kernel held against
        # its plain version at the new shapes; a generator of its own
        t4h = time.perf_counter()
        results["wide_widths"] = run_wide_widths(
            dev, np.random.default_rng([args.seed, 16]), args.seed, kernels, counters, drive,
            card, chunks)
        results["phase4h_s"] = time.perf_counter() - t4h
        log(f"phase 4h (nf {WIDE_NF}, K {WIDE_K} and the widened kernels' shapes): "
            f"{results['phase4h_s']:.1f} s")
        stamp("4h")
        # 7) the retrieval trainer, then the retrieval pipeline (map ->
        # compose -> evaluate) with its checkpoint, then serving from those
        # artifacts, at the full width of ShapeNetV2's configs, on a synthetic
        # dataset whose dictionary reaches the flagship database's rows
        retrieval, training, refine, from_artifacts = {}, {}, {}, {}
        with tempfile.TemporaryDirectory() as tmp:
            root = Path(tmp)
            t0 = time.perf_counter()
            made = write_retrieval_dataset(root / "data", rng, RETRIEVAL_MIN_ROWS,
                                           RETRIEVAL_VAL_CHUNKS, dev)
            retrieval["data_s"] = time.perf_counter() - t0
            log(f"retrieval data: {len(made['train'])} train and {len(made['val'])} val chunks "
                f"(64³ targets, 8³ inputs) made and written in {retrieval['data_s']:.1f} s")
            cwd = os.getcwd()
            os.chdir(root)  # runs/ (metrics, checkpoints, the dictionary's scratch tree)
            try:
                # 7a) the retrieval trainer: its first steps against the CPU,
                # steps/s through fit, one epoch through its CLI, one validation
                tcfg = dict(retrieval_config(root / "data", ""), seed=args.seed,
                            experiment="chip_smoke_steps")
                before = {name: c.launches for name, c in counters.items()}
                t0 = t_train = time.perf_counter()
                trainer, step_losses, grad_err, tf32_err = hold_train_steps(
                    tcfg, dev, TRAIN_HOLD_STEPS)
                check({name: c.launches for name, c in counters.items()} == before,
                      "the train steps launched a kNN, topk or chamfer kernel")
                training.update(hold_s=time.perf_counter() - t0, hold_losses=step_losses,
                                hold_grad_err=grad_err, hold_tf32_err=tf32_err,
                                batch=trainer.batch_size,
                                train_patches=len(trainer.train_dataset))
                log(f"train steps 1-{TRAIN_HOLD_STEPS} on the card against the CPU (float32, "
                    f"TF32 off): losses {[round(a, 6) for a, _ in step_losses]} within 1e-5 "
                    f"relative, step-1 gradients within {grad_err:.1e} of each tensor's "
                    f"largest magnitude (<= "
                    f"{TRAIN_GRAD_TOL[tcfg['retrieval_model']['network_target']]:g}; with TF32 "
                    f"on {tf32_err:.1e}); no kernel launched")
                # device time of a step on a resident batch (no loader)
                resident = trainer._device_batch(first_batches(
                    trainer.train_dataset, trainer.batch_size, 1)[0])
                training["step_device_ms"] = cuda_ms(
                    lambda: trainer._train_step(resident, trainer.current_learning_rate), 10)
                del trainer, resident
                # one epoch through the CLI, which saves its checkpoint; its
                # fit is timed (synchronised) for steps/s, loader included
                cfg_path = root / "retrieval.yaml"
                cfg_path.write_text(yaml.safe_dump(retrieval_config(root / "data", "")))
                os.environ.pop("experiment", None)
                fit, fit_s = RetrievalTrainer.fit, []

                def timed_fit(self, *a, **kw):
                    torch.cuda.synchronize()
                    t_fit = time.perf_counter()
                    out = fit(self, *a, **kw)
                    torch.cuda.synchronize()
                    fit_s.append(time.perf_counter() - t_fit)
                    return out

                t0 = time.perf_counter()
                try:
                    RetrievalTrainer.fit = timed_fit
                    trainer, counts = drive("train CLI epoch", (), lambda: train_main([
                        "--config", str(cfg_path), "--max_epoch", "1", "--val_check_interval",
                        "100", "--seed", str(args.seed), "--experiment", "chip_smoke_train"]))
                finally:
                    RetrievalTrainer.fit = fit
                    os.environ.pop("experiment", None)
                run = Path("runs") / trainer.config["experiment"]
                recs = [json.loads(line) for line in (run / "metrics.jsonl").read_text()
                        .splitlines()]
                ckpt = (run / "ckpt_epoch=0").resolve()
                training.update(main_s=time.perf_counter() - t0, epoch_steps=trainer.global_step,
                                fit_s=fit_s[0], steps_per_s=trainer.global_step / fit_s[0],
                                first_loss=step_losses[0][0],
                                last_loss=recs[-1]["train/total_loss"], launches=counts)
                check(trainer.global_step == training["train_patches"] // trainer.batch_size
                      and np.isfinite(training["last_loss"]) and (ckpt / "params.pt").exists(),
                      f"train CLI epoch: {trainer.global_step} steps, last loss "
                      f"{training['last_loss']}, checkpoint {ckpt}")
                log(f"train CLI epoch (retrieval_trainer.main): {trainer.global_step} steps in "
                    f"{training['main_s']:.1f} s wall (construction, data and checkpoint "
                    f"included); loss {training['first_loss']:.4f} (step 1) -> "
                    f"{training['last_loss']:.4f} (step {trainer.global_step}); launches "
                    f"{counts} [{card}]")
                log(f"train steps: {training['steps_per_s']:.2f} steps/s of batch "
                    f"{training['batch']} through the CLI's fit ({trainer.global_step} steps "
                    f"in {training['fit_s']:.1f} s, loader and checkpoint included, "
                    f"synchronised); {training['step_device_ms']:.2f} ms a step on a "
                    f"resident batch [{card}]")
                t0 = time.perf_counter()
                training["val_loss"] = trainer.validate(0, run_retrieval_validation=False)
                # 10c) the CLI's trainer visualises (enable_vis): the val_vis
                # scenes' meshes and previews after the metrics, counted by
                # log_images in the run's metrics stream
                check(trainer.enable_vis, "train CLI: the trainer's visualisations are off")
                vis_spent, vlog = {}, MetricsLogger(trainer.config["experiment"])
                with timed_attrs(trainer, ("_visualize",), vis_spent):
                    val_metrics, counts = drive("train validation", ("chamfer",),
                                                lambda: trainer.retrieval_validation(0, vlog))
                vlog.close()
                training.update(validation_s=time.perf_counter() - t0,
                                validation_launches=counts, metrics=val_metrics,
                                visualization_s=vis_spent["_visualize"])
                check(counts.get("knn", 0) + counts.get("topk", 0) > 0,
                      f"train validation launched no kNN or topk kernel: {counts}")
                vdir = run / "visualization" / "epoch_0000"
                vis_scenes = sorted(trainer.dataset("val_vis").scenes)
                logged = [json.loads(line) for line in (run / "metrics.jsonl").read_text()
                          .splitlines() if "visualization/count" in line]
                check(sorted(p_.name for p_ in (vdir / "visualization_val_vis").iterdir())
                      == sorted(f"{sc}{suffix}" for sc in vis_scenes
                                for suffix in ("_gt.obj", "_pred.obj", "_input.obj"))
                      and sorted(p_.stem for p_ in (vdir / "render_val_vis").glob("*.png"))
                      == vis_scenes and len(vis_scenes) == 2
                      and [r["visualization/count"] for r in logged] == [2],
                      f"train validation visualisations: {vis_scenes}, logged {logged}")
                log(f"train validation visualisations: {len(vis_scenes)} val_vis scenes as "
                    f"_input/_pred/_gt OBJs and one PNG each, log_images counted "
                    f"{logged[0]['visualization/count']:.0f}; {vis_spent['_visualize']:.1f} s "
                    f"of the validation (host) [{card}]")
                check(np.isfinite(training["val_loss"])
                      and all(np.isfinite(v) for m in val_metrics.values() for v in m),
                      f"train validation: val loss {training['val_loss']}, {val_metrics}")
                log(f"train validation: val loss {training['val_loss']:.4f}; val [iou, "
                    f"chamfer, precision, recall] = {val_metrics['val']}; "
                    f"{training['validation_s']:.1f} s wall; launches {counts} [{card}]")
                del trainer
                training["phase_s"] = time.perf_counter() - t_train
                rcfg = retrieval_config(root / "data", ckpt)

                stamp("7a")
                # 7b) the retrieval pipeline with the trained checkpoint; the
                # C++ paste's seconds in compose are timed for 10d
                outs, paste_spent = {}, {}
                for mode, needed in (("map", ("knn",)), ("compose", ()),
                                     ("evaluate", ("chamfer",))):
                    t0 = time.perf_counter()
                    with timed_attrs(native, ("compose_paste",), paste_spent):
                        outs[mode], counts = drive(f"retrieval {mode}", needed,
                                                   lambda: retrievals_to_disk(mode, rcfg,
                                                                              device=dev))
                    retrieval[f"{mode}_s"] = time.perf_counter() - t0
                    retrieval[f"{mode}_launches"] = counts
                    log(f"retrieval {mode}: {retrieval[f'{mode}_s']:.1f} s wall; launches "
                        f"{counts} [{card}]")
                tree, rdir = root / get_tree_path(rcfg), get_retrievals_dir(rcfg)
                n_rows = np.load(tree / "database.npy", mmap_mode="r").shape[0]
                maps = {split: np.load(rdir / f"map_{split}.npy", allow_pickle=True)[()]
                        for split in ("train", "val")}
                n_q = {split: len(m) for split, m in maps.items()}
                q_batch = query_batch_size(n_rows)
                full = n_q["train"] // q_batch
                # the float32 query batches of both splits that cross over to the kernel
                streamed = sum(use_streaming_knn(n_rows, n_queries=min(q_batch, m - s))
                               for m in n_q.values() for s in range(0, m, q_batch))
                retrieval.update(database_rows=n_rows, queries=n_q, metrics=outs["evaluate"])
                log(f"retrieval: database {n_rows} rows, {n_q['train']} train queries "
                    f"({full} full {q_batch}-query batches), {n_q['val']} val queries; "
                    f"{streamed} batches cross over to the kNN kernel; metrics "
                    f"[iou, chamfer, precision, recall] = {outs['evaluate']}")
                check(n_rows >= RETRIEVAL_MIN_ROWS, f"retrieval: {n_rows} database rows")
                check(full >= 2 and retrieval["map_launches"].get("knn") == streamed,
                      f"retrieval map: {retrieval['map_launches']} kNN launches for {streamed} "
                      "query batches at or above the crossover")
                ds_train = PatchedSceneDataset("train", rcfg["dataset_train"],
                                               SceneHandler("train", rcfg))
                near = check_mapping(rcfg, tree, maps["train"], ds_train, rng, MAP_SAMPLE, dev)
                retrieval["map_near_ties"] = near
                log(f"retrieval map: {MAP_SAMPLE} sampled train queries equal a dense float32 "
                    f"search with demotion, {near} near-tie queries (top 2K+1 distances "
                    f"within 1e-5) excluded")

                # the evaluate shape: one (target, 1-NN) point-set pair per val scene
                ds_val = PatchedSceneDataset("val", rcfg["dataset_val"], SceneHandler("val", rcfg))
                nn1 = np.stack([np.load(rdir / "compose" / f"{s}.npz")["arr_0"][:1]
                                for s in ds_val.scenes])
                thr = 0.75 * ds_val.target_voxel_size
                occ = [(torch.from_numpy(ds_val.get_scene_target(s) <= thr).to(dev),
                        torch.from_numpy(nn1[i, 0] <= thr).to(dev))
                       for i, s in enumerate(ds_val.scenes)]
                occ = [(t, p) for t, p in occ if t.any() and p.any()]
                check(retrieval["evaluate_launches"].get("chamfer", 0) == len(occ),
                      f"retrieval evaluate: {retrieval['evaluate_launches']} chamfer launches "
                      f"for {len(occ)} val scenes with both point sets non-empty")
                chamfer_batch_kernel = metrics_mod.chamfer_batch
                try:  # the same metrics with the plain chamfer on the card
                    metrics_mod.chamfer_batch = chamfer_batch_plain
                    plain_metrics = get_metrics_for_retrieval(nn1, ds_val, device=dev)
                finally:
                    metrics_mod.chamfer_batch = chamfer_batch_kernel
                for got, want in zip(outs["evaluate"], plain_metrics):
                    check(np.isfinite(got) and abs(got - want) <= 1e-6 * abs(want),
                          f"retrieval evaluate: metrics {outs['evaluate']} against "
                          f"{plain_metrics} with the plain chamfer")
                log(f"retrieval evaluate: metrics equal the plain chamfer's within 1e-6 "
                    f"relative ({plain_metrics})")
                for got, want in zip(outs["evaluate"], training["metrics"]["val"]):
                    check(abs(got - want) <= 1e-6 * abs(want),
                          f"retrieval evaluate: metrics {outs['evaluate']} against the "
                          f"trainer's val metrics {training['metrics']['val']}")
                log("retrieval evaluate: metrics equal the trainer's retrieval validation's "
                    "val metrics within 1e-6 relative")

                stamp("7b")
                # 7d) the refinement trainer at the full width of ShapeNetV2's
                # refinement config, on phase 7's chunks and 7b's composed
                # retrievals: one step of each phase held against the CPU,
                # the curriculum through train_refinement_phases, each phase's
                # step on a resident batch, a validation and the checkpoint
                t_refine = time.perf_counter()
                fcfg = dict(refinement_config(root / "data", ckpt), seed=args.seed,
                            experiment="chip_smoke_refine")
                before = {name: c.launches for name, c in counters.items()}
                t0 = time.perf_counter()
                refine["hold"] = hold_refine_steps(fcfg, dev, args.seed + 4)
                init = refine["hold"].pop("init")
                check({name: c.launches for name, c in counters.items()} == before,
                      "the refinement steps launched a kernel")
                refine["hold_s"] = time.perf_counter() - t0
                log_refine_hold(refine["hold"], "refine steps", card)
                log(f"refine steps: no kernel launched; {refine['hold_s']:.1f} s [{card}]")

                # the curriculum through train_refinement_phases: two epochs a
                # phase of REFINE_STEPS / 2 steps, a checkpoint at each phase's
                # end only, phase 2 on the frozen cache, from the seeded
                # weights. Its logger (metrics.jsonl) gives each epoch's last
                # loss and the time after it, so each phase's second epoch
                # times REFINE_STEPS / 2 steps through fit. Phase 2 trains only
                # where phase 0's decoder opens the occupancy gate: its losses
                # must be > 0 and its attention must move
                ccfg = dict(fcfg, phase_change_epochs=[2, 2, 2], max_epoch=2, save_epoch=2,
                            val_check_interval=100, frozen_phase_cache=True)
                half = REFINE_STEPS // 2
                t0 = time.perf_counter()
                refiner, counts = drive("refine curriculum", (), lambda: train_refinement_phases(
                    ccfg, max_steps_per_epoch=half, device=dev))
                refine["curriculum_s"] = time.perf_counter() - t0
                check(not counts, f"the refinement curriculum launched kernels: {counts}")
                run_dir = Path("runs") / ccfg["experiment"]
                recs = [r for r in map(json.loads, (run_dir / "metrics.jsonl").read_text()
                                       .splitlines()) if "train/total_loss" in r]
                check([(r["phase"], r["epoch"]) for r in recs]
                      == [(ph, e) for ph in range(4) for e in range(2)]
                      and [r["_step"] for r in recs] == [half * (i + 1) for i in range(8)],
                      f"refine curriculum: train records {[(r['phase'], r['epoch'], r['_step']) for r in recs]}")
                refine["phases"] = {}
                for ph in range(4):
                    r0, r1 = recs[2 * ph], recs[2 * ph + 1]
                    losses = [r0["train/total_loss"], r1["train/total_loss"]]
                    check(all(np.isfinite(losses)) and (ph != 2 or min(losses) > 0),
                          f"refine phase {ph}: losses {losses} after steps {half} and "
                          f"{2 * half}" + (" (a zero phase-2 loss: the contrastive gate "
                                           "is shut)" if ph == 2 else ""))
                    dt = r1["_time"] - r0["_time"]
                    refine["phases"][ph] = dict(epoch_s=dt, steps=half, steps_per_s=half / dt,
                                                loss_half=losses[0], loss_last=losses[1])
                    log(f"refine phase {ph} through fit: its second epoch, {half} steps of "
                        f"batch {refiner.batch_size}, in {dt:.3f} s = {half / dt:.2f} steps/s "
                        f"(loader included); loss {losses[0]:.4f} (step {half}) -> "
                        f"{losses[1]:.4f} (step {2 * half}) [{card}]")
                # each phase's end: phase 0's is overwritten by later phases'
                # epoch numbering (as in the JAX trainer), so phases 0-1 are
                # read together against the seeded weights
                ends = {ph: load_checkpoint(run_dir / f"ckpt_epoch={2 * ph + 1}")
                        for ph in (1, 2, 3)}
                check(sorted(p_.name for p_ in run_dir.glob("ckpt_epoch=*"))
                      == [f"ckpt_epoch={e}" for e in (1, 3, 5, 7)]
                      and [ends[ph]["opt_state"]["phase"] for ph in (1, 2, 3)] == [1, 2, 3],
                      f"refine curriculum: checkpoints {sorted(run_dir.iterdir())}")
                for label, old, new_, want in (
                        ("phases 0-1", init, ends[1]["params"],
                         {"unet_backbone", "decoder", "retrieval_backbone"}),
                        ("phase 2", ends[1]["params"], ends[2]["params"],
                         {"patched_attention_block"}),
                        ("phase 3", ends[2]["params"], ends[3]["params"], set(init))):
                    moved = {n for n, sd in new_.items()
                             if any(not torch.equal(v.cpu(), old[n][k].cpu())
                                    for k, v in sd.items())}
                    check(moved == want, f"refine curriculum: {label} changed {sorted(moved)}, "
                                         f"not {sorted(want)}")
                log("refine curriculum: phases 0-1 changed the backbone, the decoder and the "
                    "retrieval backbone, phase 2 the attention alone, phase 3 all four "
                    "(checkpoints at each phase's end against the seeded weights)")
                trained = {n: {k: v.detach().cpu().clone() for k, v in sd.items()}
                           for n, sd in refiner.params().items()}
                fckpt = (run_dir / "ckpt_epoch=7").resolve()

                # the frozen phase-2 cache as fit builds it, timed
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                cache = refiner.build_phase2_cache()
                torch.cuda.synchronize()
                cache_info = dict(s=time.perf_counter() - t0, on_device=isinstance(cache, dict))
                check(cache_info["on_device"], "the phase-2 cache took the host path")
                cache_info["gb"] = sum(v.numel() * v.element_size() for v in cache.values()) / 1e9
                refine["cache"] = cache_info
                log(f"refine phase-2 cache (as fit builds it): {len(refiner.train_dataset)} "
                    f"items, {cache_info['gb']:.2f} GB on the device, built in "
                    f"{cache_info['s']:.1f} s [{card}]")

                # a validation of the trained networks: the chamfer kernel only
                t0 = time.perf_counter()
                refine["metrics"], counts = drive("refine validation", ("chamfer",),
                                                  refiner.validate)
                refine.update(validation_s=time.perf_counter() - t0, validation_launches=counts)
                check(set(counts) == {"chamfer"},
                      f"refine validation launched {counts}, not the chamfer kernel alone")
                check(all(np.isfinite(m[k]) for m in refine["metrics"].values()
                          for k in ("iou", "precision", "recall")),
                      f"refine validation metrics {refine['metrics']}")
                # 10c) the refinement trainer's visualisation after its
                # validation, and the 2x upsample of fast_visualization False
                # on the card against the CPU's
                t0 = time.perf_counter()
                vis_dir = refiner.run_visualization("val")
                refine["visualization_s"] = time.perf_counter() - t0
                vis_ds = refiner.dataset("val_vis")
                check(sorted(p_.name for p_ in vis_dir.iterdir())
                      == sorted(f"{sc}{suffix}" for sc in vis_ds.scenes
                                for suffix in ("_gt.obj", "_fuse.obj", "_input.obj")),
                      f"refine run_visualization: {sorted(vis_dir.iterdir())}")
                vol = vis_ds.get_scene_target(vis_ds.scenes[0]).astype(np.float32)
                up_err = float((trilinear_upsample_2x(torch.from_numpy(vol).to(dev)).cpu()
                                - trilinear_upsample_2x(torch.from_numpy(vol))).abs().max())
                check(up_err <= 1e-6, f"trilinear_upsample_2x: card vs CPU max |diff| {up_err}")
                slow = SceneHandler("val", dict(fcfg, fast_visualization=False))
                slow.visualize_target_chunk(vol, root / "target_2x.obj", device=dev)
                check("\nf " in (root / "target_2x.obj").read_text(),
                      "fast_visualization False: an empty mesh")
                refine["upsample_max_diff"] = up_err
                log(f"refine run_visualization('val'): {len(vis_ds.scenes)} val_vis scenes as "
                    f"_gt/_fuse/_input OBJs in {refine['visualization_s']:.1f} s; "
                    f"trilinear_upsample_2x (fast_visualization False) on the card within "
                    f"{up_err:.1e} of the CPU's (<= 1e-6) [{card}]")
                for key, m in refine["metrics"].items():
                    log(f"refine validation {key}: iou {m['iou']:.4f}, cd {m['cd']:.4f}, "
                        f"precision {m['precision']:.4f}, recall {m['recall']:.4f}, "
                        f"f1 {m['f1']:.4f}")
                log(f"refine validation: {len(refiner.val_dataset)} val and "
                    f"{len(refiner.dataset('train_eval'))} train_eval chunks at batch "
                    f"{refiner.batch_size} in {refine['validation_s']:.1f} s; launches "
                    f"{counts} [{card}]")
                loaded = RefinementTrainer(dict(fcfg), device=dev)
                loaded.load(fckpt, params_only=False)
                check(all(torch.equal(v.cpu(), trained[n][k]) for n, sd in loaded.params().items()
                          for k, v in sd.items()) and loaded.global_step == refiner.global_step,
                      "refine checkpoint: loaded parameters differ from the trained ones")
                log(f"refine checkpoint {fckpt.name}: parameters bit-equal after load "
                    f"(with its optimizer state), global step {loaded.global_step}")
                del loaded

                # the cached phase-2 step (the cache's first 8 items) against
                # the direct one on the same trained parameters and items
                bs = refiner.batch_size
                batch8 = refiner._device_batch(next(iter(batch_iterator(
                    refiner.train_dataset, bs, shuffle=False, prefetch=0))))
                cb = {k: v[:bs] for k, v in cache.items()}
                del cache
                got = step_gradients(refiner, 2, cb, cached=True)
                want = step_gradients(refiner, 2, batch8)
                check(float(want[0]) > 0, "refine cached phase 2: the direct step's loss is 0 "
                                          "(the contrastive gate is shut)")
                share, where = grad_share(got[2], want[2])
                rel = abs(float(got[0]) - float(want[0])) / float(want[0])
                check(rel <= 1e-5 and share <= 1e-4,
                      f"refine cached phase 2: loss {float(got[0])} vs {float(want[0])}, "
                      f"gradient {where} {share:.2e}")
                refine["cache_hold"] = dict(loss_rel=rel, grad_share=share)
                log(f"refine cached phase-2 step vs direct (batch {bs}): loss "
                    f"{float(got[0]):.6f} within {rel:.1e} relative, gradients within "
                    f"{share:.1e} of the attention's largest")

                # each phase's step on a resident batch of 8 (CUDA events),
                # and the device's idle share over one traced step
                refine["resident"] = {}
                lr = refiner.base_lr
                steps = {0: lambda: refiner.train_step(batch8, lr),
                         1: lambda: refiner.train_step(batch8, lr),
                         2: lambda: refiner.train_step(batch8, lr),
                         "2 cached": lambda: refiner.train_step(cb, lr, cached=True),
                         3: lambda: refiner.train_step(batch8, lr)}
                for ph, fn in steps.items():
                    refiner.set_phase(int(str(ph)[0]))
                    ms = cuda_ms(fn, 3 if ph == 3 else 5)
                    busy, wall = device_busy(fn)
                    refine["resident"][str(ph)] = dict(ms=ms, kernel_ms=busy, wall_ms=wall,
                                                       idle=1 - busy / wall)
                    log(f"refine phase {ph} step on a resident batch of {refiner.batch_size}: "
                        f"{ms:.2f} ms (CUDA events); traced: kernels {busy:.2f} ms of "
                        f"{wall:.2f} ms, idle {1 - busy / wall:.1%} [{card}]")
                del refiner, cb, batch8, got, want
                refine["phase_s"] = time.perf_counter() - t_refine
                log(f"phase 7d (refinement training) {refine['phase_s']:.1f} s wall: hold "
                    f"{refine['hold_s']:.1f} s, curriculum {refine['curriculum_s']:.1f} s, "
                    f"cache {refine['cache']['s']:.1f} s, validation "
                    f"{refine['validation_s']:.1f} s [{card}]")

                stamp("7d")
                # 7c) serving from the artifacts: phase 7's dictionary and train
                # scenes, the trained retrieval checkpoint and the refinement
                # checkpoint that 7d trained
                t_serve = time.perf_counter()
                scfg = serving_config(root / "data", ckpt)
                sparams = load_checkpoint(fckpt)["params"]
                database = np.load(tree / "database.npy")
                scene_list = json.loads((tree / "index.json").read_text())
                rtrained = load_checkpoint(ckpt)["params"]
                from_artifacts["min_cos"] = serve.verify_bank_database_alignment(
                    scfg, rtrained["fenc_target"], database, scene_list, ds_train, device=dev)
                art, t0 = {}, time.perf_counter()
                for dtype, tag in ((torch.bfloat16, "bf16"), (torch.float32, "f32")):
                    art[tag] = serve.build_engine_from_artifacts(
                        scfg, ckpt, fckpt, compute_dtype=dtype, device=dev, variant=FAST_VARIANT)
                torch.cuda.synchronize()
                from_artifacts["build_s"] = time.perf_counter() - t0
                bank = serve.build_patch_bank_from_database(database, scene_list, ds_train)
                mparams = dict(sparams, fenc_input=rtrained["fenc_input"])
                mem = {tag: RetrieveRefineEngine(scfg, mparams, database[:, 7:], bank,
                                                 compute_dtype=dtype, device=dev, **kw)
                       for tag, dtype, kw in (
                           ("f32", torch.float32, variant_engine_kwargs(FAST_VARIANT)),
                           ("base_bf16", torch.bfloat16, {}))}
                del bank
                vin = root / "serve_in"
                vin.mkdir()
                for name in made["val"]:
                    (vin / f"{name}.npz").symlink_to(root / "data" / "sdf_008" / "SynthSet"
                                                     / f"{name}.npz")
                xv = np.stack([np.load(vin / f"{name}.npz")["arr"] for name in sorted(made["val"])]
                              )[..., None].astype(np.float32)
                eng = art["bf16"]
                eng(xv)  # warm-up: cuDNN plans, allocator
                t0 = time.perf_counter()
                done, counts = drive("serve from artifacts", ("knn_bf16", "attention"),
                                     lambda: serve_directory(eng, vin, root / "serve_out",
                                                             batch_size=len(made["val"])))
                wall = time.perf_counter() - t0
                check(done == sorted(made["val"]), f"serve from artifacts: served {len(done)}")
                served = np.stack([np.load(root / "serve_out" / f"{n}_pred.npz")["arr"]
                                   for n in done]).astype(np.float32)
                with torch.inference_mode():
                    got = {tag: e(xv) for tag, e in art.items()}
                    want = {tag: e(xv) for tag, e in mem.items()}
                for tag, o in got.items():
                    check(o.shape == (len(done), 64, 64, 64, 1) and torch.isfinite(o).all().item(),
                          f"serve from artifacts {tag}: TSDF not finite or of shape "
                          f"{tuple(o.shape)}")
                served_err = float(np.abs(served - got["bf16"][..., 0].cpu().numpy()).max())
                f32_err = float((got["f32"] - want["f32"]).abs().max())
                bf16_mae = float((got["bf16"] - want["base_bf16"]).abs().mean())
                from_artifacts.update(
                    chunks=len(done), wall_s=wall, chunks_per_s=len(done) / wall,
                    launches=counts, served_file_max_err=served_err, f32_max_abs=f32_err,
                    bf16_mae_vs_base=bf16_mae, engine_ms=cuda_ms(lambda: eng(xv), 5))
                check(served_err <= 1e-3, f"serve from artifacts: files differ by {served_err}")
                check(f32_err <= 1e-5, f"serve from artifacts f32: max |diff| {f32_err} against "
                      "the engine built in memory")
                check(bf16_mae < 1e-3, f"serve from artifacts bf16: MAE {bf16_mae} against the "
                      "bf16 base engine built in memory")
                log(f"serve from artifacts ({FAST_VARIANT}, bf16): alignment guard min cosine "
                    f"{from_artifacts['min_cos']:.6f}; two engines built in "
                    f"{from_artifacts['build_s']:.1f} s; {len(done)} val chunks in {wall:.2f} s "
                    f"= {len(done) / wall:.1f} chunks/s through serve_directory (npz I/O "
                    f"included), engine {from_artifacts['engine_ms']:.2f} ms/batch of "
                    f"{len(done)}; launches {counts} [{card}]")
                log(f"serve from artifacts: f32 TSDF equal to the engine built in memory "
                    f"(max |diff| {f32_err:.1e} <= 1e-5); bf16 MAE {bf16_mae:.2e} against the "
                    f"bf16 base engine (< 1e-3); files within {served_err:.1e} (float16)")
                # the serving CLI on the same artifacts, in bf16 and float32
                scfg_path = root / "serving.yaml"
                scfg_path.write_text(yaml.safe_dump(
                    {k: v for k, v in scfg.items() if k != "retrieval_ckpt"}))
                for tag, extra, needed in (("bf16", [], ("knn_bf16", "attention")),
                                           ("f32", ["--f32"], ("knn", "attention"))):
                    argv = ["--config", str(scfg_path), "--retrieval_ckpt", str(ckpt),
                            "--refinement_ckpt", str(fckpt), "--input", str(vin), "--output",
                            str(root / f"cli_{tag}"), "--batch_size", str(len(made["val"])),
                            "--fast", *extra]
                    t0 = time.perf_counter()
                    done, counts = drive(f"serve CLI {tag}", needed, lambda: serve.main(argv))
                    cli_s = time.perf_counter() - t0
                    files = np.stack([np.load(root / f"cli_{tag}" / f"{n}_pred.npz")["arr"]
                                      for n in done]).astype(np.float32)
                    err = float(np.abs(files - got[tag][..., 0].cpu().numpy()).max())
                    from_artifacts[f"cli_{tag}"] = dict(max_err=err, launches=counts, wall_s=cli_s)
                    check(done == sorted(made["val"]) and err <= 1e-4,
                          f"serve CLI {tag}: {len(done)} chunks, files differ by {err} from "
                          "the engine from artifacts")
                    log(f"serve CLI (serve.main --fast{' --f32' if extra else ''}): "
                        f"{len(done)} chunks in {cli_s:.1f} s wall (engine build included), "
                        f"files within {err:.1e} of the engine from artifacts (float16 "
                        f"files); launches {counts} [{card}]")
                del art, mem, eng
                from_artifacts["phase_s"] = time.perf_counter() - t_serve

                stamp("7c")
                # 10) meshes: serving with meshes, mesh metrics, the C++ paste
                results["meshes"] = run_phase10(
                    root, dev, scfg, scfg_path, ckpt, fckpt, sorted(made["val"]), rcfg, maps,
                    {"train": ds_train, "val": ds_val},
                    dict(tree=tree, compose_s=retrieval["compose_s"],
                         paste_s=paste_spent.get("compose_paste", 0.0),
                         scenes=len(ds_train.scenes) + len(ds_val.scenes)),
                    drive, card)
                stamp("10")
                # 11a-c) the data-parallel paths over two ranks on the card
                mesh_argv = ["--config", str(scfg_path), "--retrieval_ckpt", str(ckpt),
                             "--refinement_ckpt", str(fckpt), "--input", str(vin), "--output",
                             str(root / "cli_mesh"), "--batch_size",
                             str(PHASE11_RANKS * len(made["val"])), "--fast", "--f32",
                             "--device", "cuda:0"]
                results["data_parallel"] = run_phase11(
                    root, dev, args.seed, cfg, params, db, rcfg, fcfg, mesh_argv,
                    root / "cli_f32", refine["hold"]["phases"][3]["bound"], launches, card)
                stamp("11a-c")
                # 13) the real-data parity harness on phase 7's artifacts
                results["parity_real"] = run_phase13(root, dev, rcfg, fcfg, ckpt, fckpt, card)
                log(f"phase 7a (training) {training['phase_s']:.1f} s, phase 7d (refinement "
                    f"training) {refine['phase_s']:.1f} s, phase 7c (serving from artifacts) "
                    f"{from_artifacts['phase_s']:.1f} s wall [{card}]")
            finally:
                os.chdir(cwd)
        results.update(retrieval=retrieval, training=training, refinement=refine,
                       from_artifacts=from_artifacts)

        stamp("13")
        # 8) the chamfer kernel against its plain version at the evaluate shape
        # (B = 1 per val scene) and at a batched shape
        cap = max(CHAMFER_CAPACITY, -(-max(int(x.sum()) for pair in occ for x in pair)
                                      // CHAMFER_CAPACITY) * CHAMFER_CAPACITY)

        def point_args(pairs, capacity):
            """(target buffers, counts, 1-NN buffers, counts) of B pairs."""
            cols = list(zip(*[occupancy_to_point_buffer(x, capacity) for pair in pairs
                              for x in pair]))
            bufs, counts = torch.stack(cols[0]), torch.tensor(cols[1], dtype=torch.int32,
                                                              device=dev)
            return [bufs[0::2].contiguous(), counts[0::2].contiguous(),
                    bufs[1::2].contiguous(), counts[1::2].contiguous()]

        eval_args = [point_args([pair], cap) for pair in occ]
        err = hold_chamfer(f"evaluate shape (B=1, cap {cap})", eval_args)
        cham_bound = chamfer_bound(eval_args)
        # a B = 1 call is split up to 8 ways over the streamed set: the first
        # scene with one set cut to a count that no split count divides (the
        # last run is ragged), and to fewer points than there are runs
        a0, n_a0, b0, n_b0 = eval_args[0]
        ragged = int(n_b0) // 8 * 8 - 3
        check(ragged > 8, f"chamfer: the first val scene has only {int(n_b0)} points")
        err = max(err, hold_chamfer(f"ragged split (B=1, {int(n_a0)} x {ragged} points)",
                                    [[a0, n_a0, b0, torch.full_like(n_b0, ragged)]]))
        err = max(err, hold_chamfer(f"under one split (B=1, {int(n_a0)} x 3 points)",
                                    [[a0, n_a0, b0, torch.full_like(n_b0, 3)]]))
        shells = [synthetic_df(rng, CHAMFER_PAIRS, 64, rcfg["dataset_val"]["voxel_size_target"],
                               dev) <= thr for _ in range(2)]
        shells[1][0] = False  # one pair with an empty set
        batch_args = point_args(list(zip(*shells)), CHAMFER_CAPACITY)
        err = max(err, hold_chamfer(f"batched (B={CHAMFER_PAIRS}, cap {CHAMFER_CAPACITY})",
                                    [batch_args]))
        batch_bound = chamfer_bound([batch_args])
        n_eval = len(eval_args)
        kernels["chamfer"] = dict(
            name="chamfer", route="cuda", source="retrieval_fuse_tpu_torch/csrc/chamfer.cu",
            replaces="retrieval_fuse_tpu/ops/pallas_chamfer.py:21", max_abs_err=err,
            ms=cuda_ms(lambda: [chamfer_minima(*a) for a in eval_args], 5) / n_eval,
            plain_ms=cuda_ms(lambda: [chamfer_minima_plain(*a) for a in eval_args], 2) / n_eval,
            library_ms=None, bound_ms=cham_bound[0] / n_eval, bound_by=cham_bound[1],
            batch_ms=cuda_ms(lambda: chamfer_minima(*batch_args), 5),
            batch_plain_ms=cuda_ms(lambda: chamfer_minima_plain(*batch_args), 1),
            batch_bound_ms=batch_bound[0], batch_bound_by=batch_bound[1],
            earlier_ms=EARLIER_KERNEL_MS["chamfer"],
            earlier_batch_ms=EARLIER_KERNEL_MS["chamfer_batch"],
            shape=f"{n_eval} val scenes, B=1, cap {cap}; batched B={CHAMFER_PAIRS}, "
                  f"cap {CHAMFER_CAPACITY}; f32 voxel coordinates")
        kr = kernels["chamfer"]
        log(f"chamfer: kernel {kr['ms']:.3f} ms per evaluate call ({kr['earlier_ms']:.3f} ms "
            f"before its redesign), plain {kr['plain_ms']:.3f} "
            f"ms, library none, bound {kr['bound_ms']:.4f} ms ({kr['bound_by']}: "
            f"{CHAMFER_OPS_PER_PAIR} float32 operations per valid point pair at 67 TFLOP/s, "
            f"bytes at 3.35 TB/s); batched "
            f"B={CHAMFER_PAIRS}: kernel {kr['batch_ms']:.3f} ms ({kr['earlier_batch_ms']:.3f} "
            f"ms before), plain "
            f"{kr['batch_plain_ms']:.3f} ms, bound {kr['batch_bound_ms']:.3f} ms "
            f"({kr['batch_bound_by']}) [{card}]")
        stamp("8")
        # 9) the other tasks' networks at full width (run_phase9)
        t9 = time.perf_counter()
        results["surface"], results["superres16"], launches9 = run_phase9(
            dev, rng, args.seed, kernels, counters, drive, card)
        for name, n in launches9.items():
            launches[name] += n
        results["phase9_s"] = time.perf_counter() - t9
        log(f"phase 9: {results['phase9_s']:.1f} s")

        stamp("9")
        # 11d) the driver entries on the card
        results["entries"] = run_phase11d(launches, card)
        stamp("11d")

        for key, n in launches.items():  # phase 9 set its widened records' own
            kernels[key]["launches"] = n
        results["kernels"] = kernels
    except Failed as e:
        print(f"chip_smoke: FAILED: {e}", file=sys.stderr)
        return 1

    keys = ("name", "route", "source", "replaces", "launches", "max_abs_err", "ms",
            "plain_ms", "bound_ms", "bound_by", "library_ms")
    out = Path(args.out)
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_text(json.dumps(results, indent=1, default=str))
    # every record has `keys`; "math" where the kernel has two instruction paths
    log(json.dumps({"kernels": [{k_: kr[k_] for k_ in (*keys, *(("math",) if "math" in kr else ()))}
                                for kr in kernels.values()]}))
    log(card)
    log(json.dumps({"ok": True, "device": {"platform": "gpu",
                                           "kind": torch.cuda.get_device_name(0),
                                           "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
