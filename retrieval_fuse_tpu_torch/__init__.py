"""RetrievalFuse in PyTorch for NVIDIA Hopper (H100).

A second package beside the JAX reference `retrieval_fuse_tpu`, with the
same module names so each counterpart is easy to find:

  device.py      device resolution: CUDA unless the CPU is asked for
  config/        YAML configs (the port's own copy of the JAX package's tree)
  data/          scene handler (with its OBJ visualisations), patched
                 dataset, batch loader, synthetic data, offline prep
  models/        patch encoders (MLP, conv), the 3D U-Net family, the
                 refinement stacks of the three tasks, attention
  ops/           fold/unfold, kNN selection, the coarse-grid decoders and
                 backbone, chamfer, and the seven hand-written Hopper
                 kernels (topk, streaming_knn, three patch attentions,
                 decoder_tail, streaming_chamfer) with their plain PyTorch
                 versions; the generic Patcher
  csrc/          the kernels' CUDA sources
  native/        host C++ (marching cubes, the exact shell voxelizer, the
                 compose paste; copies of the JAX package's sources), built
                 by g++ on first use
  retrieval/     dictionary, kNN mapping, compose, and the retrieval CLI
  evaluation/    IoU, Chamfer, precision and recall over occupancy grids;
                 meshes and the paper's mesh metrics, with their CLI
  train/         the retrieval and refinement trainers, schedule, checkpoints
  utils/         weight bridges (flax params, reference checkpoints), paths,
                 timer, logging, visualisation
  inference.py   RetrieveRefineEngine (the serving path)
  serve.py       directory-of-chunks serving loop

It imports torch, numpy and scipy (and PyYAML inside config.read_config).
Entry points run on the card unless the caller passes device="cpu"; without
CUDA they raise instead of falling back.
Layouts at public functions are channels-last (B, D, H, W, C), as in JAX.
"""

__version__ = "0.1.0"
