"""RetrievalFuse in PyTorch for NVIDIA Hopper (H100).

A second package beside the JAX reference `retrieval_fuse_tpu`, with the
same module names so each counterpart is easy to find:

  device.py      device resolution: CUDA unless the CPU is asked for
  config/        YAML configs (the port's own copy of the JAX package's tree)
  data/          scene handler, patched dataset, batch loader, synthetic data
  models/        patch encoders (MLP, conv), the 3D U-Net family, the
                 refinement stacks of the three tasks, attention
  ops/           fold/unfold, kNN selection, the coarse-grid decoders and
                 backbone, chamfer, and the seven hand-written Hopper
                 kernels (topk, streaming_knn, three patch attentions,
                 decoder_tail, streaming_chamfer) with their plain PyTorch
                 versions
  csrc/          the kernels' CUDA sources
  retrieval/     dictionary, kNN mapping, compose, and the retrieval CLI
  evaluation/    IoU, Chamfer, precision and recall over occupancy grids
  train/         the checkpoint layout; get_metrics_for_retrieval
  utils/         flax-params -> state_dict weight bridge, paths, timer
  inference.py   RetrieveRefineEngine (the serving path)
  serve.py       directory-of-chunks serving loop

It imports torch and numpy only (and PyYAML inside config.read_config).
Entry points run on the card unless the caller passes device="cpu"; without
CUDA they raise instead of falling back.
Layouts at public functions are channels-last (B, D, H, W, C), as in JAX.
"""

__version__ = "0.1.0"
