"""RetrievalFuse in PyTorch for NVIDIA Hopper (H100).

A second package beside the JAX reference `retrieval_fuse_tpu`, with the
same module names so each counterpart is easy to find:

  device.py      device resolution: CUDA unless the CPU is asked for
  models/        patch encoder, 3D U-Net, refinement stacks, attention
  ops/           fold/unfold, kNN selection, the coarse-grid decoders and
                 backbone, and the six hand-written Hopper kernels (topk,
                 streaming_knn, three patch attentions, decoder_tail) with
                 their plain PyTorch versions
  csrc/          the kernels' CUDA sources
  utils/         flax-params -> state_dict weight bridge
  inference.py   RetrieveRefineEngine (the serving path)
  serve.py       directory-of-chunks serving loop

It imports torch and numpy only. Entry points run on the card unless the
caller passes device="cpu"; without CUDA they raise instead of falling back.
Layouts at public functions are channels-last (B, D, H, W, C), as in JAX.
"""

__version__ = "0.1.0"
