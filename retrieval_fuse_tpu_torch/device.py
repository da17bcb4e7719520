"""Where the port runs: the CUDA card unless the caller asks for the CPU."""

from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """None or "cuda[:i]" -> a CUDA device (raises if CUDA is absent);
    "cpu" -> the CPU. Never falls back to the CPU on its own.

    On CUDA it also turns TF32 off for cuDNN convolutions and float32
    matmuls: TF32 keeps ~3 decimal digits, which would break the float32
    comparisons against the reference (cuDNN enables it by default)."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "CUDA is not available; pass device='cpu' to run on the CPU")
        torch.backends.cudnn.allow_tf32 = False
        torch.set_float32_matmul_precision("highest")  # no TF32 in float32 matmuls
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {device!r}")
    return dev
