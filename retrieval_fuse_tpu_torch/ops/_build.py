"""Build and load the port's CUDA kernels (csrc/*.cu).

Each source is compiled by nvcc for Hopper (sm_90a) into its own shared
library with a plain C interface, and loaded with ctypes; tensors cross as
`data_ptr()` integers and the stream as PyTorch's current stream handle.
Sources that include no PyTorch header build in seconds, where a
`torch.utils.cpp_extension` build that includes them takes minutes, and
every run on a fresh machine builds anew.

The Pallas kernels these replace were compiled by Mosaic when traced and
needed no build step. Their TPU layout workarounds do not survive in the
CUDA sources: the 1-D flattening of the index operand (SMEM pads a 2-D
operand's last axis to 128 lanes), the -4 sentinel column that kept padded
kNN rows from winning, and the padding of Q and N to tile, group or
sublane multiples. Each CUDA kernel reads its operands in their natural
shapes and stops at their ragged edges by index.

Libraries land in `build/retrieval_fuse_tpu_torch/` beside the package
(ignored by git), named by a hash of the sources and flags, so an edited
kernel is rebuilt and a stale library is never loaded. Nothing is compiled
or loaded at import: the first kernel call builds what it needs, and
`build_all()` builds every kernel at once, one nvcc process per source, all
started together. `launch()` calls a kernel's C entry point on PyTorch's
current stream; each entry point returns a cudaError_t value, which
`launch()` turns into an exception.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "retrieval_fuse_tpu_torch"
#: -split-compile=0 (nvcc's optimiser and ptxas, one thread a core): knn.cu's
#: 140 instantiations build in 132 s instead of 315 on the card's machine
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v", "-split-compile=0",
              "-Xptxas", "--split-compile=0")

_p, _i, _f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
#: dtype, xt, bank, idx, q, k, f, t, general, the weights and biases, hard,
#: sharpness, out, sel, stream
_GATHERED_ARGS = [_i, _p, _p, _p, _i, _i, _i, _i, _i, _p, _p, _p, _p, _i, _f, _p, _p, _p]
#: kernel name -> (source, C entry point, its argtypes; the stream comes last)
KERNELS = {
    "topk": ("topk.cu", "rf_topk", [_p, _p, _p, _i, _i, _i, _p]),
    "knn": ("knn.cu", "rf_knn", [_i, _p, _p, _p, _p, _i, _i, _i, _i, _i, _p]),
    "gathered_attention": ("gathered_attention.cu", "rf_gathered_attention", _GATHERED_ARGS),
    "gathered_attention_v1": ("gathered_attention_v1.cu", "rf_gathered_attention_v1",
                              _GATHERED_ARGS[:-1] + [_p, _p]),  # + its scratch
    "patch_attention": ("patch_attention.cu", "rf_patch_attention",
                        [_i, _p, _p, _i, _i, _i, _i, _p, _p, _p, _p, _i, _f, _p, _p, _p]),
    "decoder_tail": ("decoder_tail.cu", "rf_decoder_tail",
                     [_i, _p, _p, _p, _f, _i, _i, _i, _i, _p, _p]),
    "chamfer": ("chamfer.cu", "rf_chamfer", [_p, _p, _p, _p, _p, _p, _i, _i, _i, _p]),
}

_loaded: dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") or "/usr/local/cuda"
    cand = Path(home) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA toolkit "
                       "(set CUDA_HOME or put nvcc on PATH)")


def library_path(name: str) -> Path:
    source = KERNELS[name][0]
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for f in sorted(CSRC.glob("*.cu*")):  # the .cu and the headers it may include
        h.update(f.name.encode())
        h.update(f.read_bytes())
    return BUILD_DIR / f"{Path(source).stem}-{h.hexdigest()[:16]}.so"


def build_all(names=None) -> dict[str, str]:
    """Compile every kernel library that is missing, all nvcc processes
    started together. Returns {name: ptxas report} for what was built."""
    names = list(KERNELS) if names is None else list(names)
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    jobs = []
    for name in names:
        out = library_path(name)
        if out.exists():
            continue
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
        os.close(fd)
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", tmp, str(CSRC / KERNELS[name][0])]
        proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                text=True)
        jobs.append((name, out, tmp, proc))
    reports, failed = {}, []
    for name, out, tmp, proc in jobs:
        log, _ = proc.communicate()
        if proc.returncode != 0:
            Path(tmp).unlink(missing_ok=True)
            failed.append(f"{name}:\n{log}")
            continue
        os.replace(tmp, out)  # atomic: a concurrent build never loads half a file
        reports[name] = log
    if failed:
        raise RuntimeError("nvcc failed for " + "\n".join(failed))
    return reports


def load(name: str) -> ctypes.CDLL:
    """The loaded library of kernel `name`, built first if needed."""
    lib = _loaded.get(name)
    if lib is None:
        path = library_path(name)
        if not path.exists():
            build_all([name])
        lib = ctypes.CDLL(str(path))
        _, entry, argtypes = KERNELS[name]
        getattr(lib, entry).argtypes = argtypes
        getattr(lib, entry).restype = ctypes.c_int
        lib.rf_error_string.argtypes = [ctypes.c_int]
        lib.rf_error_string.restype = ctypes.c_char_p
        _loaded[name] = lib
    return lib


def launch(name: str, device, *args) -> None:
    """Call kernel `name`'s C entry point with `args` and PyTorch's current
    stream on `device`, and raise if it returns a CUDA error (a refused
    launch never runs, and no later synchronize reports it)."""
    lib = load(name)
    with torch.cuda.device(device):
        err = getattr(lib, KERNELS[name][1])(*args, torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"{name}: CUDA error {err}: {lib.rf_error_string(err).decode()}")
