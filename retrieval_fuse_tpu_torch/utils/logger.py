"""Experiment logging, as in the JAX package's utils/logger.py:

  * `FilesystemLogger` snapshots the port's source tree and the resolved
    config into runs/<experiment>/ at run start;
  * `MetricsLogger` appends one JSON record of scalar metrics per call to
    runs/<experiment>/metrics.jsonl (keys `_time`, `_step` and the metric
    names), mirrored to W&B when it is asked for and importable;
  * `log_images` records the rendered preview images of a directory
    (`<prefix>/count`, `<prefix>/dir`) and mirrors them to W&B;
  * `trace_profile` wraps a code region in torch.profiler (CPU, and CUDA
    where there is a card) and writes a Chrome trace.

PyYAML is imported inside FilesystemLogger only, as in config.read_config.
"""

from __future__ import annotations

import contextlib
import json
import shutil
import time
from pathlib import Path

import torch


class FilesystemLogger:
    """Snapshot source + config into the experiment dir."""

    SRC_SUFFIXES = {".py", ".pyx", ".txt", ".so", ".pyd", ".h", ".cu", ".cuh", ".c", ".cpp",
                    ".html", ".yaml"}

    def __init__(self, experiment_config: dict):
        import yaml

        self.experiment_config = experiment_config
        experiment_dir = Path("runs", experiment_config["experiment"])
        experiment_dir.mkdir(exist_ok=True, parents=True)
        root = Path(__file__).resolve().parents[1]
        code_dir = experiment_dir / "code"
        for f in root.rglob("*"):
            if (f.is_file() and f.suffix in self.SRC_SUFFIXES
                    and "__pycache__" not in f.parts and "runs" not in f.parts):
                dest = code_dir / f.relative_to(root)
                dest.parent.mkdir(parents=True, exist_ok=True)
                shutil.copyfile(f, dest)

        def dumpable(v) -> bool:
            try:
                yaml.dump(v)
                return True
            except yaml.YAMLError:
                return False

        (experiment_dir / "config.yaml").write_text(
            yaml.dump({k: v for k, v in experiment_config.items() if dumpable(v)}))


class MetricsLogger:
    """Append-only JSONL metric stream + optional W&B mirroring."""

    def __init__(self, experiment: str, project: str = "", use_wandb: bool = False):
        self.path = Path("runs", experiment, "metrics.jsonl")
        self.path.parent.mkdir(exist_ok=True, parents=True)
        self._fh = self.path.open("a")
        self._wandb = None
        if use_wandb:
            try:
                import wandb
                wandb.init(project=project, name=experiment, id=experiment, resume="allow")
                self._wandb = wandb
            except Exception as e:  # the JSONL file stays the record
                print(f"[logger] W&B disabled: {e!r}")

    def log(self, metrics: dict, step: int | None = None):
        rec = {"_time": time.time()}
        if step is not None:
            rec["_step"] = step
        rec.update({k: float(v) if hasattr(v, "__float__") else v for k, v in metrics.items()})
        self._fh.write(json.dumps(rec) + "\n")
        self._fh.flush()
        if self._wandb is not None:
            self._wandb.log(metrics, step=step)

    def close(self):
        self._fh.close()


@contextlib.contextmanager
def trace_profile(log_dir, enabled: bool = True):
    """torch.profiler around a code region (CPU activity, and CUDA when a
    card is present); on exit writes <log_dir>/trace.json (Chrome trace
    format). Yields the profiler (None when not enabled), whose
    key_averages() sum the time by operation and kernel."""
    if not enabled:
        yield None
        return
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    log_dir = Path(log_dir)
    log_dir.mkdir(parents=True, exist_ok=True)
    with torch.profiler.profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(str(log_dir / "trace.json"))


def log_images(logger: MetricsLogger, image_dir, step: int | None = None,
               prefix: str = "visualization") -> int:
    """Record the rendered preview images (utils/visualization.IMAGE_SUFFIX)
    of `image_dir` in the metrics stream as `<prefix>/count` and
    `<prefix>/dir`, and mirror them to W&B when it is on. Returns the count."""
    from retrieval_fuse_tpu_torch.utils.visualization import IMAGE_SUFFIX
    images = sorted(Path(image_dir).glob(f"*{IMAGE_SUFFIX}"))
    if not images:
        return 0
    logger.log({f"{prefix}/count": len(images), f"{prefix}/dir": str(image_dir)}, step=step)
    if logger._wandb is not None:
        wandb = logger._wandb
        wandb.log({f"{prefix}/{im.name}": [wandb.Image(str(im))] for im in images}, step=step)
    return len(images)
