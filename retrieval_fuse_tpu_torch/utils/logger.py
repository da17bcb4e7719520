"""Experiment logging, as in the JAX package's utils/logger.py:

  * `FilesystemLogger` snapshots the port's source tree and the resolved
    config into runs/<experiment>/ at run start;
  * `MetricsLogger` appends one JSON record of scalar metrics per call to
    runs/<experiment>/metrics.jsonl (keys `_time`, `_step` and the metric
    names), mirrored to W&B when it is asked for and importable.

PyYAML is imported inside FilesystemLogger only, as in config.read_config.
"""

from __future__ import annotations

import json
import shutil
import time
from pathlib import Path


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
