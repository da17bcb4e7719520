"""Config system, as in the JAX package's config/__init__.py: YAML with
single-level ``inherit_from`` inheritance, recursive merge, ``dataset``
block fan-out into ``dataset_train`` / ``dataset_val``, and argparse
override semantics.

The YAML tree lives beside this module (base/, super_resolution/,
surface_reconstruction/): the port's own copy of the JAX package's configs,
byte for byte (a test pins the two). PyYAML is imported inside
`read_config` only: code that builds its config in Python needs no YAML
parser.
"""

from __future__ import annotations

from pathlib import Path

# the packaged config tree (base/, super_resolution/, surface_reconstruction/)
CONFIG_ROOT = Path(__file__).resolve().parent


def update_recursive(dict1: dict, dict2: dict) -> None:
    """Merge dict2 into dict1 in place; nested dicts merge, scalars overwrite."""
    for k, v in dict2.items():
        if k not in dict1:
            dict1[k] = {}
        if isinstance(v, dict):
            if not isinstance(dict1[k], dict):
                dict1[k] = {}
            update_recursive(dict1[k], v)
        else:
            dict1[k] = v


def update_dataset_configs(config: dict) -> None:
    """Fan the shared `dataset` block out into dataset_train / dataset_val
    (keys already there win)."""
    if "dataset" in config:
        for c in config["dataset"]:
            for d in ("dataset_train", "dataset_val"):
                config.setdefault(d, {})
                if c not in config[d]:
                    config[d][c] = config["dataset"][c]


def override_config_with_args(config: dict, args) -> None:
    """Apply argparse overrides: an arg wins unless it is None or -100 (the
    "unset" sentinels); unknown keys are added."""
    var_args = vars(args) if not isinstance(args, dict) else args
    for k in var_args:
        if (k not in config) or (var_args[k] is not None and var_args[k] != -100):
            config[k] = var_args[k]


def read_config(path, args=None, config_root=None) -> dict:
    """Load a YAML config, resolving single-level inheritance and CLI
    overrides. `inherit_from` resolves against `config_root` (default: the
    packaged tree), else against the parents of the config file."""
    import yaml

    path = Path(path)
    _config = yaml.safe_load(path.read_text())
    config: dict = {}
    if "inherit_from" in _config:
        root = Path(config_root) if config_root is not None else CONFIG_ROOT
        base_path = root / _config["inherit_from"]
        if not base_path.exists():
            for parent in path.resolve().parents:
                cand = parent / _config["inherit_from"]
                if cand.exists():
                    base_path = cand
                    break
        config = yaml.safe_load(base_path.read_text())
    update_recursive(config, _config)
    update_dataset_configs(config)
    if "dataset" in config:
        del config["dataset"]
    if args is not None:
        override_config_with_args(config, args)
    return config
