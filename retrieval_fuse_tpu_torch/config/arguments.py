"""CLI argument parsing shared by the trainers, as in the JAX package's
config/arguments.py: the same flags and "unset" sentinels, and the same
experiment names (timestamped; the `experiment` environment variable keeps
the name of a run's processes equal; a resumed run keeps its checkpoint's
experiment). One flag is the port's own: `--device` (the CUDA card unless
"cpu" is asked for).
"""

from __future__ import annotations

import argparse
import os
from datetime import datetime
from pathlib import Path
from random import randint

from retrieval_fuse_tpu_torch.config import read_config


def generate_experiment_name(config: dict) -> None:
    """Set config["experiment"] to `<ddmmHHMM>_<task>_<dataset>_<experiment>`
    (the checkpoint's experiment when resuming, unless new_exp_for_resume),
    or to the `experiment` environment variable when it is set; the name is
    then written to that variable."""
    if not os.environ.get("experiment"):
        config["experiment"] = (
            f"{datetime.now().strftime('%d%m%H%M')}_{config['task']}_"
            f"{config['dataset_train']['dataset_name']}_{config['experiment']}"
        )
        if config.get("resume") is not None and not config.get("new_exp_for_resume"):
            config["experiment"] = Path(config["resume"]).parents[0].name
        os.environ["experiment"] = config["experiment"]
    else:
        config["experiment"] = os.environ["experiment"]


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser()
    parser.add_argument("--config", type=str, default=None, help="config path")
    parser.add_argument("--sanity_steps", type=int, default=0, help="sanity_steps")
    parser.add_argument("--resume", type=str, default=None, help="resume checkpoint")
    parser.add_argument("--new_exp_for_resume", action="store_true",
                        help="create new experiment for resume")
    parser.add_argument("--val_check_percent", type=float, default=1.0,
                        help="percentage of val checked")
    parser.add_argument("--val_check_interval", type=float, default=1.0,
                        help="check val every fraction of epoch")
    parser.add_argument("--max_epoch", type=int, default=100, help="number of epochs to train for")
    parser.add_argument("--save_epoch", type=int, default=1, help="save every nth epoch")
    parser.add_argument("--experiment", type=str, default="fast_dev", help="experiment directory")
    parser.add_argument("--suffix", type=str, default="", help="logger project suffix")
    parser.add_argument("--seed", type=int, default=-1, help="random seed")
    parser.add_argument("--current_phase", type=int, default=0, help="current phase")
    parser.add_argument("--phase_change_epochs", type=int, nargs="+", default=[30, 25, 5],
                        help="phases")
    parser.add_argument("--wandb_main", action="store_true")
    parser.add_argument("--no_retrievals", action="store_true")
    parser.add_argument("--retrieval_ckpt", type=str, default=None)
    parser.add_argument("--unet_backbone_decoder_ckpt", type=str, default=None)
    parser.add_argument("--retrieval_backbone_ckpt", type=str, default=None)
    parser.add_argument("--attention_block_ckpt", type=str, default=None)
    parser.add_argument("--frozen_phase_cache", action="store_true")
    parser.add_argument("--device", type=str, default=None, help="cuda (default) or cpu")
    return parser


def parse_arguments(argv=None) -> dict:
    args = build_parser().parse_args(argv)

    if args.seed == -1:
        args.seed = randint(0, 999)

    if args.val_check_interval > 1:
        args.val_check_interval = int(args.val_check_interval)

    if not args.wandb_main and args.suffix == "":
        args.suffix = "-dev"

    config = read_config(args.config, args)
    generate_experiment_name(config)
    return config
