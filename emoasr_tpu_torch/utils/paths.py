"""Run-directory and checkpoint path conventions.

Copy of `emoasr_tpu/utils/paths.py` (parity target emoASR
`utils/paths.py:44-136`): the run dir is the config path minus ``.yaml``;
checkpoints live in ``<run>/checkpoints`` as ``model.ep{N}`` torch
`state_dict` files beside ``optim.ep{N}``; results in ``<run>/results``;
``--resume`` finds the latest epoch by scanning the checkpoint dir.
"""

from __future__ import annotations

import os
import re
from typing import Tuple

REPO_ROOT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "../../")


def get_run_dir(conf_path: str) -> str:
    return os.path.splitext(conf_path)[0]


def get_model_path(conf_path: str, epoch) -> str:
    return os.path.join(get_run_dir(conf_path), "checkpoints", f"model.ep{epoch}")


def get_results_dir(conf_path: str) -> str:
    d = os.path.join(get_run_dir(conf_path), "results")
    os.makedirs(d, exist_ok=True)
    return d


def get_log_save_paths(conf_path: str) -> Tuple[str, str, str]:
    run_dir = get_run_dir(conf_path)
    log_dir = os.path.join(run_dir, "log")
    save_dir = os.path.join(run_dir, "checkpoints")
    os.makedirs(log_dir, exist_ok=True)
    os.makedirs(save_dir, exist_ok=True)
    return (
        log_dir,
        os.path.join(save_dir, "model.ep{}"),
        os.path.join(save_dir, "optim.ep{}"),
    )


def get_resume_paths(conf_path: str, epoch: int = 0) -> Tuple[str, str, int]:
    """Checkpoint paths to resume from (the latest epoch when epoch=0);
    ("", "", 0) when there is none (`utils/paths.py:81-129`)."""
    save_dir = os.path.join(get_run_dir(conf_path), "checkpoints")
    if epoch <= 0:
        model_ep_max = optim_ep_max = 0
        if os.path.isdir(save_dir):
            for name in os.listdir(save_dir):
                m = re.fullmatch(r"model\.ep([0-9]+)", name)
                if m:
                    model_ep_max = max(model_ep_max, int(m.group(1)))
                m = re.fullmatch(r"optim\.ep([0-9]+)", name)
                if m:
                    optim_ep_max = max(optim_ep_max, int(m.group(1)))
        if model_ep_max != optim_ep_max:
            raise RuntimeError(
                f"model/optim checkpoint mismatch in {save_dir}: "
                f"model.ep{model_ep_max} but optim.ep{optim_ep_max}"
            )
        epoch = model_ep_max
    if epoch <= 0:
        return "", "", 0
    return (
        os.path.join(save_dir, f"model.ep{epoch}"),
        os.path.join(save_dir, f"optim.ep{epoch}"),
        epoch,
    )


def rel_to_abs_path(path: str) -> str:
    return path if os.path.exists(path) else os.path.join(REPO_ROOT, path)
