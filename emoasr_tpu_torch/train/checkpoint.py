"""Checkpoint save / resume / epoch averaging (PyTorch port of
`emoasr_tpu/train/checkpoint.py`).

- per-epoch `model.ep{N}` + `optim.ep{N}` under `<run>/checkpoints`
  (`asr/train_asr.py:290-303`).  `model.ep{N}` is a reference-layout file: a
  flat `state_dict` of CPU float32 tensors saved with `torch.save`, which
  both the port and the JAX package's torch importer read.  `optim.ep{N}`
  holds the optimizer's `state_dict`, the step counters, the epdecay factor
  and the open gradient accumulation.
- `--resume` finds the latest epoch pair (`utils/paths.py`); warm start from
  `model_path` loads a `model.ep{N}`.
- post-hoc weight averaging over epoch ranges "91-100" or lists "1+2+5"
  (`utils/average_checkpoints.py:16-52`), triggered lazily at test time.

The LM trainer (`train/train_lm.py`) writes and resumes through the same
functions: `model.ep{N}` holds the `LM` facade's `state_dict` (`lm.` keys),
`optim.ep{N}` its AdamW state with both parameter groups.
"""

from __future__ import annotations

import logging
import os
from typing import Dict, List, Optional

import torch

from emoasr_tpu_torch.utils.paths import get_model_path


def parse_epochs(ep: str) -> Optional[List[int]]:
    """"91-100" -> range; "1+2+5" -> list; plain ints -> None (no averaging)
    (average_checkpoints.py:19-27)."""
    if "-" in ep:
        a, b = ep.split("-")
        return list(range(int(a), int(b) + 1))
    if "+" in ep:
        return list(map(int, ep.split("+")))
    return None


def save_state_dict(state_dict: Dict[str, torch.Tensor], path: str) -> None:
    """Save as a flat dict of contiguous CPU float32 (non-float kept) tensors."""
    out = {}
    for k, v in state_dict.items():
        v = v.detach().to("cpu")
        if v.is_floating_point():
            v = v.float()
        out[k] = v.contiguous()
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    torch.save(out, path)


def load_state_dict(path: str) -> Dict[str, torch.Tensor]:
    return torch.load(path, map_location="cpu", weights_only=True)


def save_model(path: str, model: torch.nn.Module) -> None:
    save_state_dict(model.state_dict(), path)


def load_model(path: str, model: torch.nn.Module) -> None:
    """Load a `model.ep{N}` into `model`, wherever its parameters lie."""
    model.load_state_dict(load_state_dict(path))


def save_optim(path: str, state) -> None:
    """Write what `load_optim` needs to go on from `state` (a
    `train.step.TrainState`) exactly: moments, counters, open accumulation."""
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    torch.save(
        {
            "optimizer": state.optimizer.state_dict(),
            "step": int(state.step),
            "epoch_scale": float(state.epoch_scale),
            "skipped": int(state.skipped),
            "mini_step": int(state.mini_step),
            "acc_grads": [g.detach().cpu() for g in state.acc_grads],
        },
        path,
    )


def load_optim(path: str, state) -> None:
    """Restore `state`'s optimizer, counters and open accumulation in place;
    tensors go to the device of the parameters they belong to."""
    tree = torch.load(path, map_location="cpu", weights_only=True)
    state.optimizer.load_state_dict(tree["optimizer"])
    state.step = int(tree["step"])
    state.epoch_scale = float(tree["epoch_scale"])
    state.skipped = int(tree["skipped"])
    state.mini_step = int(tree["mini_step"])
    state.acc_grads = [g.to(p.device) for g, p in zip(tree["acc_grads"], state.params)]


def model_average(conf_path: str, ep: str) -> Optional[str]:
    """Average `model.ep{N}` files over an epoch range into `model.ep{ep}`.

    Float tensors are averaged in float64, then cast back; integer and
    bool buffers are taken from the first epoch (the reference's in-place
    `+=` then integer division, `utils/average_checkpoints.py:16-52`).
    Returns the save path, or None if `ep` is a single epoch."""
    epochs = parse_epochs(ep)
    if epochs is None:
        return None
    save_path = get_model_path(conf_path, ep)
    if os.path.exists(save_path):
        logging.info(f"checkpoint: {save_path} already exists")
        return save_path
    logging.info(f"average checkpoints... (epochs: {epochs})")
    avg: Dict[str, torch.Tensor] = {}
    dtypes: Dict[str, torch.dtype] = {}
    for i, e in enumerate(epochs):
        for k, v in load_state_dict(get_model_path(conf_path, e)).items():
            if i == 0:
                dtypes[k] = v.dtype
                avg[k] = v.double() if v.is_floating_point() else v
            elif dtypes[k].is_floating_point:
                avg[k] = avg[k] + v.double()
    out = {
        k: (a / len(epochs)).to(dtypes[k]) if dtypes[k].is_floating_point else a
        for k, a in avg.items()
    }
    torch.save(out, save_path)
    logging.info(f"checkpoints saved to: {save_path}")
    return save_path
