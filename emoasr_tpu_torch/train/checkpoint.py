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

On a mesh (`parallel/mesh.py`) `save_checkpoint` gathers the tensor-parallel
shares of the weights, the moments and the open accumulation on every rank
of a model group, rank 0 writes both files in the single-process format
(which the JAX CLI and a one-process run load unchanged) and the others
wait at a barrier.  A rank loads a whole `model.ep{N}` before its model
is laid out (`parallel/tensor.py::prepare_model_` keeps its shares), and
`load_optim(..., mesh)` cuts a whole `optim.ep{N}` to them.
"""

from __future__ import annotations

import logging
import os
from typing import Dict, List, Optional, Tuple

import torch

from emoasr_tpu_torch.parallel import mesh as pmesh
from emoasr_tpu_torch.parallel.tensor import full_tensors, shard_tensors
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


def optim_tree(state) -> Dict:
    """What `load_optim` needs to go on from `state` (a
    `train.step.TrainState`) exactly: moments, counters, open accumulation."""
    return {
        "optimizer": state.optimizer.state_dict(),
        "step": int(state.step),
        "epoch_scale": float(state.epoch_scale),
        "skipped": int(state.skipped),
        "mini_step": int(state.mini_step),
        "acc_grads": [g.detach().cpu() for g in state.acc_grads],
    }


def save_optim(path: str, state, tree: Optional[Dict] = None) -> None:
    """Write `optim_tree(state)` (or `tree`) to `path`."""
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    torch.save(optim_tree(state) if tree is None else tree, path)


def _optim_keys(state) -> Tuple[List[str], List[str]]:
    """The parameter names of the optimizer's indices and of `acc_grads`."""
    names = {id(p): n for n, p in state.model.named_parameters()}
    by_index = [names[id(p)] for g in state.optimizer.param_groups for p in g["params"]]
    return by_index, [n for n, p in state.model.named_parameters() if p.requires_grad]


def _map_optim(tree: Dict, state, plan: Dict[str, int], fn) -> Dict:
    """`tree` with every tensor of a split parameter (moments, open
    accumulation) passed through fn(tensors, plan) by a key of its own."""
    by_index, trainable = _optim_keys(state)
    tensors, sub_plan = {}, {}
    for i, st in tree["optimizer"]["state"].items():
        for k, v in st.items():
            if by_index[i] in plan and torch.is_tensor(v) and v.dim() > 0:
                tensors[(i, k)] = v
                sub_plan[(i, k)] = plan[by_index[i]]
    for j, (name, g) in enumerate(zip(trainable, tree["acc_grads"])):
        if name in plan:
            tensors[("acc", j)] = g
            sub_plan[("acc", j)] = plan[name]
    done = fn(tensors, sub_plan)
    out = dict(tree, optimizer=dict(tree["optimizer"]))
    out["optimizer"]["state"] = {i: {k: done.get((i, k), v) for k, v in st.items()}
                                 for i, st in tree["optimizer"]["state"].items()}
    out["acc_grads"] = [done.get(("acc", j), g) for j, g in enumerate(tree["acc_grads"])]
    return out


def load_optim(path: str, state, mesh=None) -> None:
    """Restore `state`'s optimizer, counters and open accumulation in place;
    tensors go to the device of the parameters they belong to.  On a mesh
    the whole file's split tensors are cut to this rank's shares."""
    tree = torch.load(path, map_location="cpu", weights_only=True)
    plan = getattr(state.model, "tp_plan", {})
    if mesh is not None and plan:
        tree = _map_optim(tree, state, plan, lambda t, p: shard_tensors(mesh, p, t))
    state.optimizer.load_state_dict(tree["optimizer"])
    state.step = int(tree["step"])
    state.epoch_scale = float(tree["epoch_scale"])
    state.skipped = int(tree["skipped"])
    state.mini_step = int(tree["mini_step"])
    state.acc_grads = [g.to(p.device) for g, p in zip(tree["acc_grads"], state.params)]


def full_state_dict(model: torch.nn.Module, mesh=None) -> Dict[str, torch.Tensor]:
    """`model.state_dict()` with the tensor-parallel shares gathered whole
    (a collective of the model group: every rank of it calls this)."""
    plan = getattr(model, "tp_plan", {})
    if mesh is None or not plan:
        return model.state_dict()
    return full_tensors(mesh, plan, model.state_dict())


def save_checkpoint(mesh, model_path: str, optim_path: str, state) -> None:
    """`save_model` + `save_optim` of `state`; on a mesh every rank gathers
    its model group's shares, rank 0 writes, and all wait at a barrier."""
    if mesh is None:
        save_model(model_path, state.model)
        save_optim(optim_path, state)
        return
    sd = full_state_dict(state.model, mesh)
    tree = optim_tree(state)
    plan = getattr(state.model, "tp_plan", {})
    if plan:
        tree = _map_optim(tree, state, plan, lambda t, p: full_tensors(mesh, p, t))
    if mesh.is_main:
        save_state_dict(sd, model_path)
        save_optim(optim_path, state, tree)
    pmesh.barrier(mesh)


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
