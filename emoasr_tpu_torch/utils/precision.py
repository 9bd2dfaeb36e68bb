"""Mixed-precision policy (port of `emoasr_tpu/utils/precision.py`).

Parameters are stored in float32.  Under a half policy
(`cfg.compute_dtype: bfloat16`):

- Training: master parameters and the optimizer's moments stay float32.
  The forward sees a half copy of the floating parameters, made by a cast
  that autograd records (`cast_params_for_compute`, applied through
  `torch.func.functional_call`), so the backward returns float32 gradients
  to the masters, as the transpose of JAX's cast does.  BatchNorm running
  statistics are buffers, not parameters: they stay float32 and take the
  running update in place.  The batch is cast after SpecAugment
  (`cast_batch_for_compute`).
- Decoding: the model's floating parameters and buffers are cast once
  (`cast_floating`) and the features fed in half precision.

Either way the matrix products run in bf16, and the f32 islands are the
modules' own: attention softmax, the loss lattices and log-softmaxes,
LayerNorm and BatchNorm statistics.  This is an explicit cast, not
`torch.autocast`, whose per-op rules (LayerNorm and softmax returning f32
and so on) are not the JAX policy of bf16 activations.
"""

from __future__ import annotations

from typing import Dict

import torch
from torch import nn


def dtype_of(cfg) -> torch.dtype:
    """cfg.compute_dtype as a torch dtype."""
    dt = getattr(torch, cfg.compute_dtype, None)
    if not isinstance(dt, torch.dtype):
        raise ValueError(f"unknown compute_dtype {cfg.compute_dtype!r}")
    return dt


def is_half(cfg) -> bool:
    return dtype_of(cfg) != torch.float32


def cast_floating(obj, dtype: torch.dtype):
    """Cast every floating parameter and buffer of a module (in place), or
    every floating tensor of a `state_dict` (a new dict), to `dtype`;
    integer and bool tensors are left alone."""
    if isinstance(obj, nn.Module):
        for t in list(obj.parameters()) + list(obj.buffers()):
            if t.is_floating_point():
                t.data = t.data.to(dtype)
        return obj
    return {
        k: (v.to(dtype) if v.is_floating_point() else v) for k, v in obj.items()
    }


def cast_params_for_compute(model: nn.Module, dtype: torch.dtype) -> Dict[str, torch.Tensor]:
    """{name: the parameter cast to `dtype`} for every floating parameter,
    each cast recorded by autograd, for `torch.func.functional_call`;
    buffers are left out, so the module keeps its own (float32) ones."""
    return {
        name: p.to(dtype) if p.is_floating_point() else p
        for name, p in model.named_parameters()
    }


def cast_batch_for_compute(cfg, xs: torch.Tensor) -> torch.Tensor:
    return xs.to(dtype_of(cfg)) if is_half(cfg) else xs
