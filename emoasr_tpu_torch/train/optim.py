"""Optimizer and LR schedules (PyTorch port of `emoasr_tpu/train/optim.py`).

Parity target: emoASR `asr/optimizers.py`:
- `noam`: lr = base * d_model^-0.5 * min(step^-0.5, step * warmup^-1.5)
  (optimizers.py:57-63)
- `epdecay`: linear warmup to base, then constant; multiplied by
  `lr_decay_rate` at each epoch >= `lr_decay_start_epoch` (:52-56, 88-97)
- `lindecay`: linear warmup then linear decay to 0 over total steps (:65-77)
- ASR uses torch Adam with *coupled* L2 weight_decay; the LM trainer uses
  AdamW, the decay decoupled from Adam, with biases, LayerNorm / BatchNorm
  weights and the relative-position biases excluded from it
  (`lm/train_lm.py:188-195`, `optimizers.py:128-137`).
- NaN/inf grads skip the step (train_asr.py:83-90); grad clipping by global
  norm; gradient accumulation (`accum_grad`) are in `train/step.py`.

The LR is a pure function of (step, epoch_scale), computed on the host and
set on the optimizer at each update.
"""

from __future__ import annotations

from typing import Callable, Dict, Iterable, Optional, Union

import torch
from torch import nn

from emoasr_tpu_torch.config import ExpConfig


def resolve_warmup(cfg: ExpConfig, num_total_steps: Optional[int]) -> int:
    """`num_warmup_steps` xor `warmup_proportion` (optimizers.py:18-28)."""
    if (cfg.num_warmup_steps is None) == (cfg.warmup_proportion is None):
        raise ValueError("exactly one of num_warmup_steps / warmup_proportion must be set")
    if cfg.warmup_proportion is not None:
        if num_total_steps is None:
            raise ValueError("warmup_proportion needs the total number of optimizer steps")
        return int(num_total_steps * cfg.warmup_proportion)
    return cfg.num_warmup_steps


def make_lr_fn(cfg: ExpConfig, num_total_steps: Optional[int] = None) -> Callable[..., float]:
    """Returns lr(step, epoch_scale) -> float.

    `step` counts optimizer updates starting at 1; `epoch_scale` carries the
    cumulative epdecay factor (1.0 otherwise)."""
    warmup = resolve_warmup(cfg, num_total_steps)
    base = cfg.learning_rate
    sched = cfg.lr_schedule_type

    if sched == "noam":
        d_model = cfg.enc_hidden_size if cfg.encoder_type else cfg.hidden_size

        def lr(step, epoch_scale=1.0):
            s = max(float(step), 1.0)
            return base * d_model ** -0.5 * min(s ** -0.5, s * warmup ** -1.5)

    elif sched == "epdecay":

        def lr(step, epoch_scale=1.0):
            s = float(step)
            warm = base / max(1.0, warmup) * s
            return (warm if s <= warmup else base) * epoch_scale

    elif sched == "lindecay":
        if num_total_steps is None:
            raise ValueError("lindecay needs the total number of optimizer steps")

        def lr(step, epoch_scale=1.0):
            s = float(step)
            if s <= warmup:
                return base / max(1.0, warmup) * s
            return base * max(0.0, (num_total_steps - s) / max(1.0, num_total_steps - warmup))

    else:
        raise ValueError(sched)

    return lr


def nodecay_mask(model: nn.Module) -> Dict[str, bool]:
    """By parameter name: True where weight decay applies.  The reference
    exempts every parameter whose name contains "bias" and the LayerNorms'
    weights (optimizers.py:128-137): here `*.bias`, the LSTMs' `bias_ih_l*`
    and `bias_hh_l*`, LayerNorm and BatchNorm weights, and the Conformer's
    `pos_bias_u` / `pos_bias_v`.  (The JAX package's mask, by flax leaf
    name, misses the LSTM biases, which flax names `bias_ih` / `bias_hh`;
    ROADMAP.md §3.)"""
    norms = {id(m.weight) for m in model.modules()
             if isinstance(m, (nn.LayerNorm, nn.BatchNorm1d, nn.BatchNorm2d)) and m.weight is not None}
    mask = {}
    for name, p in model.named_parameters():
        leaf = name.rsplit(".", 1)[-1]
        exempt = leaf == "bias" or leaf.startswith(("bias_ih", "bias_hh")) or leaf in ("pos_bias_u", "pos_bias_v")
        mask[name] = not (exempt or id(p) in norms)
    return mask


def build_optimizer(cfg: ExpConfig, params: Union[nn.Module, Iterable[torch.nn.Parameter]],
                    use_adamw: bool = False) -> torch.optim.Optimizer:
    """torch Adam (b1 0.9, b2 0.999, eps 1e-8) with coupled L2: the decay
    term joins the gradient before the moment updates, after the clip
    (`train/step.py` clips the accumulated gradient first).

    `use_adamw` (the LM trainer; `params` is then the model): AdamW with
    two parameter groups, `nodecay_mask`'s exempt parameters at weight
    decay 0, the update p - lr (adam(g) + wd p), as the JAX package's
    clip -> scale_by_adam -> add_decayed_weights(mask) -> -lr.  The `lr` of
    every group is set at every update from `make_lr_fn`."""
    kw = dict(lr=0.0, betas=(0.9, 0.999), eps=1e-8)
    if not use_adamw:
        if isinstance(params, nn.Module):
            params = params.parameters()
        return torch.optim.Adam(list(params), weight_decay=float(cfg.weight_decay or 0.0), **kw)
    if not isinstance(params, nn.Module):
        raise TypeError("build_optimizer(use_adamw=True) takes the model, for its parameters' names")
    mask = nodecay_mask(params)
    named = [(n, p) for n, p in params.named_parameters() if p.requires_grad]
    groups = [
        {"params": [p for n, p in named if mask[n]], "weight_decay": float(cfg.weight_decay or 0.0)},
        {"params": [p for n, p in named if not mask[n]], "weight_decay": 0.0},
    ]
    return torch.optim.AdamW([g for g in groups if g["params"]], **kw)


def grads_finite(grads) -> torch.Tensor:
    """0-dim bool tensor: every gradient is finite.  Decided on the sum of
    squares, which a NaN or an inf anywhere turns non-finite."""
    norms = torch._foreach_norm(list(grads))
    return torch.isfinite(torch.stack(norms).square().sum())


def finite_or_zero(grads):
    """Zero the whole gradient list if any entry is non-finite; returns
    (grads, was_finite).  Mirrors the reference's NaN-step skip."""
    grads = list(grads)
    finite = grads_finite(grads)
    return [torch.where(finite, g, torch.zeros_like(g)) for g in grads], finite


def sharded_norm(grads, sharded, group) -> torch.Tensor:
    """The global L2 norm of gradients of which those flagged in `sharded`
    are a rank's shares over the model group `group` (tensor parallelism):
    their squares are summed over the group, the whole ones' counted once."""
    grads = list(grads)
    sq = [torch.zeros((), dtype=torch.float32, device=grads[0].device) for _ in range(2)]
    for g, part in zip(grads, sharded):
        sq[int(bool(part))] = sq[int(bool(part))] + g.float().square().sum()
    torch.distributed.all_reduce(sq[1], group=group)
    return (sq[0] + sq[1]).sqrt()


def clip_by_global_norm_(grads, max_norm: float, sharded=None, group=None) -> torch.Tensor:
    """Scale `grads` in place so that their global L2 norm is at most
    `max_norm` (g * max_norm / norm when the norm is not below it); returns
    the norm before clipping.  `sharded`/`group`: the norm of `sharded_norm`."""
    grads = list(grads)
    if sharded is None:
        norm = torch.stack(torch._foreach_norm(grads)).norm()
    else:
        norm = sharded_norm(grads, sharded, group)
    scale = torch.where(norm < max_norm, torch.ones_like(norm), max_norm / norm)
    for g in grads:
        g.mul_(scale)
    return norm
