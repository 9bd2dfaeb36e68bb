"""Train / valid steps (PyTorch port of `emoasr_tpu/train/step.py`).

Replaces the reference's `train_step` (`asr/train_asr.py:35-98`): forward,
backward, gradient accumulation, clip, NaN-skip, scheduled LR, optimizer
step.  SpecAugment and frame stacking run on the device (`preprocess`),
keeping the host path IO-only.

`TrainState` holds what a step changes besides the weights and moments:
the micro-step counter, the cumulative epdecay factor, the count of skipped
micro-steps, and the open gradient accumulation.  The model's parameters
and the optimizer's moments are updated in place.

Under a half `compute_dtype` the step follows the JAX package's policy
(`utils/precision.py`): SpecAugment runs on the float32 features, then the
batch is cast; the forward runs on a bf16 copy of the float32 master
parameters through `torch.func.functional_call`, so the gradients come back
float32; accumulation, clip, NaN-skip and Adam stay float32 on the masters.

On a mesh (`parallel/mesh.py`, the model laid out by
`parallel/tensor.py::prepare_model_`) each rank takes its rows of the
global batch; its loss is its share of the global loss (the losses divide
by the global batch's counts), the micro-gradients are summed over the
data group in one all-reduce before the finiteness test, so every rank
skips the same micro-steps, the clip's norm counts each tensor-parallel
share once, Adam runs on each rank's shares, and the logged loss terms are
the global ones.  Without a mesh the step is the single-process one.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional

import torch

from emoasr_tpu_torch.config import ExpConfig
from emoasr_tpu_torch.ops.specaug import spec_augment
from emoasr_tpu_torch.parallel import mesh as pmesh
from emoasr_tpu_torch.train.optim import clip_by_global_norm_, grads_finite, make_lr_fn
from emoasr_tpu_torch.utils.precision import (
    cast_batch_for_compute,
    cast_params_for_compute,
    dtype_of,
    is_half,
)
from emoasr_tpu_torch.utils.profile import span


@dataclass
class TrainState:
    model: torch.nn.Module
    optimizer: torch.optim.Optimizer
    step: int = 0  # micro-steps taken, skipped ones included
    epoch_scale: float = 1.0  # cumulative epdecay factor
    skipped: int = 0  # micro-steps skipped for non-finite gradients
    mini_step: int = 0  # micro-gradients in the open accumulation
    acc_grads: List[torch.Tensor] = field(default_factory=list)  # their sum

    @property
    def params(self) -> List[torch.nn.Parameter]:
        return [p for p in self.model.parameters() if p.requires_grad]


def preprocess(cfg: ExpConfig, xs: torch.Tensor, xlens: torch.Tensor,
               generator: Optional[torch.Generator] = None, train: bool = False):
    """SpecAugment (training only) then frame stacking, on the device
    (reference order: spec_augment.py before _stack_frames,
    datasets.py:94-101)."""
    if train and cfg.spec_augment:
        xs = spec_augment(
            generator, xs, xlens,
            max_mask_freq=cfg.max_mask_freq,
            num_masks_freq=cfg.num_masks_freq,
            max_mask_time=cfg.max_mask_time,
            num_masks_time=cfg.num_masks_time,
            max_mask_time_ratio=cfg.max_mask_time_ratio,
            num_masks_time_ratio=cfg.num_masks_time_ratio,
            replace_with_zero=cfg.replace_with_zero,
            rows=pmesh.rows_block(xs.shape[0]),
        )
    n = cfg.num_framestacks
    if n > 1:
        B, T, F = xs.shape
        xs = xs[:, : (T // n) * n].reshape(B, T // n, F * n)
        xlens = torch.div(xlens, n, rounding_mode="floor")
    return xs, xlens


def compute_loss(model, cfg: ExpConfig, batch: Dict, generator=None, train: bool = True):
    """(loss, loss_dict) of one batch as the step computes it: preprocess,
    then the forward in `cfg.compute_dtype` (on a cast copy of the master
    parameters under a half policy, so that gradients reach the masters in
    float32)."""
    xs, xlens = preprocess(cfg, batch["xs"], batch["xlens"], generator, train)
    args = (cast_batch_for_compute(cfg, xs), xlens, batch["ys"], batch["ylens"], batch.get("ys_in"),
            batch.get("ys_out"), batch.get("soft_labels"), batch.get("ps"), batch.get("plens"))
    if not is_half(cfg):
        return model(*args)
    return torch.func.functional_call(model, cast_params_for_compute(model, dtype_of(cfg)), args)


def make_train_step(cfg: ExpConfig, num_total_steps: Optional[int] = None,
                    loss_fn: Callable = compute_loss) -> Callable:
    """Build the train step (of an ASR model; the LM trainer passes its own
    `loss_fn(model, cfg, batch, generator, train)`).

    Returns step_fn(state, batch, generator=None) -> metrics.  `batch`:
    dict of tensors on the model's device with xs/xlens/ys/ylens (+ys_in,
    ys_out, ps, plens); `generator` draws the SpecAugment masks.  Metrics
    are the loss terms (0-dim tensors on the device, detached), `lr`
    (float) and `grad_finite` (bool).

    One call is one micro-step.  `accum_grad` finite micro-gradients are
    averaged, the average is clipped by its global norm, and one Adam
    update is made at the LR of optimizer step
    `(step + accum_grad - 1) // accum_grad`.  A micro-step whose gradient
    is not finite leaves the parameters, the moments and the open
    accumulation as they were and counts as skipped; the micro-step counter
    advances all the same (`train_asr.py:83-121`).  The finiteness test
    reads one scalar back from the device, once per micro-step.  Under a
    half `compute_dtype` the forward runs in that dtype and everything from
    the gradients on stays float32 (see the module note)."""
    lr_fn = make_lr_fn(cfg, num_total_steps)
    accum = max(int(cfg.accum_grad), 1)
    mesh = pmesh.active()
    if mesh is not None and mesh.world == 1:
        mesh = None  # a world of one: the single-process step

    def step_fn(state: TrainState, batch: Dict, generator=None) -> Dict:
        with span("train.micro_step", key=state.step + 1):
            return micro_step(state, batch, generator)

    def micro_step(state: TrainState, batch: Dict, generator) -> Dict:
        model, params = state.model, state.params
        model.train()
        with span("train.forward"):
            loss, loss_dict = loss_fn(model, cfg, batch, generator, True)
        with span("train.backward"):  # autograd launches the backward's kernels from its device thread
            grads = torch.autograd.grad(loss, params, allow_unused=True)
        grads = [torch.zeros_like(p) if g is None else g for g, p in zip(grads, params)]
        clip_kw = {}
        if mesh is None:
            finite = bool(grads_finite(grads))
        else:
            grads = [g.contiguous() for g in grads]  # summed in place
            if mesh.data_size > 1:
                pmesh.all_reduce_flat_(grads, mesh.data_group)
            finite = _finite_on_every_rank(grads, mesh)
            if mesh.model_size > 1:
                plan = getattr(model, "tp_plan", {})
                clip_kw = dict(sharded=[n in plan for n, p in model.named_parameters() if p.requires_grad],
                               group=mesh.model_group)

        state.step += 1
        # the scheduler counts optimizer updates, one per accum_grad micro-steps
        opt_step = (state.step + accum - 1) // accum
        lr = lr_fn(opt_step, state.epoch_scale)

        if finite:
            if not state.acc_grads:
                state.acc_grads = [torch.zeros_like(p) for p in params]
            torch._foreach_add_(state.acc_grads, grads)
            state.mini_step += 1
            if state.mini_step == accum:
                with span("train.update"):
                    if accum > 1:
                        torch._foreach_div_(state.acc_grads, float(accum))
                    if cfg.clip_grad_norm and cfg.clip_grad_norm > 0:
                        clip_by_global_norm_(state.acc_grads, float(cfg.clip_grad_norm), **clip_kw)
                    for p, g in zip(params, state.acc_grads):
                        p.grad = g
                    for group in state.optimizer.param_groups:
                        group["lr"] = lr
                    state.optimizer.step()
                    for p in params:
                        p.grad = None
                    torch._foreach_zero_(state.acc_grads)
                state.mini_step = 0
        else:
            state.skipped += 1

        metrics = pmesh.reduce_metrics(mesh, {k: v.detach() for k, v in loss_dict.items()})
        metrics["lr"] = lr
        metrics["grad_finite"] = finite
        return metrics

    return step_fn


def _finite_on_every_rank(grads, mesh) -> bool:
    """The summed micro-gradient is finite on every rank of the model group
    (each holds other tensor-parallel shares)."""
    bad = (~grads_finite(grads)).float()
    if mesh.model_size > 1:
        torch.distributed.all_reduce(bad, group=mesh.model_group)
    return not bool(bad)


def make_eval_loss_step(cfg: ExpConfig) -> Callable:
    """Validation loss (no SpecAugment, dropout off): step_fn(state, batch)
    -> loss_dict.

    Batches built with `pad_to_batch` repeat the first utterance into the
    tail rows; the loss is a whole-batch mean, so callers that aggregate
    over utterances weight by `batch["n_valid"]`."""

    @torch.no_grad()
    def step_fn(state: TrainState, batch: Dict) -> Dict:
        was_training = state.model.training
        state.model.eval()
        _, loss_dict = compute_loss(state.model, cfg, batch, None, False)
        state.model.train(was_training)
        return loss_dict

    return step_fn
