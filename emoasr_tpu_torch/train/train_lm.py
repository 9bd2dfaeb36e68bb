"""LM / P2W training loop + CLI (PyTorch port of `emoasr_tpu/train/train_lm.py`).

Parity target: emoASR `lm/train_lm.py:40-327`: the ASR trainer's skeleton
with AdamW and its no-decay parameter group (:188-195), total steps from
`train_size` for `lindecay` and `warmup_proportion` (:183-186), sharded
train directories whose files are shuffled every epoch (:217-253),
`model.ep{N}` / `optim.ep{N}` every `save_step` epochs, and `--resume`;
P2W batches (`P2WDataset`: `ps`, `plens`) for the phone-conditioned types
(:165-168), and discriminator-only training (`forward_disc` on the
`error_labels` column) for the `*-disc` types.

The step is `train/step.py::make_train_step` with the LM's loss: gradient
accumulation, clip by global norm, and a non-finite micro-step that moves
neither the weights nor the moments nor the open accumulation (the step
counter still advances), as the JAX step does.  Dropout (the BERT stack's
0.1, the RNN LM's `dropout_rate`, the P2W encoder's and decoder's rates) is
on in training; `nn.Dropout` draws from PyTorch's global generator, the
fused attention's dropout seeds (a P2W phone encoder with `enc_fused_attn`)
from a generator of their own, and ELECTRA's and P-ELECTRA's replacements
from a sampling generator that the step is given; all three are seeded from
`seed`.

Usage: `python -m emoasr_tpu_torch.train.train_lm -conf lm.yaml [--resume] [--cpu]`
(on the GPU unless `--cpu` is given).  Started by `torchrun` it trains on
the yaml's mesh, as `train/loop.py` does (JAX `train_lm.py:95-107`): BERT's
query/key/value and intermediate products column-parallel, its attention
output and per-layer output row-parallel (`parallel/tensor.py`).
"""

from __future__ import annotations

import argparse
import logging
import os
import time
from typing import Dict, Optional

import numpy as np
import torch

from emoasr_tpu_torch.config import ExpConfig, load_config
from emoasr_tpu_torch.data.lm_dataset import LMDataset, P2WDataset
from emoasr_tpu_torch.models.lm.lm import DISC_TYPES, LM, LM_TYPES, PHONE_TYPES
from emoasr_tpu_torch.parallel import mesh as pmesh
from emoasr_tpu_torch.train import checkpoint as ckpt
from emoasr_tpu_torch.train.loop import build_train_state, prefetch_to_device
from emoasr_tpu_torch.train.step import TrainState, make_train_step
from emoasr_tpu_torch.utils.device import resolve_device, set_matmul_precision
from emoasr_tpu_torch.utils.log import setup_logging
from emoasr_tpu_torch.utils.paths import get_log_save_paths, get_resume_paths
from emoasr_tpu_torch.utils.precision import cast_params_for_compute, dtype_of, is_half

def is_p2w(cfg: ExpConfig) -> bool:
    return cfg.lm_type in ("ptransformer", "pbert", "pctc")


def lm_loss(model: LM, cfg: ExpConfig, batch: Dict, generator=None, train: bool = True):
    """(loss, loss_dict) of one LM batch (`ys_in`, `ylens`, and `labels`,
    `ps`, `plens` or, for the `*-disc` types, `error_labels`), the forward
    in `cfg.compute_dtype` on a cast copy of the float32 masters under a
    half policy (as `train/step.py::compute_loss`); `generator` draws
    ELECTRA's and P-ELECTRA's replacements."""
    if cfg.lm_type in DISC_TYPES:
        args, kw = (batch["ys_in"], batch["ylens"]), {"error_labels": batch["error_labels"]}
    else:
        args = (batch["ys_in"], batch["ylens"], batch.get("labels"), batch.get("ps"), batch.get("plens"))
        kw = {"generator": generator}
    if not is_half(cfg):
        return model(*args, **kw)
    return torch.func.functional_call(model, cast_params_for_compute(model, dtype_of(cfg)), args, kw)


def check_lm_type(cfg: ExpConfig) -> None:
    if cfg.lm_type not in LM_TYPES:
        raise ValueError(f"lm_type={cfg.lm_type!r}: one of {LM_TYPES}")


def make_dataset(cfg: ExpConfig, path: str, phase: str, seed: int = 0):
    """`P2WDataset` for the phone-conditioned types, else `LMDataset`."""
    if cfg.lm_type in PHONE_TYPES and cfg.lm_type != "pelectra-disc":
        return P2WDataset(cfg, path, phase=phase, seed=seed)
    return LMDataset(cfg, path, phase=phase, seed=seed)


def make_lm_train_step(cfg: ExpConfig, num_total_steps: Optional[int] = None):
    """step_fn(state, batch, generator=None) -> metrics
    (`train_lm.py:41-108`); `generator` draws ELECTRA's replacements."""
    check_lm_type(cfg)
    return make_train_step(cfg, num_total_steps, loss_fn=lm_loss)


def _train_files(cfg: ExpConfig, epoch: int):
    """A sharded `train_path` directory: its files, shuffled each epoch by
    `default_rng(seed + epoch)` (:217-253); a file: itself."""
    path = cfg.train_path
    if os.path.isdir(path):
        files = sorted(os.path.join(path, f) for f in os.listdir(path) if not f.startswith("."))
        np.random.default_rng(cfg.seed + epoch).shuffle(files)
        return files
    return [path]


def num_total_steps_of(cfg: ExpConfig) -> Optional[int]:
    """Optimizer steps of the whole run from `train_size` (:183-186)."""
    if cfg.train_size is None:
        return None
    return cfg.train_size // cfg.batch_size * cfg.num_epochs // cfg.accum_grad


def train(conf_path: str, resume: bool = False, cfg: Optional[ExpConfig] = None, device=None) -> TrainState:
    """Run LM training on `device` (the card when None; "cpu" must be asked
    for)."""
    cfg = cfg or load_config(conf_path)
    check_lm_type(cfg)
    device = resolve_device(device)
    mesh = pmesh.mesh_from_env(cfg, device)  # None unless started by torchrun
    if mesh is not None:
        device = mesh.device
    set_matmul_precision(cfg.compute_dtype)
    log_dir, save_fmt, optim_save_fmt = get_log_save_paths(conf_path)
    if mesh is None or mesh.is_main:
        setup_logging(os.path.join(log_dir, "train.log"))
    else:
        setup_logging(None, logging.WARNING)
    logging.info(f"config: {conf_path} on {device}")
    if mesh is not None:
        logging.info(pmesh.describe(mesh))

    num_total_steps = num_total_steps_of(cfg)
    if num_total_steps is not None:
        logging.info(f"total steps: {num_total_steps}")

    model_path, optim_path, start_epoch = cfg.model_path, cfg.optim_path, cfg.startep
    if resume:
        r_model, r_optim, r_ep = get_resume_paths(conf_path)
        model_path, optim_path, start_epoch = r_model or model_path, r_optim or optim_path, r_ep or start_epoch
    # the sampling generator: ELECTRA's replacements; a P2W phone encoder's
    # fused attention draws from the model's dropout generator
    state, sample_gen = build_train_state(cfg, device, mesh, model_path, optim_path, lm=True)

    step_fn = make_lm_train_step(cfg, num_total_steps)
    for epoch in range(start_epoch, cfg.num_epochs):
        t0 = time.time()
        n_steps = 0
        accum: Dict[str, torch.Tensor] = {}
        for path in _train_files(cfg, epoch):
            dataset = make_dataset(cfg, path, "train", cfg.seed + epoch)
            for batch in prefetch_to_device(dataset.batches(seed=cfg.seed + epoch), device, mesh=mesh):
                metrics = step_fn(state, batch, sample_gen)
                lr = metrics.pop("lr")
                metrics.pop("grad_finite")
                n_steps += 1
                for k, v in metrics.items():  # the sums stay on the device between log steps
                    accum[k] = accum[k] + v if k in accum else v
                if n_steps % cfg.log_step == 0:
                    loss_str = " ".join(f"{k}: {float(v) / cfg.log_step:.3f}" for k, v in accum.items())
                    logging.info(f"epoch {epoch + 1} step {n_steps} {loss_str} lr: {lr:.6f}")
                    accum = {}
        logging.info(f"epoch {epoch + 1} done in {time.time() - t0:.1f}s "
                     f"({n_steps} steps, skipped {state.skipped})")
        if (epoch + 1) % cfg.save_step == 0:
            ckpt.save_checkpoint(mesh, save_fmt.format(epoch + 1), optim_save_fmt.format(epoch + 1), state)
            logging.info(f"checkpoint saved: {save_fmt.format(epoch + 1)}")
    return state


def build_argparser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser()
    parser.add_argument("-conf", type=str, required=True)
    parser.add_argument("--resume", action="store_true")
    parser.add_argument("--cpu", action="store_true", help="run on the CPU (the default is the GPU)")
    return parser


def main(argv=None) -> TrainState:
    args = build_argparser().parse_args(argv)
    try:
        return train(args.conf, resume=args.resume, device="cpu" if args.cpu else None)
    finally:
        pmesh.shutdown()


if __name__ == "__main__":
    main()
