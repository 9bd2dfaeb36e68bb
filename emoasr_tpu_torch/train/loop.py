"""ASR training loop + CLI (PyTorch port of `emoasr_tpu/train/loop.py`).

Parity target: emoASR `asr/train_asr.py`: epoch loop with grad-accum,
clip + NaN skip, per-`log_step` averaged loss logging with LR, per-epoch
greedy-WER validation, `model.ep{N}`/`optim.ep{N}` checkpointing,
`--resume`, warm start via `model_path`, epoch wall-clock + ETA logging.

Usage: `python -m emoasr_tpu_torch.train.loop -conf exp.yaml [--resume] [--cpu]`

It runs on the GPU unless `--cpu` is given.  The yaml's `compute_dtype`
picks the precision (`bfloat16`: the forward in bf16 on float32 masters,
`train/step.py`); checkpoints hold the float32 masters either way.

Started by `torchrun` (`python -m torch.distributed.run --standalone
--nproc_per_node N -m emoasr_tpu_torch.train.loop -conf exp.yaml [--cpu]`)
it trains on the mesh of the yaml's `mesh_shape` / `mesh_axes` over the N
ranks (`parallel/mesh.py`; JAX `loop.py:176`): each rank builds the model
from the one seed, keeps its tensor-parallel shares
(`parallel/tensor.py`), takes its rows of every batch and draws what one
process draws for them; rank 0 alone logs, validates and writes the
checkpoints, in the single-process format.  A bucket batch that the data
axis does not divide raises, as the JAX loop's `device_put` does.

`--profile DIR` traces batches 8-12 of the first epoch (`utils/profile.py`;
JAX `loop.py:233-242`), stopped once the step's outputs are on the host; a
first epoch of fewer than 13 batches stops the trace at its end (the JAX
loop leaves it running).  Under torchrun only rank 0 traces.
"""

from __future__ import annotations

import argparse
import copy
import logging
import os
import queue
import threading
import time
from typing import Dict, Iterator, Optional, Tuple, Union

import numpy as np
import torch

from emoasr_tpu_torch.config import ExpConfig, load_config
from emoasr_tpu_torch.data.asr_dataset import ASRDataset
from emoasr_tpu_torch.eval.decode import build_decode_fn
from emoasr_tpu_torch.eval.wer import compute_wers
from emoasr_tpu_torch.models.asr import ASR
from emoasr_tpu_torch.models.layers import set_dropout_generator
from emoasr_tpu_torch.models.lm.lm import LM, load_lm_state_dict
from emoasr_tpu_torch.parallel import mesh as pmesh
from emoasr_tpu_torch.parallel.tensor import prepare_model_
from emoasr_tpu_torch.train import checkpoint as ckpt
from emoasr_tpu_torch.train.optim import build_optimizer
from emoasr_tpu_torch.train.step import TrainState, make_train_step, preprocess
from emoasr_tpu_torch.utils.converters import strip_eos
from emoasr_tpu_torch.utils.device import resolve_device, set_matmul_precision
from emoasr_tpu_torch.utils.log import setup_logging
from emoasr_tpu_torch.utils.paths import get_log_save_paths, get_resume_paths
from emoasr_tpu_torch.utils.precision import cast_floating, dtype_of, is_half
from emoasr_tpu_torch.utils.profile import TRAIN_FIRST, TRAIN_LAST, Trace
from emoasr_tpu_torch.utils.vocab import Vocab


def array_only(batch: Dict) -> Dict:
    return {k: v for k, v in batch.items() if isinstance(v, np.ndarray)}


def prefetch_to_device(batch_iter, device: torch.device, depth: int = 3,
                       mesh: Optional[pmesh.Mesh] = None) -> Iterator[Dict]:
    """Producer-thread pipeline: collate and the host-to-device copy run
    ahead of the training step.  On a `mesh` only this rank's rows of each
    batch are copied (`parallel/mesh.py::shard_batch`).

    The reference gets this from DataLoader(num_workers=2)
    (`asr/train_asr.py:248-257`); here a thread collates (numpy and file
    IO release the GIL) and, on the card, copies from pinned memory on a
    stream of its own with `non_blocking=True`; the consumer's stream waits
    for the copy's event before it touches the batch."""
    q: "queue.Queue" = queue.Queue(maxsize=depth)
    stop = threading.Event()
    err: list = []
    on_card = device.type == "cuda"
    copy_stream = torch.cuda.Stream(device) if on_card else None

    def put(item) -> bool:
        while not stop.is_set():
            try:
                q.put(item, timeout=0.2)
                return True
            except queue.Full:
                continue
        return False

    def to_device(batch: Dict):
        host = {k: torch.from_numpy(v) for k, v in pmesh.shard_batch(mesh, array_only(batch)).items()}
        if not on_card:
            return host, None, None
        host = {k: v.pin_memory() for k, v in host.items()}
        with torch.cuda.stream(copy_stream):
            dev = {k: v.to(device, non_blocking=True) for k, v in host.items()}
            done = torch.cuda.Event()
            done.record(copy_stream)
        return dev, done, host  # `host` stays alive until the copy is done

    def producer():
        try:
            for batch in batch_iter:
                if not put(to_device(batch)):
                    return
        except Exception as e:  # noqa: BLE001 - re-raised in the consumer
            err.append(e)
        finally:
            put(None)

    thread = threading.Thread(target=producer, daemon=True)
    thread.start()
    try:
        while True:
            item = q.get()
            if item is None:
                if err:
                    raise err[0]
                break
            batch, done, _host = item
            if done is not None:
                cur = torch.cuda.current_stream(device)
                cur.wait_event(done)
                for t in batch.values():
                    t.record_stream(cur)
            yield batch
    finally:
        stop.set()
        thread.join(timeout=10)


@torch.no_grad()
def greedy_valid_wer(cfg: ExpConfig, model: ASR, dataset: ASRDataset, vocab=None) -> float:
    """Per-epoch greedy WER on the dev set (train_asr.py:146-184); the
    model is switched to `eval()` and back.  CTC, RNN-T and LAS decoders
    decode greedily (batched, JAX `loop.py:111`); the attention decoder runs
    a width-1 beam
    (`eval/decode.py::build_decode_fn(..., beam_width=1)`, as the reference
    decodes with beam_width=1).  Under a half `compute_dtype` a cast copy
    decodes, as the JAX package's validation decodes the cast variables."""
    device = next(model.parameters()).device
    was_training = model.training
    model.eval()
    decoder = cast_floating(copy.deepcopy(model), dtype_of(cfg)) if is_half(cfg) else model
    beam = cfg.decoder_type == "transformer"
    decode_fn = build_decode_fn(decoder, cfg, beam_width=1, device=device) if beam else None
    hyps_all, refs_all = [], []
    try:
        for batch in dataset.batches():
            if beam:
                hyps, hyp_lens, _ = decode_fn(batch["xs"], batch["xlens"])
                hyps, hyp_lens = hyps[:, 0], hyp_lens[:, 0]
            else:
                xs = torch.from_numpy(batch["xs"]).to(device, dtype_of(cfg))
                xlens = torch.from_numpy(batch["xlens"]).to(device, torch.int64)
                hyps, hyp_lens, _, _ = decoder.decode_greedy(*preprocess(cfg, xs, xlens))
            hyps, hyp_lens = hyps.cpu().numpy(), hyp_lens.cpu().numpy()
            for b in range(len(batch["utt_ids"])):
                hyp_ids = hyps[b, : hyp_lens[b]].tolist()
                if beam:  # beam hypotheses carry their framing eos tokens
                    hyp_ids = strip_eos(hyp_ids, cfg.eos_id)
                ref_ids = batch["ys"][b, : batch["ylens"][b]].tolist()
                if vocab is not None:
                    hyps_all.append(vocab.ids2words(hyp_ids))
                    refs_all.append(vocab.ids2words(ref_ids))
                else:
                    hyps_all.append(list(map(str, hyp_ids)))
                    refs_all.append(list(map(str, ref_ids)))
    finally:
        model.train(was_training)
    wer, _ = compute_wers(hyps_all, refs_all)
    return wer


def train(conf_path: str, resume: bool = False, cfg: Optional[ExpConfig] = None,
          max_steps: Optional[int] = None, device=None, profile_dir: Optional[str] = None) -> TrainState:
    """Run the training loop on `device` (the card when None; "cpu" must be
    asked for); `max_steps` bounds the run in micro-steps (a checkpoint is
    saved on early stop), for bounded demo runs; `profile_dir` traces
    batches 8-12 of the first epoch there (see the module note)."""
    cfg = cfg or load_config(conf_path)
    device = resolve_device(device)
    mesh = pmesh.mesh_from_env(cfg, device)  # None unless started by torchrun
    if mesh is not None:
        device = mesh.device
    main = mesh is None or mesh.is_main
    set_matmul_precision(cfg.compute_dtype)
    log_dir, save_fmt, optim_save_fmt = get_log_save_paths(conf_path)
    if main:
        setup_logging(os.path.join(log_dir, "train.log"))
    else:
        setup_logging(None, logging.WARNING)
    logging.info(f"config: {conf_path} on {device}")
    if mesh is not None:
        logging.info(pmesh.describe(mesh))

    dataset = ASRDataset(cfg, cfg.train_path, phase="train")
    dev_dataset = ASRDataset(cfg, cfg.dev_path, phase="valid") if cfg.dev_path else None
    vocab = Vocab(cfg.vocab_path) if cfg.vocab_path and os.path.exists(cfg.vocab_path) else None

    steps_per_epoch = len(dataset.make_batcher(seed=cfg.seed))
    num_total_steps = None
    if cfg.lr_schedule_type == "lindecay" or cfg.warmup_proportion is not None:
        num_total_steps = steps_per_epoch * cfg.num_epochs // cfg.accum_grad

    # resume / warm start (paths.py:81-129, train_asr.py:215-227)
    model_path, optim_path, start_epoch = cfg.model_path, cfg.optim_path, cfg.startep
    if resume:
        r_model, r_optim, r_ep = get_resume_paths(conf_path)
        model_path, optim_path, start_epoch = (
            r_model or model_path, r_optim or optim_path, r_ep or start_epoch
        )
    state, sa_gen = build_train_state(cfg, device, mesh, model_path, optim_path)
    model = state.model

    train_step = make_train_step(cfg, num_total_steps)

    stopped_early = False
    for epoch in range(start_epoch, cfg.num_epochs):
        t0 = time.time()
        batcher = dataset.make_batcher(seed=cfg.seed + epoch)
        accum: Dict[str, torch.Tensor] = {}
        n_acc = 0
        lr = 0.0
        trace = None
        for i, batch in enumerate(prefetch_to_device(dataset.batches(batcher), device, mesh=mesh)):
            if max_steps is not None and state.step >= max_steps:
                stopped_early = True
                break
            if profile_dir and main and epoch == start_epoch and i == TRAIN_FIRST:
                trace = Trace(profile_dir, "train_steps", device).start()
            metrics = train_step(state, batch, sa_gen)
            if trace is not None and i == TRAIN_LAST:
                trace.stop()
                trace = None
            lr = metrics.pop("lr")
            metrics.pop("grad_finite")
            # the loss sums stay on the device between log steps
            for k, v in metrics.items():
                accum[k] = accum[k] + v if k in accum else v
            n_acc += 1
            if (i + 1) % cfg.log_step == 0:
                loss_str = " ".join(f"{k}: {float(v) / n_acc:.3f}" for k, v in accum.items())
                logging.info(
                    f"epoch {epoch + 1} step {i + 1}/{steps_per_epoch} {loss_str} lr: {lr:.6f}"
                )
                accum, n_acc = {}, 0

        if trace is not None:  # a first epoch of fewer than 13 batches
            trace.stop()

        # epdecay epoch update (optimizers.py:88-97)
        if (
            cfg.lr_schedule_type == "epdecay"
            and cfg.lr_decay_start_epoch is not None
            and (epoch + 1) >= cfg.lr_decay_start_epoch
        ):
            state.epoch_scale *= cfg.lr_decay_rate
            logging.info(f"learning rate decayed: scale={state.epoch_scale:.6f}")

        elapsed = time.time() - t0
        eta = elapsed * (cfg.num_epochs - epoch - 1)
        logging.info(
            f"epoch {epoch + 1} done in {elapsed:.1f}s (ETA {eta / 3600:.2f}h), "
            f"skipped steps: {state.skipped}"
        )

        # per-epoch greedy WER validation (train_asr.py:146-184), on rank 0
        if dev_dataset is not None:
            valid_model = _whole_model(cfg, model, mesh)
            if main:
                wer = greedy_valid_wer(cfg, valid_model, dev_dataset, vocab)
                logging.info(f"epoch {epoch + 1} dev WER (greedy): {wer:.2f}")
            pmesh.barrier(mesh)

        if (epoch + 1) % cfg.save_step == 0 or stopped_early:
            ckpt.save_checkpoint(mesh, save_fmt.format(epoch + 1), optim_save_fmt.format(epoch + 1), state)
            logging.info(f"checkpoint saved: {save_fmt.format(epoch + 1)}")
        if stopped_early:
            logging.info(f"stopping at max_steps={max_steps}")
            break

    return state


def build_train_state(cfg: ExpConfig, device: torch.device, mesh: Optional[pmesh.Mesh] = None,
                      weights: Union[str, Dict, None] = None, optim_path: Optional[str] = None,
                      lm: bool = False) -> Tuple[TrainState, torch.Generator]:
    """The trainers' set-up: the precision switches, then one seed for
    everything random (the initial weights and `nn.Dropout` draw from
    PyTorch's global generators, the fused attention's dropout from a
    generator of its own), the ASR model (or the LM, `lm`) on `device`,
    warm-started from `weights` (a `model.ep{N}` path or a state dict),
    its tensor-parallel shares on `mesh`, and a `TrainState` whose
    optimizer (AdamW for the LMs) takes them, its moments read from
    `optim_path`.  Also returns SpecAugment's (ASR) or the sampling (LM)
    generator, seeded alike on `device`.  (The CLIs set the switches
    earlier, before they touch the data; the rank programs get them here.)"""
    set_matmul_precision(cfg.compute_dtype)
    torch.manual_seed(cfg.seed)
    model = (LM(cfg) if lm else ASR(cfg)).to(device)
    gen = torch.Generator(device=device)
    gen.manual_seed(cfg.seed)
    do_gen = torch.Generator()
    do_gen.manual_seed(cfg.seed)
    set_dropout_generator(model, do_gen)
    logging.info(f"{'LM' if lm else 'ASR'} model #parameters: {sum(p.numel() for p in model.parameters())}")
    if weights:  # a path ("" in a yaml: none) or a state dict
        sd = ckpt.load_state_dict(weights) if isinstance(weights, str) else weights
        load_lm_state_dict(model, sd) if lm else model.load_state_dict(sd)
        if isinstance(weights, str):
            logging.info(f"model loaded: {weights}")
    prepare_model_(model, mesh)  # a rank's shares, before the optimizer takes them
    state = TrainState(model=model, optimizer=build_optimizer(cfg, model, use_adamw=True) if lm
                       else build_optimizer(cfg, model.parameters()))
    if optim_path:
        ckpt.load_optim(optim_path, state, mesh)
        logging.info(f"optim loaded: {optim_path}")
    return state, gen


def _whole_model(cfg: ExpConfig, model: ASR, mesh: Optional[pmesh.Mesh]) -> Optional[ASR]:
    """The model as rank 0 decodes it: itself, or under tensor parallelism
    a whole copy of the gathered shares (a collective: every rank calls
    this; None on the other ranks).  The copy is built without touching the
    generators that the ranks share."""
    if mesh is None or not getattr(model, "tp_plan", None):
        return model
    sd = ckpt.full_state_dict(model, mesh)
    if not mesh.is_main:
        return None
    with torch.random.fork_rng(devices=[]):
        whole = ASR(cfg)
    whole.load_state_dict(sd)
    return whole.to(next(model.parameters()).device)


def build_argparser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser()
    parser.add_argument("-conf", type=str, required=True)
    parser.add_argument("--resume", action="store_true")
    parser.add_argument("--cpu", action="store_true",
                        help="run on the CPU (the default is the GPU)")
    parser.add_argument("--profile", type=str, default=None,
                        help="trace batches 8-12 of the first epoch to this directory")
    return parser


def main(argv=None) -> TrainState:
    args = build_argparser().parse_args(argv)
    try:
        return train(args.conf, resume=args.resume, device="cpu" if args.cpu else None, profile_dir=args.profile)
    finally:
        pmesh.shutdown()


if __name__ == "__main__":
    main()
