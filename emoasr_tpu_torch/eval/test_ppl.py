"""LM perplexity (causal PPL, masked pseudo-PPL) + CLI (PyTorch port of
`emoasr_tpu/eval/test_ppl.py` for the Transformer, BERT and RNN LMs).

Parity target: emoASR `lm/test_ppl.py:32-223`: causal PPL skips the
first-token and <eos> predictions when `add_sos_eos`; the masked
pseudo-PPL masks each position in turn; PPL = exp(total NLL / token count).

The pseudo-PPL runs the masked copies in chunks and applies the vocabulary
head only at each copy's masked position
(`models/lm/lm.py::pseudo_log_likelihood`): the JAX package's one batch of
(B L, L, V) logits would take 28.8 GB in float32 at a (11, 256) batch and
V = 10000.  The same sum, in another order.

Usage: `python -m emoasr_tpu_torch.eval.test_ppl -conf lm.yaml -ep N [--data TSV] [--cpu]`
(on the GPU unless `--cpu` is given).
"""

from __future__ import annotations

import argparse
import logging
import math
import os
from typing import Tuple

import torch

from emoasr_tpu_torch.config import ExpConfig, load_config
from emoasr_tpu_torch.data.lm_dataset import LMDataset
from emoasr_tpu_torch.models.lm.lm import LM, load_lm_state_dict, pseudo_log_likelihood
from emoasr_tpu_torch.train import checkpoint as ckpt
from emoasr_tpu_torch.utils.device import resolve_device, set_matmul_precision
from emoasr_tpu_torch.utils.log import setup_logging
from emoasr_tpu_torch.utils.paths import get_model_path, rel_to_abs_path


def causal_nll(model: LM, ys: torch.Tensor, ylens: torch.Tensor, add_sos_eos: bool) -> Tuple[torch.Tensor, torch.Tensor]:
    """Summed next-token NLL and its token count (test_ppl.py:35-52)."""
    ys_in, ys_out, lens_in = ys[:, :-1], ys[:, 1:], ylens - 1
    logp = torch.log_softmax(model(ys_in, lens_in).float(), dim=-1)
    tok_lp = torch.gather(logp, 2, ys_out.long()[:, :, None])[:, :, 0]
    pos = torch.arange(ys_out.shape[1], device=ys.device)[None, :]
    valid = pos < lens_in[:, None]
    if add_sos_eos:  # skip the first-token and <eos> predictions (test_ppl.py:62-66)
        valid = valid & (pos >= 1) & (pos < (lens_in - 1)[:, None])
    return -torch.where(valid, tok_lp, torch.zeros_like(tok_lp)).sum(), valid.sum()


def masked_nll(model: LM, ys: torch.Tensor, ylens: torch.Tensor, mask_id: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Pseudo-NLL: each valid position masked in turn (test_ppl.py:55-71)."""
    lp = pseudo_log_likelihood(model.lm.stack, model.lm.head, ys, ylens, mask_id)
    return -lp.sum(), (torch.arange(ys.shape[1], device=ys.device)[None, :] < ylens[:, None]).sum()


@torch.no_grad()
def evaluate_ppl(cfg: ExpConfig, model: LM, dataset: LMDataset) -> Tuple[int, float]:
    """Corpus (pseudo-)perplexity over every batch of `dataset` in order,
    on the device of the model's parameters (test_ppl.py:99-124)."""
    device = next(model.parameters()).device
    model.eval()
    total_nll, total_cnt = 0.0, 0
    for batch in dataset.batches(dataset.make_batcher(shuffle=False, drop_tail=False)):
        ys = torch.from_numpy(batch["ys_in"]).to(device)
        ylens = torch.from_numpy(batch["ylens"]).to(device).long()
        if cfg.lm_type == "bert":
            nll, cnt = masked_nll(model, ys, ylens, cfg.mask_id)
        else:
            nll, cnt = causal_nll(model, ys, ylens, cfg.add_sos_eos)
        total_nll += float(nll)
        total_cnt += int(cnt)
    return total_cnt, math.exp(total_nll / max(total_cnt, 1))


def test_main(args) -> Tuple[int, float]:
    cfg = load_config(args.conf)
    device = resolve_device("cpu" if args.cpu else None)
    set_matmul_precision(cfg.compute_dtype)
    setup_logging(None)
    model = LM(cfg)
    model_path = get_model_path(args.conf, args.ep)
    if not os.path.exists(model_path):
        ckpt.model_average(args.conf, args.ep)
    logging.info(f"LM: {model_path} on {device}")
    load_lm_state_dict(model, ckpt.load_state_dict(model_path))
    dataset = LMDataset(cfg, rel_to_abs_path(args.data or cfg.test_path), phase="test")
    cnt, ppl = evaluate_ppl(cfg, model.to(device), dataset)
    logging.info(f"{cnt} tokens | PPL: {ppl:.3f}")
    print(f"PPL: {ppl:.3f}")
    return cnt, ppl


def build_argparser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser()
    parser.add_argument("-conf", type=str, required=True)
    parser.add_argument("-ep", type=str, required=True)
    parser.add_argument("--data", type=str, default=None)
    parser.add_argument("--cpu", action="store_true", help="run on the CPU (the default is the GPU)")
    return parser


def main(argv=None) -> Tuple[int, float]:
    return test_main(build_argparser().parse_args(argv))


if __name__ == "__main__":
    main()
