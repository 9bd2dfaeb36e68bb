"""LM perplexity (causal PPL, masked pseudo-PPL) + CLI (PyTorch port of
`emoasr_tpu/eval/test_ppl.py`).

Parity target: emoASR `lm/test_ppl.py:32-223`: causal PPL skips the
first-token and <eos> predictions when `add_sos_eos`; the masked
pseudo-PPL masks each position in turn; PPL = exp(total NLL / token count).

The pseudo-PPL runs the masked copies in chunks and applies the vocabulary
head only at each copy's masked position
(`models/lm/lm.py::pseudo_log_likelihood`): the JAX package's one batch of
(B L, L, V) logits would take 28.8 GB in float32 at a (11, 256) batch and
V = 10000.  The same sum, in another order.  The phone-conditioned masked
LM (`pbert`) encodes each utterance's phones once and runs its copies over
that encoder output (`p2w_pseudo_log_likelihood`), where the JAX package
repeats the phones L times.

Types: `transformer`, `rnn`, `ptransformer` (causal, the P2W one over the
phones), `bert`, `pbert` (masked).  The ELECTRA types, P-ELECTRA and `pctc`
are refused with a `ValueError`: the JAX package's `test_ppl` cannot score
them (its forward without labels fails for ELECTRA and P-ELECTRA, and
returns `pctc`'s CTC loss, not logits; ROADMAP.md §3).

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
from emoasr_tpu_torch.data.lm_dataset import LMDataset, P2WDataset
from emoasr_tpu_torch.models.lm.lm import LM, load_lm_state_dict, p2w_pseudo_log_likelihood, pseudo_log_likelihood
from emoasr_tpu_torch.train import checkpoint as ckpt
from emoasr_tpu_torch.utils.device import resolve_device, set_matmul_precision
from emoasr_tpu_torch.utils.log import setup_logging
from emoasr_tpu_torch.utils.paths import get_model_path, rel_to_abs_path


PPL_TYPES = ("transformer", "rnn", "ptransformer", "bert", "pbert")
MASKED_TYPES = ("bert", "pbert")


def causal_nll(model: LM, ys: torch.Tensor, ylens: torch.Tensor, add_sos_eos: bool,
               ps=None, plens=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """Summed next-token NLL and its token count (test_ppl.py:35-52)."""
    ys_in, ys_out, lens_in = ys[:, :-1], ys[:, 1:], ylens - 1
    logp = torch.log_softmax(model(ys_in, lens_in, None, ps, plens).float(), dim=-1)
    tok_lp = torch.gather(logp, 2, ys_out.long()[:, :, None])[:, :, 0]
    pos = torch.arange(ys_out.shape[1], device=ys.device)[None, :]
    valid = pos < lens_in[:, None]
    if add_sos_eos:  # skip the first-token and <eos> predictions (test_ppl.py:62-66)
        valid = valid & (pos >= 1) & (pos < (lens_in - 1)[:, None])
    return -torch.where(valid, tok_lp, torch.zeros_like(tok_lp)).sum(), valid.sum()


def masked_nll(model: LM, ys: torch.Tensor, ylens: torch.Tensor, mask_id: int,
               ps=None, plens=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """Pseudo-NLL: each valid position masked in turn (test_ppl.py:55-71),
    conditioned on the phones for `pbert`."""
    if ps is not None:
        lp = p2w_pseudo_log_likelihood(model.lm, ys, ylens, ps, plens, mask_id)
    else:
        lp = pseudo_log_likelihood(model.lm.stack, model.lm.head, ys, ylens, mask_id)
    return -lp.sum(), (torch.arange(ys.shape[1], device=ys.device)[None, :] < ylens[:, None]).sum()


def check_ppl_type(cfg: ExpConfig) -> None:
    if cfg.lm_type not in PPL_TYPES:
        raise ValueError(
            f"lm_type={cfg.lm_type!r} has no (pseudo-)perplexity here: one of {PPL_TYPES} "
            "(the JAX package's test_ppl cannot score the others either)"
        )


def make_ppl_dataset(cfg: ExpConfig, data_path: str):
    return (P2WDataset if cfg.lm_type in ("ptransformer", "pbert") else LMDataset)(cfg, data_path, phase="test")


@torch.no_grad()
def evaluate_ppl(cfg: ExpConfig, model: LM, dataset) -> Tuple[int, float]:
    """Corpus (pseudo-)perplexity over every batch of `dataset` in order,
    on the device of the model's parameters (test_ppl.py:99-124)."""
    check_ppl_type(cfg)
    device = next(model.parameters()).device
    model.eval()
    total_nll, total_cnt = 0.0, 0
    for batch in dataset.batches(dataset.make_batcher(shuffle=False, drop_tail=False)):
        ys = torch.from_numpy(batch["ys_in"]).to(device)
        ylens = torch.from_numpy(batch["ylens"]).to(device).long()
        ps = plens = None
        if "ps" in batch:
            ps = torch.from_numpy(batch["ps"]).to(device)
            plens = torch.from_numpy(batch["plens"]).to(device).long()
        if cfg.lm_type in MASKED_TYPES:
            nll, cnt = masked_nll(model, ys, ylens, cfg.mask_id, ps, plens)
        else:
            nll, cnt = causal_nll(model, ys, ylens, cfg.add_sos_eos, ps, plens)
        total_nll += float(nll)
        total_cnt += int(cnt)
    return total_cnt, math.exp(total_nll / max(total_cnt, 1))


def test_main(args) -> Tuple[int, float]:
    cfg = load_config(args.conf)
    check_ppl_type(cfg)
    device = resolve_device("cpu" if args.cpu else None)
    set_matmul_precision(cfg.compute_dtype)
    setup_logging(None)
    model = LM(cfg)
    model_path = get_model_path(args.conf, args.ep)
    if not os.path.exists(model_path):
        ckpt.model_average(args.conf, args.ep)
    logging.info(f"LM: {model_path} on {device}")
    load_lm_state_dict(model, ckpt.load_state_dict(model_path))
    dataset = make_ppl_dataset(cfg, rel_to_abs_path(args.data or cfg.test_path))
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
