"""Soft labels from an LM for knowledge distillation, and their accuracy
(PyTorch port of `emoasr_tpu/eval/make_label.py`).

Parity target: emoASR `asr/distill/make_label.py:30-292` and
`eval_label.py:20-56`: the pickle `{utt_id: [[(vocab, prob), ...], ...]}`
holds, for each position, the top-k (default 8) tokens and their softmax
probabilities at temperature `temp` (default 3.0).  A causal LM labels the
positions [start_pos, end_pos) of each row from the logits of the position
before (position 0 takes its own token as a hard label); BERT labels the
`mask_pos` of each pre-masked row.  With the LM's `add_sos_eos` the rows
are framed by <eos> and <eos> entries are left out of the labels.  Either
package reads the other's pickle.

Each chunk of `BATCH_SIZE` rows is one LM forward on the device; the
logits rows to label are gathered into one (N, V) tensor there, their top-k
(`search/common.py::topk_lastdim`, the top-k kernel on the card) and the
softmax of the k values at `temp` are taken there, and one tensor comes
back to the host a chunk.  The JAX package takes the top-k of one row at a
time; the rows are independent, so the labels are the same.

    python -m emoasr_tpu_torch.eval.make_label make -lm_conf <yaml> -lm_ep <N> \\
        -data <tsv> -save_path <pkl> [--topk 8] [--temp 3.0] [--cpu]
    python -m emoasr_tpu_torch.eval.make_label eval <pkl> -ref <tsv>

The `make` TSV holds `utt_id`, `token_id` and, for a causal LM,
`start_pos` and `end_pos`; for BERT `mask_pos` (and the masked ids).
"""

from __future__ import annotations

import argparse
import logging
import pickle
from typing import Dict, List, Sequence, Tuple

import numpy as np
import pandas as pd
import torch

from emoasr_tpu_torch.eval.test_asr import load_lm
from emoasr_tpu_torch.search.common import topk_lastdim
from emoasr_tpu_torch.utils.converters import str2ints
from emoasr_tpu_torch.utils.device import resolve_device, set_matmul_precision
from emoasr_tpu_torch.utils.log import setup_logging
from emoasr_tpu_torch.utils.paths import get_model_path, rel_to_abs_path

BATCH_SIZE = 128


def _frame(ids: List[int], add_sos_eos: bool, eos_id: int, max_seq_len: int) -> Tuple[List[int], int]:
    """(framed ids, shift of the positions): <eos> ids <eos> when it fits
    in `max_seq_len`, else the first and last ids give way to the <eos>s."""
    if not add_sos_eos:
        return ids, 0
    if len(ids) <= max_seq_len - 2:
        return [eos_id] + ids + [eos_id], 1
    return [eos_id] + ids[1:-1] + [eos_id], 0


def _logits(lm_model, framed: Sequence[List[int]], device) -> torch.Tensor:
    """The LM's logits (N, L, V) of a chunk of rows, zero-padded to the
    longest, on the device."""
    L = max(len(ids) for ids in framed)
    ys = np.zeros((len(framed), L), np.int64)
    for j, ids in enumerate(framed):
        ys[j, : len(ids)] = ids
    ylens = torch.tensor([len(ids) for ids in framed], device=device)
    return lm_model(torch.from_numpy(ys).to(device), ylens)


def _topk_temp(rows: torch.Tensor, topk: int, temp: float) -> np.ndarray:
    """(N, V) logits on the device -> (N, 2, k) float64 on the host: the
    top-k ids and their softmax at `temp`, one read-back."""
    o_topk, v_topk = topk_lastdim(rows, topk)
    p_topk = torch.softmax(o_topk.float() / temp, dim=-1)
    return torch.stack([v_topk.double(), p_topk.double()], dim=1).cpu().numpy()


def _label(ids: np.ndarray, probs: np.ndarray, add_sos_eos: bool, eos_id: int) -> List[Tuple[int, float]]:
    return [(int(v), float(p)) for v, p in zip(ids, probs) if not (add_sos_eos and v == eos_id)]


def _save(labels: Dict, save_path: str) -> None:
    with open(save_path, "wb") as f:
        pickle.dump(labels, f)
    logging.info(f"pickle saved to {save_path}")


@torch.no_grad()
def make_lm_label(df: pd.DataFrame, lm_model, save_path: str, topk: int = 8, temp: float = 3.0,
                  add_sos_eos: bool = False, eos_id: int = 2, max_seq_len: int = 256) -> Dict:
    """Causal LM soft labels over [start_pos, end_pos) of each row, on the
    device of `lm_model`'s parameters."""
    device = next(lm_model.parameters()).device
    labels: Dict[str, List] = {}
    rows = list(df.itertuples())
    for s in range(0, len(rows), BATCH_SIZE):
        chunk = rows[s: s + BATCH_SIZE]
        framed = []
        for row in chunk:
            ids, shift = _frame(str2ints(row.token_id), add_sos_eos, eos_id, max_seq_len)
            framed.append((row.utt_id, ids, row.start_pos + shift, row.end_pos + shift))
        logits = _logits(lm_model, [f[1] for f in framed], device)
        # every labelled position but 0 reads the logits of the position before
        at = torch.tensor([(j, pos - 1) for j, f in enumerate(framed) for pos in range(f[2], f[3]) if pos > 0],
                          dtype=torch.long).reshape(-1, 2).to(device)
        got = _topk_temp(logits[at[:, 0], at[:, 1]], topk, temp) if len(at) else None
        n = 0
        for utt_id, ids, start_pos, end_pos in framed:
            for pos in range(start_pos, end_pos):
                if pos == 0:
                    v_topk, p_topk = np.array([ids[pos]]), np.array([1.0])
                    logging.warning(f"hard label is used: {v_topk}")
                else:
                    v_topk, p_topk = got[n]
                    n += 1
                labels.setdefault(utt_id, []).append(_label(v_topk, p_topk, add_sos_eos, eos_id))
        if (s // BATCH_SIZE) % 100 == 0:
            logging.info(f"{s + len(chunk)} / {len(rows)}")
    _save(labels, save_path)
    return labels


@torch.no_grad()
def make_bert_label(df: pd.DataFrame, lm_model, save_path: str, topk: int = 8, temp: float = 3.0,
                    add_sos_eos: bool = False, eos_id: int = 2, max_seq_len: int = 256) -> Dict:
    """BERT soft labels at `mask_pos` of pre-masked rows (one a row)."""
    device = next(lm_model.parameters()).device
    labels: Dict[str, List] = {}
    rows = list(df.itertuples())
    for s in range(0, len(rows), BATCH_SIZE):
        chunk = rows[s: s + BATCH_SIZE]
        framed = []
        for row in chunk:
            ids, shift = _frame(str2ints(row.token_id), add_sos_eos, eos_id, max_seq_len)
            if len(ids) > max_seq_len:
                raise ValueError(f"make_label: {row.utt_id} has {len(ids)} ids framed, above max_seq_len {max_seq_len}")
            framed.append((row.utt_id, ids, row.mask_pos + shift))
        logits = _logits(lm_model, [f[1] for f in framed], device)
        pos = torch.tensor([f[2] for f in framed], device=device)
        got = _topk_temp(logits[torch.arange(len(framed), device=device), pos], topk, temp)
        for (utt_id, _, _), (v_topk, p_topk) in zip(framed, got):
            labels.setdefault(utt_id, []).append(_label(v_topk, p_topk, add_sos_eos, eos_id))
    _save(labels, save_path)
    return labels


def accuracy(labels: Dict, dfref: pd.DataFrame, vocab=None):
    """Top-1 / top-k accuracy (%) of soft labels against the references
    (eval_label.py:20-56) and the count of positions."""
    id2ref = {row.utt_id: str2ints(row.token_id) for row in dfref.itertuples()}
    cnt = acc1 = acck = 0
    for utt_id, label in labels.items():
        ref = id2ref[utt_id]
        cnt += len(label)
        for i, vps in enumerate(label):
            v1, _ = vps[0]
            acc1 += int(v1 == ref[i])
            acck += int(any(v == ref[i] for v, _ in vps))
    return acc1 / cnt * 100, acck / cnt * 100, cnt


def main(args):
    setup_logging(None)
    device = resolve_device("cpu" if args.cpu else None)
    lm_model, lm_cfg = load_lm(args.lm_conf, get_model_path(args.lm_conf, args.lm_ep))
    set_matmul_precision(lm_cfg.compute_dtype)
    df = pd.read_table(rel_to_abs_path(args.data)).dropna()
    fn = make_bert_label if lm_cfg.lm_type == "bert" else make_lm_label
    return fn(df, lm_model.to(device), args.save_path, topk=args.topk, temp=args.temp,
              add_sos_eos=lm_cfg.add_sos_eos, eos_id=lm_cfg.eos_id, max_seq_len=lm_cfg.max_seq_len)


def eval_label_main(args):
    """Soft-label accuracy CLI (replaces `asr/distill/eval_label.py`)."""
    with open(args.pkl_path, "rb") as f:
        labels = pickle.load(f)
    dfref = pd.read_table(rel_to_abs_path(args.ref))
    acc1, acck, cnt = accuracy(labels, dfref)
    print(f"{cnt} tokens")
    print(f"Accuracy top1: {acc1:.3f} topk: {acck:.3f}")
    return acc1, acck, cnt


def build_argparser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser()
    sub = parser.add_subparsers(dest="cmd")
    mk = sub.add_parser("make")
    mk.add_argument("-lm_conf", type=str, required=True)
    mk.add_argument("-lm_ep", type=str, required=True)
    mk.add_argument("-data", type=str, required=True)
    mk.add_argument("-save_path", type=str, required=True)
    mk.add_argument("--topk", type=int, default=8)
    mk.add_argument("--temp", type=float, default=3.0)
    mk.add_argument("--cpu", action="store_true", help="run on the CPU (the default is the GPU)")
    ev = sub.add_parser("eval")
    ev.add_argument("pkl_path", type=str)
    ev.add_argument("-ref", type=str, required=True)
    return parser


def cli(argv=None):
    args = build_argparser().parse_args(argv)
    if args.cmd == "eval":
        return eval_label_main(args)
    return main(args)


if __name__ == "__main__":
    cli()
