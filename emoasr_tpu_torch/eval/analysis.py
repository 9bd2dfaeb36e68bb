"""Diagnostics: per-frame CTC probabilities of one utterance, and the
per-utterance WER difference of two result TSVs (PyTorch port of
`emoasr_tpu/eval/analysis.py`).

Parity targets:
- emoASR `asr/analysis/analyse_ctc_prob.py:26-83`: the top-k CTC
  probabilities of each frame of one utterance.  The checkpoint loads
  through the eval CLI's loader, the utterance is encoded on the device
  (the attention kernel with `enc_fused_attn`), and the softmax of its
  frames is taken there; one read-back.
- emoASR `asr/analysis/compare_wer.py:15-68`: the utterances whose WERs
  differ between two result TSVs.

    python -m emoasr_tpu_torch.eval.analysis ctc_prob -conf <yaml> -ep <N> -utt_id <id> \\
        [--topk 5] [--data TSV] [--cpu]
    python -m emoasr_tpu_torch.eval.analysis compare_wer <tsv1> <tsv2> [--all]
"""

from __future__ import annotations

import argparse
from typing import Optional

import numpy as np
import pandas as pd
import torch

from emoasr_tpu_torch.config import load_config
from emoasr_tpu_torch.data.asr_dataset import ASRDataset
from emoasr_tpu_torch.eval.test_asr import load_asr_model
from emoasr_tpu_torch.eval.wer import compute_wer
from emoasr_tpu_torch.train.step import preprocess
from emoasr_tpu_torch.utils.device import resolve_device, set_matmul_precision
from emoasr_tpu_torch.utils.paths import get_model_path, rel_to_abs_path
from emoasr_tpu_torch.utils.vocab import Vocab


@torch.no_grad()
def analyse_ctc_prob(conf: str, ep: str, utt_id: str, topk: int = 5, data: Optional[str] = None,
                     device=None) -> np.ndarray:
    """Print the top-k CTC probabilities of every frame of one utterance;
    returns the (T', V) probabilities.  `device` None is the card."""
    cfg = load_config(conf)
    dev = resolve_device(device)
    set_matmul_precision(cfg.compute_dtype)
    model = load_asr_model(get_model_path(conf, ep), cfg).to(dev).eval()
    vocab = Vocab(rel_to_abs_path(cfg.vocab_path))
    dataset = ASRDataset(cfg, rel_to_abs_path(data or cfg.test_path), "test")

    idx = dataset.data.index[dataset.data["utt_id"] == utt_id]
    if len(idx) != 1:
        raise ValueError(f"utt {utt_id} found {len(idx)} times in {data or cfg.test_path}")
    ex = dataset[int(idx[0])]
    xs, xlens = preprocess(cfg, torch.from_numpy(ex["x"])[None].to(dev), torch.tensor([ex["xlen"]], device=dev))
    eouts, elens, _ = model.encode(xs, xlens)
    probs = torch.softmax(model.decoder.logits(eouts)[0].float(), dim=-1).cpu().numpy()

    lines = []
    for t in range(int(elens[0])):
        order = np.argsort(-probs[t])[:topk]
        lines.append(f"t={t:4d} | " + " | ".join(f"{vocab.id2token(int(v))}: {probs[t, v]:.3f}" for v in order))
    print("\n".join(lines))
    return probs


def compare_wer(tsv1: str, tsv2: str, show_all: bool = False) -> pd.DataFrame:
    """Per-utterance WER difference of two result TSVs (compare_wer.py:15-68)."""
    df1 = pd.read_table(tsv1, comment="#")
    df2 = pd.read_table(tsv2, comment="#")
    id2row = {r.utt_id: r for r in df2.itertuples()}
    rows = []
    for r1 in df1.itertuples():
        if r1.utt_id not in id2row:
            continue
        r2 = id2row[r1.utt_id]
        ref = str(r1.reftext).split()
        h1 = str(r1.text).split() if isinstance(r1.text, str) else []
        h2 = str(r2.text).split() if isinstance(r2.text, str) else []
        wer1, _ = compute_wer(h1, ref)
        wer2, _ = compute_wer(h2, ref)
        if show_all or abs(wer1 - wer2) > 1e-9:
            rows.append((r1.utt_id, wer1, wer2, " ".join(h1), " ".join(h2), " ".join(ref)))
    out = pd.DataFrame(rows, columns=["utt_id", "wer1", "wer2", "hyp1", "hyp2", "ref"])
    for r in out.itertuples():
        print(f"*** {r.utt_id}: {r.wer1:.1f} vs {r.wer2:.1f}")
        print(f"  hyp1: {r.hyp1}")
        print(f"  hyp2: {r.hyp2}")
        print(f"  ref : {r.ref}")
    return out


def build_argparser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser()
    sub = parser.add_subparsers(dest="cmd", required=True)
    p1 = sub.add_parser("ctc_prob")
    p1.add_argument("-conf", required=True)
    p1.add_argument("-ep", required=True)
    p1.add_argument("-utt_id", required=True)
    p1.add_argument("--topk", type=int, default=5)
    p1.add_argument("--data", default=None)
    p1.add_argument("--cpu", action="store_true", help="run on the CPU (the default is the GPU)")
    p2 = sub.add_parser("compare_wer")
    p2.add_argument("tsv1")
    p2.add_argument("tsv2")
    p2.add_argument("--all", action="store_true")
    return parser


def main(argv=None):
    args = build_argparser().parse_args(argv)
    if args.cmd == "ctc_prob":
        return analyse_ctc_prob(args.conf, args.ep, args.utt_id, args.topk, args.data, "cpu" if args.cpu else None)
    return compare_wer(args.tsv1, args.tsv2, args.all)


if __name__ == "__main__":
    main()
