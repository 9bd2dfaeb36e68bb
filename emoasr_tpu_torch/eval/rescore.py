"""N-best rescoring with LM scores and a (lm_weight, len_weight) grid search
(PyTorch port of `emoasr_tpu/eval/rescore.py`).

Parity target: emoASR `asr/rescore/test_rescore_grid.py:30-213`: `score_lm`
adds a `score_lm` column to the n-best TSV (the eval CLI's `--nbest`
output), cached as `*_{lm_tag}.tsv`; `rescore` picks, per utterance, the
hypothesis with the largest `score_asr + lm_w * score_lm + len_w * ylen`;
the grid runs over both weights and the best result is saved as
`*_lm{w}_len{w}.tsv`; `--runtime` times the scoring (RTF).

`LM.score` is the Transformer and RNN LMs' sum of next-token log-probs,
BERT's pseudo-log-likelihood (masked copies in chunks,
`models/lm/lm.py::pseudo_log_likelihood`) or the discriminator of ELECTRA
or P-ELECTRA (minus the sum of its sigmoid).  Hypotheses go to the LM in batches of
`batch_size` rows, each padded to its longest hypothesis rounded up to a
multiple of 16 (capped at the LM's `max_seq_len`, which also truncates);
a hypothesis's score does not depend on the rows beside it or on the
padding.  The scores are read back once a batch.

Runs on the card unless `--cpu` is given:

    python -m emoasr_tpu_torch.eval.rescore <nbest.tsv> -ref <tag or TSV> \
        -lm_conf <lm yaml> -lm_ep <N> [--lm_tag T] [--runtime] [--cpu]
"""

from __future__ import annotations

import argparse
import logging
import os
import re
import time
from typing import List

import numpy as np
import pandas as pd
import torch

from emoasr_tpu_torch.config import load_config
from emoasr_tpu_torch.eval.test_asr import get_eval_path, load_lm
from emoasr_tpu_torch.eval.wer import compute_wers_df, wer_info_line
from emoasr_tpu_torch.models.lm.lm import LM
from emoasr_tpu_torch.utils.converters import str2ints
from emoasr_tpu_torch.utils.device import resolve_device, set_matmul_precision
from emoasr_tpu_torch.utils.log import setup_logging
from emoasr_tpu_torch.utils.paths import get_model_path

BATCH_SIZE = 128
EPS = 1e-5
# the types with a `score` (the phone-to-word models have none: they need phones)
SCORE_TYPES = ("transformer", "rnn", "bert", "electra", "electra-disc", "pelectra", "pelectra-disc")


@torch.no_grad()
def score_lm(
    df: pd.DataFrame,
    lm_model: LM,
    max_len: int = 256,
    batch_size: int = BATCH_SIZE,
    num_samples: int = -1,
) -> pd.DataFrame:
    """`df` with a `score_lm` column: `LM.score` of each row's `token_id`,
    on the device of the LM's parameters (rescore.py:45-101).  With
    `num_samples > 0` only the rows of the first that many utterances are
    scored (the others keep 0), as the runtime mode does."""
    if lm_model.cfg.lm_type not in SCORE_TYPES:
        raise ValueError(f"lm_type={lm_model.cfg.lm_type!r} cannot score hypotheses: one of {SCORE_TYPES}")
    device = next(lm_model.parameters()).device
    lm_model.eval()
    token_lists: List[List[int]] = [str2ints(t) for t in df["token_id"].tolist()]
    lens = np.asarray([len(t) for t in token_lists], np.int32)
    L = int(min(max(lens.max(initial=1), 1), max_len))
    L = min(((L + 15) // 16) * 16, max_len)

    scores = np.zeros(len(df), np.float32)
    if num_samples > 0:
        keep_utts = set(df["utt_id"].unique()[:num_samples])
        idx_keep = df["utt_id"].isin(keep_utts).to_numpy().nonzero()[0]
    else:
        idx_keep = np.arange(len(df))
    for s in range(0, len(idx_keep), batch_size):
        idxs = idx_keep[s: s + batch_size]
        ys = np.zeros((len(idxs), L), np.int64)
        yl = np.ones(len(idxs), np.int64)
        for j, i in enumerate(idxs):
            t = token_lists[i][:L]
            ys[j, : len(t)] = t
            yl[j] = max(len(t), 1)
        out = lm_model.score(torch.from_numpy(ys).to(device), torch.from_numpy(yl).to(device))
        scores[idxs] = out.float().cpu().numpy()
    df = df.copy()
    df["score_lm"] = scores
    return df


def rescore(df: pd.DataFrame, dfref: pd.DataFrame, lm_weight, len_weight):
    """The best-scoring hypothesis of each utterance and its WER
    (test_rescore_grid.py:70-78)."""
    df = df.copy()
    df["ylen"] = df["token_id"].apply(lambda s: len(str(s).split()))
    df["score"] = df["score_asr"] + lm_weight * df["score_lm"] + len_weight * df["ylen"]
    df_best = df.loc[df.groupby("utt_id")["score"].idxmax(), :]
    df_best = df_best[["utt_id", "text", "token_id", "score_asr"]]
    wer, wer_dict = compute_wers_df(df_best, dfref)
    return wer, wer_dict, df_best


def grid_search(df, dfref, lm_range, len_range):
    """(best WER, its lm_weight, its len_weight, its rows); the first of
    equal WERs wins."""
    best = (100.0, 0.0, 0.0, None)
    for lm_w in lm_range:
        for len_w in len_range:
            wer, wer_dict, df_result = rescore(df, dfref, lm_w, len_w)
            logging.info(f"lm_weight: {lm_w:.3f} len_weight: {len_w:.3f} - {wer_info_line(wer, wer_dict)}")
            if wer < best[0]:
                best = (wer, lm_w, len_w, df_result)
    return best


def test_main(args):
    lm_cfg = load_config(args.lm_conf)
    lm_tag = args.lm_tag or lm_cfg.lm_type
    device = resolve_device("cpu" if args.cpu else None)
    set_matmul_precision(lm_cfg.compute_dtype)
    setup_logging(None, logging.DEBUG if args.debug else logging.INFO)
    if lm_cfg.lm_type not in SCORE_TYPES:  # before anything is read
        raise ValueError(f"lm_type={lm_cfg.lm_type!r} cannot score hypotheses: one of {SCORE_TYPES}")

    df = pd.read_table(args.tsv_path).dropna()
    dfref = pd.read_table(get_eval_path(args.ref))
    lm_path = get_model_path(args.lm_conf, args.lm_ep)
    lm_model, lm_cfg = load_lm(args.lm_conf, lm_path)
    lm_model = lm_model.to(device)
    logging.info(f"LM: {lm_path} on {device}")

    if args.runtime:
        runtimes, rtfs = [], []
        for j in range(args.runtime_num_repeats):
            t0 = time.time()
            scored = score_lm(df, lm_model, max_len=lm_cfg.max_seq_len, num_samples=args.runtime_num_samples)
            runtime = time.time() - t0
            wavtime = 0.0
            for u in scored["utt_id"].unique()[: args.runtime_num_samples]:
                parts = re.split("_|-", u)
                wavtime += (int(parts[-1]) - int(parts[-2])) / args.wavtime_factor
            rtf = runtime / max(wavtime, 1e-9)
            logging.info(f"Run {j + 1} runtime: {runtime:.5f}s | RTF: {rtf:.5f}")
            runtimes.append(runtime)
            rtfs.append(rtf)
        logging.info(f"Averaged runtime {np.mean(runtimes):.5f}s, RTF {np.mean(rtfs):.5f}")
        return runtimes, rtfs

    scored_tsv_path = args.tsv_path.replace(".tsv", f"_{lm_tag}.tsv")
    if not os.path.exists(scored_tsv_path):
        df = score_lm(df, lm_model, max_len=lm_cfg.max_seq_len)
        df.to_csv(scored_tsv_path, sep="\t", index=False)
    else:
        logging.info(f"load score_lm: {scored_tsv_path}")
        df = pd.read_table(scored_tsv_path)

    lm_range = np.arange(args.lm_min, args.lm_max + EPS, args.lm_step)
    len_range = np.arange(args.len_min, args.len_max + EPS, args.len_step)
    wer_min, lm_best, len_best, df_best = grid_search(df, dfref, lm_range, len_range)
    best_tsv_path = scored_tsv_path.replace(".tsv", f"_lm{lm_best:.2f}_len{len_best:.2f}.tsv")
    logging.info(f"best lm_weight: {lm_best:.3f} len_weight: {len_best:.3f}")
    if df_best is not None:
        df_best.to_csv(best_tsv_path, sep="\t", index=False)
    logging.info(f"best WER: {wer_min:.3f}")
    return wer_min, lm_best, len_best


def build_argparser():
    parser = argparse.ArgumentParser()
    parser.add_argument("tsv_path", type=str)
    parser.add_argument("-ref", type=str, required=True)
    parser.add_argument("--cpu", action="store_true", help="run on the CPU (the default is the GPU)")
    parser.add_argument("--debug", action="store_true")
    parser.add_argument("--runtime", action="store_true")
    parser.add_argument("--runtime_num_samples", type=int, default=20)
    parser.add_argument("--runtime_num_repeats", type=int, default=5)
    parser.add_argument("--wavtime_factor", type=float, default=1000)
    parser.add_argument("-lm_conf", type=str, required=True)
    parser.add_argument("-lm_ep", type=str, required=True)
    parser.add_argument("--lm_tag", type=str, default=None)
    parser.add_argument("--lm_min", type=float, default=0)
    parser.add_argument("--lm_max", type=float, default=1)
    parser.add_argument("--lm_step", type=float, default=0.1)
    parser.add_argument("--len_min", type=float, default=0)
    parser.add_argument("--len_max", type=float, default=5)
    parser.add_argument("--len_step", type=float, default=1)
    return parser


def main(argv=None):
    return test_main(build_argparser().parse_args(argv))


if __name__ == "__main__":
    main()
