"""Word/character error rate via Levenshtein alignment.

Behavioral parity target: emoASR `asr/metrics.py:20-175` — same
edit-distance DP, same backtrace priority (C > I > S > D) so the S/I/D
breakdown matches exactly, same `<dummy>` substitution for empty hypotheses,
same corpus aggregation (summed S+I+D over summed ref lengths).

Copy of `emoasr_tpu/eval/wer.py`: the DP rows are numpy-vectorized, and
`compute_wers` scores a corpus with the native edit distance
(`emoasr_tpu_torch/native`, built with g++ at first use; a failed build
raises); its Python path, the plain version the tests hold the native one
against, is taken only when asked (`native=False`).
"""

from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

import numpy as np

from emoasr_tpu_torch import native as _native


def _edit_distance_matrix(ref: Sequence, hyp: Sequence) -> np.ndarray:
    R, H = len(ref), len(hyp)
    d = np.zeros((R + 1, H + 1), dtype=np.int32)
    d[0, :] = np.arange(H + 1)
    d[:, 0] = np.arange(R + 1)
    hyp_arr = np.asarray(hyp, dtype=object)
    for i in range(1, R + 1):
        match = hyp_arr == ref[i - 1]
        prev = d[i - 1]
        row = d[i]
        # vectorize the three candidates; insertion needs a left-to-right
        # scan, but min-plus over a cumulative minimum handles it exactly:
        # row[j] = min(base[j], min_{k<j}(base_ins[k] + (j-k))) with base_ins=row
        base = np.minimum(prev[:-1] + np.where(match, 0, 1), prev[1:] + 1)
        # prefix-scan for insertions: row[j] = min(base[j-1], row[j-1]+1)
        out = np.empty(H + 1, dtype=np.int32)
        out[0] = row[0]
        running = out[0]
        for j in range(1, H + 1):
            running = min(base[j - 1], running + 1)
            out[j] = running
        d[i] = out
    return d


def compute_wer(hyp: List, ref: List, cer: bool = False) -> Tuple[float, Dict]:
    """Single-utterance WER with S/I/D breakdown (metrics.py:20-105)."""
    if len(hyp) == 0:
        hyp = ["<dummy>"]
    if cer:
        hyp = list("".join(hyp))
        ref = list("".join(ref))

    d = _edit_distance_matrix(ref, hyp)
    dist = int(d[len(ref), len(hyp)])

    # backtrace with the reference's priority order
    x, y = len(ref), len(hyp)
    error_list: List[str] = []
    while not (x == 0 and y == 0):
        if x > 0 and y > 0:
            if d[x, y] == d[x - 1, y - 1] and ref[x - 1] == hyp[y - 1]:
                error_list.append("C"); x -= 1; y -= 1
            elif d[x, y] == d[x, y - 1] + 1:
                error_list.append("I"); y -= 1
            elif d[x, y] == d[x - 1, y - 1] + 1:
                error_list.append("S"); x -= 1; y -= 1
            else:
                error_list.append("D"); x -= 1
        elif x == 0:
            if d[x, y] == d[x, y - 1] + 1:
                error_list.append("I"); y -= 1
            else:
                error_list.append("D"); x -= 1
        else:
            error_list.append("D"); x -= 1
    error_list.reverse()

    n_sub = error_list.count("S")
    n_ins = error_list.count("I")
    n_del = error_list.count("D")
    assert dist == n_sub + n_ins + n_del

    wer = dist / len(ref) * 100
    return wer, {
        "wer": wer,
        "n_sub": n_sub,
        "n_ins": n_ins,
        "n_del": n_del,
        "n_ref": len(ref),
        "error_list": error_list,
    }


def _intern_tokens(seqs: List[List]) -> List[List[int]]:
    """Map arbitrary token sequences to int ids for the native kernel."""
    table: Dict = {}
    return [[table.setdefault(t, len(table)) for t in s] for s in seqs]


def compute_wers(hyps: List[List], refs: List[List], cer: bool = False, native: bool = True):
    """Corpus WER: aggregate S/I/D over utterances (metrics.py:108-135), by
    the native edit distance, or by `compute_wer` with `native=False`."""
    tot = {"n_sub": 0, "n_ins": 0, "n_del": 0, "n_ref": 0}
    if native:
        # <dummy> substitution before the cer split, as compute_wer does it
        hyps = [h if len(h) else ["<dummy>"] for h in hyps]
        if cer:
            hyps = [list("".join(map(str, h))) for h in hyps]
            refs = [list("".join(map(str, r))) for r in refs]
        interned = _intern_tokens([*hyps, *refs])
        counts = _native.edit_distance_native(interned[:len(hyps)], interned[len(hyps):])
        for j, k in enumerate(("n_sub", "n_ins", "n_del", "n_ref")):
            tot[k] = int(counts[:, j].sum())
    else:
        for hyp, ref in zip(hyps, refs):
            _, wd = compute_wer(hyp, ref, cer=cer)
            for k in tot:
                tot[k] += wd[k]
    wer = (tot["n_sub"] + tot["n_ins"] + tot["n_del"]) / tot["n_ref"] * 100
    tot["wer"] = wer
    return wer, tot


def compute_wers_df(dfhyp, dfref=None, cer: bool = False):
    """WER over a pandas results table (metrics.py:138-175).

    With `dfref=None`, rows carry both `text` (hyp) and `reftext`; otherwise
    hyps are joined to refs on `utt_id` (missing utt = empty hyp).
    """
    import pandas as pd

    tot = {"n_sub": 0, "n_ins": 0, "n_del": 0, "n_ref": 0}

    def accumulate(hyp, ref):
        _, wd = compute_wer(hyp, ref, cer=cer)
        for k in tot:
            tot[k] += wd[k]

    if dfref is None:
        for row in dfhyp.itertuples():
            hyp = row.text.split() if not pd.isna(row.text) else []
            accumulate(hyp, row.reftext.split())
    else:
        id2hyp = {row.utt_id: row.text.split() for row in dfhyp.itertuples()}
        for row in dfref.itertuples():
            accumulate(id2hyp.get(row.utt_id, []), row.text.split())

    wer = (tot["n_sub"] + tot["n_ins"] + tot["n_del"]) / tot["n_ref"] * 100
    tot["wer"] = wer
    return wer, tot


def wer_info_line(wer: float, wd: Dict, cer: bool = False) -> str:
    tag = "CER" if cer else "WER"
    return (
        f"{tag}: {wer:.2f} [D={wd['n_del']:d}, S={wd['n_sub']:d}, "
        f"I={wd['n_ins']:d}, N={wd['n_ref']:d}]"
    )
