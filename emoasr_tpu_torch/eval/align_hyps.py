"""Align n-best hypotheses to their references -> per-token C/S/I(/D)
error labels, the training data of `electra-disc` / `pelectra-disc`
(copy of `emoasr_tpu/eval/align_hyps.py`, on the port's eval modules).

Parity target: emoASR `asr/rescore/align_hyps.py:19-87`.  Its "pass D to
the left" branch compares (`==`) where it means to assign (align_hyps.py:46),
so a deletion after a correct token is dropped; this follows the evident
intent, as the JAX package does: the preceding C becomes D.

    python -m emoasr_tpu_torch.eval.align_hyps <nbest.tsv> -ref <tsv or tag> \\
        [--align_type SI|SID] [--len_min 1] [--len_max 256]
"""

from __future__ import annotations

import argparse

import pandas as pd

from emoasr_tpu_torch.eval.test_asr import get_eval_path
from emoasr_tpu_torch.eval.wer import compute_wer
from emoasr_tpu_torch.utils.converters import str2ints


def alignment(dfhyp: pd.DataFrame, dfref: pd.DataFrame, align_type: str = "SID", len_min: int = 1,
              len_max: int = 256) -> pd.DataFrame:
    """One row of error labels (a label a hypothesis token) for each
    hypothesis of `len_min` to `len_max` tokens."""
    id2ref = {row.utt_id: str2ints(row.token_id) for row in dfref.itertuples()}

    outs = []
    for row in dfhyp.itertuples():
        hyp = str2ints(row.token_id)
        ref = id2ref[row.utt_id]
        if len(hyp) < len_min or len(hyp) > len_max:
            continue

        _, wer_dict = compute_wer(hyp, ref)
        error_list = wer_dict["error_list"]

        align_list = []
        del_flag = False
        if align_type == "SI":
            align_list = [e for e in error_list if e != "D"]
        elif align_type == "SID":
            for e in error_list:
                if e == "D":
                    if align_list and align_list[-1] == "C":
                        align_list[-1] = "D"  # pass `D` to the left C
                    else:
                        del_flag = True  # pass to the right
                else:
                    if del_flag and e == "C":
                        align_list.append("D")
                    else:
                        align_list.append(e)
                    del_flag = False
        assert len(hyp) == len(align_list)

        outs.append((row.utt_id, row.score_asr, row.token_id, row.text, row.reftext, " ".join(align_list)))

    return pd.DataFrame(outs, columns=["utt_id", "score_asr", "token_id", "text", "reftext", "error_label"])


def main(args) -> str:
    dfhyp = pd.read_table(args.tsv_path).dropna()
    dfref = pd.read_table(get_eval_path(args.ref))
    df = alignment(dfhyp, dfref, args.align_type, len_min=args.len_min, len_max=args.len_max)
    out = args.tsv_path.replace(".tsv", f"_{args.align_type}align.tsv")
    df.to_csv(out, sep="\t", index=False)
    return out


def build_argparser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser()
    parser.add_argument("tsv_path", type=str)
    parser.add_argument("-ref", type=str, required=True)
    parser.add_argument("--align_type", choices=["SI", "SID"], default="SID")
    parser.add_argument("--len_min", type=int, default=1)
    parser.add_argument("--len_max", type=int, default=256)
    return parser


if __name__ == "__main__":
    main(build_argparser().parse_args())
