"""Shallow-fusion grid search over (lm_weight, len_weight) (copy of
`emoasr_tpu/eval/fusion_grid.py`, on the port's eval CLI).

Parity target: emoASR `asr/fusion/test_fusion_grid.py:20-99`, which fans
the grid points out to a CPU `multiprocessing.Pool`.  Here one device
decodes each point in turn through `test_asr.test_main` (which keeps its
model, LM and decode function between points of one setup); the best
point is the lowest WER, the first of equal ones.

    python -m emoasr_tpu_torch.eval.fusion_grid -conf <yaml> -ep <N> --beam_width 8 \\
        --lm_conf <lm yaml> --lm_ep <M> [--lm_min 0 --lm_max 1 --lm_step 0.1] \\
        [--len_min 0 --len_max 5 --len_step 1] [--cpu]

With `--dp` under torchrun (`python -m torch.distributed.run --standalone
--nproc_per_node N -m emoasr_tpu_torch.eval.fusion_grid ... --dp`) every
rank decodes its rows of each grid point (the eval CLI's `--dp`, JAX
`fusion_grid.py:80`) and rank 0 alone logs the grid and its best point.
"""

from __future__ import annotations

import argparse
import logging
import os

import numpy as np

from emoasr_tpu_torch.eval.test_asr import get_eval_path, test_main
from emoasr_tpu_torch.parallel import mesh as pmesh
from emoasr_tpu_torch.utils.log import setup_logging
from emoasr_tpu_torch.utils.paths import get_results_dir

EPS = 1e-5


def main(args):
    """-> (wer, lm_weight, len_weight, wer_info) of the best point."""
    log_dir = get_results_dir(args.conf)
    data_path = get_eval_path(args.data)
    data_tag = args.data if args.data_tag == "test" and data_path != args.data else args.data_tag
    log_file = f"test_fusion_grid_{data_tag}_ctc{args.decode_ctc_weight}_ep{args.ep}.log"
    if int(os.environ.get("RANK", 0)) == 0:
        setup_logging(os.path.join(log_dir, log_file))
    else:
        setup_logging(None, logging.WARNING)

    lm_cands = np.arange(args.lm_min, args.lm_max + EPS, args.lm_step)
    len_cands = np.arange(args.len_min, args.len_max + EPS, args.len_step)

    best = (100.0, 0.0, 0.0, "")
    for lm_weight in lm_cands:
        for len_weight in len_cands:
            out = test_main(args, float(lm_weight), float(len_weight))
            if out is None:
                continue
            lm_w, len_w, wer, wer_info = out
            logging.info(f"lm_weight: {lm_w:.3f} len_weight: {len_w:.3f} - {wer_info}")
            if wer < best[0]:
                best = (wer, lm_w, len_w, wer_info)

    logging.info("***** best WER:")
    logging.info(f"lm_weight: {best[1]:.3f} len_weight: {best[2]:.3f} - {best[3]}")
    return best


def build_argparser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser()
    parser.add_argument("-conf", type=str, required=True)
    parser.add_argument("-ep", type=str, required=True)
    parser.add_argument("--data", type=str, default=None)
    parser.add_argument("--data_tag", type=str, default="test")
    parser.add_argument("--save_dir", type=str, default=None)
    parser.add_argument("--beam_width", type=int, default=None)
    parser.add_argument("--decode_ctc_weight", type=float, default=0)
    parser.add_argument("--lm_min", type=float, default=0)
    parser.add_argument("--lm_max", type=float, default=1)
    parser.add_argument("--lm_step", type=float, default=0.1)
    parser.add_argument("--len_min", type=float, default=0)
    parser.add_argument("--len_max", type=float, default=5)
    parser.add_argument("--len_step", type=float, default=1)
    parser.add_argument("--lm_conf", type=str, default=None)
    parser.add_argument("--lm_ep", type=str, default=None)
    parser.add_argument("--lm_path", type=str, default=None,
                        help="the LM's state_dict file (default: --lm_ep's, else the yaml's lm_path)")
    parser.add_argument("--lm_tag", type=str, default=None)
    parser.add_argument("--cpu", action="store_true", help="run on the CPU (the default is the GPU)")
    parser.add_argument("--dp", action="store_true",
                        help="split every batch's rows over the ranks that torchrun started")
    return parser


def parse_args(argv=None):
    """The grid's flags, with the eval CLI's other flags at their defaults
    (top-1 decoding of the whole corpus, weights from the grid)."""
    args = build_argparser().parse_args(argv)
    args.nbest = args.debug = args.runtime = args.decode_phone = False
    args.utt_id = args.len_weight = args.lm_weight = None
    return args


if __name__ == "__main__":
    try:
        main(parse_args())
    finally:
        pmesh.shutdown()
