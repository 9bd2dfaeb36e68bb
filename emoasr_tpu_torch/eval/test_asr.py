"""ASR evaluation CLI: batched decoding -> result TSV + WER (+ RTF mode).

PyTorch port of `emoasr_tpu/eval/test_asr.py` for CTC models, RNN-T models
(greedy and the ALSD beam) and models with the attention (Transformer)
decoder (parity target emoASR
`asr/test_asr.py`): same flags, result-file naming
(`result_{data}_beam{W}_len{L}_ctc{C}_lm{M}{tag}_ep{E}.tsv`), WER comment
stamped into the TSV, `test_main` returning
(lm_weight, len_weight, wer, wer_info), `--runtime` RTF mode using
utt-id-embedded start/end times, `--nbest` output, checkpoint averaging for
epoch ranges, Transformer- or RNN-LM shallow fusion (`--lm_weight`,
`--lm_conf`, `--lm_ep` or `--lm_path`, `--lm_tag`, or the yaml's
`lm_weight`, `lm_conf`, `lm_path`) into the CTC prefix beam, the attention
beam and the ALSD beam (an ELECTRA LM through its stateless `predict`), and
`--decode_phone` (a CTC model's phone head, the hierarchical one from the
intermediate layer: the phone TSV against `phone_vocab_path`, its PER).
Checkpoints are reference-layout torch `state_dict` files.

Runs on the card unless `--cpu` is given:

    python -m emoasr_tpu_torch.eval.test_asr -conf <yaml> -ep <N> --beam_width 8
    python -m emoasr_tpu_torch.eval.test_asr -conf <l3 yaml> -ep <N> \
        --lm_weight 0.5 --lm_conf <lm yaml> --lm_ep <M>

`--dp` under `torchrun` (`python -m torch.distributed.run --standalone
--nproc_per_node N -m emoasr_tpu_torch.eval.test_asr ... --dp`) splits the
rows of every batch over the N ranks (JAX `test_asr.py:438-451`); a batch
that does not divide is decoded whole by rank 0 (JAX replicates it,
`:361-363`), and rank 0 gathers the rows and writes the TSV a single
process writes.  `--profile DIR` writes a `torch.profiler` trace of
`decode_dataset` (`utils/profile.py`; JAX `test_asr.py:561-570`), rank 0's
under torchrun.
"""

from __future__ import annotations

import argparse
import contextlib
import itertools
import logging
import os
import queue
import re
import sys
import threading
import time
from typing import List, Optional

import numpy as np
import pandas as pd

from emoasr_tpu_torch.config import ExpConfig, load_config
from emoasr_tpu_torch.data.asr_dataset import ASRDataset
from emoasr_tpu_torch.eval.decode import build_decode_fn
from emoasr_tpu_torch.eval.wer import compute_wers_df, wer_info_line
from emoasr_tpu_torch.models.asr import ASR
from emoasr_tpu_torch.models.lm.lm import LM, load_lm_state_dict
from emoasr_tpu_torch.parallel import mesh as pmesh
from emoasr_tpu_torch.search.common import check_lm_fusion_type, make_lm_fusion
from emoasr_tpu_torch.train import checkpoint as ckpt
from emoasr_tpu_torch.utils.converters import ints2str
from emoasr_tpu_torch.utils.device import resolve_device, set_matmul_precision
from emoasr_tpu_torch.utils.log import insert_comment, setup_logging
from emoasr_tpu_torch.utils.paths import (
    REPO_ROOT,
    get_model_path,
    get_results_dir,
    rel_to_abs_path,
)
from emoasr_tpu_torch.utils.profile import span, trace
from emoasr_tpu_torch.utils.vocab import Vocab

EVAL_TAGS = {
    "test": "corpora/ted2/nsp10k/data/test.tsv",
    "dev": "corpora/ted2/nsp10k/data/dev.tsv",
    "test-clean": "corpora/libri/nsp10k/data/test_clean.tsv",
    "test-other": "corpora/libri/nsp10k/data/test_other.tsv",
    "dev-clean": "corpora/libri/nsp10k/data/dev_clean.tsv",
    "dev-other": "corpora/libri/nsp10k/data/dev_other.tsv",
    "eval1": "corpora/csj/nsp10k/data/eval1.tsv",
    "eval2": "corpora/csj/nsp10k/data/eval2.tsv",
    "eval3": "corpora/csj/nsp10k/data/eval3.tsv",
    "csj-dev": "corpora/csj/nsp10k/data/dev.tsv",
    "csj-dev500": "corpora/csj/nsp10k/data/dev_500.tsv",
}


def get_eval_path(tag: Optional[str]) -> Optional[str]:
    if tag in EVAL_TAGS:
        return os.path.join(REPO_ROOT, EVAL_TAGS[tag])
    return tag


def load_asr_model(model_path: str, cfg: ExpConfig) -> ASR:
    """An `ASR` on the CPU with the weights of a torch `state_dict` file."""
    model = ASR(cfg)
    model.load_state_dict(ckpt.load_state_dict(model_path))
    return model


def load_lm(lm_conf: str, lm_path: str):
    """(`LM` on the CPU in eval mode with the weights of the torch
    `state_dict` file `lm_path`, its config), for every LM type.  The file's
    keys may carry the facade's `lm.` prefix or not (JAX
    `eval/test_asr.py:90-118`)."""
    lm_cfg = load_config(lm_conf)
    lm_model = LM(lm_cfg)
    load_lm_state_dict(lm_model, ckpt.load_state_dict(lm_path))
    return lm_model.eval(), lm_cfg


def _postproc_batch(
    cfg: ExpConfig,
    batch: dict,
    hyps: np.ndarray,
    hyp_lens: np.ndarray,
    scores: np.ndarray,
    vocab: Vocab,
    nbest: bool,
    sample_utt_id: Optional[str],
    max_utts: int = -1,
    decode_phone: bool = False,
) -> tuple:
    """Host post-processing for one decoded batch -> (result rows,
    utterances consumed).  Row b of the outputs belongs to
    `batch["utt_ids"][b]`; the padding rows after `n_valid` are never read.

    Only the selected hypothesis per utterance is detokenized in
    non-nbest mode; nbest mode keeps all surviving candidates.  The third
    result counts the selected hypotheses of an attention decoder's beam
    that carry no trailing eos: they were force-finalized at their row's
    step budget (search/attention_beam.py `row_caps`).  A CTC beam's
    hypotheses never end in eos and are not counted."""
    rows = []
    n_utts = 0
    n_forced = 0
    count_forced = cfg.decoder_type == "transformer"
    eos = cfg.eos_id
    texts = batch["ptexts"] if decode_phone else batch["texts"]
    multi = hyps.ndim == 3  # beam outputs (B, W, L)
    if multi:
        valid = scores > -1e29  # (B, W) DEAD-filtered, beams best-first
        any_valid = valid.any(axis=1)
        first_valid = np.argmax(valid, axis=1)
    for b, utt_id in enumerate(batch["utt_ids"]):
        if max_utts >= 0 and n_utts >= max_utts:
            break
        if sample_utt_id is not None and utt_id != sample_utt_id:
            continue
        n_utts += 1
        reftext = texts[b]
        if nbest:
            ws = np.nonzero(valid[b])[0] if multi else (None,)
            for w in ws:
                h_raw = (
                    hyps[b, w, : hyp_lens[b, w]]
                    if multi else hyps[b, : hyp_lens[b]]
                )
                h = h_raw[h_raw != eos].tolist()
                s = float(scores[b, w] if multi else scores[b])
                rows.append(
                    [utt_id, s, ints2str(h), vocab.ids2text(h), reftext]
                )
            continue
        if multi and not any_valid[b]:
            logging.warning(f"cannot decode {utt_id}")
            rows.append([utt_id, None, "", reftext])
            continue
        if multi:
            h_raw = hyps[b, first_valid[b], : hyp_lens[b, first_valid[b]]]
            if count_forced and hyps.shape[1] > 1 and len(h_raw) and h_raw[-1] != eos:
                n_forced += 1
        else:
            h_raw = hyps[b, : hyp_lens[b]]
        h = h_raw[h_raw != eos].tolist()
        rows.append([utt_id, ints2str(h), vocab.ids2text(h), reftext])
    return rows, n_utts, n_forced


def decode_dataset(
    cfg: ExpConfig,
    dataset: ASRDataset,
    decode_fn,
    vocab: Vocab,
    nbest: bool = False,
    num_samples: int = -1,
    sample_utt_id: Optional[str] = None,
    decode_phone: bool = False,
    mesh: Optional[pmesh.Mesh] = None,
) -> List[list]:
    """Decode bucket batch after bucket batch -> result rows.

    A collate thread loads and pads the next batch (numpy, file IO) while
    the main thread decodes the current one; each batch's outputs are
    paired with that batch's own `utt_ids`.  `num_samples > 0` stops after
    that many utterances.  The count of force-finalized hypotheses is
    logged.  On a `mesh` each rank decodes its rows of a batch (rank 0 the
    whole of a batch that does not divide) and rank 0 returns every row;
    the other ranks return []."""
    rows: List[list] = []
    n_forced_total = 0
    q: "queue.Queue" = queue.Queue(maxsize=2)
    stop = threading.Event()
    err: list = []

    def put(item) -> bool:
        while not stop.is_set():
            try:
                q.put(item, timeout=0.2)
                return True
            except queue.Full:
                continue
        return False

    def producer():
        batches = dataset.batches()
        try:
            while True:
                with span("decode.collate"):  # the batch's frames counted in `ASRDataset.collate`
                    batch = next(batches, None)
                if batch is None or not put(batch):
                    return
        except BaseException as e:  # noqa: BLE001 — re-raised in the consumer
            err.append(e)
        finally:
            put(None)

    thread = threading.Thread(target=producer, daemon=True)
    thread.start()
    n_done = 0
    try:
        for i in itertools.count():
            with span("decode.wait", key=i):
                batch = q.get()
            if batch is None:
                if err:
                    raise err[0]
                break
            max_utts = (num_samples - n_done) if num_samples > 0 else -1
            outs = _decode_rows(decode_fn, batch, mesh)
            if outs is not None:
                with span("decode.postproc", key=i):
                    new, n_utts, n_forced = _postproc_batch(
                        cfg, batch, *outs, vocab, nbest, sample_utt_id, max_utts=max_utts,
                        decode_phone=decode_phone,
                    )
                rows.extend(new)
                n_forced_total += n_forced
            else:  # what rank 0 counts: every row up to max_utts without an utt_id filter
                n_utts = len(batch["utt_ids"]) if max_utts < 0 else min(len(batch["utt_ids"]), max_utts)
            n_done += n_utts
            if num_samples > 0 and sample_utt_id is None and n_done >= num_samples:
                break
    finally:
        stop.set()
        thread.join(timeout=10)
    if n_forced_total:
        logging.info(
            f"{n_forced_total} hypotheses force-finalized at their "
            "row step budget (no natural eos before the CTC-length cap "
            "— best-effort, possibly truncated; decode_len_cap: off "
            "restores reference semantics)"
        )
    return rows


def _decode_rows(decode_fn, batch: dict, mesh: Optional[pmesh.Mesh]):
    """(hyps, hyp_lens, scores) of the whole batch as numpy arrays, on
    rank 0 (None on the others): each rank decodes its rows and rank 0
    gathers them; a batch the data axis does not divide is rank 0's."""
    n = batch["xs"].shape[0]
    if mesh is None or n % mesh.data_size:
        if mesh is not None and not mesh.is_main:
            return None
        return tuple(t.cpu().numpy() for t in decode_fn(batch["xs"], batch["xlens"]))
    rows = pmesh.row_slice(mesh, n)
    mine = tuple(t.cpu().numpy() for t in decode_fn(batch["xs"][rows], batch["xlens"][rows]))
    parts = pmesh.gather_rows(mesh, mine)
    if parts is None:
        return None
    return tuple(_concat_padded([p[i] for p in parts]) for i in range(len(mine)))


def _concat_padded(arrays: List[np.ndarray]) -> np.ndarray:
    """Concatenate along the rows, padding the last axis to the longest
    (a rank's beam hypotheses may be shorter; the pad is never read)."""
    width = max(a.shape[-1] for a in arrays) if arrays[0].ndim > 1 else None
    if width is not None:
        arrays = [np.pad(a, [(0, 0)] * (a.ndim - 1) + [(0, width - a.shape[-1])]) for a in arrays]
    return np.concatenate(arrays, axis=0)


# the model, LM and decode function of the last call, reused by a call with
# the same setup (a grid over lm_weight and len_weight); at most one entry
_SETUP_CACHE: dict = {}


def test_main(args, lm_weight=None, len_weight=None):
    cfg = load_config(args.conf)
    device = resolve_device("cpu" if args.cpu else None)
    mesh = _dp_mesh(args, device)
    if mesh is not None:
        device = mesh.device
    set_matmul_precision(cfg.compute_dtype)
    beam_width = args.beam_width if args.beam_width is not None else cfg.beam_width
    if len_weight is None:
        len_weight = (
            args.len_weight if args.len_weight is not None else cfg.len_weight
        )
    decode_ctc_weight = (
        args.decode_ctc_weight
        if args.decode_ctc_weight is not None
        else cfg.decode_ctc_weight
    )
    if lm_weight is None:
        lm_weight = args.lm_weight if args.lm_weight is not None else cfg.lm_weight
    has_lm = lm_weight > 0
    # top-1 decoding everywhere except --nbest: the attention beam may stop
    # a row once its stored best is provably unbeatable
    top1 = not args.nbest

    main = mesh is None or mesh.is_main
    setup_logging(None, (logging.DEBUG if args.debug else logging.INFO) if main else logging.WARNING)
    logging.info(f"***** {' '.join(sys.argv)}")

    setup_key = (args.conf, str(args.ep), beam_width, decode_ctc_weight, args.lm_conf, args.lm_ep,
                 args.lm_path, has_lm, top1, str(device), args.decode_phone)
    cached = _SETUP_CACHE.get(setup_key)
    if cached is None:
        lm_fusion, lm_tag = None, ""
        if has_lm:
            lm_conf = args.lm_conf or rel_to_abs_path(cfg.lm_conf)
            lm_path = (get_model_path(lm_conf, args.lm_ep) if args.lm_ep is not None
                       else args.lm_path or rel_to_abs_path(cfg.lm_path))
            logging.info(f"LM: {lm_path} on {device}")
            check_lm_fusion_type(load_config(lm_conf).lm_type)  # before the checkpoint is read
            lm_model, lm_cfg = load_lm(lm_conf, lm_path)
            lm_fusion = make_lm_fusion(lm_model.to(device), lm_weight)
            lm_tag = lm_cfg.lm_type if args.lm_tag is None else args.lm_tag

        model_path = get_model_path(args.conf, args.ep)
        if not os.path.exists(model_path):
            ckpt.model_average(args.conf, args.ep)
        logging.info(f"ASR: {model_path} on {device}")
        model = load_asr_model(model_path, cfg)
        # for a CTC model decode_ctc_weight only names the result file: it
        # has no second score to weigh
        base_decode_fn = build_decode_fn(
            model, cfg, beam_width, len_weight, decode_ctc_weight, lm=lm_fusion, top1=top1,
            device=device, decode_phone=args.decode_phone,
        )
        cached = (base_decode_fn, lm_tag)
        _SETUP_CACHE.clear()  # hold at most one setup
        _SETUP_CACHE[setup_key] = cached
    base_decode_fn, lm_tag = cached
    decode_fn = base_decode_fn.with_weights(lm_weight, len_weight)

    data_path = get_eval_path(args.data)
    data_tag = (
        args.data
        if args.data_tag == "test" and data_path != args.data
        else args.data_tag
    )
    if data_path is None:
        data_path = cfg.test_path
    logging.info(f"test data: {data_path}")
    dataset = ASRDataset(cfg, rel_to_abs_path(data_path), phase="test", decode_phone=args.decode_phone)
    vocab = Vocab(rel_to_abs_path(cfg.phone_vocab_path if args.decode_phone else cfg.vocab_path))

    if args.runtime:
        runtimes, rtfs = [], []
        n_decoded = n_total = 0
        for j in range(args.runtime_num_repeats):
            t0 = time.time()
            results = decode_dataset(
                cfg, dataset, decode_fn, vocab, nbest=args.nbest,
                num_samples=args.runtime_num_samples,
                sample_utt_id=args.utt_id, decode_phone=args.decode_phone, mesh=mesh,
            )
            runtime = time.time() - t0
            runtime_utt = runtime / max(len(results), 1)
            wavtime = 0.0
            for r in results:
                parts = re.split("_|-", r[0])
                start_t = int(parts[-2]) / args.wavtime_factor
                end_t = int(parts[-1]) / args.wavtime_factor
                wavtime += end_t - start_t
            rtf = runtime / max(wavtime, 1e-9)
            n_total = len(results)
            n_decoded = sum(1 for r in results if r[1] is not None)
            logging.info(
                f"Run {j + 1} | runtime: {runtime_utt:.5f}sec/utt, "
                f"wavtime: {wavtime:.5f}sec | RTF: {rtf:.5f} "
                f"| decoded {n_decoded}/{n_total}"
            )
            runtimes.append(runtime_utt)
            rtfs.append(rtf)
        logging.info(
            f"Averaged runtime {np.mean(runtimes):.5f}sec, RTF {np.mean(rtfs):.5f}"
        )
        return runtimes, rtfs, n_decoded

    profile_dir = getattr(args, "profile", None) if main else None
    with trace(profile_dir, "decode_dataset", device) if profile_dir else contextlib.nullcontext():
        results = decode_dataset(
            cfg, dataset, decode_fn, vocab, nbest=args.nbest, sample_utt_id=args.utt_id,
            decode_phone=args.decode_phone, mesh=mesh,
        )
    if not main:  # rank 0 writes
        return None
    if args.utt_id is not None:
        for r in results:
            logging.info(r)
        return None

    results_dir = get_results_dir(args.conf)
    if args.save_dir is not None:
        results_dir = os.path.join(results_dir, args.save_dir)
        os.makedirs(results_dir, exist_ok=True)
    result_file = (
        f"result_{data_tag}_beam{beam_width:d}_len{len_weight:.1f}"
        f"_ctc{decode_ctc_weight:.1f}_lm{lm_weight:.2f}{lm_tag}_ep{args.ep}.tsv"
    )
    if args.decode_phone:
        result_file = result_file.replace(".tsv", "_phone.tsv")
    if args.nbest:
        result_file = result_file.replace(".tsv", "_nbest.tsv")
    result_path = os.path.join(results_dir, result_file)
    logging.info(f"result: {result_path}")

    if args.nbest:
        df = pd.DataFrame(
            results, columns=["utt_id", "score_asr", "token_id", "text", "reftext"]
        )
        df.to_csv(result_path, sep="\t", index=False)
        return None

    df = pd.DataFrame(results, columns=["utt_id", "token_id", "text", "reftext"])
    df.to_csv(result_path, sep="\t", index=False)
    wer, wer_dict = compute_wers_df(df)
    wer_info = wer_info_line(wer, wer_dict).replace("WER", "PER" if args.decode_phone else "WER", 1)
    logging.info(wer_info)
    insert_comment(result_path, wer_info)
    return lm_weight, len_weight, wer, wer_info


def _dp_mesh(args, device) -> Optional[pmesh.Mesh]:
    """`--dp` under torchrun: every rank on the data axis (JAX
    `test_asr.py:438-451`); None in a single process.  Ranks without
    `--dp` would each decode and write the whole set: refused."""
    world = int(os.environ.get("WORLD_SIZE", 1))
    if not getattr(args, "dp", False):
        if world > 1:
            raise ValueError(f"started on {world} ranks without --dp: pass --dp to split the batches over them")
        return None
    if "WORLD_SIZE" not in os.environ:
        return None
    if pmesh.active() is not None:  # a grid's later calls
        return pmesh.active()
    return pmesh.make_mesh((world,), (pmesh.DATA,), device=device)


def build_argparser():
    parser = argparse.ArgumentParser()
    parser.add_argument("-conf", type=str, required=True)
    parser.add_argument("-ep", type=str, required=True)
    parser.add_argument("--cpu", action="store_true",
                        help="run on the CPU (the default is the GPU)")
    parser.add_argument("--nbest", action="store_true")
    parser.add_argument("--data", type=str, default=None)
    parser.add_argument("--data_tag", type=str, default="test")
    parser.add_argument("--save_dir", type=str, default=None)
    parser.add_argument("--debug", action="store_true")
    parser.add_argument("--utt_id", type=str, default=None)
    parser.add_argument("--runtime", action="store_true")
    parser.add_argument("--runtime_num_samples", type=int, default=20)
    parser.add_argument("--runtime_num_repeats", type=int, default=5)
    parser.add_argument("--wavtime_factor", type=float, default=1000)
    parser.add_argument("--beam_width", type=int, default=None)
    parser.add_argument("--len_weight", type=float, default=None)
    parser.add_argument("--decode_ctc_weight", type=float, default=None)
    parser.add_argument("--lm_weight", type=float, default=None)
    parser.add_argument("--lm_conf", type=str, default=None)
    parser.add_argument("--lm_ep", type=str, default=None)
    parser.add_argument("--lm_path", type=str, default=None,
                        help="the LM's state_dict file (default: --lm_ep's, else the yaml's lm_path)")
    parser.add_argument("--lm_tag", type=str, default=None)
    parser.add_argument("--decode_phone", action="store_true",
                        help="decode the phone head (CTC models trained with phone CTC)")
    parser.add_argument("--dp", action="store_true",
                        help="split every batch's rows over the ranks that torchrun started")
    parser.add_argument("--profile", type=str, default=None,
                        help="write a torch.profiler trace of the decoding to this directory")
    return parser


def main(argv=None):
    try:
        return test_main(build_argparser().parse_args(argv))
    finally:
        pmesh.shutdown()


if __name__ == "__main__":
    main()
