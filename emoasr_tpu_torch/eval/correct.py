"""Non-autoregressive error correction with masked LMs (PyTorch port of
`emoasr_tpu/eval/correct.py`).

Parity target: emoASR `asr/test_asr_correct.py`:

- CTC greedy decoding with frame alignments;
- `aggregate_logits` (:39-72): for each decoded token, the softmax row of
  the frame, within the token's alignment segment, where the token's
  probability peaks; that peak is the token's confidence;
- tokens whose confidence is below `mask_th` become `<mask>`;
- the masks are filled from `(1 - w) ASR + w LM` probabilities over the
  first min(V, V_lm) entries, the LM being BERT (or a causal LM's logits, as
  the JAX package takes them) or the phone-conditioned PC-MLM (`pbert`),
  which reads the phone hypotheses of the ASR model's (hierarchical) phone
  CTC head; a filled mask predicted as `blank_id` (the deletable PC-MLM's
  pad) is removed;
- `pctc`: the cascade, phone CTC hypotheses through the P2W CTC decoder;
- `--runtime`: the RTF, as the eval CLI gives it.

The encoder runs once a batch for both heads; aggregation, masking, the LM
fill and the mix stay on the device, and the corrected ids, the masks and
the lengths are read back once a batch.  Refused with a `ValueError`:
ELECTRA, P-ELECTRA and `ptransformer` as the correction LM (the JAX
package's forward without labels fails for the first two, and it gives
`ptransformer` no phones; ROADMAP.md §3).

Runs on the card unless `--cpu` is given:

    python -m emoasr_tpu_torch.eval.correct -conf <asr yaml> -ep <N> \
        --lm_conf <lm yaml> --lm_ep <M> [--mask_th 0.9] [--lm_weight 0.5] [--cpu]
"""

from __future__ import annotations

import argparse
import logging
import re
import time
from typing import List, Optional, Tuple

import numpy as np
import pandas as pd
import torch

from emoasr_tpu_torch.config import ExpConfig, load_config
from emoasr_tpu_torch.data.asr_dataset import ASRDataset
from emoasr_tpu_torch.eval.test_asr import get_eval_path, load_asr_model, load_lm
from emoasr_tpu_torch.eval.wer import compute_wers_df, wer_info_line
from emoasr_tpu_torch.models.asr import ASR
from emoasr_tpu_torch.models.lm.lm import LM
from emoasr_tpu_torch.train.step import preprocess
from emoasr_tpu_torch.utils.converters import ints2str
from emoasr_tpu_torch.utils.device import resolve_device, set_matmul_precision
from emoasr_tpu_torch.utils.log import insert_comment, setup_logging
from emoasr_tpu_torch.utils.paths import get_model_path, get_results_dir, rel_to_abs_path
from emoasr_tpu_torch.utils.vocab import Vocab

# the correction LMs: masked fill-in (bert, pbert), the cascade (pctc), and
# the causal LMs' logits, which the JAX package also takes
CORRECT_TYPES = ("bert", "pbert", "pctc", "transformer", "rnn")


def check_correct_type(lm_type: str) -> None:
    if lm_type not in CORRECT_TYPES:
        raise ValueError(
            f"lm_type={lm_type!r} cannot correct: one of {CORRECT_TYPES} (the JAX package's "
            "correction fails on ELECTRA and P-ELECTRA, and gives ptransformer no phones)"
        )


def aggregate_logits(logits: np.ndarray, aligns: np.ndarray, blank_id: int) -> Tuple[np.ndarray, np.ndarray]:
    """One utterance on the host (test_asr_correct.py:39-72): logits (T, V),
    aligns (T,) -> (token_probs (U, V), confidences (U,))."""
    x = np.asarray(logits, np.float32)
    e = np.exp(x - x.max(axis=-1, keepdims=True))
    probs = e / e.sum(axis=-1, keepdims=True)
    token_probs, token_probs_v = [], []
    seg_rows, tok_prev = [], None
    for t in range(len(aligns)):
        tok = int(aligns[t])
        if tok == blank_id:
            continue
        if tok_prev is not None and tok != int(aligns[t - 1]):
            rows = np.asarray(seg_rows)
            i = int(np.argmax(rows[:, tok_prev]))
            token_probs.append(rows[i])
            token_probs_v.append(rows[i, tok_prev])
            seg_rows = []
        seg_rows.append(probs[t])
        tok_prev = tok
    if seg_rows:
        rows = np.asarray(seg_rows)
        i = int(np.argmax(rows[:, tok_prev]))
        token_probs.append(rows[i])
        token_probs_v.append(rows[i, tok_prev])
    return np.asarray(token_probs), np.asarray(token_probs_v)


def aggregate_logits_device(logits: torch.Tensor, aligns: torch.Tensor, blank_id: int,
                            k: Optional[int] = None) -> Tuple[torch.Tensor, torch.Tensor]:
    """`aggregate_logits` over a batch on the device: logits (B, T, V),
    aligns (B, T) -> (token_probs (B, K, V), confidences (B, K)), K = `k`
    or T.  Segment j of row b (its j-th greedy token) fills slot [b, j]; a
    slot past the row's segments has confidence -inf and an arbitrary row.
    The segment maxima and their first frames come from two scatter
    reductions over the frames (no (B, T, T) membership table)."""
    B, T, _ = logits.shape
    K = T if k is None else k
    dev = logits.device
    probs = torch.softmax(logits.float(), dim=-1)
    aligns = aligns.long()
    nb = aligns != blank_id  # non-blank frames
    prev = torch.nn.functional.pad(aligns, (1, 0), value=-1)[:, :-1]
    boundary = nb & (aligns != prev)  # segment starts (the greedy emissions)
    seg = torch.cumsum(boundary.long(), dim=1) - 1
    seg = torch.where(nb, seg, torch.full_like(seg, T))  # blank frames go to a spare slot
    ptok = torch.gather(probs, 2, aligns[:, :, None])[:, :, 0]
    ptok = torch.where(nb, ptok, torch.full_like(ptok, -float("inf")))
    conf = torch.full((B, T + 1), -float("inf"), device=dev).scatter_reduce(
        1, seg, ptok, reduce="amax", include_self=True)
    # the first frame reaching its segment's maximum (np.argmax's tie rule)
    t_idx = torch.arange(T, device=dev)[None, :].expand(B, T)
    hit = nb & (ptok == torch.gather(conf, 1, seg))
    best_t = torch.full((B, T + 1), T, dtype=torch.long, device=dev).scatter_reduce(
        1, seg, torch.where(hit, t_idx, torch.full_like(t_idx, T)), reduce="amin", include_self=True)
    best_t = best_t[:, :K].clamp(max=T - 1)
    token_probs = torch.gather(probs, 1, best_t[:, :, None].expand(-1, -1, probs.shape[-1]))
    return token_probs, conf[:, :K]


class Corrector:
    """An ASR model and a correction LM (both on one device) applied a batch
    at a time."""

    def __init__(self, cfg: ExpConfig, model: ASR, lm_cfg: Optional[ExpConfig] = None,
                 lm_model: Optional[LM] = None, mask_th: float = 0.0, lm_weight: float = 0.0):
        if lm_cfg is not None:
            check_correct_type(lm_cfg.lm_type)
        self.cfg = cfg
        self.model = model.eval()
        self.lm_cfg = lm_cfg
        self.lm_model = None if lm_model is None else lm_model.eval()
        self.mask_th = mask_th
        self.lm_weight = lm_weight
        self.cascade_ctc = lm_cfg is not None and lm_cfg.lm_type == "pctc"
        self.use_phone = lm_cfg is not None and lm_cfg.lm_type in ("pbert", "pctc")
        self.device = next(model.parameters()).device

    def _correct_core(self, hyps, hyp_lens, logits, aligns, ps=None, plens=None):
        """aggregate -> confidence mask -> LM fill -> mix -> corrected ids:
        (hyp_cor (B, K), mask (B, K), lens (B,)), K = min(T', the LM's
        max_seq_len)."""
        V = logits.shape[-1]
        K = min(hyps.shape[1], self.lm_cfg.max_seq_len or hyps.shape[1])
        tp, conf = aggregate_logits_device(logits, aligns, self.cfg.blank_id, K)
        hyps_k = hyps[:, :K].long()
        lens_k = hyp_lens.long().clamp(max=K)
        in_hyp = torch.arange(K, device=hyps.device)[None, :] < lens_k[:, None]
        mask = in_hyp & (conf < self.mask_th)
        ys = torch.where(mask, torch.full_like(hyps_k, self.lm_cfg.mask_id), hyps_k)
        ys = torch.where(in_hyp, ys, torch.full_like(ys, self.lm_cfg.eos_id))
        ylens = lens_k.clamp(min=1)
        lm_logits = self.lm_model(ys, ylens, None, ps, plens)
        lm_probs = torch.softmax(lm_logits.float(), dim=-1)
        Vmix = min(V, lm_probs.shape[-1])
        mix = (1.0 - self.lm_weight) * tp[:, :, :Vmix] + self.lm_weight * lm_probs[:, :, :Vmix]
        hyp_cor = torch.where(mask, torch.argmax(mix, dim=-1), hyps_k)
        return hyp_cor, mask, lens_k

    @torch.no_grad()
    def correct_batch(self, batch) -> List[Tuple[str, List[int], str, int, int]]:
        """Rows (utt_id, corrected ids, reference text, masked tokens,
        tokens) of the batch's utterances."""
        cfg = self.cfg
        xs = torch.as_tensor(batch["xs"]).to(self.device, torch.float32)
        xlens = torch.as_tensor(batch["xlens"]).to(self.device, torch.int64)
        xs, xlens = preprocess(cfg, xs, xlens)
        eouts, elens, eouts_inter = self.model.encode(xs, xlens)
        hyps, hyp_lens, logits, aligns = self.model.decoder.greedy(eouts, elens)
        ps = plens = None
        if self.use_phone:
            src = eouts_inter if cfg.hie_mtl_phone else eouts
            ps, plens, _, _ = self.model.decoder.greedy(src, elens, decode_phone=True)
            plens = plens.long()

        if self.cascade_ctc:
            hyp_cor, cor_lens = self.lm_model.lm.decode_greedy(ps, plens)
            hyp_cor, cor_lens = hyp_cor.cpu().numpy(), cor_lens.cpu().numpy()
            return [(u, hyp_cor[b, : cor_lens[b]].tolist(), batch["texts"][b], 0, 0)
                    for b, u in enumerate(batch["utt_ids"])]

        hyp_cor, mask, lens_k = (t.cpu().numpy() for t in self._correct_core(
            hyps, hyp_lens, logits, aligns, ps, plens))
        results = []
        for b, utt_id in enumerate(batch["utt_ids"]):
            n = int(lens_k[b])
            if n == 0:
                results.append((utt_id, [], batch["texts"][b], 0, 0))
                continue
            # deletable PC-MLM: masks predicted as pad/blank are removed
            cor = [int(x) for x in hyp_cor[b, :n] if x != cfg.blank_id]
            results.append((utt_id, cor, batch["texts"][b], int(mask[b, :n].sum()), n))
        return results


def test_main(args):
    cfg = load_config(args.conf)
    device = resolve_device("cpu" if args.cpu else None)
    set_matmul_precision(cfg.compute_dtype)
    setup_logging(None, logging.DEBUG if args.debug else logging.INFO)
    lm_cfg = lm_model = None
    if args.lm_conf:
        check_correct_type(load_config(args.lm_conf).lm_type)  # before a checkpoint is read
    model_path = get_model_path(args.conf, args.ep)
    model = load_asr_model(model_path, cfg).to(device)
    logging.info(f"ASR: {model_path} on {device}")
    vocab = Vocab(rel_to_abs_path(cfg.vocab_path))
    if args.lm_conf:
        lm_path = get_model_path(args.lm_conf, args.lm_ep)
        lm_model, lm_cfg = load_lm(args.lm_conf, lm_path)
        lm_model = lm_model.to(device)
        logging.info(f"LM: {lm_path}")
    corr = Corrector(cfg, model, lm_cfg, lm_model, mask_th=args.mask_th, lm_weight=args.lm_weight)

    data_path = rel_to_abs_path(get_eval_path(args.data) or cfg.test_path)
    dataset = ASRDataset(cfg, data_path, phase="test")
    batcher = dataset.make_batcher(shuffle=False, drop_tail=False)

    if args.runtime:  # the RTF protocol of test_asr_correct.py:312-348
        rtfs = []
        for j in range(args.runtime_num_repeats):
            t0 = time.time()
            n_done, wavtime = 0, 0.0
            for batch in dataset.batches(batcher):
                for utt_id, *_ in corr.correct_batch(batch):
                    parts = re.split("_|-", utt_id)
                    wavtime += (int(parts[-1]) - int(parts[-2])) / args.wavtime_factor
                    n_done += 1
                    if n_done >= args.runtime_num_samples:
                        break
                if n_done >= args.runtime_num_samples:
                    break
            rtf = (time.time() - t0) / max(wavtime, 1e-9)
            logging.info(f"Run {j + 1} | RTF: {rtf:.5f}")
            rtfs.append(rtf)
        logging.info(f"Averaged RTF {np.mean(rtfs):.5f}")
        return rtfs

    rows = []
    n_masked_total = n_tokens_total = 0
    t0 = time.time()
    for batch in dataset.batches(batcher):
        for utt_id, ids, reftext, n_masked, n_tokens in corr.correct_batch(batch):
            rows.append([utt_id, ints2str(ids), vocab.ids2text(ids), reftext])
            n_masked_total += n_masked
            n_tokens_total += n_tokens
    runtime = time.time() - t0

    df = pd.DataFrame(rows, columns=["utt_id", "token_id", "text", "reftext"])
    out = (f"{get_results_dir(args.conf)}/result_correct_{args.data_tag}"
           f"_th{args.mask_th:.2f}_lm{args.lm_weight:.2f}_ep{args.ep}.tsv")
    df.to_csv(out, sep="\t", index=False)
    wer, wer_dict = compute_wers_df(df)
    wer_info = wer_info_line(wer, wer_dict)
    logging.info(wer_info)
    if n_tokens_total:
        logging.info(f"masked: {n_masked_total}/{n_tokens_total} "
                     f"({100 * n_masked_total / n_tokens_total:.1f}%), runtime {runtime:.2f}s")
    insert_comment(out, wer_info)
    return wer, wer_info


def build_argparser():
    parser = argparse.ArgumentParser()
    parser.add_argument("-conf", type=str, required=True)
    parser.add_argument("-ep", type=str, required=True)
    parser.add_argument("--cpu", action="store_true", help="run on the CPU (the default is the GPU)")
    parser.add_argument("--data", type=str, default=None)
    parser.add_argument("--data_tag", type=str, default="test")
    parser.add_argument("--debug", action="store_true")
    parser.add_argument("--lm_conf", type=str, default=None)
    parser.add_argument("--lm_ep", type=str, default=None)
    parser.add_argument("--mask_th", type=float, default=0.5)
    parser.add_argument("--lm_weight", type=float, default=0.5)
    parser.add_argument("--runtime", action="store_true")
    parser.add_argument("--runtime_num_samples", type=int, default=20)
    parser.add_argument("--runtime_num_repeats", type=int, default=5)
    parser.add_argument("--wavtime_factor", type=float, default=1000)
    return parser


def main(argv=None):
    return test_main(build_argparser().parse_args(argv))


if __name__ == "__main__":
    main()
