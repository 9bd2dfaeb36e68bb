"""Batched label-synchronous beam search for the LAS decoder (PyTorch port
of `emoasr_tpu/search/las_beam.py`).

Parity target: emoASR `LASDecoder.decode` (`asr/modeling/decoders/las.py:
176-285`):
- beams start as [eos]; each step every beam expands with its top-W tokens
  of the attention log-softmax (plus `lm.weight` x the LM's log-probs when
  an LM is fused), and the W x W pool is pruned to W by cumulative score;
- a beam ending in <eos> is finalized with a `len_weight * |hyp|` bonus
  (|hyp| counts both framing eos); "only <eos>" hypotheses are rejected; a
  batch row stops once W results exist and is frozen from then on.

The whole batch and all beams advance together in a Python loop over label
steps, which reads one flag back a step (whether any row still runs).  The
decoder carry (LSTM states, context, previous attention weights) and the
LM states are beam-gathered on pruning: a beam that extends advances them,
its parent's stay as they were.  Both top-k selections, the (B, W, V)
pre-selection and the (B, W W) pool, go to the top-k kernel on the card
(`ops/topk.py`; the JAX package takes `lax.top_k` for the pool, with the
same order: values descending, ties to the lower index).  An LM with the
ancestor-indirect protocol (the Transformer LM; its layer step by the LM
step kernel when `models/lm/bert.py::FUSED_INDIRECT_STEP` is set) takes
that protocol: the search is label-synchronous, every slot writes cache
column t at step t.
"""

from __future__ import annotations

from typing import Callable, Optional, Tuple

import torch

from emoasr_tpu_torch.ops.topk import topk_lastdim_kernel
from emoasr_tpu_torch.search.common import DEAD, LMFusion, gather_beams, topk_lastdim, tree_map


def las_beam_search(
    step_fn: Callable,
    carry0,
    batch_size: int,
    vocab_size: int,
    beam_width: int,
    eos_id: int = 2,
    len_weight: float = 0.0,
    max_decode_ylen: int = 256,
    lm: Optional[LMFusion] = None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """step_fn(carry, tokens (B W,)) -> (carry, log-probs (B W, V)); the
    leaves of `carry0` are (B W, ...) (the caller tiles the encoder side W
    times).  Returns (hyps (B, W, Lmax) int32 with eos framing, lens int32,
    scores), results best-first."""
    B, W, V = batch_size, beam_width, vocab_size
    Lmax = max_decode_ylen + 2
    lw = float(len_weight)
    lm_weight = float(lm.weight) if lm is not None else 0.0
    leaves = []
    tree_map(leaves.append, carry0)
    dev = leaves[0].device

    hyps = torch.full((B, W, Lmax), eos_id, dtype=torch.int64, device=dev)
    lens = torch.ones((B, W), dtype=torch.int64, device=dev)
    scores = torch.full((B, W), DEAD, dtype=torch.float32, device=dev)
    scores[:, 0] = 0.0
    carry = tree_map(lambda x: x.reshape((B, W) + x.shape[1:]), carry0)
    res_hyps = hyps.clone()
    res_lens = torch.zeros((B, W), dtype=torch.int64, device=dev)
    res_scores = torch.full((B, W), DEAD, dtype=torch.float32, device=dev)
    res_count = torch.zeros((B,), dtype=torch.int64, device=dev)
    lm_states = lm_predict = lm_gather = None
    if lm is not None and lm.indirect is not None:
        lm_states = lm.indirect.init_states(B, W, Lmax)
        lm_predict, lm_gather = lm.indirect.predict_beams, lm.indirect.gather_states
    elif lm is not None:
        lm_states = lm.init_states(B, W)
        lm_predict = lm.predict_beams
        lm_gather = lambda states, parent: tree_map(lambda x: gather_beams(x, parent), states)

    b_idx = torch.arange(B, device=dev)[:, None]
    w_idx = torch.arange(W, device=dev)[None, :]

    for _ in range(max_decode_ylen):
        alive = scores > DEAD / 2
        row_active = alive.any(dim=1) & (res_count < W)
        if not bool(row_active.any()):
            break
        last_tok = torch.gather(hyps, 2, (lens.clamp(min=1) - 1)[:, :, None])[..., 0]
        new_carry, logp = step_fn(tree_map(lambda x: x.reshape((B * W,) + x.shape[2:]), carry),
                                  last_tok.reshape(B * W))
        scores_cand = logp.to(torch.float32).reshape(B, W, V)
        if lm is not None:
            lm_logp, new_lm_states = lm_predict(hyps, lens, lm_states)
            scores_cand = scores_cand + lm_weight * lm_logp[:, :, :V].to(torch.float32)

        sel_sc, sel_tok = topk_lastdim(scores_cand, W)  # (B, W, W)
        pool_sc = torch.where(alive[:, :, None], scores[:, :, None] + sel_sc, DEAD).reshape(B, W * W)
        top_sc, top_idx = topk_lastdim_kernel(pool_sc, W)  # (B, W)
        top_idx = top_idx.long()
        parent = top_idx // W

        new_hyps = gather_beams(hyps, parent)
        tok = torch.gather(sel_tok.reshape(B, W * W).long(), 1, top_idx)
        new_lens = torch.gather(lens, 1, parent) + 1
        new_hyps[b_idx, w_idx, (new_lens - 1).clamp(max=Lmax - 1)] = tok
        new_carry = tree_map(lambda x: gather_beams(x.reshape((B, W) + x.shape[1:]), parent), new_carry)

        valid_new = top_sc > DEAD / 2
        ended = (tok == eos_id) & valid_new
        # "only <eos>" hypotheses (no real token) are rejected (las.py:263-266)
        acceptable = ended & (new_lens > 2)
        final_score = top_sc + lw * new_lens.to(torch.float32)

        # accepted beams (in descending score order) fill result slots while
        # there is room; slot W is scratch
        offset = torch.cumsum(acceptable.to(torch.int64), dim=1) - 1
        slot = res_count[:, None] + offset
        can_store = acceptable & (slot < W) & row_active[:, None]
        slot_c = torch.where(can_store, slot, W)

        def store(res, new):
            ext = torch.cat([res, torch.zeros_like(res[:, :1])], dim=1)
            keep = can_store.reshape(can_store.shape + (1,) * (res.dim() - 2))
            ext[b_idx, slot_c] = torch.where(keep, new, ext[b_idx, slot_c])
            return ext[:, :W]

        res_new = (store(res_hyps, new_hyps), store(res_lens, new_lens), store(res_scores, final_score),
                   res_count + can_store.sum(dim=1))
        cont_scores = torch.where(ended | ~valid_new, DEAD, top_sc)

        # freeze finished batch rows; frozen rows take the new decoder carry
        # and LM states too: nothing reads them again
        def pick(n, o):
            return torch.where(row_active.reshape((B,) + (1,) * (n.dim() - 1)), n, o)

        hyps, lens, scores = pick(new_hyps, hyps), pick(new_lens, lens), pick(cont_scores, scores)
        res_hyps, res_lens, res_scores, res_count = (pick(n, o) for n, o in zip(
            res_new, (res_hyps, res_lens, res_scores, res_count)))
        carry = new_carry
        if lm is not None:
            lm_states = lm_gather(new_lm_states, parent)

    order = torch.argsort(-res_scores, dim=1, stable=True)
    return (
        gather_beams(res_hyps, order).to(torch.int32),
        torch.gather(res_lens, 1, order).to(torch.int32),
        torch.gather(res_scores, 1, order),
    )
