"""Batched label-synchronous beam search for attention decoders, with joint
CTC prefix scoring, LM shallow fusion and length penalty (PyTorch port of
`emoasr_tpu/search/attention_beam.py`).

Parity target: emoASR `TransformerDecoder.decode`
(`asr/modeling/decoders/transformer.py:160-294`):
- per step: one-step decoder forward, log-softmax scores
- optional LM fusion added before candidate pre-selection
- optional joint CTC: pre-select ctc_beam_width = 1.5x beam candidates by
  (att + lm), re-score with (1-w)*(att + lm) + w*(ctc prefix delta) + lm:
  the reference's effective (2 - w) LM weight, kept
- global prune to beam_width; beams ending in <eos> are finalized with a
  `len_weight * |hyp|` bonus ("only <eos>" hyps rejected); a batch row stops
  once beam_width results exist and is frozen from then on.

The whole batch and all beams advance together; a Python loop over label
steps takes the place of the JAX package's `lax.while_loop` and reads one
flag back per step (whether any row still runs).  The incremental step
functions write into the caches in place.
"""

from __future__ import annotations

from typing import Callable, Optional, Tuple

import torch
import torch.nn.functional as F

from emoasr_tpu_torch.search.common import DEAD, LMFusion, gather_beams, topk_lastdim, tree_map
from emoasr_tpu_torch.search.ctc_prefix_score import (
    ctc_prefix_initial_state,
    ctc_prefix_score_psi,
    ctc_prefix_state_update,
)

CTC_BEAM_WIDTH_RATIO = 1.5  # transformer.py:22

# Cache-length stage boundaries.  The self-attention caches only ever need
# rows < current length, so the search runs in stages with growing cache
# bounds: the dense and indirect step routes attend (and the direct routes
# permute) caches of the stage's length, not of Lmax.  None = adaptive
# (~Lmax/4 and ~Lmax/2, rounded to multiples of 8).  Exact: rows >= len are
# never read, and a row is overwritten at its step before it is attended.
# Tests override with explicit bounds to force transitions at small sizes.
STAGE_BOUNDS = None


def _grow(x: torch.Tensor, bound: int) -> torch.Tensor:
    """Zero-pad axis 2 (the cache length) of a (B, W, Lc, ...) tensor to
    `bound`; a tensor that long already stays as it is."""
    if x.shape[2] >= bound:
        return x
    pad = [0, 0] * (x.dim() - 3) + [0, bound - x.shape[2]]
    return F.pad(x, pad)


def attention_beam_search(
    eouts: torch.Tensor,
    elens: torch.Tensor,
    step_fn: Optional[Callable],
    vocab_size: int,
    beam_width: int,
    eos_id: int = 2,
    blank_id: int = 0,
    len_weight: float = 0.0,
    lm: Optional[LMFusion] = None,
    decode_ctc_weight: float = 0.0,
    ctc_log_probs: Optional[torch.Tensor] = None,
    max_decode_ylen: int = 256,
    cached_step: Optional[Tuple[Callable, ...]] = None,
    row_caps: Optional[torch.Tensor] = None,
    need_results: Optional[int] = None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Label-sync beam search over a batch.

    step_fn(flat_hyps (N, Lc), flat_lens (N,), eouts_rep (N, T, E),
            elens_rep (N,)) -> logits (N, V): one-step decoder forward.
    `cached_step` = (init_cache(N, Lc) -> caches,
    step(tokens (N,), pos (N,), caches) -> (logits, caches)) switches to
    incremental KV-cached decoding; caches are beam-gathered on pruning.  A
    third entry, step(tokens, pos (B, W), caches, anc) -> (logits, caches),
    switches to ancestor-indirect caches: they stay in physical slot order
    and the beam permutations compose into the (B, W, Lc) table `anc`.

    `lm`: shallow fusion through an `LMFusion` (search/common.py): its
    `indirect` protocol where it has one, else its standard fields.  States
    with a length axis start at the first stage bound and grow with the
    stages up to the LM's own `state_max_len`.
    Returns (hyps (B, W, Lmax) with the leading eos kept and the trailing
    one where a beam emitted it, lens, scores), results best-first.

    `row_caps` (B,), optional: per-utterance decode-step budget (e.g.
    CTC-length-informed, eval/decode.py::ctc_len_caps).  A row reaching its
    cap force-finalizes every surviving beam (score + the same length bonus
    natural eos finalization gets) instead of running to the global step
    cap, so a row whose beams never emit a viable eos still returns its best
    live hypotheses.

    `need_results`, optional (default W): a row stops once this many results
    are stored and no live beam can still beat the stored best.  With 1
    (top-1 decoding) the stop is exact for the returned best hypothesis:
    every per-step score increment is <= 0, the only positive term is the
    finalization bonus len_weight*len, so a live beam (score s, len l, r
    steps of row budget left) can never finalize above
    s + len_weight*l + max(len_weight, 0)*r."""
    B, T, E = eouts.shape
    dev = eouts.device
    W = beam_width
    V = vocab_size
    Lmax = max_decode_ylen + 2
    use_ctc = decode_ctc_weight > 0
    need = W if need_results is None else min(need_results, W)
    caps = (
        torch.full((B,), max_decode_ylen, dtype=torch.int64, device=dev)
        if row_caps is None
        else row_caps.to(dev, torch.int64).clamp(max=max_decode_ylen)
    )
    # time-major-last table for the prefix scorer's per-candidate row gather
    ctc_lp_T = ctc_log_probs.transpose(1, 2).contiguous() if use_ctc else None
    K2 = min(V, int(W * CTC_BEAM_WIDTH_RATIO)) if use_ctc else W
    lw = float(len_weight)
    lm_weight = float(lm.weight) if lm is not None else 0.0

    if STAGE_BOUNDS is None:
        cand = [max(8, Lmax // 4 // 8 * 8), max(16, Lmax // 2 // 8 * 8)]
    else:
        cand = list(STAGE_BOUNDS)
    stage_bounds = sorted({b for b in cand if b < Lmax}) + [Lmax]

    caches = anc = None
    step_cached_fn = step_indirect_fn = None
    if cached_step is not None:
        init_cache_fn, step_cached_fn = cached_step[0], cached_step[1]
        if len(cached_step) > 2:
            step_indirect_fn = cached_step[2]
        caches = [
            tuple(x.reshape((B, W) + x.shape[1:]) for x in kv)
            for kv in init_cache_fn(B * W, stage_bounds[0])
        ]
        if step_indirect_fn is not None:
            anc = torch.zeros((B, W, stage_bounds[0]), dtype=torch.int32, device=dev)

    hyps = torch.full((B, W, Lmax), eos_id, dtype=torch.int64, device=dev)
    lens = torch.ones((B, W), dtype=torch.int64, device=dev)
    scores = torch.full((B, W), DEAD, dtype=torch.float32, device=dev)
    scores[:, 0] = 0.0
    score_ctc = torch.zeros((B, W), dtype=torch.float32, device=dev)
    ctc_state = ctc_prefix_initial_state(ctc_log_probs, elens, blank_id, W) if use_ctc else None
    res_hyps = hyps.clone()
    res_lens = torch.zeros((B, W), dtype=torch.int64, device=dev)
    res_scores = torch.full((B, W), DEAD, dtype=torch.float32, device=dev)
    res_count = torch.zeros((B,), dtype=torch.int64, device=dev)
    lm_states = lm_predict = lm_gather = None
    if lm is not None and lm.indirect is not None:
        lm_states = lm.indirect.init_states(B, W, stage_bounds[0])
        lm_predict, lm_gather = lm.indirect.predict_beams, lm.indirect.gather_states
    elif lm is not None:
        lm_states = lm.init_states(B, W, stage_bounds[0]) if lm.state_pad_axis is not None \
            else lm.init_states(B, W)
        lm_predict = lm.predict_beams
        lm_gather = lambda states, parent: tree_map(lambda x: gather_beams(x, parent), states)

    if cached_step is None:
        eouts_rep = eouts[:, None].expand(B, W, T, E).reshape(B * W, T, E)
        elens_rep = elens[:, None].expand(B, W).reshape(B * W)
    b_idx = torch.arange(B, device=dev)[:, None]
    w_idx = torch.arange(W, device=dev)[None, :]
    w_slots = w_idx.expand(B, W).to(torch.int32)

    def rows_running(step: int) -> torch.Tensor:
        """(B,) rows still doing useful work; the loop condition and the
        body's freeze mask share it."""
        alive = scores > DEAD / 2
        running = alive.any(dim=1) & (res_count < W)
        if need < W:
            # admissible top-1 stop (see docstring): bound on the best score
            # any live beam could still finalize with
            remaining = (caps - step).clamp(min=0).to(torch.float32)
            live_pot = torch.where(alive, scores + lw * lens.to(torch.float32), DEAD).amax(dim=1) \
                + max(lw, 0.0) * remaining
            best_stored = res_scores.amax(dim=1)
            # 1e-4 slack: err toward running longer under float reordering
            beatable = live_pot >= best_stored - 1e-4
            running = running & ((res_count < need) | beatable)
        return running

    step = 0
    prev_bound = stage_bounds[0]
    done = False
    for Lc in stage_bounds:
        if done:
            break
        if Lc > prev_bound and caches is not None:
            caches = [tuple(_grow(x, Lc) for x in kv) for kv in caches]
            if anc is not None:
                anc = _grow(anc, Lc)
        if Lc > prev_bound and lm is not None and lm.state_pad_axis is not None:
            # every leaf, the ancestor table too, on the LM's length axis (2),
            # up to the LM's own bound, which the decoder's may pass
            cap = min(Lc, lm.state_max_len)
            lm_states = tree_map(lambda x: _grow(x, cap), lm_states)
        prev_bound = Lc
        # step cap: the cache write position (lens - 1 <= step + 1) must stay
        # inside this stage's bound
        step_cap = min(Lc - 1, max_decode_ylen)
        while step < step_cap:
            row_active = rows_running(step)  # (B,)
            if not bool(row_active.any()):
                done = True
                break
            alive = scores > DEAD / 2  # (B, W)

            flat_hyps = hyps.reshape(B * W, Lmax)
            flat_lens = lens.reshape(B * W).clamp(min=1)
            parent_anc = None
            if step_indirect_fn is not None:
                last_tok = torch.gather(flat_hyps, 1, (flat_lens - 1)[:, None])[:, 0]
                posb = (lens.clamp(min=1) - 1).clamp(max=Lc - 1)
                anc[b_idx, w_idx, posb] = w_slots
                logits, caches = step_indirect_fn(last_tok, posb, caches, anc)
                parent_anc = anc
            elif cached_step is not None:
                last_tok = torch.gather(flat_hyps, 1, (flat_lens - 1)[:, None])[:, 0]
                flat_caches = [
                    tuple(x.reshape((B * W,) + x.shape[2:]) for x in kv) for kv in caches
                ]
                logits, new_flat = step_cached_fn(last_tok, flat_lens - 1, flat_caches)
                caches = [tuple(x.reshape((B, W) + x.shape[1:]) for x in kv) for kv in new_flat]
            else:
                # causal decoder: positions >= the stage bound are all beyond
                # every live prefix, so re-encoding the sliced buffer is exact
                logits = step_fn(flat_hyps[:, :Lc], flat_lens.clamp(max=Lc), eouts_rep, elens_rep)
            scores_pre = torch.log_softmax(logits.to(torch.float32), dim=-1).reshape(B, W, V)
            if lm is not None:
                lm_logp, new_lm_states = lm_predict(hyps[:, :, :Lc], lens, lm_states)
                lm_logp = lm_logp[:, :, :V]
                scores_pre = scores_pre + lm_weight * lm_logp

            if row_caps is not None and step == 0:
                # a step-0 eos candidate is always rejected ("only <eos>",
                # below): selecting it only wastes a beam slot, and at W == 1
                # it kills the whole row (then nothing remains to
                # force-finalize at the cap).  Masking it is WER-neutral.
                scores_pre[:, :, eos_id] += DEAD

            if use_ctc:
                # pre-select K2 candidates by att (+ lm) (transformer.py:222-232)
                pre_sc, v_topb = topk_lastdim(scores_pre, K2)  # (B, W, K2)
                v_topb = v_topb.long()
                # psi only: the lattice state advances lazily after selection
                # (ctc_prefix_state_update below), so the scans run over W
                # winners instead of W*K2 candidates
                psi = ctc_prefix_score_psi(
                    ctc_lp_T, elens, hyps, lens, v_topb, ctc_state, blank_id, eos_id
                )
                # the reference re-scores (1-w)*scores + w*ctc_delta + lm where
                # `scores` already holds att + lm (it aliases and mutates in
                # place, transformer.py:220-244): an effective LM weight of
                # (2-w)*lm_weight, reproduced as the published +CTC+SF
                # operating points were tuned under it
                cand_sc = (
                    (1 - decode_ctc_weight) * pre_sc
                    + decode_ctc_weight * (psi - score_ctc[:, :, None])
                )
                if lm is not None:
                    cand_sc = cand_sc + lm_weight * torch.gather(lm_logp, 2, v_topb)
                # per-parent top-W among the K2 (the reference then pools W*W)
                sel_sc, sel_i = topk_lastdim(cand_sc, W)  # (B, W, W)
                sel_i = sel_i.long()
                sel_tok = torch.gather(v_topb, 2, sel_i)
                sel_psi = torch.gather(psi, 2, sel_i)
            else:
                sel_sc, sel_tok = topk_lastdim(scores_pre, W)  # (B, W, W)
                sel_tok = sel_tok.long()
                sel_psi = None

            K = W
            pool_sc = torch.where(alive[:, :, None], scores[:, :, None] + sel_sc, DEAD).reshape(B, W * K)
            top_sc, top_idx = topk_lastdim(pool_sc, W)  # (B, W)
            top_idx = top_idx.long()
            parent = top_idx // K

            parent_hyps = gather_beams(hyps, parent)
            parent_lens = torch.gather(lens, 1, parent)
            tok = torch.gather(sel_tok.reshape(B, W * K), 1, top_idx)
            new_lens = parent_lens + 1
            pos = (new_lens - 1).clamp(max=Lmax - 1)
            new_hyps = parent_hyps.clone()
            new_hyps[b_idx, w_idx, pos] = tok

            new_score_ctc, new_ctc_state = score_ctc, ctc_state
            if use_ctc:
                new_score_ctc = torch.gather(sel_psi.reshape(B, W * K), 1, top_idx)
                # lazy lattice update: advance r only for each beam's winning
                # token, from the parent's state (W scans instead of W*K2)
                new_ctc_state = ctc_prefix_state_update(
                    ctc_lp_T, elens, parent_hyps, parent_lens, tok,
                    gather_beams(ctc_state, parent), blank_id,
                )

            valid_new = top_sc > DEAD / 2

            # ---- finalize beams that just emitted eos ----
            ended = (tok == eos_id) & valid_new  # (B, W)
            # "only <eos>" (len_noeos < 1) hyps are rejected outright
            acceptable = ended & (new_lens > 2)
            # rows at their per-utterance step budget force-finalize every
            # surviving beam.  Only with explicit row_caps: the bare search
            # keeps the reference's semantics (a row that never emits a
            # viable eos returns nothing, transformer.py:264-287).
            if row_caps is not None:
                at_cap = row_active & (step + 1 >= caps)  # (B,)
                acceptable = acceptable | (at_cap[:, None] & valid_new & ~ended)
            else:
                at_cap = torch.zeros((B,), dtype=torch.bool, device=dev)
            final_score = top_sc + lw * new_lens.to(torch.float32)

            # append accepted beams (already in descending score order) into
            # result slots while capacity remains; slot W is scratch
            offset = torch.cumsum(acceptable.to(torch.int64), dim=1) - 1
            slot = res_count[:, None] + offset  # (B, W)
            can_store = acceptable & (slot < W) & row_active[:, None]
            slot_c = torch.where(can_store, slot, W)

            def store(res, new):
                ext = torch.cat([res, torch.zeros_like(res[:, :1])], dim=1)
                keep = can_store.reshape(can_store.shape + (1,) * (res.dim() - 2))
                ext[b_idx, slot_c] = torch.where(keep, new, ext[b_idx, slot_c])
                return ext[:, :W]

            new_res_hyps = store(res_hyps, new_hyps)
            new_res_lens = store(res_lens, new_lens)
            new_res_scores = store(res_scores, final_score)
            new_res_count = res_count + can_store.sum(dim=1)

            # ended (accepted or rejected) and budget-exhausted beams leave
            # the active set
            cont_scores = torch.where(ended | ~valid_new | at_cap[:, None], DEAD, top_sc)

            # freeze finished batch rows.  The caches and the ancestor table
            # are not frozen: for an inactive row every consumer is already
            # guarded (its scores are DEAD, its result writes are gated on
            # row_active, and the search never reads its caches again).
            def pick(n, o):
                return torch.where(row_active.reshape((B,) + (1,) * (n.dim() - 1)), n, o)

            hyps, lens, scores = pick(new_hyps, hyps), pick(new_lens, lens), pick(cont_scores, scores)
            if use_ctc:
                score_ctc = pick(new_score_ctc, score_ctc)
                ctc_state = pick(new_ctc_state, ctc_state)
            res_hyps, res_lens = pick(new_res_hyps, res_hyps), pick(new_res_lens, res_lens)
            res_scores, res_count = pick(new_res_scores, res_scores), pick(new_res_count, res_count)
            if parent_anc is not None:
                anc = torch.gather(parent_anc, 1, parent[:, :, None].expand(B, W, Lc))
            elif cached_step is not None:
                caches = [tuple(gather_beams(x, parent) for x in kv) for kv in caches]
            if lm is not None:
                # frozen rows take the new states too: nothing reads them again
                lm_states = lm_gather(new_lm_states, parent)
            step += 1

    order = torch.argsort(-res_scores, dim=1, stable=True)
    return (
        gather_beams(res_hyps, order).to(torch.int32),
        torch.gather(res_lens, 1, order).to(torch.int32),
        torch.gather(res_scores, 1, order),
    )
