"""Batched ALSD-style RNN-T beam search (PyTorch port of
`emoasr_tpu/search/rnnt_beam.py`).

Parity target: emoASR `RNNTDecoder._beam_search`
(`asr/modeling/decoders/rnn_transducer.py:242-325`): time-synchronous
decoding with `NUM_EXPANDS` = 3 label expansions a frame, the blank
expansions of all rounds pooled and merged with logaddexp over total
scores, per-round pruning, and prediction-network states carried per beam
(a beam's stored state reflects hyp[:-1]; the network consumes hyp[-1]
when the beam is evaluated).

The whole (B, W) beam advances frame by frame in a Python loop, up to the
longest utterance (later frames change no row).  Each round's
pre-selection over the vocabulary goes through `topk_lastdim` (the top-k
kernel on the card); the second selection over the W K candidates and the
pool's selection take the lower index among equal scores, as `lax.top_k`
does.  Within one round, extensions of distinct parents cannot collide, so
only the blank pool is merged, by the double hash of `search/common.py`
(first occurrence canonical).

LM shallow fusion (an `LMFusion`, `search/common.py`; JAX
`search/rnnt_beam.py:121-171`): each round's label candidates add the LM
weight times the LM's log-probs; a beam's LM state advances only with the
label it emits, and the blank pool keeps each beam's pre-round state.
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Tuple

import torch

from emoasr_tpu_torch.search.common import (
    DEAD,
    gather_beams,
    hash_extend,
    hash_init,
    topk_lastdim,
    tree_map,
)

NUM_EXPANDS = 3


class _Beams(NamedTuple):
    hyps: torch.Tensor  # (B, W, Lmax) int32
    lens: torch.Tensor  # (B, W) int64
    scores: torch.Tensor  # (B, W) float32, logaddexp-merged totals
    dstates: torch.Tensor  # (B, W, layers, 2, H): the state for hyp[:-1]
    h1: torch.Tensor
    h2: torch.Tensor
    lm_states: object  # the fusion LM's states with (B, W, ...) leaves, or None


def _take(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """x (B, N) at idx (B, W)."""
    return torch.gather(x, 1, idx.long())


def rnnt_beam_search(
    eouts: torch.Tensor,
    elens: torch.Tensor,
    recurrency_fn: Callable,
    joint_fn: Callable,
    num_layers: int,
    dec_hidden: int,
    beam_width: int,
    vocab_size: int,
    blank_id: int = 0,
    eos_id: int = 2,
    max_hyp_len: int = 257,
    lm=None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """ALSD beam search over a batch.

    recurrency_fn(tokens (N, 1), dstates (layers, 2, N, H)) -> (douts
    (N, D), new dstates); joint_fn(eouts_t (N, E), douts (N, D)) -> logits
    (N, V).  Returns (hyps (B, W, Lmax) with the leading eos, lens (B, W),
    scores (B, W)), best first.  `lm` (LMFusion) adds shallow fusion on
    the label expansions."""
    B, T, E = eouts.shape
    dev = eouts.device
    W = beam_width
    K = min(beam_width, vocab_size - 1)
    Lmax = max_hyp_len
    A = NUM_EXPANDS * W  # blank-pool size a frame
    elens = elens.to(dev)

    hyps0 = torch.full((B, W, Lmax), blank_id, dtype=torch.int32, device=dev)
    hyps0[:, :, 0] = eos_id
    h1, h2 = hash_extend(hash_init((B, W), dev), torch.full((B, W), eos_id, device=dev))
    scores0 = torch.full((B, W), DEAD, dtype=torch.float32, device=dev)
    scores0[:, 0] = 0.0
    beams = _Beams(
        hyps=hyps0, lens=torch.ones((B, W), dtype=torch.long, device=dev), scores=scores0,
        dstates=eouts.new_zeros((B, W, num_layers, 2, dec_hidden)), h1=h1, h2=h2,
        lm_states=lm.init_states(B, W) if lm is not None else None,
    )
    b_idx = torch.arange(B, device=dev)[:, None]
    w_idx = torch.arange(W, device=dev)[None, :]

    def flat_recurrency(last_tok, dstates_bw):
        """(B, W) tokens + (B, W, layers, 2, H) -> (B, W, D), new states."""
        ds = dstates_bw.reshape(B * W, num_layers, 2, dec_hidden).permute(1, 2, 0, 3)
        douts, new_ds = recurrency_fn(last_tok.reshape(B * W, 1), ds)
        return douts.reshape(B, W, -1), new_ds.permute(2, 0, 1, 3).reshape(B, W, num_layers, 2, dec_hidden)

    n_frames = min(T, int(elens.max()))  # frames past every row's end change nothing
    for t in range(n_frames):
        e_t = eouts[:, t]
        active_b = t < elens  # (B,)

        # the blank pool, filled across the rounds
        a_hyps = torch.zeros((B, A, Lmax), dtype=torch.int32, device=dev)
        a_lens = torch.zeros((B, A), dtype=torch.long, device=dev)
        a_scores = torch.full((B, A), DEAD, dtype=torch.float32, device=dev)
        a_dstates = eouts.new_zeros((B, A, num_layers, 2, dec_hidden))
        a_h1 = torch.zeros((B, A), dtype=torch.long, device=dev)
        a_h2 = torch.zeros((B, A), dtype=torch.long, device=dev)
        a_lm_states = tree_map(lambda x: torch.cat([x] * NUM_EXPANDS, dim=1), beams.lm_states)

        cur = beams
        for v_round in range(NUM_EXPANDS):
            alive = cur.scores > DEAD / 2
            last_tok = torch.gather(cur.hyps, 2, (cur.lens - 1).clamp(min=0)[:, :, None])[:, :, 0]
            douts, new_dstates = flat_recurrency(last_tok, cur.dstates)
            logits = joint_fn(e_t[:, None, :].expand(B, W, E).reshape(B * W, E), douts.reshape(B * W, -1))
            sa = torch.log_softmax(logits.float(), dim=-1).reshape(B, W, vocab_size)

            # blank expansion into the pool (the state is not advanced)
            sl = slice(v_round * W, (v_round + 1) * W)
            a_hyps[:, sl] = cur.hyps
            a_lens[:, sl] = cur.lens
            a_scores[:, sl] = torch.where(alive, cur.scores + sa[:, :, blank_id], torch.full_like(cur.scores, DEAD))
            a_dstates[:, sl] = cur.dstates
            a_h1[:, sl] = cur.h1
            a_h2[:, sl] = cur.h2
            if a_lm_states is not None:
                tree_map(lambda a, c: a[:, sl].copy_(c), a_lm_states, cur.lm_states)

            # label expansion (the last round has none); the reference's
            # top-k runs over vocab[1:], so it assumes blank_id == 0
            # (rnn_transducer.py:301-303)
            if v_round < NUM_EXPANDS - 1:
                sa_nb = sa[:, :, 1:]
                lm_new_states = None
                if lm is not None:
                    # the states advance only where a label is emitted
                    lm_logp, lm_new_states = lm.predict_beams(cur.hyps, cur.lens, cur.lm_states)
                    sa_nb = sa_nb + lm.weight * lm_logp[:, :, 1:]
                top_sc, top_v = topk_lastdim(sa_nb.contiguous(), K)  # (B, W, K)
                top_v = top_v + 1
                ok = alive[:, :, None] & (cur.lens[:, :, None] < Lmax - 1)
                cand = torch.where(ok, cur.scores[:, :, None] + top_sc, torch.full_like(top_sc, DEAD))
                sel_sc, sel_idx = topk_lastdim(cand.reshape(B, W * K), W)  # (B, W)
                parent = sel_idx.long() // K
                tok = _take(top_v.reshape(B, W * K), sel_idx)
                new_hyps = gather_beams(cur.hyps, parent)
                new_lens = _take(cur.lens, parent) + 1
                pos = (new_lens - 1).clamp(max=Lmax - 1)
                kept = new_hyps[b_idx, w_idx, pos]
                new_hyps[b_idx, w_idx, pos] = torch.where(sel_sc > DEAD / 2, tok, kept)
                nh1, nh2 = hash_extend((_take(cur.h1, parent), _take(cur.h2, parent)), tok)
                cur = _Beams(hyps=new_hyps, lens=new_lens, scores=sel_sc,
                             dstates=gather_beams(new_dstates, parent), h1=nh1, h2=nh2,
                             lm_states=cur.lm_states if lm_new_states is None else
                             tree_map(lambda x: gather_beams(x, parent), lm_new_states))

        # merge the pool (first occurrence canonical) and prune
        valid = a_scores > DEAD / 2
        eq = ((a_h1[:, :, None] == a_h1[:, None, :]) & (a_h2[:, :, None] == a_h2[:, None, :])
              & (a_lens[:, :, None] == a_lens[:, None, :]) & valid[:, :, None] & valid[:, None, :])
        first_eq = torch.argmax(eq.to(torch.int32), dim=2)  # the first equal entry
        is_canon = first_eq == torch.arange(A, device=dev)[None, :]
        merged = torch.logsumexp(torch.where(eq, a_scores[:, None, :], torch.full_like(eq, DEAD, dtype=torch.float32)),
                                 dim=2)
        merged = torch.where(valid & is_canon, merged, torch.full_like(merged, DEAD))
        top_sc, top_idx = topk_lastdim(merged, W)
        new = _Beams(hyps=gather_beams(a_hyps, top_idx), lens=_take(a_lens, top_idx), scores=top_sc,
                     dstates=gather_beams(a_dstates, top_idx), h1=_take(a_h1, top_idx), h2=_take(a_h2, top_idx),
                     lm_states=tree_map(lambda x: gather_beams(x, top_idx), a_lm_states))
        beams = _Beams(*[tree_map(
            lambda n, o: torch.where(active_b.reshape((B,) + (1,) * (n.dim() - 1)), n, o), nf, of)
            for nf, of in zip(new, beams)])

    order = torch.argsort(-beams.scores, dim=1, stable=True)
    return (gather_beams(beams.hyps, order), _take(beams.lens, order).to(torch.int32),
            _take(beams.scores, order))
