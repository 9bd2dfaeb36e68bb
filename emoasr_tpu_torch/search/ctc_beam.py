"""Batched CTC prefix beam search (PyTorch port of
`emoasr_tpu/search/ctc_beam.py`).

Parity target: `CTCDecoder._beam_search`
(emoASR `asr/modeling/decoders/ctc.py:203-344`): p_b/p_nb prefix
bookkeeping, per-step top-k token expansion, path merging with logaddexp,
length reward `len_weight * |hyp|`, optional LM shallow fusion through the
standard (cached) fields of an `LMFusion`.  The whole batch advances one
encoder frame per loop step with (B, W) beam tensors.

As in the JAX package, each candidate adds exactly its own token's LM
log-prob (emoASR accumulates across a parent's top-k candidates in place,
ctc.py:309-310, an evident bug), and a candidate that extends its beam takes
the LM state advanced by this frame's prediction while a kept one takes its
parent's state from before it (ctc.py:286).

Path merging: candidates are identical only when a non-extended beam j
equals an extended beam i+[v]; identity is tested via double 32-bit rolling
hashes (see search/common.py).  The first candidate in enumeration order is
the canonical one; p_b/p_nb/score_asr merge with logaddexp.

Order semantics that PyTorch does not promise by default are pinned:
`jax.lax.top_k`'s ties-to-lowest-index becomes a stable descending sort,
`jnp.argsort` a stable argsort, and `torch.argmax` returns the first
maximum as `jnp.argmax` does.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from emoasr_tpu_torch.ops.common import LOG_0
from emoasr_tpu_torch.search.common import (
    DEAD,
    LMFusion,
    gather_beams,
    hash_extend,
    hash_init,
    topk_lastdim,
    tree_map,
)


def _take(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    return torch.gather(x, 1, idx)


def ctc_beam_search(
    log_probs: torch.Tensor,
    elens: torch.Tensor,
    beam_width: int,
    blank_id: int = 0,
    eos_id: int = 2,
    len_weight: float = 0.0,
    lm: Optional[LMFusion] = None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Run prefix beam search over a batch.

    log_probs: (B, T, V) log-softmax CTC outputs (float32).
    Returns (hyps (B, W, Lmax) int32 incl. leading eos, hyp_lens (B, W)
    int32, scores (B, W) float32), beams sorted best-first.
    """
    B, T, V = log_probs.shape
    W = beam_width
    K = min(beam_width, V)
    Lmax = min(T + 1, 257)
    dev = log_probs.device
    f32, i32, i64 = torch.float32, torch.int32, torch.int64
    lw = float(len_weight)
    lm_weight = float(lm.weight) if lm is not None else 0.0

    first = torch.arange(W, device=dev)[None, :] == 0  # (1, W)
    hyps = torch.full((B, W, Lmax), blank_id, dtype=i64, device=dev)
    hyps[:, :, 0] = eos_id
    h1, h2 = hash_extend(hash_init((B, W), dev), torch.full((B, W), eos_id, device=dev))
    lens = torch.ones((B, W), dtype=i64, device=dev)
    p_b = torch.where(first, 0.0, LOG_0).to(f32).expand(B, W).contiguous()
    p_nb = torch.full((B, W), LOG_0, dtype=f32, device=dev)
    score_asr = torch.where(first, 0.0, DEAD).to(f32).expand(B, W).contiguous()
    score_lm = torch.zeros((B, W), dtype=f32, device=dev)
    score_len = torch.zeros((B, W), dtype=f32, device=dev)
    lm_states = lm.init_states(B, W) if lm is not None else None
    n_noneos = torch.zeros((B, W), dtype=i64, device=dev)

    C = W * (K + 1)  # candidates per batch row, reference enumeration order
    cand_parent = (torch.arange(C, device=dev) // (K + 1))[None, :].expand(B, C)
    ar_C = torch.arange(C, device=dev)[None, :]
    ar_W = torch.arange(W, device=dev)[None, :]
    b_idx = torch.arange(B, device=dev)[:, None]
    elens = elens.to(dev)

    def interleave(x1, x2):
        # x1 (B, W), x2 (B, W, K) -> (B, C): parent i -> [case1(i), case2(i, k)]
        return torch.cat([x1[:, :, None], x2], dim=2).reshape(B, C)

    for t in range(T):
        lp_t = log_probs[:, t].contiguous()  # (B, V)
        active_b = (t < elens)[:, None]  # (B, 1)
        alive = score_asr > DEAD / 2  # (B, W)

        # per-step top-k candidate tokens (ctc.py:240-247)
        _, v_topk = topk_lastdim(lp_t, K)
        v_topk = v_topk.to(i64)  # (B, K)
        if lm is not None:
            lm_logp, new_lm_states = lm.predict_beams(hyps, lens, lm_states)  # (B, W, V)

        lp_blank = lp_t[:, blank_id][:, None]  # (B, 1)
        last_tok = torch.gather(hyps, 2, (lens - 1).clamp(min=0)[:, :, None])[:, :, 0]
        has_last = lens > 1

        # ---- case 1: not extended ----
        p_tot = torch.logaddexp(p_b, p_nb)
        c1_p_b = p_tot + lp_blank
        lp_last = _take(lp_t, last_tok)
        c1_p_nb = torch.where(has_last, p_nb + lp_last, torch.full_like(p_nb, LOG_0))
        c1_asr = torch.logaddexp(c1_p_b, c1_p_nb)

        # ---- case 2: extended with v_topk ----
        v = v_topk[:, None, :]  # (B, 1, K)
        lp_v = _take(lp_t, v_topk)[:, None, :]  # (B, 1, K)
        same = (v == last_tok[:, :, None]) & has_last[:, :, None]
        c2_p_nb = torch.where(same, p_b[:, :, None] + lp_v, p_tot[:, :, None] + lp_v)
        c2_p_b = torch.full_like(c2_p_nb, LOG_0)
        # score_len = len_weight * (|strip_eos(hyp)| + 1) (ctc.py:308)
        c2_len = (lw * (n_noneos + 1).to(f32))[:, :, None].expand(B, W, K)
        vb = v.expand(B, W, K)
        if lm is not None:
            c2_lm = score_lm[:, :, None] + lm_weight * torch.gather(lm_logp, 2, vb)
        else:
            c2_lm = score_lm[:, :, None].expand(B, W, K)
        c2_valid = (v != blank_id) & alive[:, :, None] & (lens[:, :, None] < Lmax - 1)

        cand_p_b = interleave(c1_p_b, c2_p_b)
        cand_p_nb = interleave(c1_p_nb, c2_p_nb)
        cand_asr = interleave(c1_asr, c2_p_nb)
        cand_lm = interleave(score_lm, c2_lm)
        cand_len = interleave(score_len, c2_len)
        cand_ext_tok = interleave(torch.full((B, W), -1, dtype=i64, device=dev), vb)
        is_ext = cand_ext_tok >= 0
        cand_lens = interleave(lens, (lens + 1)[:, :, None].expand(B, W, K))
        cand_noneos = interleave(n_noneos, n_noneos[:, :, None] + (vb != eos_id).to(i64))
        cand_valid = interleave(alive, c2_valid)

        # hashes: case1 keeps parent hash; case2 extends with v
        e1, e2 = hash_extend((h1[:, :, None], h2[:, :, None]), vb)
        cand_h1 = interleave(h1, e1)
        cand_h2 = interleave(h2, e2)

        # ---- merge identical candidates (first occurrence canonical) ----
        eq = (
            (cand_h1[:, :, None] == cand_h1[:, None, :])
            & (cand_h2[:, :, None] == cand_h2[:, None, :])
            & (cand_lens[:, :, None] == cand_lens[:, None, :])
            & cand_valid[:, :, None]
            & cand_valid[:, None, :]
        )  # (B, C, C)
        first_eq = torch.argmax(eq.to(torch.uint8), dim=2)  # first equal (incl. self)
        is_canon = first_eq == ar_C

        def lse_merge(x):
            # logsumexp over the rows equal to each canonical candidate
            contrib = torch.where(eq, x[:, None, :], torch.full_like(x[:, None, :], LOG_0))
            return torch.logsumexp(contrib, dim=2)

        m_p_b = lse_merge(cand_p_b)
        m_p_nb = lse_merge(cand_p_nb)
        m_asr = lse_merge(cand_asr)

        score = m_asr + cand_lm + cand_len
        score = torch.where(cand_valid & is_canon, score, torch.full_like(score, DEAD))

        # ---- prune to W: lax.top_k order (ties to the lowest index) ----
        top_scores, top_idx = torch.sort(score, dim=1, descending=True, stable=True)
        top_scores, top_idx = top_scores[:, :W], top_idx[:, :W]

        parent = _take(cand_parent, top_idx)
        new_hyps = gather_beams(hyps, parent)
        ext_tok = _take(cand_ext_tok, top_idx)
        new_lens = _take(cand_lens, top_idx)
        ext = _take(is_ext, top_idx)
        # write the extension token at position len-1 (only for extended)
        pos = (new_lens - 1).clamp(max=Lmax - 1)
        cur = new_hyps[b_idx, ar_W, pos]
        new_hyps[b_idx, ar_W, pos] = torch.where(ext, ext_tok, cur)

        new_asr = _take(m_asr, top_idx)
        new_asr = torch.where(top_scores <= DEAD / 2, torch.full_like(new_asr, DEAD), new_asr)

        # freeze batch rows past their length
        def freeze(new, old):
            a = active_b.reshape((B,) + (1,) * (new.dim() - 1))
            return torch.where(a, new, old)

        hyps = freeze(new_hyps, hyps)
        lens = freeze(new_lens, lens)
        p_b = freeze(_take(m_p_b, top_idx), p_b)
        p_nb = freeze(_take(m_p_nb, top_idx), p_nb)
        score_asr = freeze(new_asr, score_asr)
        score_lm = freeze(_take(cand_lm, top_idx), score_lm)
        score_len = freeze(_take(cand_len, top_idx), score_len)
        n_noneos = freeze(_take(cand_noneos, top_idx), n_noneos)
        h1 = freeze(_take(cand_h1, top_idx), h1)
        h2 = freeze(_take(cand_h2, top_idx), h2)
        if lm is not None:
            # an extended candidate takes the advanced state, a kept one its
            # parent's state from before this frame
            def keep_parent(new, old):
                e = ext.reshape(ext.shape + (1,) * (new.dim() - 2))
                return freeze(torch.where(e, gather_beams(new, parent), gather_beams(old, parent)), old)

            lm_states = tree_map(keep_parent, new_lm_states, lm_states)

    total = score_asr + score_lm + score_len
    order = torch.argsort(-total, dim=1, stable=True)
    return (
        gather_beams(hyps, order).to(i32),
        _take(lens, order).to(i32),
        _take(total, order),
    )
