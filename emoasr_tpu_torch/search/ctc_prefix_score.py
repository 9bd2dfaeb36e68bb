"""Batched incremental CTC prefix scorer for joint CTC+attention decoding
(PyTorch port of `emoasr_tpu/search/ctc_prefix_score.py`).

Parity target: emoASR `CTCPrefixScorer`
(`asr/modeling/decoders/ctc_score.py:13-85`, espnet-style): state
r_t^{n,b}(g) per prefix, per-step scores log psi for K candidate extensions,
for all (B, W, K) candidates at once.

The API is split for the beam loop's benefit:

- `ctc_prefix_score_psi` returns the selection scores log psi for all K
  candidates.  psi needs no lattice recursion: it is a logsumexp of
  phi[t-1] + xs[t] over the active window.
- `ctc_prefix_state_update` advances the r lattice for the one token per
  beam that selection actually kept, so the scans run over (B, W, T)
  instead of (B, W, K, T): candidates are scored eagerly, states
  materialise lazily.
- `ctc_prefix_score_step` is the fused form (psi + states for all K), kept
  for oracle tests and non-beam callers.

The two first-order recurrences of the lattice, x_t = LSE(b_t, a_t +
x_{t-1}), are solved in closed form, x_t = A_t + logcumsumexp_s(b_s - A_s)
with A = cumsum(a), in float64 (`log_linear_scan`): four calls where the JAX
package's doubling scan takes log2(T) sweeps of several calls each, which in
eager PyTorch are all launch overhead.  In float64 the differences of the
cumulated log-probabilities (magnitudes in the thousands) round below
float32's own resolution, so the result is the recurrence's value rounded to
float32, as the doubling scan's is up to its own float32 rounding.

Padded-batch handling: rows t >= elen carry the previous row forward so the
end-of-sequence probability (used for the eos candidate) reads r_sum at
elen-1, matching the reference's exact-length inputs.
"""

from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F

from emoasr_tpu_torch.ops.common import LOG_0


def log_linear_scan(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Solve x_t = b_t LSE (a_t + x_{t-1}) along the last axis (x_{-1} =
    log 0): x_t = A_t + logcumsumexp_{s <= t}(b_s - A_s), A = cumsum(a),
    computed in float64 and returned in a's dtype."""
    A = torch.cumsum(a.double(), dim=-1)
    return (A + torch.logcumsumexp(b.double() - A, dim=-1)).to(a.dtype)


def ctc_prefix_initial_state(
    log_probs: torch.Tensor, elens: torch.Tensor, blank_id: int, num_beams: int
) -> torch.Tensor:
    """(B, T, V) -> (B, W, T, 2) initial r: blank-run cumsum in channel 1
    (ctc_score.py:20-33), frozen past elens."""
    B, T, V = log_probs.shape
    blanks = log_probs[:, :, blank_id]  # (B, T)
    valid = torch.arange(T, device=log_probs.device)[None, :] < elens[:, None]
    r_b = torch.cumsum(torch.where(valid, blanks, 0.0), dim=1)
    r = torch.stack([torch.full_like(r_b, LOG_0), r_b], dim=-1)  # (B, T, 2)
    return r[:, None].expand(B, num_beams, T, 2)


def _candidate_inputs(log_probs_T, elens, hyps, hyp_lens, cs, r_prev, blank_id):
    """Shared per-candidate tensors for psi scoring and lattice updates.

    cs: (B, W, K) candidate tokens.  Returns (xs, phi_prev, run, init_r0,
    start) with xs/phi_prev/run shaped (B, W, K, T) (run broadcasts on K)."""
    B, V, T = log_probs_T.shape
    W, K = cs.shape[1], cs.shape[2]
    dev = log_probs_T.device
    olen = hyp_lens - 1  # output length excluding the leading eos (B, W)

    last = torch.gather(hyps, 2, (hyp_lens - 1).clamp(min=0)[:, :, None].long())[:, :, 0]  # (B, W)

    # xs: per-candidate emissions (B, W, K, T).  With the (B, V, T) layout
    # each candidate is one contiguous T-row: an embedding-style row gather
    xs = torch.gather(
        log_probs_T, 1, cs.reshape(B, W * K)[:, :, None].long().expand(B, W * K, T)
    ).reshape(B, W, K, T)

    r_sum = torch.logaddexp(r_prev[..., 0], r_prev[..., 1])  # (B, W, T)
    is_last = (cs == last[:, :, None]) & (olen > 0)[:, :, None]  # (B, W, K)
    log_phi = torch.where(
        is_last[..., None], r_prev[:, :, None, :, 1], r_sum[:, :, None, :]
    )  # (B, W, K, T)
    phi_prev = F.pad(log_phi, (1, 0), value=LOG_0)[..., :-1]  # phi[t-1] at position t

    t_idx = torch.arange(T, device=dev)
    start = olen.clamp(min=1)  # (B, W)
    run = (
        (t_idx[None, None, None, :] >= start[:, :, None, None])
        & (t_idx[None, None, None, :] < elens[:, None, None, None])
    )  # (B, W, 1, T)

    # initialise: rows < start-1 dead; row start-1 per reference:
    #   olen == 0 -> r[0] = (xs[0], LOG_0); olen > 0 -> r[olen-1] = LOG_0
    init_r0 = torch.where((olen == 0)[:, :, None], xs[:, :, :, 0], LOG_0)  # (B, W, K)
    return xs, phi_prev, run, init_r0, start


def ctc_prefix_score_psi(
    log_probs_T: torch.Tensor,
    elens: torch.Tensor,
    hyps: torch.Tensor,
    hyp_lens: torch.Tensor,
    cs: torch.Tensor,
    r_prev: torch.Tensor,
    blank_id: int,
    eos_id: int,
) -> torch.Tensor:
    """Selection scores log psi (B, W, K) for K candidate extensions.

    log_probs_T: (B, V, T), the frame log-probs time-major-last (callers
    transpose once per utterance batch); hyps: (B, W, L) with leading eos;
    hyp_lens (B, W); cs: (B, W, K) candidate tokens; r_prev: (B, W, T, 2).

    psi = LSE(r[start-1, 0], LSE_{t in [start, elen)} phi[t-1] + xs[t])."""
    xs, phi_prev, run, init_r0, _ = _candidate_inputs(
        log_probs_T, elens, hyps, hyp_lens, cs, r_prev, blank_id
    )
    contrib = torch.where(run, phi_prev + xs, LOG_0)
    log_psi = torch.logaddexp(init_r0, torch.logsumexp(contrib, dim=-1))

    # eos candidate: log(r_T^n(g) + r_T^b(g)) at the last valid frame
    r_sum = torch.logaddexp(r_prev[..., 0], r_prev[..., 1])  # (B, W, T)
    W = r_sum.shape[1]
    last_t = (elens - 1).clamp(min=0)[:, None, None].long().expand(-1, W, 1)
    r_sum_last = torch.gather(r_sum, 2, last_t)[:, :, 0]  # (B, W)
    log_psi = torch.where(cs == eos_id, r_sum_last[:, :, None], log_psi)
    return torch.where(cs == blank_id, LOG_0, log_psi)


def _lattice(log_probs_T, elens, hyps, hyp_lens, cs, r_prev, blank_id) -> torch.Tensor:
    """Advance the r lattice for cs (B, W, K): returns (B, W, K, T, 2).

    The recurrences
      r0[t] = LSE(r0[t-1], phi[t-1]) + xs[t]
      r1[t] = LSE(r0[t-1], r1[t-1]) + blank[t]
    are first-order linear in the (LSE, +) semiring: two `log_linear_scan`s.
    Per-beam [start, elen) masking is encoded in the coefficients:
    outside the window a = 0 (the identity), b = LOG_0 carries the row
    forward."""
    T = log_probs_T.shape[-1]
    xs, phi_prev, run, init_r0, start = _candidate_inputs(
        log_probs_T, elens, hyps, hyp_lens, cs, r_prev, blank_id
    )
    blanks = log_probs_T[:, blank_id][:, None, None, :]  # (B, 1, 1, T)
    t_idx = torch.arange(T, device=xs.device)

    a0 = torch.where(run, xs, 0.0)
    b0 = torch.where(run, phi_prev + xs, LOG_0)
    # row start-1 carries the init value
    at_init = t_idx[None, None, None, :] == (start - 1)[:, :, None, None]
    b0 = torch.where(at_init, init_r0[..., None], b0)
    r0_full = log_linear_scan(a0, b0)  # (B, W, K, T)

    r0_prev = F.pad(r0_full, (1, 0), value=LOG_0)[..., :-1]
    a1 = torch.where(run, blanks, 0.0)
    b1 = torch.where(run, r0_prev + blanks, LOG_0)
    r1_full = log_linear_scan(a1, b1)  # (B, W, K, T)
    return torch.stack([r0_full, r1_full], dim=-1)  # (B, W, K, T, 2)


def ctc_prefix_state_update(
    log_probs_T: torch.Tensor,
    elens: torch.Tensor,
    hyps: torch.Tensor,
    hyp_lens: torch.Tensor,
    tok: torch.Tensor,
    r_prev: torch.Tensor,
    blank_id: int,
) -> torch.Tensor:
    """Lazy state update: advance r only for the selected token per beam.

    hyps/hyp_lens/r_prev are the parent beams (post-selection gather,
    pre-extension); tok: (B, W) the token each beam was extended with.
    Returns the new r lattice (B, W, T, 2), elementwise the fused
    `ctc_prefix_score_step` state at the selected candidate."""
    r_new = _lattice(log_probs_T, elens, hyps, hyp_lens, tok[:, :, None], r_prev, blank_id)
    return r_new[:, :, 0]


def ctc_prefix_score_step(
    log_probs_T: torch.Tensor,
    elens: torch.Tensor,
    hyps: torch.Tensor,
    hyp_lens: torch.Tensor,
    cs: torch.Tensor,
    r_prev: torch.Tensor,
    blank_id: int,
    eos_id: int,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Fused form: psi (B, W, K) and advanced states (B, W, K, T, 2) for
    every candidate."""
    log_psi = ctc_prefix_score_psi(log_probs_T, elens, hyps, hyp_lens, cs, r_prev, blank_id, eos_id)
    r_new = _lattice(log_probs_T, elens, hyps, hyp_lens, cs, r_prev, blank_id)
    return log_psi, r_new
