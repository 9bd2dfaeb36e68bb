"""CTC loss and forced alignment (PyTorch port of `emoasr_tpu/ops/ctc.py`).

Replaces the reference's `torch.nn.CTCLoss` surface
(`asr/modeling/decoders/ctc.py:36-38,109-113`: blank=blank_id,
reduction="sum", zero_infinity=True, normalised by B) and its
`CTCForcedAligner` (`ctc_aligner.py:96-221`).

Everything works on the 2U+1 blank-interleaved path lattice, batched.  The
loss lattice is `ops/ctc_lattice.py::ctc_ll_from_path` (a CUDA kernel on the
card); the default training loss `ctc_loss_fused_head` takes the encoder
output and the raw head weights and goes through
`ops/ctc_head.py::fused_ctc_head`, so the (B, T, V) logits are never
written.  The forced aligner is a pair of Python loops over T plus a greedy
walk (decode-side tooling, not on the training path).
"""

from __future__ import annotations

from typing import Tuple

import torch

from emoasr_tpu_torch.ops.common import LOG_0, flip_by_length, logaddexp3
from emoasr_tpu_torch.ops.ctc_head import fused_ctc_head, fused_ctc_head_shard
from emoasr_tpu_torch.ops.ctc_lattice import ctc_ll_from_path
from emoasr_tpu_torch.parallel import vocab
from emoasr_tpu_torch.parallel.mesh import global_rows


def _extend_with_blanks(labels: torch.Tensor, blank_id: int) -> torch.Tensor:
    """(B, U) labels -> (B, 2U+1) blank-interleaved path ^a^b^ ... ^."""
    B, U = labels.shape
    z = torch.full((B, 2 * U + 1), blank_id, dtype=labels.dtype, device=labels.device)
    z[:, 1::2] = labels
    return z


def _skip_allowed(z: torch.Tensor, blank_id: int) -> torch.Tensor:
    """(B, S) bool: the skip transition into s is allowed when z[s] is not
    blank and differs from z[s-2]."""
    z2 = torch.cat([z.new_full((z.shape[0], 2), -1), z[:, :-2]], dim=1)
    return (z != blank_id) & (z != z2)


def _path_masks(labels, ylens, blank_id) -> Tuple[torch.Tensor, ...]:
    """(z, allow2f, initf, finalf) for the blank-interleaved path lattice."""
    z = _extend_with_blanks(labels, blank_id)
    allow2f = _skip_allowed(z, blank_id).float()
    s_iota = torch.arange(z.shape[1], device=z.device)[None, :]
    has = (ylens > 0)[:, None]
    initf = ((s_iota == 0) | ((s_iota == 1) & has)).float()
    last = (2 * ylens)[:, None]
    finalf = ((s_iota == last) | ((s_iota == last - 1) & has)).float()
    return z, allow2f, initf, finalf


def _nll_from_path(lp_path, allow2f, initf, finalf, xlens, zero_infinity=True) -> torch.Tensor:
    ll = ctc_ll_from_path(lp_path, allow2f, initf, finalf, xlens)
    nll = -ll
    if zero_infinity:
        nll = torch.where(ll < LOG_0 / 2, torch.zeros_like(nll), nll)
    return nll


def ctc_loss(log_probs, labels, xlens, ylens, blank_id: int = 0,
             zero_infinity: bool = True) -> torch.Tensor:
    """Per-utterance CTC negative log-likelihood, (B,) float32.

    log_probs: (B, T, V) log-softmax outputs; labels: (B, U) int targets
    (padding beyond ylens is ignored).  Infeasible alignments (T too short)
    give 0 when `zero_infinity`, as `torch.nn.CTCLoss(zero_infinity=True)`."""
    log_probs = log_probs.float()
    z, allow2f, initf, finalf = _path_masks(labels, ylens, blank_id)
    idx = z.long()[:, None, :].expand(-1, log_probs.shape[1], -1)
    lp_path = torch.gather(log_probs, 2, idx).transpose(0, 1)  # (T, B, S)
    return _nll_from_path(lp_path, allow2f, initf, finalf, xlens, zero_infinity)


def ctc_loss_fn(logits, labels, xlens, ylens, blank_id: int = 0, shard=None) -> torch.Tensor:
    """Reference-reduction CTC loss from raw logits: sum over the batch / B
    (`asr/modeling/decoders/ctc.py:109-114`).  The dense route: the (B, T, V)
    logits exist (a rank's (B, T, V / m) under a vocabulary `shard`), the
    lattice is the same kernel."""
    logits = logits.float()
    z, allow2f, initf, finalf = _path_masks(labels, ylens, blank_id)
    idx = z.long()[:, None, :].expand(-1, logits.shape[1], -1)
    if shard is None:
        lse = torch.logsumexp(logits, dim=-1)  # (B, T)
        xs = torch.gather(logits, 2, idx)
    else:
        lse, xs = vocab.log_normaliser(logits, shard), vocab.logit_at(logits, idx, shard)
    lp_path = (xs - lse[:, :, None]).transpose(0, 1)
    return _nll_from_path(lp_path, allow2f, initf, finalf, xlens).sum() / global_rows(logits.shape[0])


def ctc_loss_fused_head(eouts, w, b, labels, xlens, ylens, blank_id: int = 0, shard=None) -> torch.Tensor:
    """`ctc_loss_fn` without ever materialising the (B, T, V) logits.

    eouts: (B, T, H) encoder output; w: (H, V) and b: (V,) the raw head
    weights (a rank's (H, V / m) and (V / m,) under a vocabulary `shard`).
    Only (B, T) and (B, T, S) tensors are written.  Equal to
    `ctc_loss_fn(eouts @ w + b, ...)` up to the products' sum order."""
    z, allow2f, initf, finalf = _path_masks(labels, ylens, blank_id)
    lse, xs = fused_ctc_head(eouts, w, b, z) if shard is None else fused_ctc_head_shard(eouts, w, b, z, shard)
    lp_path = (xs - lse[:, :, None]).transpose(0, 1)  # (T, B, S) view, read in place
    return _nll_from_path(lp_path, allow2f, initf, finalf, xlens).sum() / global_rows(eouts.shape[0])


# ---------------------------------------------------------------------------
# Forced alignment (forward-backward + constrained greedy walk)
# ---------------------------------------------------------------------------


def _path_transition(alpha, allow2):
    """alpha'[s] = LSE(alpha[s], alpha[s-1], alpha[s-2] if allowed); (B, S)."""
    B = alpha.shape[0]
    a1 = torch.cat([alpha.new_full((B, 1), LOG_0), alpha[:, :-1]], dim=1)
    a2 = torch.cat([alpha.new_full((B, 2), LOG_0), alpha[:, :-2]], dim=1)[:, : alpha.shape[1]]
    a2 = torch.where(allow2, a2, torch.full_like(a2, LOG_0))
    return logaddexp3(alpha, a1, a2)


def _pre_emission_scan(lp_path, allow2, path_lens):
    """Forward recursion emitting the pre-emission transition value at every
    step (what the reference accumulates into `log_probs_fwd_bwd`,
    `ctc_aligner.py:121-148`).  lp_path (T, B, S) -> (T, B, S)."""
    T, B, S = lp_path.shape
    inside = torch.arange(S, device=lp_path.device)[None, :] < path_lens[:, None]
    alpha = lp_path.new_full((B, S), LOG_0)
    alpha[:, 0] = 0.0
    pres = []
    for t in range(T):
        pre = _path_transition(alpha, allow2)
        pre = torch.where(inside, pre, torch.full_like(pre, LOG_0))
        pres.append(pre)
        alpha = pre + lp_path[t]
    return torch.stack(pres)


@torch.no_grad()
def ctc_forced_align(log_probs, xlens, labels, ylens, blank_id: int = 0, shard=None) -> torch.Tensor:
    """Best CTC path via forward-backward posteriors + greedy constrained
    walk (`CTCForcedAligner.__call__`, `ctc_aligner.py:150-221`).  Under a
    vocabulary `shard`, `log_probs` holds the rank's columns of the
    log-probabilities, and each path column comes from its owner.

    Returns (B, T) int32 frame-level alignment (blank or token id); frames
    beyond xlens are 0-filled like the reference's zeros init."""
    log_probs = log_probs.float()
    B, T = log_probs.shape[:2]
    dev = log_probs.device
    S = 2 * labels.shape[1] + 1
    xlens, ylens = xlens.long(), ylens.long()

    # zero out padded frames (the reference masks log_probs to 0 outside xlens)
    tmask = torch.arange(T, device=dev)[None, :] < xlens[:, None]
    log_probs = torch.where(tmask[:, :, None], log_probs, torch.zeros_like(log_probs))

    z = _extend_with_blanks(labels.long(), blank_id)
    allow2 = _skip_allowed(z, blank_id)
    path_lens = 2 * ylens + 1

    def gather_path(lp, zz):
        idx = zz[:, None, :].expand(-1, T, -1)
        got = torch.gather(lp, 2, idx) if shard is None else vocab.logit_at(lp, idx, shard)
        return got.transpose(0, 1)

    lp_path = gather_path(log_probs, z)  # (T, B, S)
    pre_alpha = _pre_emission_scan(lp_path, allow2, path_lens)

    # backward: the same scan on time-flipped emissions and a state-flipped path
    s_idx = (path_lens[:, None] - 1 - torch.arange(S, device=dev)[None, :]) % S  # (B, S)
    z_r = torch.gather(z, 1, s_idx)
    lp_path_r = gather_path(flip_by_length(log_probs, xlens), z_r)
    pre_beta_r = _pre_emission_scan(lp_path_r, _skip_allowed(z_r, blank_id), path_lens)

    # flip beta back to the original (time, state) coordinates
    pre_beta = flip_by_length(pre_beta_r.transpose(0, 1), xlens)  # (B, T, S)
    pre_beta = torch.gather(pre_beta, 2, s_idx[:, None, :].expand(-1, T, -1))
    # posterior = emission + pre-alpha + pre-beta (the emission appears once)
    fwd_bwd = lp_path.transpose(0, 1) + pre_alpha.transpose(0, 1) + pre_beta  # (B, T, S)

    # greedy constrained walk: from state s the reachable states are
    # {s, s+1, s+2 if allow2}; pick the argmax posterior (first on ties)
    inside = torch.arange(S, device=dev)[None, :] < path_lens[:, None]
    s_range = torch.arange(S, device=dev)[None, :]
    prev = torch.zeros((B,), dtype=torch.long, device=dev)
    toks = []
    for t in range(T):
        p = prev[:, None]
        reach = ((s_range == p) | (s_range == p + 1) | ((s_range == p + 2) & allow2)) & inside
        masked = torch.where(reach, fwd_bwd[:, t], torch.full_like(fwd_bwd[:, t], LOG_0))
        prev = torch.argmax(masked, dim=1)
        toks.append(torch.gather(z, 1, prev[:, None])[:, 0])
    aligns = torch.stack(toks, dim=1)
    return torch.where(tmask, aligns, torch.zeros_like(aligns)).to(torch.int32)
