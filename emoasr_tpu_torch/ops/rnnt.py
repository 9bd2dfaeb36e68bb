"""RNN-Transducer loss (PyTorch port of `emoasr_tpu/ops/rnnt.py`).

Replaces `warp_rnnt.rnnt_loss` (blank=blank_id, reduction="mean",
average_frames=False) of emoASR's `asr/modeling/decoders/rnn_transducer.py:
106-115`.  The (T, U+1) lattice recurrence

    alpha[t, u] = LSE(alpha[t-1, u] + blank[t-1, u],
                      alpha[t, u-1] + label[t, u-1])

is solved one time row at a time (`rnnt_alpha_rowscan`).  The cross-row
term is elementwise; the within-row term is a first-order log-linear
recurrence x_u = LSE(b_u, a_u + x_{u-1}) with the closed form
x_u = A_u + logcumsumexp_{s <= u}(b_s - A_s), A = cumsum(a), computed in
float64 (`search/ctc_prefix_score.py::log_linear_scan`), where the JAX
package runs a doubling scan: a few launches a row instead of log2(U)
sweeps of several each.
The label emission into column 0 is no term of any path; it is set to 0,
not `LOG_0`, before the cumsum, so that the -1e10 takes no precision from
the sums.  Rows at t >= xlen keep the row xlen - 1, so the last row holds
every utterance's final cell.  Autograd through the rows gives the exact
gradient.

Only the blank column and one label column per cell are taken from the
joint output (`gather=True` of warp_rnnt).  `rnnt_gathered_from_joint` (the
`chunked` mode) computes them from the joint activations in time chunks of
32 frames and never holds the (B, T, U+1, V) tensor; its backward
recomputes each chunk and applies the analytic gradient of log-softmax and
gather, so no V-wide residual is kept.  The fused kernel (`pallas` mode,
ops/rnnt_joint.py) uses the same backward.

In bfloat16 the chunked route computes in the activations' dtype, as the
JAX package's does: z, the logits (each product summed in float32, then
rounded, then the bias added) and the blank and label logits are bf16, the
logsumexp float32.  Its analytic backward rounds where the VJP of that JAX
function rounds: the float32 cotangents of the blank and label logits and
of the logits (g_lse p) are rounded to bf16; d z is the bf16 sum of three
bf16 products (the logits' w^T, the blank column's, the label rows');
tanh's VJP is (d z + d z z)(1 - z) in bf16; every sum over cells
accumulates in float32 and is rounded once; the gradients of h_dec, w and
b add up over the time chunks in bf16.

`rnnt_forced_align` (emoASR `rnnt_aligner.py:159-198`) builds the whole
alpha lattice from the same closed-form rows, and beta as an alpha of the
emissions flipped by each utterance's lengths (the JAX package's
construction), both in float64, then walks from (0, 0) towards the larger
of alpha + beta at (t + 1, u) and (t, u + 1): T + U steps on the device,
one read-back by the caller at the end.
"""

from __future__ import annotations

from typing import Tuple

import torch

from emoasr_tpu_torch.ops.common import LOG_0, flip_by_length
from emoasr_tpu_torch.parallel import vocab
from emoasr_tpu_torch.parallel.mesh import batch_mean
from emoasr_tpu_torch.search.ctc_prefix_score import log_linear_scan

TIME_CHUNK = 32  # frames of the joint output held at once (the JAX package's)


def _gather_blank_label(
    log_probs: torch.Tensor, labels: torch.Tensor, blank_id: int, shard=None
) -> Tuple[torch.Tensor, torch.Tensor]:
    """(B, T, U+1, V) -> blank (B, T, U+1) and label (B, T, U) emissions;
    under a vocabulary `shard`, from the rank's (B, T, U+1, V / m) columns,
    each taken from its owner."""
    B, T, U1 = log_probs.shape[:3]
    U = labels.shape[1]
    if shard is not None:
        blank = torch.full((B, T, U1), blank_id, dtype=torch.long, device=log_probs.device)
        idx = labels.long()[:, None, :].expand(B, T, U)
        return vocab.logit_at(log_probs, blank, shard), vocab.logit_at(log_probs[:, :, :U], idx, shard)
    lp_blank = log_probs[..., blank_id]
    idx = labels.long()[:, None, :, None].expand(B, T, U, 1)
    lp_label = torch.gather(log_probs[:, :, :U, :], 3, idx)[..., 0]
    return lp_blank, lp_label


def rnnt_alpha_rowscan(
    lp_blank: torch.Tensor, lp_label: torch.Tensor, xlens: torch.Tensor, ylens: torch.Tensor
) -> torch.Tensor:
    """Per-utterance log-likelihood (B,) of the lattice, a row at a time
    (see the module note)."""
    lp_blank = lp_blank.float()
    B, T, U1 = lp_blank.shape
    dev = lp_blank.device
    xlens = xlens.to(dev).long()
    ylens = ylens.to(dev).long()
    # a[:, t, u]: label emission into u (from u - 1); column 0 is no edge
    a = torch.cat([torch.zeros((B, T, 1), dtype=torch.float64, device=dev), lp_label.double()], dim=2)
    b = torch.full((B, U1), LOG_0, dtype=torch.float64, device=dev)
    b[:, 0] = 0.0
    alpha = log_linear_scan(a[:, 0], b)  # row 0: the label chain from alpha[0, 0] = 0
    blank64 = lp_blank.double()
    for t in range(1, T):
        new = log_linear_scan(a[:, t], alpha + blank64[:, t - 1])
        alpha = torch.where((t < xlens)[:, None], new, alpha)
    final = torch.gather(alpha, 1, ylens[:, None])[:, 0]
    last = torch.gather(lp_blank, 1, (xlens - 1)[:, None, None].expand(B, 1, U1))[:, 0]
    term = torch.gather(last, 1, ylens[:, None])[:, 0]
    return final.float() + term


def _reduce(nll: torch.Tensor, reduction: str) -> torch.Tensor:
    if reduction == "mean":
        return batch_mean(nll)
    if reduction == "sum":
        return nll.sum()
    return nll


def rnnt_loss_rowscan(
    log_probs: torch.Tensor, labels: torch.Tensor, xlens: torch.Tensor, ylens: torch.Tensor,
    blank_id: int = 0, reduction: str = "mean", shard=None,
) -> torch.Tensor:
    """RNN-T loss of log-softmaxed joint outputs (B, T, U+1, V) (a rank's
    columns under a vocabulary `shard`)."""
    lp_blank, lp_label = _gather_blank_label(log_probs.float(), labels, blank_id, shard)
    return _reduce(-rnnt_alpha_rowscan(lp_blank, lp_label, xlens, ylens), reduction)


def rnnt_loss(
    log_probs: torch.Tensor, labels: torch.Tensor, xlens: torch.Tensor, ylens: torch.Tensor,
    blank_id: int = 0, reduction: str = "mean", shard=None,
) -> torch.Tensor:
    """RNN-T loss matching `warp_rnnt.rnnt_loss(average_frames=False)` (the
    `full` mode).  The JAX package's `rnnt_loss` scans anti-diagonals; the
    lattice is the same, so this is the row scan."""
    return rnnt_loss_rowscan(log_probs, labels, xlens, ylens, blank_id, reduction, shard)


# ---------------------------------------------------------------- forced alignment


def _alpha_lattice(lp_blank: torch.Tensor, lp_label: torch.Tensor) -> torch.Tensor:
    """The whole (B, T, U+1) alpha lattice in float64, every row of every
    utterance (no length masking: the walk reads only cells inside each
    utterance's lengths, which depend only on cells inside them)."""
    B, T, U1 = lp_blank.shape
    dev = lp_blank.device
    a = torch.cat([torch.zeros((B, T, 1), dtype=torch.float64, device=dev), lp_label.double()], dim=2)
    b = torch.full((B, U1), LOG_0, dtype=torch.float64, device=dev)
    b[:, 0] = 0.0
    blank64 = lp_blank.double()
    rows = [log_linear_scan(a[:, 0], b)]
    for t in range(1, T):
        rows.append(log_linear_scan(a[:, t], rows[-1] + blank64[:, t - 1]))
    return torch.stack(rows, dim=1)


def _flip_axis2(x: torch.Tensor, lens: torch.Tensor) -> torch.Tensor:
    """Reverse the valid prefix of axis 2 per batch element (mod wrap)."""
    L = x.shape[2]
    idx = (lens[:, None] - 1 - torch.arange(L, device=x.device)[None, :]) % L
    return torch.gather(x, 2, idx[:, None, :].expand(x.shape).long())


@torch.no_grad()
def rnnt_fwd_bwd(log_probs: torch.Tensor, xlens: torch.Tensor, labels: torch.Tensor, ylens: torch.Tensor,
                 blank_id: int = 0, shard=None) -> torch.Tensor:
    """alpha + beta (B, T, U+1), float64, of log-softmaxed joint outputs
    (B, T, U+1, V): the log-probability of the paths through each cell
    (`rnnt_aligner.py:159-188`), exact inside each utterance's lengths."""
    B, T, U1, _ = log_probs.shape
    dev = log_probs.device
    xlens, ylens = xlens.to(dev).long(), ylens.to(dev).long()
    lp_blank, lp_label = _gather_blank_label(log_probs.float(), labels.to(dev), blank_id, shard)
    alpha = _alpha_lattice(lp_blank, lp_label)

    # beta[t, u] = LSE(beta[t+1, u] + blank[t, u], beta[t, u+1] + label[t, u]),
    # beta[X-1, Y] = blank[X-1, Y]: under the flip t' = X-1-t, u' = Y-u an
    # alpha recursion whose edge into (t', u') carries the emission of the
    # flipped cell itself, so the blank emissions go in one frame earlier
    Bf = _flip_axis2(flip_by_length(lp_blank, xlens), ylens + 1)
    lb_gen = torch.cat([Bf[:, 1:], Bf.new_full((B, 1, U1), LOG_0)], dim=1)
    ll_gen = _flip_axis2(flip_by_length(lp_label, xlens), ylens)
    beta = _flip_axis2(flip_by_length(_alpha_lattice(lb_gen, ll_gen), xlens), ylens + 1)
    last = torch.gather(lp_blank, 1, (xlens - 1)[:, None, None].expand(B, 1, U1))[:, 0]
    term = torch.gather(last, 1, ylens[:, None]).double()  # (B, 1): blank[X-1, Y], beta's own init
    return alpha + beta + term[:, :, None]


@torch.no_grad()
def rnnt_align_walk(fwd_bwd: torch.Tensor, xlens: torch.Tensor, ylens: torch.Tensor):
    """The greedy walk over `rnnt_fwd_bwd`'s cells (rnnt_aligner.py:189-196):
    from (0, 0), advance t where fwd_bwd[t + 1, u] > fwd_bwd[t, u + 1],
    else emit label u at frame t; T + U steps on the device.  -> aligns
    (B, U) int32, 0 past ylens."""
    B, T, U1 = fwd_bwd.shape
    U = U1 - 1
    dev = fwd_bwd.device
    xlens, ylens = xlens.to(dev).long(), ylens.to(dev).long()
    rows = torch.arange(B, device=dev)
    t = torch.zeros(B, dtype=torch.long, device=dev)
    u = torch.zeros(B, dtype=torch.long, device=dev)
    aligns = torch.zeros((B, U + 1), dtype=torch.long, device=dev)  # column U takes the no-emit writes
    for _ in range(T + U):
        go = (t + 1 < xlens) & (u < ylens)
        fb_t1u = fwd_bwd[rows, (t + 1).clamp(max=T - 1), u]
        fb_tu1 = fwd_bwd[rows, t, (u + 1).clamp(max=U1 - 1)]
        advance_t = go & (fb_t1u > fb_tu1)
        emit = go & ~advance_t
        aligns[rows, torch.where(emit, u, torch.full_like(u, U))] = t
        t = torch.where(advance_t, t + 1, t)
        u = torch.where(emit, u + 1, u)
    return aligns[:, :U].to(torch.int32)


def rnnt_forced_align(log_probs: torch.Tensor, xlens: torch.Tensor, labels: torch.Tensor, ylens: torch.Tensor,
                      blank_id: int = 0, shard=None) -> torch.Tensor:
    """Emission frame of each reference label by forward-backward and a
    greedy walk (`RNNTForcedAligner.__call__`, rnnt_aligner.py:159-198).
    log_probs (B, T, U+1, V) log-softmaxed joint outputs (a rank's columns
    under a vocabulary `shard`) -> (B, U) int32 (0 past ylens)."""
    fwd_bwd = rnnt_fwd_bwd(log_probs, xlens, labels, ylens, blank_id, shard)
    return rnnt_align_walk(fwd_bwd, xlens, ylens)


# ---------------------------------------------------------------- the joint, chunked


def _label_rows(w_out: torch.Tensor, b_out: torch.Tensor, labels: torch.Tensor):
    """Per-label output rows (B, U, J), biases (B, U) and a validity mask: a
    label outside [0, V) selects nothing (its logit counts as 0), as in the
    fused kernel."""
    V = w_out.shape[1]
    lab = labels.long()
    ok = (lab >= 0) & (lab < V)
    lab = torch.where(ok, lab, torch.zeros_like(lab))
    return w_out.t()[lab], b_out[lab], ok


def joint_chunk(h_enc_c, h_dec, w_out, b_out, w_lab, b_lab, ok, blank_id: int):
    """One time chunk: (B, c, J) x (B, U+1, J) -> z (B, c, U+1, J), logits
    (B, c, U+1, V), lse, the blank logit (B, c, U+1) and the label logit
    (B, c, U).  z is in the activations' dtype, the logits in w_out's
    (float32 weights take z's values exactly: the fused kernel's
    arithmetic); lse and the two selected logits are float32, 0 for a blank
    or label outside [0, V)."""
    U = w_lab.shape[1]
    z = torch.tanh(h_enc_c[:, :, None, :] + h_dec[:, None, :, :])
    zw = z.to(w_out.dtype)
    logits = torch.matmul(zw, w_out) + b_out
    lse = torch.logsumexp(logits.float(), dim=-1)
    if 0 <= blank_id < logits.shape[-1]:
        blank = logits[..., blank_id].float()
    else:
        blank = torch.zeros_like(lse)
    lab_logit = (torch.einsum("bcuj,buj->bcu", zw[:, :, :U], w_lab) + b_lab[:, None, :]).float()
    return z, logits, lse, blank, torch.where(ok[:, None, :], lab_logit, torch.zeros_like(lab_logit))


def _chunks(T: int, time_chunk: int):
    return [(s, min(s + time_chunk, T)) for s in range(0, T, time_chunk)]


def joint_parts_plain(h_enc, h_dec, w_out, b_out, labels, blank_id: int = 0,
                      time_chunk: int = TIME_CHUNK) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(lse, blank logit (B, T, U+1), label logit (B, T, U)) of w_out's
    columns, float32, a time chunk at a time; a blank or label outside
    [0, V) selects nothing (0)."""
    w_lab, b_lab, ok = _label_rows(w_out, b_out, labels)
    parts = [[], [], []]
    for s, e in _chunks(h_enc.shape[1], time_chunk):
        _, _, *chunk = joint_chunk(h_enc[:, s:e], h_dec, w_out, b_out, w_lab, b_lab, ok, blank_id)
        for acc, x in zip(parts, chunk):
            acc.append(x)
    return tuple(torch.cat(p, dim=1) for p in parts)


def joint_gather_plain(h_enc, h_dec, w_out, b_out, labels, blank_id: int = 0,
                       time_chunk: int = TIME_CHUNK) -> Tuple[torch.Tensor, torch.Tensor]:
    """(lp_blank (B, T, U+1), lp_label (B, T, U)) from the joint
    activations, a time chunk at a time (no autograd graph is kept by the
    callers that need one: see `rnnt_gathered_from_joint`)."""
    lse, blank, label = joint_parts_plain(h_enc, h_dec, w_out, b_out, labels, blank_id, time_chunk)
    return blank - lse, label - lse[:, :, :label.shape[2]]


def joint_gather_backward(h_enc, h_dec, w_out, b_out, labels, g_blank, g_label, blank_id: int = 0,
                          time_chunk: int = TIME_CHUNK, lse=None):
    """Gradients of (lp_blank, lp_label) with cotangents (g_blank, g_label)
    to (h_enc, h_dec, w_out, b_out), a recomputed time chunk at a time, in
    the chunked route's dtype with its rounding (see the module note).

    `lse` (B, T, U+1): the whole vocabulary's normaliser when w_out and
    b_out are a model rank's block of columns (`ops/rnnt_joint.py::
    joint_gather_shard`; labels and blank then in the block's ids): p is
    taken against it, every label's cotangent reaches it, and only the
    blank and labels in the block add their columns' terms.

    With p = softmax(logits): the logits take -(g_blank + g_label) p, the
    blank logit g_blank and the label logit g_label; d z = their products
    with w^T, the blank column and the label rows; d pre = d z (1 - z^2),
    summed over u for h_enc and over t for h_dec.  The label rows' gradient
    goes back to its vocabulary columns by a one-hot product (a fixed sum
    order)."""
    B, T, J = h_enc.shape
    U1, V = h_dec.shape[1], w_out.shape[1]
    U = U1 - 1
    w_lab, b_lab, ok = _label_rows(w_out, b_out, labels)
    g_blank = g_blank.float()
    g_norm = g_label.float()
    g_label = torch.where(ok[:, None, :], g_norm, torch.zeros_like(g_label, dtype=torch.float32))
    if lse is None:  # the whole vocabulary: a label outside it takes no cotangent at all
        g_norm = g_label
    dt = w_out.dtype
    gpb, gpl = g_blank.to(dt), g_label.to(dt)  # cotangents of the rounded blank and label logits
    has_blank = 0 <= blank_id < V
    w_blank = w_out[:, blank_id if has_blank else 0]
    d_enc = torch.empty_like(h_enc)
    d_dec = torch.zeros_like(h_dec)
    d_w = torch.zeros_like(w_out)
    d_b = torch.zeros_like(b_out)
    d_w_blank, d_b_blank = torch.zeros_like(w_blank), torch.zeros_like(b_out[0])
    d_w_lab, d_b_lab = torch.zeros_like(w_lab), torch.zeros_like(b_lab)
    for s, e in _chunks(T, time_chunk):
        z, logits, lse_c, _, _ = joint_chunk(h_enc[:, s:e], h_dec, w_out, b_out, w_lab, b_lab, ok, blank_id)
        if lse is not None:
            lse_c = lse[:, s:e]
        gb, gl = gpb[:, s:e], gpl[:, s:e]
        g_lse = -(g_blank[:, s:e] + torch.cat([g_norm[:, s:e], torch.zeros_like(g_blank[:, s:e, :1])], dim=2))
        g_logits = torch.exp(logits.float() - lse_c[..., None]).mul_(g_lse[..., None]).to(dt)
        dz = torch.matmul(g_logits, w_out.t())
        if has_blank:
            dz = dz + gb[..., None] * w_blank
        dz[:, :, :U] += gl[..., None] * w_lab[:, None]
        d_pre = (dz + dz * z) * (1.0 - z)
        d_enc[:, s:e] = d_pre.sum(dim=2)
        d_dec += d_pre.sum(dim=1)
        zw = z.to(dt)
        d_w += torch.matmul(zw.reshape(-1, J).t(), g_logits.reshape(-1, V))
        d_b += g_logits.sum(dim=(0, 1, 2))
        d_w_blank += torch.einsum("bcuj,bcu->j", zw, gb)
        d_b_blank += gb.sum()
        d_w_lab += torch.einsum("bcuj,bcu->buj", zw[:, :, :U], gl)
        d_b_lab += gl.sum(dim=1)
    if has_blank:
        d_w[:, blank_id] += d_w_blank
        d_b[blank_id] += d_b_blank
    onehot = torch.nn.functional.one_hot(torch.where(ok, labels.long(), torch.zeros_like(labels, dtype=torch.long)),
                                         V).reshape(-1, V).float()  # (B U, V)
    d_w += (d_w_lab.reshape(-1, J).float().t() @ onehot).to(dt)
    d_b += (d_b_lab.reshape(1, -1).float() @ onehot)[0].to(dt)
    return d_enc, d_dec, d_w, d_b


def zero_cotangents(h_enc, h_dec, g_blank, g_label):
    """Cotangents of the two outputs, zeros for an output no loss used."""
    B, T = h_enc.shape[:2]
    U1 = h_dec.shape[1]
    if g_blank is None:
        g_blank = torch.zeros((B, T, U1), dtype=torch.float32, device=h_enc.device)
    if g_label is None:
        g_label = torch.zeros((B, T, U1 - 1), dtype=torch.float32, device=h_enc.device)
    return g_blank, g_label


class _ChunkedJointGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, h_enc, h_dec, w_out, b_out, labels, blank_id, time_chunk):
        ctx.save_for_backward(h_enc, h_dec, w_out, b_out, labels)
        ctx.blank_id, ctx.time_chunk = blank_id, time_chunk
        return joint_gather_plain(h_enc, h_dec, w_out, b_out, labels, blank_id, time_chunk)

    @staticmethod
    def backward(ctx, g_blank, g_label):
        h_enc, h_dec, w_out, b_out, labels = ctx.saved_tensors
        g_blank, g_label = zero_cotangents(h_enc, h_dec, g_blank, g_label)
        grads = joint_gather_backward(h_enc, h_dec, w_out, b_out, labels, g_blank, g_label,
                                      ctx.blank_id, ctx.time_chunk)
        return (*grads, None, None, None)


def rnnt_gathered_from_joint(
    h_enc: torch.Tensor, h_dec: torch.Tensor, w_out: torch.Tensor, b_out: torch.Tensor,
    labels: torch.Tensor, blank_id: int = 0, time_chunk: int = TIME_CHUNK,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Blank and label log-probabilities (B, T, U+1), (B, T, U) from the
    joint activations h_enc (B, T, J) = W_enc eouts, h_dec (B, U+1, J) =
    W_dec douts (biases folded in), the output layer w_out (J, V), b_out
    (V,), without the (B, T, U+1, V) tensor (the `chunked` mode)."""
    return _ChunkedJointGather.apply(h_enc, h_dec, w_out, b_out, labels, blank_id, time_chunk)
