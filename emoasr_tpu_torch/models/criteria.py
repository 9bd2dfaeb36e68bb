"""Training criteria (PyTorch port of `emoasr_tpu/models/criteria.py`):
label smoothing, the masked-LM loss and the five distillation losses.

Parity target: emoASR `asr/criteria.py:5-46`: the masked cross-entropy
against a label-smoothed target, (1 - p) on the label and p / (V - 1) on
every other entry.  The target is never built: its product with the
log-probabilities is taken in closed form,

    (1 - p) logp[y] + p / (V - 1) (sum_v logp[v] - logp[y]),

so no one-hot of (B, L, V) is made.  It sums the same terms as the JAX
package's one-hot product, in another order (float32, within a few ulps of
the loss; tests/test_torch_criteria.py).

`masked_lm_loss` (emoASR `lm/criteria.py:5-18`, the CMLM decoder's loss) is
the mean cross-entropy over the labels that are not -100, taken as a gather
of the log-probabilities at the labels, not as the JAX package's one-hot
product.

The distillation losses (emoASR `asr/criteria.py:49-288`) are masked
batched reductions, as in the JAX package.  Their hard (label-smoothed
one-hot) targets are taken in the closed form above, by a gather at the
label; the soft targets are dense (B, L, V) tensors and are multiplied
in.  `rnnt_align_distill_loss` sums over every label position, the JAX
package's intended semantics (emoASR keeps only the last one).
`rnnt_word_distill_loss` also takes soft labels of U rows, as the dataset
makes them for a transducer (the JAX function wants U + 1; the row it
lacks is never read).

Every loss here also takes logits split over the model axis (`shard`:
this rank's columns, `parallel/vocab.py`): the same closed forms from the
whole vocabulary's normaliser, label logit and sums, which the model ranks
combine; a soft target is whole on every rank (data) and meets the rank's
columns only.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from emoasr_tpu_torch.parallel import vocab
from emoasr_tpu_torch.parallel.mesh import global_rows, global_sum


def _lsm_target(logp: torch.Tensor, ys: torch.Tensor, lsm_prob: float) -> torch.Tensor:
    """sum_v logp[..., v] onehot_lsm(ys)[..., v] in closed form: (1 - p)
    logp[y] + p / (V - 1) (sum_v logp[v] - logp[y])."""
    V = logp.shape[-1]
    at_y = torch.gather(logp, -1, ys.long().clamp(0, V - 1)[..., None])[..., 0]
    if lsm_prob == 0.0:
        return at_y
    return (1.0 - lsm_prob) * at_y + (lsm_prob / (V - 1)) * (logp.sum(-1) - at_y)


def label_smoothing_loss(
    logits: torch.Tensor,
    ys: torch.Tensor,
    ylens: torch.Tensor,
    lsm_prob: float = 0.0,
    normalize_length: bool = False,
    normalize_batch: bool = True,
    shard: Optional[vocab.VocabShard] = None,
) -> torch.Tensor:
    """Masked cross-entropy with label smoothing (criteria.py:18-46);
    positions at or past `ylens` do not count."""
    B, L = logits.shape[:2]
    if shard is None:
        target = _lsm_target(torch.log_softmax(logits.float(), dim=-1), ys, lsm_prob)
    else:
        target = vocab.lsm_target(logits, ys.to(logits.device), lsm_prob, shard)
    mask = torch.arange(L, device=logits.device)[None, :] < ylens.to(logits.device)[:, None]
    per_pos = torch.where(mask, target, torch.zeros((), device=logits.device))
    per_b = per_pos.sum(dim=1)
    if normalize_length:
        per_b = per_b / ylens.to(logits.device).clamp(min=1)
    loss = -per_b.sum()
    if normalize_batch:
        loss = loss / global_rows(B)
    return loss


def distill_loss(
    logits: torch.Tensor,
    ys: torch.Tensor,
    soft_labels: torch.Tensor,
    ylens: torch.Tensor,
    soft_label_weight: float,
    lsm_prob: float = 0.0,
    normalize_length: bool = False,
    normalize_batch: bool = True,
    shard: Optional[vocab.VocabShard] = None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Soft/hard label interpolation KD (criteria.py:49-100) -> (loss,
    loss_soft, loss_hard): the masked cross-entropy against the soft labels
    and against the label-smoothed labels, mixed by `soft_label_weight`."""
    B, L = logits.shape[:2]
    dev = logits.device
    ylens = ylens.to(dev)
    mask = torch.arange(L, device=dev)[None, :] < ylens[:, None]

    def masked_sum(per_pos):
        per_b = torch.where(mask, per_pos, torch.zeros((), device=dev)).sum(dim=1)
        if normalize_length:
            per_b = per_b / ylens.clamp(min=1)
        return per_b

    soft = soft_labels[:, :L].to(dev, torch.float32)
    if shard is None:
        logp = torch.log_softmax(logits.float(), dim=-1)
        soft_b = masked_sum((logp * soft).sum(-1))
        hard_b = masked_sum(_lsm_target(logp, ys.to(dev), lsm_prob))
    else:  # sum_v q_v logp_v = sum_v q_v logit_v - lse sum_v q_v
        lse = vocab.log_normaliser(logits, shard)
        soft_b = masked_sum(vocab.soft_dot(logits, soft, shard) - lse * soft.sum(-1))
        hard_b = masked_sum(vocab.lsm_target(logits, ys.to(dev), lsm_prob, shard, lse))
    loss_b = soft_label_weight * soft_b + (1.0 - soft_label_weight) * hard_b
    denom = global_rows(B) if normalize_batch else 1
    return -loss_b.sum() / denom, -soft_b.sum() / denom, -hard_b.sum() / denom


IGNORE_ID = -100


def masked_lm_loss(logits: torch.Tensor, labels: torch.Tensor, ignore_id: int = IGNORE_ID,
                   shard: Optional[vocab.VocabShard] = None) -> torch.Tensor:
    """Mean cross-entropy over the positions whose label is not
    `ignore_id` (criteria.py:80-91, torch `CrossEntropyLoss`'s default), 0
    where there is none."""
    valid = labels != ignore_id
    tgt = torch.where(valid, labels, torch.zeros_like(labels)).long()
    if shard is None:
        ce = -torch.gather(torch.log_softmax(logits.float(), dim=-1), -1, tgt[..., None])[..., 0]
    else:
        ce = -vocab.log_prob_at(logits, tgt, shard)
    return torch.where(valid, ce, torch.zeros_like(ce)).sum() / global_sum(valid.sum()).clamp(min=1)


# ---------------------------------------------------------------- alignment-based distillation


def frame_to_label_mapping(
    aligns: torch.Tensor,
    xlens: torch.Tensor,
    ylens: torch.Tensor,
    blank_id: int = 0,
    position: str = "all",
) -> torch.Tensor:
    """Map each frame to a label index (or -1), batched
    (`CTCAlignDistillLoss._frame_to_label_mapping`, criteria.py:176-215):
    label segments are runs of one non-blank token, delimited by any change
    (blanks break runs); `position` picks the frames of each segment that
    carry its label: all, left, mid or right.  aligns (B, T) -> (B, T) int32."""
    B, T = aligns.shape
    dev = aligns.device
    t_idx = torch.arange(T, device=dev)[None, :]
    valid = t_idx < xlens.to(dev)[:, None]
    nonblank = (aligns != blank_id) & valid
    prev = torch.cat([aligns.new_full((B, 1), -1), aligns[:, :-1]], dim=1)
    new_tok = nonblank & ((t_idx == 0) | (aligns != prev))
    label_id = torch.cumsum(new_tok.to(torch.int64), dim=1) - 1  # (B, T)
    minus1 = torch.full_like(label_id, -1)
    if position == "all":
        return torch.where(nonblank, label_id, minus1).to(torch.int32)
    if position not in ("left", "mid", "right"):
        raise ValueError(position)

    U = T  # at most T segments; column U collects the frames of no segment
    seg = torch.where(nonblank, label_id, torch.full_like(label_id, U))
    t_b = t_idx.expand(B, T)
    left = torch.full((B, U + 1), T, dtype=torch.int64, device=dev).scatter_reduce(
        1, seg, torch.where(nonblank, t_b, torch.full_like(t_b, T)), reduce="amin")[:, :U]
    right = torch.full((B, U + 1), -1, dtype=torch.int64, device=dev).scatter_reduce(
        1, seg, torch.where(nonblank, t_b, torch.full_like(t_b, -1)), reduce="amax")[:, :U]
    pick = {"left": left, "right": right}.get(position)
    if pick is None:
        pick = torch.div(left + right, 2, rounding_mode="floor")

    # the label index onto the picked frame of each segment
    num_seg = torch.where(nonblank, label_id + 1, torch.zeros_like(label_id)).amax(dim=1)  # (B,)
    u_idx = torch.arange(U, device=dev)[None, :].expand(B, U)
    seg_valid = u_idx < num_seg[:, None]
    out = torch.full((B, T + 1), -1, dtype=torch.int64, device=dev)
    out.scatter_(1, torch.where(seg_valid, pick, torch.full_like(pick, T)),
                 torch.where(seg_valid, u_idx, torch.full_like(u_idx, -1)))
    return out[:, :T].to(torch.int32)


def ctc_align_distill_loss(
    logits: torch.Tensor,
    ys: torch.Tensor,
    soft_labels: torch.Tensor,
    aligns: torch.Tensor,
    xlens: torch.Tensor,
    ylens: torch.Tensor,
    blank_id: int = 0,
    soft_label_weight: float = 1.0,
    position: str = "all",
    lsm_prob: float = 0.0,
    normalize_length: bool = True,
    normalize_batch: bool = True,
    shard: Optional[vocab.VocabShard] = None,
) -> torch.Tensor:
    """Frame-level KD through a CTC forced alignment (criteria.py:103-174):
    each frame that `frame_to_label_mapping` gives a label takes that
    label's soft row (and its label-smoothed one-hot) as its target."""
    B, T = logits.shape[:2]
    dev = logits.device
    if shard is None:
        logp = torch.log_softmax(logits.float(), dim=-1)
        V = logp.shape[-1]
    else:
        lse = vocab.log_normaliser(logits, shard)
        logp, V = vocab.log_softmax_shard(logits, shard), shard.total  # the rank's columns
    xlens = xlens.to(dev)
    label_map = frame_to_label_mapping(aligns, xlens, ylens, blank_id, position).long()
    exists = (label_map >= 0) & (torch.arange(T, device=dev)[None, :] < xlens[:, None])
    zero = torch.zeros((), device=dev)
    denom = exists.sum(dim=1).clamp(min=1) if normalize_length else 1

    loss_b = torch.zeros(B, device=dev)
    if soft_label_weight > 0:
        table = soft_labels.to(dev, logp.dtype)
        lm = label_map.clamp(0, table.shape[1] - 1)
        tgt = torch.gather(table, 1, lm[:, :, None].expand(B, T, V))  # (B, T, V): each frame's row
        dot = (tgt * logp).sum(-1) if shard is None else vocab.soft_dot(logp, tgt, shard)
        s = torch.where(exists, dot, zero).sum(dim=1)
        loss_b = loss_b + soft_label_weight * (s / denom if normalize_length else s)
    if soft_label_weight < 1:
        ys = ys.to(dev).long()
        y_t = torch.gather(ys, 1, label_map.clamp(0, ys.shape[1] - 1))  # (B, T): each frame's label
        target = (_lsm_target(logp, y_t, lsm_prob) if shard is None
                  else vocab.lsm_target(logits, y_t, lsm_prob, shard, lse))
        h = torch.where(exists, target, zero).sum(dim=1)
        loss_b = loss_b + (1 - soft_label_weight) * (h / denom if normalize_length else h)
    loss = -loss_b.sum()
    if normalize_batch:
        loss = loss / global_rows(B)
    return loss


def rnnt_word_distill_loss(
    logits: torch.Tensor,
    soft_labels: torch.Tensor,
    xlens: torch.Tensor,
    ylens: torch.Tensor,
    normalize_length: bool = True,
    normalize_batch: bool = True,
    log_probs: Optional[torch.Tensor] = None,
    shard: Optional[vocab.VocabShard] = None,
) -> torch.Tensor:
    """Word-level RNN-T KD: the soft cross-entropy of row u's soft label
    summed over the (t < xlen, u < ylen) grid (criteria.py:218-250).
    `soft_labels` (B, U or U+1, V): row U is never read.  `log_probs`, the
    float32 log-softmax of `logits` where the caller has it already (the
    decoder's RNN-T loss does), saves a second (B, T, U+1, V) tensor."""
    B, T, U1 = logits.shape[:3]
    V = soft_labels.shape[-1]
    dev = logits.device
    if log_probs is not None:
        logp = log_probs
    elif shard is None:
        logp = torch.log_softmax(logits.float(), dim=-1)
    else:
        logp = vocab.log_softmax_shard(logits, shard)
    xlens, ylens = xlens.to(dev), ylens.to(dev)
    soft = soft_labels[:, :U1].to(dev, logp.dtype)
    if soft.shape[1] < U1:
        soft = torch.cat([soft, soft.new_zeros((B, U1 - soft.shape[1], V))], dim=1)
    tmask = torch.arange(T, device=dev)[None, :] < xlens[:, None]
    umask = torch.arange(U1, device=dev)[None, :] < ylens[:, None]
    grid = tmask[:, :, None] & umask[:, None, :]
    if shard is None:
        per_cell = (logp * soft[:, None]).sum(-1)  # (B, T, U1)
    else:
        per_cell = vocab.soft_dot(logp, soft[:, None].expand(B, T, U1, V), shard)
    per = torch.where(grid, per_cell, torch.zeros((), device=dev)).sum(dim=(1, 2))
    if normalize_length:
        per = per / (xlens * ylens).clamp(min=1)
    loss = -per.sum()
    if normalize_batch:
        loss = loss / global_rows(B)
    return loss


def rnnt_align_distill_loss(
    logits: torch.Tensor,
    soft_labels: torch.Tensor,
    aligns: torch.Tensor,
    xlens: torch.Tensor,
    ylens: torch.Tensor,
    normalize_length: bool = True,
    normalize_batch: bool = True,
    shard: Optional[vocab.VocabShard] = None,
) -> torch.Tensor:
    """Alignment-level RNN-T KD: the soft cross-entropy at the aligned cells
    (aligns[u], u), summed over every u < ylen (see the module note)."""
    B, T, U1 = logits.shape[:3]
    U = U1 - 1
    dev = logits.device
    ylens = ylens.to(dev)
    al = aligns[:, :U].to(dev).long().clamp(0, T - 1)  # (B, U)
    u_idx = torch.arange(U, device=dev)[None, :].expand(B, U)
    # the log-softmax of the U aligned cells only: (B, U, V)
    cells = logits[torch.arange(B, device=dev)[:, None], al, u_idx]
    umask = u_idx < ylens[:, None]
    soft = soft_labels[:, :U].to(dev, torch.float32)
    if shard is None:
        per_u = (torch.log_softmax(cells.float(), dim=-1) * soft).sum(-1)
    else:
        per_u = vocab.soft_dot(vocab.log_softmax_shard(cells, shard), soft, shard)
    per = torch.where(umask, per_u, torch.zeros((), device=dev)).sum(dim=1)
    if normalize_length:
        per = per / ylens.clamp(min=1)
    loss = -per.sum()
    if normalize_batch:
        loss = loss / global_rows(B)
    return loss
