"""Training criteria (PyTorch port of the label-smoothing and masked-LM parts
of `emoasr_tpu/models/criteria.py`).

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

The distillation losses come with slice 7b (ROADMAP.md §1).
"""

from __future__ import annotations

import torch

SLICE_7 = "(ROADMAP.md §1, slice 7b: distillation)"


def label_smoothing_loss(
    logits: torch.Tensor,
    ys: torch.Tensor,
    ylens: torch.Tensor,
    lsm_prob: float = 0.0,
    normalize_length: bool = False,
    normalize_batch: bool = True,
) -> torch.Tensor:
    """Masked cross-entropy with label smoothing (criteria.py:18-46);
    positions at or past `ylens` do not count."""
    B, L, V = logits.shape
    logp = torch.log_softmax(logits.float(), dim=-1)
    at_y = torch.gather(logp, -1, ys.long().clamp(0, V - 1)[..., None])[..., 0]
    target = at_y if lsm_prob == 0.0 else (1.0 - lsm_prob) * at_y + (lsm_prob / (V - 1)) * (logp.sum(-1) - at_y)
    mask = torch.arange(L, device=logits.device)[None, :] < ylens.to(logits.device)[:, None]
    per_pos = torch.where(mask, target, torch.zeros((), device=logits.device))
    per_b = per_pos.sum(dim=1)
    if normalize_length:
        per_b = per_b / ylens.to(logits.device).clamp(min=1)
    loss = -per_b.sum()
    if normalize_batch:
        loss = loss / B
    return loss


def distill_loss(*args, **kwargs):
    raise NotImplementedError(f"the soft-label distillation loss comes with {SLICE_7}")


IGNORE_ID = -100


def masked_lm_loss(logits: torch.Tensor, labels: torch.Tensor, ignore_id: int = IGNORE_ID) -> torch.Tensor:
    """Mean cross-entropy over the positions whose label is not
    `ignore_id` (criteria.py:80-91, torch `CrossEntropyLoss`'s default), 0
    where there is none."""
    logp = torch.log_softmax(logits.float(), dim=-1)
    valid = labels != ignore_id
    tgt = torch.where(valid, labels, torch.zeros_like(labels)).long()
    ce = -torch.gather(logp, -1, tgt[..., None])[..., 0]
    return torch.where(valid, ce, torch.zeros_like(ce)).sum() / valid.sum().clamp(min=1)
