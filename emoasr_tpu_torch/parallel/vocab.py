"""Loss pieces on vocabulary-split logits (Megatron's vocabulary-parallel
cross-entropy; the port's counterpart of what GSPMD makes of the JAX
package's `P(None, "model")` heads, `parallel/mesh.py::_tp_spec:85-97`).

Under a model axis of m the vocabulary heads and tables of
`parallel/tensor.py::tp_plan` keep V / m columns a rank: rank r owns the
columns [v0, v0 + V / m), v0 = r V / m, and its head returns the (..., V / m)
logits of those columns (`VocabParallelHead`).  The losses never gather
them; each needs a few (...)-shaped numbers of the whole vocabulary, and
each is summed over the model group from the ranks' partials
(`parallel/mesh.py`):

- the normaliser lse = logsumexp_v logit_v: the ranks' partial lse
  gathered and combined in rank order (`model_logsumexp`);
- the logit at a label: taken on the rank that owns the label's column, 0
  on the others, and summed (`reduce_from_model`: exact; backward the
  identity, a rank's non-owned entries being constants);
- sum_v logit_v, which the closed-form label smoothing of
  `models/criteria.py` needs (sum_v logp_v = sum_v logit_v - V lse), and
  sum_v q_v logit_v of a soft target q (distillation): the partial sums
  gathered and added in rank order (`model_sum_in_order`).

Each of these is combined in one fixed order from the same gathered bits,
so every model rank holds the same values and what follows the head (the
lattices, the losses) runs replicated without drifting apart.  Their
gradients are local: every rank computes the same loss, and each takes its
own columns' share of it.  The normaliser's gradient is local too, so it
enters only replicated expressions (lse minus a combined logit).

Where a loss needs the log-probabilities of the rank's columns themselves
(the RNN-T `full` joint, the distillation targets), `log_softmax_shard`
gives them: its cotangents are the rank's columns' share, and its backward
sums their total over the model group (one all-reduce).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import torch

from emoasr_tpu_torch.parallel.mesh import (
    all_reduce_,
    gather_model,
    lse_in_order,
    model_logsumexp,
    model_sum_in_order,
    reduce_from_model,
)


@dataclass(frozen=True)
class VocabShard:
    """This rank's columns of a vocabulary of `local * size` entries."""

    group: object
    rank: int
    size: int
    local: int

    @property
    def v0(self) -> int:
        return self.rank * self.local

    @property
    def total(self) -> int:
        return self.local * self.size


def vocab_shard(module) -> Optional[VocabShard]:
    """The shard of a vocabulary-split head or table, None when it is whole."""
    return getattr(module, "vocab_shard", None)


def log_normaliser(logits: torch.Tensor, shard: VocabShard) -> torch.Tensor:
    """logsumexp over the whole vocabulary of split logits, float32 (...)."""
    lse_r = torch.logsumexp(logits.float(), dim=-1)
    return model_logsumexp(lse_r, shard.group, shard.rank, shard.size)


class _LogSoftmaxShard(torch.autograd.Function):
    """logits_r - lse of the whole vocabulary, float32; backward: the
    rank's cotangents g_r give d logits_r = g_r - p_r sum_v g_v, the sum
    over every rank's columns (an all-reduce of the ranks' sums)."""

    @staticmethod
    def forward(ctx, logits, shard):
        x = logits.float()
        lse = lse_in_order(gather_model(torch.logsumexp(x, dim=-1), shard.group, shard.rank, shard.size))
        out = x - lse[..., None]
        ctx.save_for_backward(out)
        ctx.shard, ctx.dtype = shard, logits.dtype
        return out

    @staticmethod
    def backward(ctx, g):
        (out,) = ctx.saved_tensors
        total = g.sum(dim=-1).contiguous()
        all_reduce_(total, ctx.shard.group)
        return (g - torch.exp(out) * total[..., None]).to(ctx.dtype), None


def log_softmax_shard(logits: torch.Tensor, shard: VocabShard) -> torch.Tensor:
    """The rank's columns (..., V / m) of the whole vocabulary's
    log-softmax, for the losses that reduce them per rank first (see the
    module note)."""
    return _LogSoftmaxShard.apply(logits, shard)


def logit_at(logits: torch.Tensor, ids: torch.Tensor, shard: VocabShard) -> torch.Tensor:
    """The float32 logits of split logits (..., V / m) at columns `ids` of
    the whole vocabulary (in [0, V)): one a row, ids (...), or several,
    ids (..., K); each from the rank that owns it."""
    one = ids.dim() == logits.dim() - 1
    local = (ids[..., None] if one else ids).long() - shard.v0
    own = (local >= 0) & (local < shard.local)
    got = torch.gather(logits, -1, torch.where(own, local, torch.zeros_like(local))).float()
    got = reduce_from_model(torch.where(own, got, torch.zeros_like(got)), shard.group)
    return got[..., 0] if one else got


def logit_sum(logits: torch.Tensor, shard: VocabShard) -> torch.Tensor:
    """sum_v logit_v over the whole vocabulary, float32 (...)."""
    return model_sum_in_order(logits.float().sum(dim=-1), shard.group, shard.rank, shard.size)


def soft_dot(logits: torch.Tensor, soft: torch.Tensor, shard: VocabShard) -> torch.Tensor:
    """sum_v soft_v logit_v of a whole (..., V) soft target."""
    mine = soft[..., shard.v0:shard.v0 + shard.local].to(torch.float32)
    return model_sum_in_order((mine * logits.float()).sum(dim=-1), shard.group, shard.rank, shard.size)


def log_prob_at(logits: torch.Tensor, ids: torch.Tensor, shard: VocabShard,
                lse: Optional[torch.Tensor] = None) -> torch.Tensor:
    """log softmax(logits)[ids] of split logits."""
    lse = log_normaliser(logits, shard) if lse is None else lse
    return logit_at(logits, ids, shard) - lse


def lsm_target(logits: torch.Tensor, ys: torch.Tensor, lsm_prob: float, shard: VocabShard,
               lse: Optional[torch.Tensor] = None) -> torch.Tensor:
    """`models/criteria.py::_lsm_target` of split logits: (1 - p) logp[y] +
    p / (V - 1) (sum_v logp_v - logp[y]), a label clamped into [0, V)."""
    V = shard.total
    lse = log_normaliser(logits, shard) if lse is None else lse
    at_y = log_prob_at(logits, ys.long().clamp(0, V - 1), shard, lse)
    if lsm_prob == 0.0:
        return at_y
    sum_logp = logit_sum(logits, shard) - V * lse
    return (1.0 - lsm_prob) * at_y + (lsm_prob / (V - 1)) * (sum_logp - at_y)
