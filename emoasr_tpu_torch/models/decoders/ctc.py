"""CTC decoder head: loss (+ MTL variants) and batched greedy decode
(PyTorch port of `emoasr_tpu/models/decoders/ctc.py`).

Parity target: emoASR `asr/modeling/decoders/ctc.py:26-201`: linear head,
CTC loss normalised by B, phone-CTC MTL (optionally hierarchical from the
intermediate layer), inter-CTC MTL, alignment distillation (`kd_weight`,
`inter_kd_weight` with soft labels, `models/criteria.py::
ctc_align_distill_loss`).  A distillation branch takes the dense route, as
the JAX package does: the (B, T, V) logits, the CTC loss from them (the
lattice kernel on the card) and the forced alignment of their
log-probabilities, no gradient through it.  The prefix beam search is in
`emoasr_tpu_torch/search/ctc_beam.py`.

With the head split over the model axis (`parallel/tensor.py`) the losses
run on the rank's vocabulary columns (`ops/ctc.py`: K1 on the rank's
block; the distillation route's dense logits, forced alignment and
`ctc_align_distill_loss` on the rank's (B, T, V / m) columns).
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
from torch import nn

from emoasr_tpu_torch.config import ExpConfig
from emoasr_tpu_torch.models.criteria import ctc_align_distill_loss
from emoasr_tpu_torch.ops.ctc import ctc_forced_align, ctc_loss_fn, ctc_loss_fused_head
from emoasr_tpu_torch.parallel.vocab import log_normaliser, vocab_shard

# Route the loss through the fused head (ops/ctc_head.py: no (B, T, V)
# logits); False takes the dense route (logits, logsumexp, gather), for
# comparison.  The lattice is the same kernel on both routes.
USE_FUSED_HEAD = True


def greedy_collapse(
    best_paths: torch.Tensor, elens: torch.Tensor, blank_id: int = 0
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Collapse repeats then remove blanks, batched.

    best_paths: (B, T) argmax frame labels.  Returns (hyps, hyp_lens):
    hyps (B, T) int32 padded with blank_id."""
    B, T = best_paths.shape
    dev = best_paths.device
    prev = torch.cat(
        [torch.full((B, 1), -1, dtype=best_paths.dtype, device=dev), best_paths[:, :-1]], 1
    )
    valid = torch.arange(T, device=dev)[None, :] < elens[:, None]
    keep = (best_paths != prev) & (best_paths != blank_id) & valid
    pos = torch.cumsum(keep.to(torch.int64), dim=1) - 1  # target slot
    hyp_lens = torch.where(keep, pos + 1, torch.zeros_like(pos)).amax(dim=1)
    out = torch.full((B, T + 1), blank_id, dtype=best_paths.dtype, device=dev)
    # dropped frames all write blank into the spare column T
    out.scatter_(1, torch.where(keep, pos, torch.full_like(pos, T)),
                 torch.where(keep, best_paths, torch.full_like(best_paths, blank_id)))
    return out[:, :T].to(torch.int32), hyp_lens.to(torch.int32)


class CTCDecoder(nn.Module):
    """Linear head over the vocabulary (`decoder.output` in the checkpoint,
    `decoder.phone_output` with phone-CTC MTL) + CTC losses."""

    def __init__(self, cfg: ExpConfig):
        super().__init__()
        self.cfg = cfg
        self.output = nn.Linear(cfg.enc_hidden_size, cfg.vocab_size)
        if cfg.mtl_phone_ctc_weight > 0:
            self.phone_output = nn.Linear(cfg.enc_hidden_size, cfg.phone_vocab_size)

    def logits(self, eouts: torch.Tensor) -> torch.Tensor:
        return self.output(eouts)

    def phone_logits(self, eouts: torch.Tensor) -> torch.Tensor:
        return self.phone_output(eouts)

    def _ctc(self, head: nn.Linear, eouts, labels, elens, label_lens) -> torch.Tensor:
        shard = vocab_shard(head)
        if USE_FUSED_HEAD:
            return ctc_loss_fused_head(
                eouts, head.weight.t(), head.bias, labels, elens, label_lens, self.cfg.blank_id, shard
            )
        return ctc_loss_fn(head(eouts), labels, elens, label_lens, self.cfg.blank_id, shard)

    def forward(
        self,
        eouts: torch.Tensor,
        elens: torch.Tensor,
        eouts_inter: Optional[torch.Tensor] = None,
        ys: Optional[torch.Tensor] = None,
        ylens: Optional[torch.Tensor] = None,
        ys_in=None,  # unused (API parity with other decoders)
        ys_out=None,  # unused
        soft_labels: Optional[torch.Tensor] = None,
        ps: Optional[torch.Tensor] = None,
        plens: Optional[torch.Tensor] = None,
    ):
        """Without `ys`: the logits.  With `ys`: (loss, loss_dict, logits),
        `logits` the (B, T, V) head output on the distillation route (the
        only route that makes it), else None."""
        cfg = self.cfg
        if ys is None:
            return self.output(eouts)

        loss_dict = {}
        use_kd = cfg.kd_weight > 0 and soft_labels is not None
        shard = vocab_shard(self.output)
        logits = None
        if use_kd:
            logits = self.output(eouts)
            loss_ctc = ctc_loss_fn(logits, ys, elens, ylens, cfg.blank_id, shard)
        else:
            loss_ctc = self._ctc(self.output, eouts, ys, elens, ylens)
        loss = loss_ctc
        loss_dict["loss_ctc"] = loss_ctc

        if use_kd:
            loss_kd = self._align_kd(logits, ys, soft_labels, elens, ylens)
            loss_dict["loss_kd"] = loss_kd
            if cfg.reduce_main_loss_kd:
                loss = (1 - cfg.kd_weight) * loss + cfg.kd_weight * loss_kd
            else:
                loss = loss + cfg.kd_weight * loss_kd

        if cfg.mtl_phone_ctc_weight > 0:
            src = eouts_inter if cfg.hie_mtl_phone else eouts
            loss_phone = self._ctc(self.phone_output, src, ps, elens, plens)
            loss = loss + cfg.mtl_phone_ctc_weight * loss_phone
            key = "loss_phone_ctc(inter)" if cfg.hie_mtl_phone else "loss_phone_ctc"
            loss_dict[key] = loss_phone

        if cfg.mtl_inter_ctc_weight > 0:
            if cfg.inter_kd_weight > 0 and soft_labels is not None:
                logits_inter = self.output(eouts_inter)
                loss_inter = ctc_loss_fn(logits_inter, ys, elens, ylens, cfg.blank_id, shard)
                loss_dict["loss_inter_ctc"] = loss_inter
                loss_inter_kd = self._align_kd(logits_inter, ys, soft_labels, elens, ylens)
                loss_dict["loss_inter_kd"] = loss_inter_kd
                if cfg.reduce_main_loss_kd:
                    loss = loss + cfg.mtl_inter_ctc_weight * (
                        (1 - cfg.inter_kd_weight) * loss_inter + cfg.inter_kd_weight * loss_inter_kd)
                else:
                    loss = loss + cfg.inter_kd_weight * loss_inter_kd
            else:
                loss_inter = self._ctc(self.output, eouts_inter, ys, elens, ylens)
                loss_dict["loss_inter_ctc"] = loss_inter
                loss = loss + cfg.mtl_inter_ctc_weight * loss_inter

        loss_dict["loss_total"] = loss
        return loss, loss_dict, logits

    def _align_kd(self, logits, ys, soft_labels, elens, ylens) -> torch.Tensor:
        """The alignment-distillation loss of one head's logits: the forced
        alignment of their log-probabilities (no gradient), then
        `ctc_align_distill_loss` (ctc.py:115-131)."""
        cfg = self.cfg
        shard = vocab_shard(self.output)
        lp = logits.detach().float()
        if shard is None:
            lp = torch.log_softmax(lp, dim=-1)
        else:  # the rank's columns of the log-probabilities
            lp = lp - log_normaliser(lp, shard)[..., None]
        aligns = ctc_forced_align(lp, elens, ys, ylens, cfg.blank_id, shard)
        return ctc_align_distill_loss(
            logits, ys, soft_labels, aligns, elens, ylens, blank_id=cfg.blank_id,
            soft_label_weight=cfg.kd_ctc_soft_label_weight, position=cfg.kd_ctc_position, lsm_prob=cfg.lsm_prob,
            shard=shard,
        )

    def greedy(self, eouts: torch.Tensor, elens: torch.Tensor, decode_phone: bool = False):
        """Batched greedy decode: returns (hyps, hyp_lens, logits, aligns),
        over the phone head with `decode_phone`.

        `torch.argmax` returns the first maximal index, as `jnp.argmax`
        does, so equal logits resolve to the lowest token id."""
        logits = self.phone_output(eouts) if decode_phone else self.output(eouts)
        best_paths = torch.argmax(logits, dim=-1)
        T = best_paths.shape[1]
        aligns = torch.where(
            torch.arange(T, device=eouts.device)[None, :] < elens[:, None],
            best_paths, torch.zeros_like(best_paths),
        ).to(torch.int32)
        hyps, hyp_lens = greedy_collapse(best_paths, elens, self.cfg.blank_id)
        return hyps, hyp_lens, logits, aligns
