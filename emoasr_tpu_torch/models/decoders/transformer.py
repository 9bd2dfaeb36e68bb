"""Attention (Transformer) decoder with auxiliary CTC (PyTorch port of
`emoasr_tpu/models/decoders/transformer.py`).

Parity target: emoASR `asr/modeling/decoders/transformer.py:25-159`: embed +
PE, N pre-norm decoder layers, final LayerNorm eps=1e-12, linear output;
causal mask over ylens+1; `forward_one_step` re-runs the full prefix and
returns the last position's logits.  The incremental steps
(`decode_step_cached`, `decode_step_cached_indirect`) serve the beam search
in `emoasr_tpu_torch/search/attention_beam.py`; they write into the caches
they are given, in place.

The training loss is the label-smoothed cross-entropy over `ylens + 1`
positions (`models/criteria.py`), in CMLM mode the masked-LM loss over the
labels that are not -100, plus `mtl_ctc_weight` times the auxiliary CTC
loss (`CTCDecoder`, which runs the CTC head and lattice kernels).  With
`kd_weight` and soft labels the attention loss is `distill_loss`'s mix of
the soft and the label-smoothed targets (`loss_kd`, `loss_att`); the
auxiliary CTC gets no soft labels and stays on its kernels.  With the
embedding and head split over the model axis (`parallel/tensor.py`) the
logits are the rank's vocabulary columns, and every loss takes them as
they are (`parallel/vocab.py`).
"""

from __future__ import annotations

import math
from typing import List, Tuple

import torch
from torch import nn

from emoasr_tpu_torch.config import ExpConfig
from emoasr_tpu_torch.models.criteria import distill_loss, label_smoothing_loss, masked_lm_loss
from emoasr_tpu_torch.models.decoders.ctc import CTCDecoder
from emoasr_tpu_torch.parallel.vocab import vocab_shard
from emoasr_tpu_torch.models.layers import (
    PositionalEncoder,
    TransformerDecoderLayer,
    cache_write_index,
    make_causal_mask,
    make_pad_mask,
    sinusoidal_pe,
)

Caches = List[Tuple[torch.Tensor, torch.Tensor]]


class TransformerDecoder(nn.Module):
    def __init__(self, cfg: ExpConfig, cmlm: bool = False):
        super().__init__()
        self.cfg = cfg
        self.cmlm = cmlm
        self.embed = nn.Embedding(cfg.vocab_size, cfg.dec_hidden_size)
        self.pe = PositionalEncoder(cfg.dec_hidden_size, cfg.dropout_dec_rate)
        self.transformers = nn.ModuleList(
            TransformerDecoderLayer(
                cfg.dec_num_attention_heads,
                cfg.dec_hidden_size,
                cfg.dec_intermediate_size,
                cfg.dropout_dec_rate,
                cfg.dropout_attn_rate,
                memory_size=cfg.enc_hidden_size,
            )
            for _ in range(cfg.dec_num_layers)
        )
        self.norm = nn.LayerNorm(cfg.dec_hidden_size, eps=1e-12)
        self.output = nn.Linear(cfg.dec_hidden_size, cfg.vocab_size)
        if cfg.mtl_ctc_weight > 0:
            self.ctc = CTCDecoder(cfg)

    def _decode_stack(self, ys_in, ymask, eouts, emask, cross_kvs=None):
        h = self.pe(self.embed(ys_in.long()))
        for i, layer in enumerate(self.transformers):
            h = layer(h, ymask, eouts, emask,
                      cross_kv=None if cross_kvs is None else cross_kvs[i])
        return h

    def precompute_cross_kv(self, eouts):
        """Per-layer encoder-side (K, V): step-invariant during decoding,
        so the beam loop projects the memory once instead of per step."""
        return [layer.compute_cross_kv(eouts) for layer in self.transformers]

    def init_cache(self, B: int, max_len: int, dtype=torch.float32, device=None) -> Caches:
        """Per-layer self-attention K/V caches for incremental decoding, in
        the activation dtype of the decode path."""
        cfg = self.cfg
        H = cfg.dec_num_attention_heads
        dk = cfg.dec_hidden_size // H
        device = self.output.weight.device if device is None else device
        return [
            (torch.zeros((B, max_len, H, dk), dtype=dtype, device=device),
             torch.zeros((B, max_len, H, dk), dtype=dtype, device=device))
            for _ in range(cfg.dec_num_layers)
        ]

    def _embed_step(self, tokens, flat_pos, Lmax):
        D = self.cfg.dec_hidden_size
        emb = self.embed(tokens.long())[:, None, :]
        key = (Lmax, emb.device, emb.dtype)
        if getattr(self, "_pe_key", None) != key:  # the table of one search stage, kept between steps
            self._pe, self._pe_key = sinusoidal_pe(Lmax, D, emb.device, emb.dtype), key
        return emb * math.sqrt(D) + self._pe[flat_pos][:, None, :]

    def decode_step_cached(self, tokens, pos, caches: Caches, cross_kvs, memory_mask=None,
                           beam_width=None, step_mode="dense", elens=None):
        """Incremental one-token decode with self-attention KV caches.

        tokens: (B,) newest token per row; pos: (B,) its position; caches
        from `init_cache` (beam-gathered by the caller on pruning).
        Numerically the same as `forward_one_step` on the full prefix.  With
        `beam_width`, B is utterances x beams and `cross_kvs`/`memory_mask`
        are per-utterance (see TransformerDecoderLayer.decode_step);
        `step_mode="fused"` sends every layer step to the fused kernel."""
        Lmax = caches[0][0].shape[1]
        pos = pos.long()
        h = self._embed_step(tokens, pos, Lmax)
        # attend over cache positions <= pos
        self_mask = (torch.arange(Lmax, device=h.device)[None, :] <= pos[:, None])[:, None, None, :]
        fused = step_mode == "fused"
        index = cache_write_index(pos, Lmax)
        step_pos = pos.to(torch.int32) if fused else pos  # as the kernel reads it
        new_caches = []
        for i, layer in enumerate(self.transformers):
            h, ck, cv = layer.decode_step(
                h, caches[i][0], caches[i][1], step_pos, self_mask, memory_mask, cross_kvs[i],
                beam_width=beam_width, fused=fused, elens=elens, cache_index=index,
            )
            new_caches.append((ck, cv))
        return self.output(self.norm(h[:, 0])), new_caches

    def decode_step_cached_indirect(self, tokens, pos, caches: Caches, anc, cross_kvs,
                                    memory_mask=None, beam_width=None, step_mode="indirect",
                                    elens=None):
        """`decode_step_cached` with ancestor-indirect caches.

        caches: per-layer (k, v) with (Bu, W, Lc, H, dk) leaves in physical
        slot order; anc: (Bu, W, Lc) ancestor table shared by all layers
        (the caller sets anc[b, w, pos] = w before the call); pos: (Bu, W);
        tokens: (B,) flat with B = Bu*W.  The beam search never permutes
        the caches: it composes beam permutations into `anc` only.
        `step_mode="fused_indirect"` sends every layer step to the kernel."""
        Lmax = caches[0][0].shape[2]
        pos = pos.long()
        h = self._embed_step(tokens, pos.reshape(-1), Lmax)
        fused = step_mode == "fused_indirect"
        index = cache_write_index(pos.reshape(-1), Lmax)
        step_pos = pos.to(torch.int32) if fused else pos  # as the kernel reads it
        new_caches = []
        for i, layer in enumerate(self.transformers):
            h, ck, cv = layer.decode_step_indirect(
                h, caches[i][0], caches[i][1], step_pos, anc, memory_mask, cross_kvs[i], beam_width,
                fused=fused, elens=elens, cache_index=index,
            )
            new_caches.append((ck, cv))
        return self.output(self.norm(h[:, 0])), new_caches

    def forward(self, eouts, elens, eouts_inter=None, ys=None, ylens=None, ys_in=None,
                ys_out=None, soft_labels=None, ps=None, plens=None):
        """Without `ys_out`: the teacher-forced logits (B, L, V).  With it:
        (loss, loss_dict, logits), `loss_dict` holding `loss_att`,
        `loss_kd` (with `kd_weight` and soft labels), `loss_ctc` (with an
        auxiliary CTC head) and `loss_total` (transformer.py:190-236)."""
        cfg = self.cfg
        L = ys_in.shape[1]
        emask = make_pad_mask(elens, eouts.shape[1])[:, None, None, :]
        if self.cmlm:
            ymask = make_pad_mask(ylens, L)[:, None, None, :]
        else:
            ymask = (
                make_pad_mask(ylens + 1, L)[:, None, None, :]
                & make_causal_mask(L, ys_in.device)[None, None, :, :]
            )
        h = self._decode_stack(ys_in, ymask, eouts, emask)
        logits = self.output(self.norm(h))
        if ys_out is None:
            return logits
        shard = vocab_shard(self.output)  # the rank's columns of split logits
        if cfg.kd_weight > 0 and soft_labels is not None:
            # soft labels of L = U + 1 rows (the last one <eos>'s), mixed with
            # the label-smoothed targets by kd_weight (transformer.py:205-215)
            loss, loss_kd, loss_att = distill_loss(
                logits, ys_out, soft_labels, ylens + 1, soft_label_weight=cfg.kd_weight, lsm_prob=cfg.lsm_prob,
                normalize_length=cfg.loss_normalize_length, normalize_batch=cfg.loss_normalize_batch, shard=shard,
            )
            loss_dict = {"loss_kd": loss_kd, "loss_att": loss_att}
        else:
            if self.cmlm:
                loss_att = masked_lm_loss(logits, ys_out, shard=shard)
            else:
                loss_att = label_smoothing_loss(
                    logits, ys_out, ylens + 1, lsm_prob=cfg.lsm_prob,
                    normalize_length=cfg.loss_normalize_length, normalize_batch=cfg.loss_normalize_batch,
                    shard=shard,
                )
            loss, loss_dict = loss_att, {"loss_att": loss_att}
        if cfg.mtl_ctc_weight > 0:
            loss_ctc, _, _ = self.ctc(eouts, elens, ys=ys, ylens=ylens)
            loss = loss + cfg.mtl_ctc_weight * loss_ctc
            loss_dict["loss_ctc"] = loss_ctc
        loss_dict["loss_total"] = loss
        return loss, loss_dict, logits

    def forward_one_step(self, ys_in, ylens_in, eouts, emask=None, cross_kvs=None):
        """Logits for the position `ylens_in-1` of each prefix: the full
        prefix is re-encoded and the last position gathered per row."""
        L = ys_in.shape[1]
        ymask = (
            make_pad_mask(ylens_in, L)[:, None, None, :]
            & make_causal_mask(L, ys_in.device)[None, None, :, :]
        )
        h = self._decode_stack(ys_in, ymask, eouts, emask, cross_kvs)
        idx = (ylens_in.long() - 1)[:, None, None].expand(-1, 1, h.shape[-1])
        return self.output(self.norm(torch.gather(h, 1, idx)[:, 0]))
