"""End-to-end ASR facade: encoder + decoder in one module (PyTorch port of
`emoasr_tpu/models/asr.py`).

Parity target: emoASR `asr/modeling/asr.py:21-101`: `forward` (loss),
greedy `decode`, `forced_align` (CTC and RNN-T); the submodule names `encoder` and
`decoder` are the reference checkpoint's prefixes.  Every encoder
(Transformer, Conformer, RNN) and decoder (CTC, RNN-T, Transformer, LAS)
of the JAX package is ported, for training and decoding.  Dropout is on in
`train()` mode and off in `eval()` mode (the JAX package's `deterministic`
flag).
"""

from __future__ import annotations

import torch
from torch import nn

from emoasr_tpu_torch.config import ExpConfig
from emoasr_tpu_torch.models.decoders.ctc import CTCDecoder
from emoasr_tpu_torch.models.decoders.las import LASDecoder
from emoasr_tpu_torch.models.decoders.rnnt import RNNTDecoder
from emoasr_tpu_torch.models.decoders.transformer import TransformerDecoder
from emoasr_tpu_torch.models.encoders import build_encoder
from emoasr_tpu_torch.ops.ctc import ctc_forced_align
from emoasr_tpu_torch.ops.rnnt import rnnt_forced_align


class ASR(nn.Module):
    def __init__(self, cfg: ExpConfig):
        super().__init__()
        self.cfg = cfg
        self.encoder = build_encoder(cfg)
        if cfg.decoder_type == "ctc":
            self.decoder = CTCDecoder(cfg)
        elif cfg.decoder_type == "rnn_transducer":
            self.decoder = RNNTDecoder(cfg)
        elif cfg.decoder_type == "transformer":
            self.decoder = TransformerDecoder(cfg)
        elif cfg.decoder_type == "las":
            self.decoder = LASDecoder(cfg)
        else:
            raise ValueError(cfg.decoder_type)

    def forward(self, xs, xlens, ys, ylens, ys_in=None, ys_out=None,
                soft_labels=None, ps=None, plens=None):
        """-> (loss, loss_dict) (`asr.py:56-74`); the RNN-T decoder reads
        the eos-led `ys_in`, the attention decoder `ys_in` and `ys_out`."""
        eouts, elens, eouts_inter = self.encoder(xs, xlens)
        loss, loss_dict, _ = self.decoder(
            eouts, elens, eouts_inter, ys, ylens, ys_in, ys_out, soft_labels, ps, plens,
        )
        return loss, loss_dict

    def encode(self, xs, xlens):
        """-> (eouts, elens, eouts_inter)."""
        return self.encoder(xs, xlens)

    def decode_greedy(self, xs, xlens, decode_phone: bool = False):
        """Batched greedy decode -> (hyps, hyp_lens, logits, aligns)
        (`asr.py:70-95` + `ctc.py:176-201` / `rnn_transducer.py:194-240` /
        `las.py:175-280`; logits None for the RNN-T and LAS decoders,
        aligns None for LAS).  `decode_phone` decodes a CTC model's phone
        head, from the intermediate layer's output when the phone CTC is
        hierarchical (`hie_mtl_phone`)."""
        if self.cfg.decoder_type not in ("ctc", "rnn_transducer", "las"):
            raise NotImplementedError(
                f"greedy decode for {self.cfg.decoder_type}; use emoasr_tpu_torch.search"
            )
        eouts, elens, eouts_inter = self.encoder(xs, xlens)
        if self.cfg.decoder_type == "rnn_transducer":
            hyps, hyp_lens, aligns = self.decoder.greedy(eouts, elens)
            return hyps, hyp_lens, None, aligns
        if self.cfg.decoder_type == "las":
            hyps, hyp_lens = self.decoder.decode_greedy(eouts, elens)
            return hyps, hyp_lens, None, None
        if decode_phone and self.cfg.hie_mtl_phone:
            eouts = eouts_inter
        return self.decoder.greedy(eouts, elens, decode_phone)

    @torch.no_grad()
    def forced_align(self, xs, xlens, ys, ylens, ys_in=None):
        """Forced alignment of the reference labels (`asr.py:101-127`): a
        CTC model's (B, T') frame alignment, an RNN-T model's (B, U)
        emission frames (`ys_in`: the eos-led labels, made from `ys` when
        not given)."""
        cfg = self.cfg
        if cfg.decoder_type not in ("ctc", "rnn_transducer"):
            raise NotImplementedError(f"forced_align for decoder_type={cfg.decoder_type}")
        eouts, elens, _ = self.encoder(xs, xlens)
        if cfg.decoder_type == "ctc":
            log_probs = torch.log_softmax(self.decoder.logits(eouts).float(), dim=-1)
            return ctc_forced_align(log_probs, elens, ys, ylens, cfg.blank_id)
        if ys_in is None:
            ys_in = torch.cat([torch.full_like(ys[:, :1], cfg.eos_id), ys], dim=1)
        douts, _ = self.decoder.recurrency(ys_in)
        log_probs = torch.log_softmax(self.decoder.joint(eouts, douts).float(), dim=-1)
        return rnnt_forced_align(log_probs, elens, ys, ylens, cfg.blank_id)
