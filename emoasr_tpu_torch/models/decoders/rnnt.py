"""RNN-Transducer decoder: LSTM prediction network, additive joint network,
transducer loss and batched greedy decoding (PyTorch port of
`emoasr_tpu/models/decoders/rnnt.py`).

Parity target: emoASR `asr/modeling/decoders/rnn_transducer.py`:
- prediction network: embedding, embedding dropout, stacked one-layer
  LSTMs (:158-192), under the checkpoint names `decoder.embed.weight` and
  `decoder.rnns.{i}.{weight_ih_l0, weight_hh_l0, bias_ih_l0, bias_hh_l0}`;
- joint: tanh(W_enc e + W_dec d) -> output linear (:147-156), under
  `decoder.w_enc.*`, `decoder.w_dec.*`, `decoder.output.*`;
- loss: warp_rnnt's mean reduction (:106-115) -> `ops/rnnt.py`, in the
  yaml's `rnnt_joint_mode`: `full` (the (B, T, U+1, V) joint output, as
  emoASR), `chunked` (blank and label log-probabilities a time chunk at a
  time) or `pallas` (the fused joint kernel, ops/rnnt_joint.py: K7 on the
  card);
- auxiliary CTC (:119-125) under `decoder.ctc.*`, through the CTC decoder
  (K1 and K2 on the card);
- greedy decoding: time-synchronous, emit until blank, at most
  `max_decode_ylen` labels (:194-240), for the whole batch at once.

- distillation (:127-141) with `kd_weight` and soft labels: `kd_type`
  `word` (the soft cross-entropy over the whole (T, U) grid) or `align`
  (at the cells of the forced alignment, `ops/rnnt.py::rnnt_forced_align`,
  no gradient through it).  Either needs the joint's log-probabilities at
  every cell, so distillation switches the joint to `full`, whatever the
  yaml's mode (JAX `rnnt.py:94-95`): K7 does not run on that route.
- with the embedding and the output layer split over the model axis
  (`parallel/tensor.py`), the `pallas` and `chunked` joints run on the
  rank's vocabulary columns (`ops/rnnt_joint.py::joint_gather_shard`: K7
  with a column offset on the card); the `full` joint (and distillation)
  holds the rank's (B, T, U+1, V / m) columns, normalised over the whole
  vocabulary.

The ALSD beam search (:242-325) is in `emoasr_tpu_torch/search/rnnt_beam.py`.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
from torch import nn

from emoasr_tpu_torch.config import ExpConfig
from emoasr_tpu_torch.models.criteria import rnnt_align_distill_loss, rnnt_word_distill_loss
from emoasr_tpu_torch.models.decoders.ctc import CTCDecoder
from emoasr_tpu_torch.ops.lstm import StackedLSTM
from emoasr_tpu_torch.ops.rnnt import rnnt_alpha_rowscan, rnnt_forced_align, rnnt_gathered_from_joint, rnnt_loss
from emoasr_tpu_torch.ops.rnnt_joint import fused_joint_gather, joint_gather_shard
from emoasr_tpu_torch.parallel.mesh import batch_mean, copy_to_model
from emoasr_tpu_torch.parallel.vocab import log_softmax_shard, vocab_shard

JOINT_MODES = ("full", "chunked", "pallas")


class RNNTDecoder(nn.Module):
    def __init__(self, cfg: ExpConfig):
        super().__init__()
        self.cfg = cfg
        if cfg.rnnt_joint_mode not in JOINT_MODES:
            raise ValueError(f"rnnt_joint_mode={cfg.rnnt_joint_mode!r}: one of {JOINT_MODES}")
        emb = cfg.embedding_size or cfg.dec_hidden_size
        joint = cfg.joint_hidden_size or cfg.dec_hidden_size
        self.embed = nn.Embedding(cfg.vocab_size, emb)
        self.dropout_emb = nn.Dropout(cfg.dropout_emb_rate)
        self.rnns = StackedLSTM(emb, cfg.dec_hidden_size, cfg.dec_num_layers, cfg.dropout_dec_rate)
        self.w_enc = nn.Linear(cfg.enc_hidden_size, joint)
        self.w_dec = nn.Linear(cfg.dec_hidden_size, joint)
        self.output = nn.Linear(joint, cfg.vocab_size)
        if cfg.mtl_ctc_weight > 0:
            self.ctc = CTCDecoder(cfg)

    # ---- submodules

    def recurrency(self, ys_in: torch.Tensor, dstate: Optional[torch.Tensor] = None):
        """Prediction network over (B, L) tokens; dstate (layers, 2, B, H)
        or None -> (douts (B, L, H), new dstate)."""
        emb = self.dropout_emb(self.embed(ys_in.long()))
        return self.rnns(emb, dstate)

    def joint(self, eouts: torch.Tensor, douts: torch.Tensor) -> torch.Tensor:
        """(B, T, E) x (B, L, D) -> (B, T, L, V)."""
        e = self.w_enc(eouts)[:, :, None, :]
        d = self.w_dec(douts)[:, None, :, :]
        return self.output(torch.tanh(e + d))

    def joint_step(self, eouts_t: torch.Tensor, douts_t: torch.Tensor) -> torch.Tensor:
        """(N, E) x (N, D) -> (N, V): one cell of the joint, for decoding."""
        return self.output(torch.tanh(self.w_enc(eouts_t) + self.w_dec(douts_t)))

    # ---- training

    def forward(self, eouts, elens, eouts_inter=None, ys=None, ylens=None, ys_in=None, ys_out=None,
                soft_labels=None, ps=None, plens=None):
        """-> (loss, loss_dict, logits): `ys_in` (B, U+1) is the eos-led
        label sequence (data/asr_dataset.py); `logits` is the joint output
        in the `full` mode (and on the distillation route), else None."""
        cfg = self.cfg
        loss_dict = {}
        douts, _ = self.recurrency(ys_in)  # (B, U+1, H)
        use_kd = cfg.kd_weight > 0 and soft_labels is not None
        shard = vocab_shard(self.output)
        logits = None
        if use_kd or cfg.rnnt_joint_mode == "full":
            logits = self.joint(eouts, douts)
            if shard is None:
                log_probs = torch.log_softmax(logits.float(), dim=-1)
            else:  # the rank's columns, normalised over the whole vocabulary
                log_probs = log_softmax_shard(logits, shard)
            loss_rnnt = rnnt_loss(log_probs, ys, elens, ylens, cfg.blank_id, reduction="mean", shard=shard)
        else:
            h_enc, h_dec = self.w_enc(eouts), self.w_dec(douts)
            w_out, b_out = self.output.weight.t(), self.output.bias  # (J, V): read in place
            if shard is not None:  # the rank's columns; h_enc's and h_dec's gradients summed over the group
                h_enc, h_dec = copy_to_model(h_enc, shard.group), copy_to_model(h_dec, shard.group)
                lp_blank, lp_label = joint_gather_shard(h_enc, h_dec, w_out, b_out, ys, cfg.blank_id, shard,
                                                        cfg.rnnt_joint_mode)
            else:
                gather = fused_joint_gather if cfg.rnnt_joint_mode == "pallas" else rnnt_gathered_from_joint
                lp_blank, lp_label = gather(h_enc, h_dec, w_out, b_out, ys, cfg.blank_id)
            loss_rnnt = -batch_mean(rnnt_alpha_rowscan(lp_blank, lp_label, elens, ylens))
        loss = loss_rnnt
        loss_dict["loss_rnnt"] = loss_rnnt
        if cfg.mtl_ctc_weight > 0:
            loss_ctc, _, _ = self.ctc(eouts, elens, ys=ys, ylens=ylens)
            loss = loss + cfg.mtl_ctc_weight * loss_ctc
            loss_dict["loss_ctc"] = loss_ctc
        if use_kd:
            if cfg.kd_type == "word":
                loss_kd = rnnt_word_distill_loss(logits, soft_labels, elens, ylens, log_probs=log_probs, shard=shard)
            else:  # align
                aligns = rnnt_forced_align(log_probs.detach(), elens, ys, ylens, cfg.blank_id, shard)
                loss_kd = rnnt_align_distill_loss(logits, soft_labels, aligns, elens, ylens, shard=shard)
            loss_dict["loss_kd"] = loss_kd
            if cfg.reduce_main_loss_kd:
                loss = (1 - cfg.kd_weight) * loss + cfg.kd_weight * loss_kd
            else:
                loss = loss + cfg.kd_weight * loss_kd
        loss_dict["loss_total"] = loss
        return loss, loss_dict, logits

    # ---- inference

    @torch.no_grad()
    def greedy(self, eouts: torch.Tensor, elens: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """Batched time-synchronous greedy decode -> (hyps (B, L) int32,
        hyp_lens (B,), aligns (B, T + L)), L = `max_decode_ylen`.

        Each step evaluates the joint at (t, the state after the last
        emitted label) for every row: blank (or a finished row) advances t,
        a label is emitted and advances the prediction network.  The
        network runs for every row each step and its output is kept where
        a row emitted, as in the JAX package's `lax.while_loop`; the loop
        reads one "all done" flag back a step and runs at most T + L
        steps.  `torch.argmax` takes the first of equal logits, as
        `jnp.argmax` does."""
        cfg = self.cfg
        B, T, _ = eouts.shape
        L, dev = cfg.max_decode_ylen, eouts.device
        elens = elens.to(dev)
        max_steps = T + L
        rows = torch.arange(B, device=dev)
        d0 = eouts.new_zeros((cfg.dec_num_layers, 2, B, cfg.dec_hidden_size))
        dout, dstate = self.recurrency(torch.full((B, 1), cfg.eos_id, dtype=torch.long, device=dev), d0)
        dout = dout[:, 0]
        t = torch.zeros(B, dtype=torch.long, device=dev)
        u = torch.zeros(B, dtype=torch.long, device=dev)
        done = torch.zeros(B, dtype=torch.bool, device=dev)
        hyps = torch.zeros((B, L), dtype=torch.int32, device=dev)
        aligns = torch.zeros((B, max_steps), dtype=torch.int32, device=dev)
        for step in range(max_steps):
            if bool(done.all()):
                break
            e_t = eouts[rows, t.clamp(max=T - 1)]
            tok = torch.argmax(self.joint_step(e_t, dout), dim=-1)
            active = ~done
            is_blank = (tok == cfg.blank_id) | ~active
            aligns[:, step] = torch.where(active, tok, torch.zeros_like(tok)).to(torch.int32)
            emit = active & ~is_blank
            slot = u.clamp(max=L - 1)
            hyps[rows, slot] = torch.where(emit, tok.to(torch.int32), hyps[rows, slot])
            u = torch.where(emit, u + 1, u)
            new_dout, new_dstate = self.recurrency(tok[:, None], dstate)
            dout = torch.where(emit[:, None], new_dout[:, 0], dout)
            dstate = torch.where(emit[None, None, :, None], new_dstate, dstate)
            t = torch.where(active & is_blank, t + 1, t)
            done = done | (t >= elens) | (u >= L)
        return hyps, u.to(torch.int32), aligns
