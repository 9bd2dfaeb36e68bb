"""LAS (listen, attend and spell) decoder: LSTM cells with location-aware
attention (PyTorch port of `emoasr_tpu/models/decoders/las.py`).

Parity target: emoASR `asr/modeling/decoders/las.py:22-342`: embedding +
stacked LSTM cells whose first layer's output drives the attention;
location-aware attention (a 1-D convolution over the previous attention
weights, kernel 201, 10 channels, no bias, then
score = w_score tanh(W_k e + W_q d + W_c conv)); the generated vector
tanh(intermed([ctx; d_top])) and one output linear over all steps;
label-smoothing or distillation loss, the auxiliary CTC through the CTC
decoder (the CTC head and lattice kernels on the card).  The reference
wires LAS but leaves it unreachable from its facade and stubs its beam's
LM hooks; the JAX package and this port make it a first-class decoder.

The encoder-side key projection is computed once, outside the step loop.
The teacher-forced pass and the decoding steps are Python loops over label
positions; a step's LSTM cells are single steps in plain PyTorch, as the
JAX package runs them in a `lax.scan` outside any Pallas kernel, and the
201-tap convolution is `F.conv1d` (JAX: `lax.conv_general_dilated`).
Parameter names are emoASR's: `embed`, `rnns.{i}` (`nn.LSTMCell`),
`score.{w_key,w_query,w_conv,w_score,conv}`, `intermed`, `output`, `ctc`.
With `embed` and `output` split over the model axis (`parallel/tensor.py`)
the losses take the rank's vocabulary columns (`parallel/vocab.py`).
"""

from __future__ import annotations

from typing import List, Tuple

import torch
from torch import nn

from emoasr_tpu_torch.config import ExpConfig
from emoasr_tpu_torch.models.criteria import distill_loss, label_smoothing_loss
from emoasr_tpu_torch.models.decoders.ctc import CTCDecoder
from emoasr_tpu_torch.parallel.vocab import vocab_shard
from emoasr_tpu_torch.models.layers import NEG_INF, make_pad_mask
from emoasr_tpu_torch.search.las_beam import las_beam_search

# (hs, cs, ctx, attn_w): per-layer (B, H) states, the (B, E) context and the
# (B, T) previous attention weights
Carry = Tuple[List[torch.Tensor], List[torch.Tensor], torch.Tensor, torch.Tensor]


def _lstm_cell(x, h, c, cell: nn.LSTMCell):
    gates = x @ cell.weight_ih.t() + cell.bias_ih + h @ cell.weight_hh.t() + cell.bias_hh
    i, f, g, o = gates.chunk(4, dim=-1)
    c = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(g)
    h = torch.sigmoid(o) * torch.tanh(c)
    return h, c


class LocationAwareAttention(nn.Module):
    """emoASR's `score` module: the key, query and conv projections, the
    score vector and the convolution over the previous weights."""

    def __init__(self, enc_size: int, dec_size: int, attn_dim: int, channels: int, kernel_size: int):
        super().__init__()
        self.w_key = nn.Linear(enc_size, attn_dim)
        self.w_query = nn.Linear(dec_size, attn_dim)
        self.w_conv = nn.Linear(channels, attn_dim)
        self.w_score = nn.Linear(attn_dim, 1)
        self.conv = nn.Conv1d(1, channels, kernel_size, padding=kernel_size // 2, bias=False)

    def forward(self, keys_proj, d, attn_w, eouts, mask):
        """keys_proj (B, T, A), d (B, H) the first layer's output, attn_w
        (B, T), mask (B, T) -> (ctx (B, E), attn_w (B, T))."""
        conv = self.conv(attn_w[:, None, :]).transpose(1, 2)  # (B, T, C)
        score = self.w_score(torch.tanh(keys_proj + self.w_query(d)[:, None, :] + self.w_conv(conv)))[..., 0]
        score = torch.where(mask, score, torch.full_like(score, NEG_INF))
        attn_w = torch.softmax(score.float(), dim=1).to(eouts.dtype)
        return torch.einsum("bt,btd->bd", attn_w, eouts), attn_w


class LASDecoder(nn.Module):
    def __init__(self, cfg: ExpConfig, attn_dim: int = 256, conv_out_channels: int = 10,
                 conv_kernel_size: int = 201):
        super().__init__()
        self.cfg = cfg
        emb_size = cfg.embedding_size or cfg.dec_hidden_size
        H, E = cfg.dec_hidden_size, cfg.enc_hidden_size
        self.embed = nn.Embedding(cfg.vocab_size, emb_size)
        self.rnns = nn.ModuleList(
            nn.LSTMCell(emb_size + E if i == 0 else H, H) for i in range(cfg.dec_num_layers)
        )
        self.score = LocationAwareAttention(E, H, attn_dim, conv_out_channels, conv_kernel_size)
        self.intermed = nn.Linear(E + H, cfg.dec_intermediate_size)
        self.output = nn.Linear(cfg.dec_intermediate_size, cfg.vocab_size)
        if cfg.mtl_ctc_weight > 0:
            self.ctc = CTCDecoder(cfg)

    def init_carry(self, eouts) -> Carry:
        B, T, E = eouts.shape
        H = self.cfg.dec_hidden_size
        z = eouts.new_zeros((B, H))
        return ([z] * len(self.rnns), [z] * len(self.rnns), eouts.new_zeros((B, E)), eouts.new_zeros((B, T)))

    def _step(self, y_emb, carry: Carry, keys_proj, eouts, mask):
        """One label position -> (carry, the generated vector (B, I))."""
        hs, cs, ctx, attn_w = carry
        x = torch.cat([y_emb, ctx], dim=-1)
        new_hs, new_cs = [], []
        for cell, h, c in zip(self.rnns, hs, cs):
            x, c = _lstm_cell(x, h, c, cell)
            new_hs.append(x)
            new_cs.append(c)
        ctx, attn_w = self.score(keys_proj, new_hs[0], attn_w, eouts, mask)
        gen = torch.tanh(self.intermed(torch.cat([ctx, x], dim=-1)))
        return (new_hs, new_cs, ctx, attn_w), gen

    def make_step(self, eouts, elens):
        """(step(carry, tokens (B,)) -> (carry, log-probs (B, V) float32),
        carry0) for decoding; the key projection is computed here, once."""
        mask = make_pad_mask(elens, eouts.shape[1])
        keys_proj = self.score.w_key(eouts)

        def step(carry, tokens):
            carry, gen = self._step(self.embed(tokens.long()), carry, keys_proj, eouts, mask)
            return carry, torch.log_softmax(self.output(gen).float(), dim=-1)

        return step, self.init_carry(eouts)

    def teacher_forced_logits(self, eouts, elens, ys_in):
        """(B, L) eos-led labels -> (B, L, V) logits."""
        mask = make_pad_mask(elens, eouts.shape[1])
        keys_proj = self.score.w_key(eouts)
        emb = self.embed(ys_in.long())
        carry = self.init_carry(eouts)
        gens = []
        for t in range(emb.shape[1]):
            carry, gen = self._step(emb[:, t], carry, keys_proj, eouts, mask)
            gens.append(gen)
        return self.output(torch.stack(gens, dim=1))

    @torch.no_grad()
    def decode_greedy(self, eouts, elens):
        """Batched greedy decode (the reference's decode at width 1, las.py:
        175-280) -> (hyps (B, max_decode_ylen) int32, hyp_lens (B,) int32),
        labels without eos.  One flag is read back a step; the loop stops
        when every row has emitted eos."""
        cfg = self.cfg
        B, L = eouts.shape[0], cfg.max_decode_ylen
        dev = eouts.device
        step, carry = self.make_step(eouts, elens)
        tok = torch.full((B,), cfg.eos_id, dtype=torch.int64, device=dev)
        done = torch.zeros((B,), dtype=torch.bool, device=dev)
        hyps = torch.zeros((B, L), dtype=torch.int64, device=dev)
        n = torch.zeros((B,), dtype=torch.int64, device=dev)
        rows = torch.arange(B, device=dev)
        for _ in range(L):
            carry, logp = step(carry, tok)
            tok = logp.argmax(dim=-1)
            emit = ~done & (tok != cfg.eos_id)
            at = n.clamp(max=L - 1)
            hyps[rows, at] = torch.where(emit, tok, hyps[rows, at])
            n = n + emit.long()
            done = done | (tok == cfg.eos_id)
            if bool(done.all()):
                break
        return hyps.to(torch.int32), n.to(torch.int32)

    @torch.no_grad()
    def decode_beam(self, eouts, elens, beam_width: int, len_weight: float = 0.0, lm=None):
        """Batched beam search (`search/las_beam.py`) -> (hyps (B, W, Lmax)
        with eos framing, lens, scores), best-first; `lm` an `LMFusion`."""
        cfg = self.cfg
        B, T, E = eouts.shape
        W = beam_width
        step, carry0 = self.make_step(eouts[:, None].expand(B, W, T, E).reshape(B * W, T, E),
                                      elens[:, None].expand(B, W).reshape(B * W))
        return las_beam_search(step, carry0, B, vocab_size=cfg.vocab_size, beam_width=W, eos_id=cfg.eos_id,
                               len_weight=len_weight, max_decode_ylen=cfg.max_decode_ylen, lm=lm)

    def forward(self, eouts, elens, eouts_inter=None, ys=None, ylens=None, ys_in=None, ys_out=None,
                soft_labels=None, ps=None, plens=None):
        """Without `ys_out`: the teacher-forced logits (B, L, V).  With it:
        (loss, loss_dict, logits) (las.py:292-341): `loss_att` (label
        smoothing over ylens + 1 positions), or with `kd_weight` and soft
        labels `distill_loss`'s mix (`loss_kd`, `loss_att`); plus
        `mtl_ctc_weight` x `loss_ctc`; `loss_total`."""
        cfg = self.cfg
        logits = self.teacher_forced_logits(eouts, elens, ys_in)
        if ys_out is None:
            return logits
        shard = vocab_shard(self.output)  # the rank's columns of split logits
        if cfg.kd_weight > 0 and soft_labels is not None:
            loss, loss_kd, loss_att = distill_loss(
                logits, ys_out, soft_labels, ylens + 1, soft_label_weight=cfg.kd_weight, lsm_prob=cfg.lsm_prob,
                normalize_length=cfg.loss_normalize_length, normalize_batch=cfg.loss_normalize_batch, shard=shard,
            )
            loss_dict = {"loss_kd": loss_kd, "loss_att": loss_att}
        else:
            loss = label_smoothing_loss(
                logits, ys_out, ylens + 1, lsm_prob=cfg.lsm_prob,
                normalize_length=cfg.loss_normalize_length, normalize_batch=cfg.loss_normalize_batch,
                shard=shard,
            )
            loss_dict = {"loss_att": loss}
        if cfg.mtl_ctc_weight > 0:
            loss_ctc, _, _ = self.ctc(eouts, elens, ys=ys, ylens=ylens)
            loss = loss + cfg.mtl_ctc_weight * loss_ctc
            loss_dict["loss_ctc"] = loss_ctc
        loss_dict["loss_total"] = loss
        return loss, loss_dict, logits
