"""Plain reference of emoASR's CTC(Transformer) (README L1): conv2d
subsampling, sinusoidal positions (input scaled by sqrt(d)), pre-norm
Transformer layers (LayerNorm eps 1e-12, ReLU feed-forward), a final
LayerNorm, a linear head over the vocabulary and the CTC loss summed over
the batch and divided by its rows.  Dropout at the rates of the
configuration after the positions, on each sub-layer's output, inside the
feed-forward and on the attention probabilities.  Parameter names follow
emoASR's checkpoints."""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from reference import common


class Layer(nn.Module):
    def __init__(self, cfg: dict):
        super().__init__()
        d = cfg["enc_hidden_size"]
        self.norm1 = nn.LayerNorm(d, eps=1e-12)
        self.self_attn = common.SelfAttention(d, cfg["enc_num_attention_heads"], rel=False)
        self.norm2 = nn.LayerNorm(d, eps=1e-12)
        self.feed_forward = common.FeedForward(d, cfg["enc_intermediate_size"], "relu")
        self.p = cfg["dropout_enc_rate"]

    def forward(self, x, lens, drop):
        x = x + F.dropout(self.self_attn(self.norm1(x), lens, drop), self.p, self.training)
        return x + F.dropout(self.feed_forward(self.norm2(x), self.p), self.p, self.training)


class Encoder(nn.Module):
    def __init__(self, cfg: dict):
        super().__init__()
        d = cfg["enc_hidden_size"]
        self.conv = common.Subsampler(cfg["feat_dim"], d)
        self.transformers = nn.ModuleList(Layer(cfg) for _ in range(cfg["enc_num_layers"]))
        self.norm = nn.LayerNorm(d, eps=1e-12)
        self.d, self.p = d, cfg["dropout_enc_rate"]

    def forward(self, xs, xlens, drop):
        x, elens = self.conv(xs, xlens)
        pe = common.sinusoid(torch.arange(x.shape[1], device=x.device), self.d)
        x = F.dropout(x * math.sqrt(self.d) + pe[None], self.p, self.training)
        for layer in self.transformers:
            x = layer(x, elens, drop)
        return self.norm(x), elens


class Head(nn.Module):
    def __init__(self, cfg: dict):
        super().__init__()
        self.output = nn.Linear(cfg["enc_hidden_size"], cfg["vocab_size"])


class Model(nn.Module):
    def __init__(self, cfg: dict):
        super().__init__()
        self.cfg = cfg
        self.encoder = Encoder(cfg)
        self.decoder = Head(cfg)

    def logits(self, xs, xlens, drop=None):
        """(B, T', V) head outputs and (B,) lengths (eval mode: no dropout)."""
        eouts, elens = self.encoder(xs, xlens, drop)
        return self.decoder.output(eouts), elens


def train_loss(model: Model, batch: dict, sa_gen, drop) -> torch.Tensor:
    """The training loss of one batch: SpecAugment, the forward, CTC."""
    cfg = model.cfg
    xs = common.spec_augment(sa_gen, batch["xs"], batch["xlens"], cfg) if cfg["spec_augment"] else batch["xs"]
    logits, elens = model.logits(xs, batch["xlens"], drop)
    nll = common.ctc_nll(logits, elens, batch["ys"], batch["ylens"], cfg["blank_id"])
    return nll.sum() / xs.shape[0]
