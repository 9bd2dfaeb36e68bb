"""Plain reference of emoASR's RNN-T(Conformer) (README L4): conv2d
subsampling, relative positions (input scaled by sqrt(d), a sinusoid
table of offsets T-1 .. -(T-1)), Conformer layers (Gulati et al. 2020:
half-step swish feed-forward, Transformer-XL relative attention with
pos_bias_u / pos_bias_v, the convolution module, a second half-step
feed-forward, a final LayerNorm; inner LayerNorms at eps 1e-6), a final
LayerNorm eps 1e-12; the prediction network (embedding, dropout, one
LSTM layer with gates i, f, g, o) over the eos-led labels; the joint
tanh(W_enc e + W_dec d) -> linear over the vocabulary; the transducer
loss averaged over the batch.  Parameter names follow emoASR's
checkpoints."""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from reference import common

LN_EPS = 1e-6


class Layer(nn.Module):
    def __init__(self, cfg: dict):
        super().__init__()
        d, f = cfg["enc_hidden_size"], cfg["enc_intermediate_size"]
        self.norm_ff_macaron = nn.LayerNorm(d, eps=LN_EPS)
        self.feed_forward_macaron = common.FeedForward(d, f, "swish")
        self.norm_self_attn = nn.LayerNorm(d, eps=LN_EPS)
        self.self_attn = common.SelfAttention(d, cfg["enc_num_attention_heads"], rel=True)
        self.norm_conv = nn.LayerNorm(d, eps=LN_EPS)
        self.conv = common.ConvModule(d, cfg["conv_kernel_size"])
        self.norm_ff = nn.LayerNorm(d, eps=LN_EPS)
        self.feed_forward = common.FeedForward(d, f, "swish")
        self.norm_final = nn.LayerNorm(d, eps=LN_EPS)
        self.p = cfg["dropout_enc_rate"]

    def forward(self, x, lens, drop, pos_emb):
        p, tr = self.p, self.training
        x = x + 0.5 * F.dropout(self.feed_forward_macaron(self.norm_ff_macaron(x), p), p, tr)
        x = x + F.dropout(self.self_attn(self.norm_self_attn(x), lens, drop, pos_emb), p, tr)
        x = x + F.dropout(self.conv(self.norm_conv(x)), p, tr)
        x = x + 0.5 * F.dropout(self.feed_forward(self.norm_ff(x), p), p, tr)
        return self.norm_final(x)


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
        T = x.shape[1]
        pos = torch.cat([torch.arange(T - 1, 0, -1, device=x.device), torch.arange(0, -T, -1, device=x.device)])
        x = F.dropout(x * math.sqrt(self.d), self.p, self.training)
        pe = F.dropout(common.sinusoid(pos, self.d)[None], self.p, self.training)
        for layer in self.transformers:
            x = layer(x, elens, drop, pe)
        return self.norm(x), elens


class LSTM(nn.Module):
    """One LSTM layer, `nn.LSTM`'s parameter names, a step at a time."""

    def __init__(self, n_in: int, h: int):
        super().__init__()
        self.h = h
        self.weight_ih_l0 = nn.Parameter(torch.zeros(4 * h, n_in))
        self.weight_hh_l0 = nn.Parameter(torch.zeros(4 * h, h))
        self.bias_ih_l0 = nn.Parameter(torch.zeros(4 * h))
        self.bias_hh_l0 = nn.Parameter(torch.zeros(4 * h))

    def forward(self, x):
        B, L, _ = x.shape
        gx = x @ self.weight_ih_l0.t() + self.bias_ih_l0 + self.bias_hh_l0
        h = x.new_zeros((B, self.h))
        c = x.new_zeros((B, self.h))
        out = []
        for t in range(L):
            i, f, g, o = (gx[:, t] + h @ self.weight_hh_l0.t()).chunk(4, dim=-1)
            c = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(g)
            h = torch.sigmoid(o) * torch.tanh(c)
            out.append(h)
        return torch.stack(out, dim=1)


class Decoder(nn.Module):
    def __init__(self, cfg: dict):
        super().__init__()
        emb, hid, joint = cfg["embedding_size"], cfg["dec_hidden_size"], cfg["joint_hidden_size"]
        self.embed = nn.Embedding(cfg["vocab_size"], emb)
        self.rnns = nn.ModuleList([LSTM(emb, hid)])
        self.w_enc = nn.Linear(cfg["enc_hidden_size"], joint)
        self.w_dec = nn.Linear(hid, joint)
        self.output = nn.Linear(joint, cfg["vocab_size"])
        self.p = cfg["dropout_emb_rate"]

    def predict(self, ys_in):
        return self.rnns[0](F.dropout(self.embed(ys_in.long()), self.p, self.training))


class Model(nn.Module):
    def __init__(self, cfg: dict):
        super().__init__()
        self.cfg = cfg
        self.encoder = Encoder(cfg)
        self.decoder = Decoder(cfg)


def train_loss(model: Model, batch: dict, sa_gen, drop) -> torch.Tensor:
    """The training loss of one batch: SpecAugment, the encoder, the
    prediction network over [eos] + labels, the whole joint, the lattice;
    the negative log-likelihoods averaged over the batch's rows."""
    cfg = model.cfg
    xs = common.spec_augment(sa_gen, batch["xs"], batch["xlens"], cfg) if cfg["spec_augment"] else batch["xs"]
    eouts, elens = model.encoder(xs, batch["xlens"], drop)
    ys = batch["ys"].long()
    ys_in = torch.cat([torch.full_like(ys[:, :1], cfg["eos_id"]), ys], dim=1)
    dec = model.decoder
    douts = dec.predict(ys_in)
    z = torch.tanh(dec.w_enc(eouts)[:, :, None, :] + dec.w_dec(douts)[:, None, :, :])
    lp = torch.log_softmax(dec.output(z), dim=-1)  # (B, T, U+1, V)
    lp_blank = lp[..., cfg["blank_id"]]
    lp_label = torch.gather(lp[:, :, :-1], 3, ys[:, None, :, None].expand(-1, lp.shape[1], -1, 1))[..., 0]
    del lp
    return -common.rnnt_ll(lp_blank, lp_label, elens, batch["ylens"]).mean()
