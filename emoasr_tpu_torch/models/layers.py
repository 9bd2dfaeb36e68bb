"""Transformer encoder building blocks (PyTorch port of the Transformer
parts of `emoasr_tpu/models/layers.py`).

Module and parameter names are emoASR's torch `state_dict` names
(emoASR `asr/modeling/transformer.py`, `encoders/conv.py`), so a
port `state_dict` is a reference-layout checkpoint.

Semantics kept from the JAX package: sinusoidal PE with sqrt(d) input
scaling; pre-norm MHSA/FF layers with LayerNorm eps=1e-12; attention scores
filled with -1e9 at padded keys before an f32 softmax and zeroed after it,
the probabilities cast to v.dtype before the AV product; two VALID 3x3
stride-2 convs + ReLU with xlens' = ((l-1)//2 - 1)//2.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
from torch import nn

from emoasr_tpu_torch.ops.attention import fused_self_attention

NEG_INF = -1e9  # mask fill for attention scores (float32-safe)


def sinusoidal_pe(length: int, dim: int, device=None, dtype=torch.float32) -> torch.Tensor:
    """(length, dim) sinusoidal table: sin on even, cos on odd channels."""
    pos = torch.arange(length, dtype=torch.float32, device=device)[:, None]
    div = torch.exp(
        torch.arange(0, dim, 2, dtype=torch.float32, device=device)
        * -(math.log(10000.0) / dim)
    )
    pe = torch.zeros((length, dim), dtype=torch.float32, device=device)
    pe[:, 0::2] = torch.sin(pos * div)
    pe[:, 1::2] = torch.cos(pos * div)
    return pe.to(dtype)


def make_pad_mask(lens: torch.Tensor, maxlen: int) -> torch.Tensor:
    """(B, maxlen) True at valid positions (model_utils.py:6-29)."""
    return torch.arange(maxlen, device=lens.device)[None, :] < lens[:, None]


class PositionalEncoder(nn.Module):
    """x * sqrt(d) + PE, then dropout (transformer.py:15-46)."""

    def __init__(self, hidden_size: int, dropout_rate: float = 0.1):
        super().__init__()
        self.hidden_size = hidden_size
        self.dropout = nn.Dropout(dropout_rate)

    def forward(self, xs: torch.Tensor) -> torch.Tensor:
        pe = sinusoidal_pe(xs.shape[1], self.hidden_size, xs.device, xs.dtype)
        return self.dropout(xs * math.sqrt(self.hidden_size) + pe[None])


class MultiHeadAttention(nn.Module):
    """Scaled dot-product MHA with boolean masking (transformer.py:48-99).

    mask: bool, broadcastable to (B, 1, Tq, Tk); True = attend.  With
    `fused` and `lens` given, the score pipeline runs in the fused kernel
    (ops/attention.py), masking keys by `lens` (which must agree with
    `mask`); in training it draws one fresh dropout seed per call from
    `dropout_generator` (PyTorch's global CPU generator when None)."""

    def __init__(self, num_heads: int, hidden_size: int, dropout_rate: float = 0.0,
                 fused: bool = False):
        super().__init__()
        self.num_heads = num_heads
        self.hidden_size = hidden_size
        self.d_k = hidden_size // num_heads
        self.dropout_rate = dropout_rate
        self.fused = fused
        self.linear_q = nn.Linear(hidden_size, hidden_size)
        self.linear_k = nn.Linear(hidden_size, hidden_size)
        self.linear_v = nn.Linear(hidden_size, hidden_size)
        self.linear_out = nn.Linear(hidden_size, hidden_size)
        self.attn_drop = nn.Dropout(dropout_rate)
        self.dropout_generator: Optional[torch.Generator] = None

    def _qkv(self, q_in, k_in, v_in):
        B = q_in.shape[0]
        shape = lambda x: x.reshape(B, -1, self.num_heads, self.d_k)
        return (
            shape(self.linear_q(q_in)),
            shape(self.linear_k(k_in)),
            shape(self.linear_v(v_in)),
        )

    def _attend(self, scores, v, mask):
        # scores: (B, H, Tq, Tk) -- softmax in float32
        if mask is not None:
            scores = scores.masked_fill(~mask, NEG_INF)
        attn = torch.softmax(scores.float(), dim=-1)
        if mask is not None:
            attn = attn.masked_fill(~mask, 0.0)
        attn = self.attn_drop(attn.to(v.dtype))
        out = torch.einsum("bhqk,bkhd->bqhd", attn, v)
        B, Tq = out.shape[0], out.shape[1]
        return self.linear_out(out.reshape(B, Tq, self.hidden_size))

    def forward(self, q_in, k_in, v_in, mask=None, lens: Optional[torch.Tensor] = None):
        q, k, v = self._qkv(q_in, k_in, v_in)
        if self.fused and lens is not None:
            out = fused_self_attention(
                q, k, v, lens,
                scale=1.0 / math.sqrt(self.d_k),
                dropout_rate=self.dropout_rate,
                deterministic=not self.training,
                generator=self.dropout_generator,
            )
            B, Tq = out.shape[0], out.shape[1]
            return self.linear_out(out.reshape(B, Tq, self.hidden_size))
        scores = torch.einsum("bqhd,bkhd->bhqk", q, k) / math.sqrt(self.d_k)
        return self._attend(scores, v, mask)


class PositionwiseFeedForward(nn.Module):
    """w2(drop(relu(w1(x)))) (transformer.py:102-118)."""

    def __init__(self, intermediate_size: int, hidden_size: int, dropout_rate: float = 0.0):
        super().__init__()
        self.w1 = nn.Linear(hidden_size, intermediate_size)
        self.w2 = nn.Linear(intermediate_size, hidden_size)
        self.dropout = nn.Dropout(dropout_rate)

    def forward(self, x):
        return self.w2(self.dropout(torch.relu(self.w1(x))))


class TransformerEncoderLayer(nn.Module):
    """Pre-norm MHSA + FF with residuals, eps=1e-12 (transformer.py:121-153)."""

    def __init__(self, num_heads: int, hidden_size: int, intermediate_size: int,
                 dropout_rate: float = 0.1, dropout_attn_rate: float = 0.1,
                 fused_attn: bool = False):
        super().__init__()
        self.norm1 = nn.LayerNorm(hidden_size, eps=1e-12)
        self.self_attn = MultiHeadAttention(
            num_heads, hidden_size, dropout_attn_rate, fused=fused_attn
        )
        self.norm2 = nn.LayerNorm(hidden_size, eps=1e-12)
        self.feed_forward = PositionwiseFeedForward(
            intermediate_size, hidden_size, dropout_rate
        )
        self.dropout = nn.Dropout(dropout_rate)

    def forward(self, x, mask=None, lens: Optional[torch.Tensor] = None):
        h = self.norm1(x)
        x = x + self.dropout(self.self_attn(h, h, h, mask, lens=lens))
        h = self.norm2(x)
        return x + self.dropout(self.feed_forward(h))


class Conv2dSubsampler(nn.Module):
    """Two VALID 3x3 stride-2 convs + ReLU + linear: 4x time reduction,
    xlens' = ((l-1)//2 - 1)//2 (encoders/conv.py:5-28).

    The flatten is channel-major, (B, C, T2, F2) -> (B, T2, C * F2), as in
    the reference and the JAX package."""

    def __init__(self, input_dim: int, output_dim: int):
        super().__init__()
        self.conv = nn.Sequential(
            nn.Conv2d(1, output_dim, 3, 2),
            nn.ReLU(),
            nn.Conv2d(output_dim, output_dim, 3, 2),
            nn.ReLU(),
        )
        f2 = ((input_dim - 1) // 2 - 1) // 2
        self.output = nn.Linear(output_dim * f2, output_dim)

    def forward(self, xs, xlens):
        h = self.conv(xs[:, None])  # (B, C, T2, F2)
        B, C, T2, F2 = h.shape
        h = self.output(h.transpose(1, 2).reshape(B, T2, C * F2))
        new_lens = torch.div(torch.div(xlens - 1, 2, rounding_mode="floor") - 1, 2,
                             rounding_mode="floor")
        return h, new_lens
