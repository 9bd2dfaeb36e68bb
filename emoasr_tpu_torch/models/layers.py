"""Transformer / Conformer building blocks (PyTorch port of
`emoasr_tpu/models/layers.py`).

Module and parameter names are emoASR's torch `state_dict` names
(emoASR `asr/modeling/transformer.py`, `conformer.py`, `encoders/conv.py`),
so a port `state_dict` is a reference-layout checkpoint.

Semantics kept from the JAX package: sinusoidal PE with sqrt(d) input
scaling; pre-norm MHSA/FF layers with LayerNorm eps=1e-12; attention scores
filled with -1e9 at padded keys before an f32 softmax and zeroed after it,
the probabilities cast to v.dtype before the AV product; two VALID 3x3
stride-2 convs + ReLU with xlens' = ((l-1)//2 - 1)//2.  Conformer:
Transformer-XL relative-position MHSA with pos_bias_u/v and rel_shift, conv
module (pointwise -> GLU -> depthwise k=31 -> BatchNorm -> swish ->
pointwise), macaron FF scaled by 0.5, inner LayerNorms at the JAX package's
epsilon (`CONFORMER_LN_EPS`).

The decoder layer's incremental steps write the new K/V into the caches
they are given, in place, and return those same tensors (the JAX package
returns updated copies).
"""

from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from emoasr_tpu_torch.ops.attention import fused_self_attention
from emoasr_tpu_torch.ops.decoder_step import (
    PackedWeights,
    fused_decoder_layer_step,
    fused_decoder_layer_step_indirect,
)
from emoasr_tpu_torch.parallel.mesh import batch_stats, dropout, rows_block

NEG_INF = -1e9  # mask fill for attention scores (float32-safe)
# The Conformer block's inner LayerNorms.  The JAX package builds them as
# `nn.LayerNorm()` and so runs them at flax's default epsilon, 1e-6 (its
# docstring names the emoASR reference's 1e-5, torch's default); the port
# computes what the JAX package computes.  Outputs differ by some 1e-5
# between the two values (ROADMAP.md §3).
CONFORMER_LN_EPS = 1e-6


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


def set_dropout_generator(model: nn.Module, generator: torch.Generator) -> None:
    """Draw the fused attention's dropout seeds of every layer of `model`
    from `generator` (the other dropout layers keep PyTorch's global
    generator)."""
    for m in model.modules():
        if hasattr(m, "dropout_generator"):
            m.dropout_generator = generator


def make_causal_mask(length: int, device=None) -> torch.Tensor:
    return torch.tril(torch.ones((length, length), dtype=torch.bool, device=device))


class PositionalEncoder(nn.Module):
    """x * sqrt(d) + PE, then dropout (transformer.py:15-46)."""

    def __init__(self, hidden_size: int, dropout_rate: float = 0.1):
        super().__init__()
        self.hidden_size = hidden_size
        self.dropout = nn.Dropout(dropout_rate)

    def forward(self, xs: torch.Tensor) -> torch.Tensor:
        pe = sinusoidal_pe(xs.shape[1], self.hidden_size, xs.device, xs.dtype)
        return self.dropout(xs * math.sqrt(self.hidden_size) + pe[None])


class RelPositionalEncoder(nn.Module):
    """Scale input and emit the 2T-1 relative position table
    (conformer.py:16-55): positions T-1 ... -(T-1).  Dropout on both."""

    def __init__(self, hidden_size: int, dropout_rate: float = 0.1):
        super().__init__()
        self.hidden_size = hidden_size
        self.dropout = nn.Dropout(dropout_rate)

    def forward(self, xs: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        T, dev = xs.shape[1], xs.device
        # positive part: positions T-1..1, then 0..-(T-1)
        pos = torch.cat([
            torch.arange(T - 1, 0, -1, device=dev), torch.arange(0, -T, -1, device=dev)
        ]).to(torch.float32)[:, None]
        div = torch.exp(
            torch.arange(0, self.hidden_size, 2, dtype=torch.float32, device=dev)
            * -(math.log(10000.0) / self.hidden_size)
        )
        pe = torch.zeros((2 * T - 1, self.hidden_size), dtype=torch.float32, device=dev)
        pe[:, 0::2] = torch.sin(pos * div)
        pe[:, 1::2] = torch.cos(pos * div)
        pe = pe.to(xs.dtype)[None]  # (1, 2T-1, D), shared by the batch's rows: one draw on every rank
        xs = self.dropout(xs * math.sqrt(self.hidden_size))
        return xs, dropout(pe, self.dropout.p, self.training, shared=True)


class MultiHeadAttention(nn.Module):
    """Scaled dot-product MHA with boolean masking (transformer.py:48-99).

    mask: bool, broadcastable to (B, 1, Tq, Tk); True = attend.  With
    `fused` and `lens` given, the score pipeline runs in the fused kernel
    (ops/attention.py), masking keys by `lens` (which must agree with
    `mask`); in training it draws one fresh dropout seed per call from
    `dropout_generator` (PyTorch's global CPU generator when None).

    On a mesh (`parallel/tensor.py`) the module may hold a block of the
    heads, `tp_heads = (first head, all heads)`; the fused kernel's dropout
    then keys each element by its row and head in the global batch."""

    tp_heads: Optional[Tuple[int, int]] = None

    def __init__(self, num_heads: int, hidden_size: int, dropout_rate: float = 0.0,
                 fused: bool = False, kv_size: Optional[int] = None):
        super().__init__()
        self.num_heads = num_heads
        self.hidden_size = hidden_size
        self.d_k = hidden_size // num_heads
        self.dropout_rate = dropout_rate
        self.fused = fused
        kv_size = hidden_size if kv_size is None else kv_size  # width of the key/value inputs
        self.linear_q = nn.Linear(hidden_size, hidden_size)
        self.linear_k = nn.Linear(kv_size, hidden_size)
        self.linear_v = nn.Linear(kv_size, hidden_size)
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

    def _dropout_block(self, B: int) -> Optional[Tuple[int, int, int, int]]:
        """The fused kernel's `block`: this rank's rows and heads in the
        global batch; None in a single process."""
        rows = rows_block(B)
        if rows is None and self.tp_heads is None:
            return None
        return (*(rows or (0, B)), *(self.tp_heads or (0, self.num_heads)))

    def forward(self, q_in, k_in, v_in, mask=None, lens: Optional[torch.Tensor] = None):
        q, k, v = self._qkv(q_in, k_in, v_in)
        if self.fused and lens is not None:
            out = fused_self_attention(
                q, k, v, lens,
                scale=1.0 / math.sqrt(self.d_k),
                dropout_rate=self.dropout_rate,
                deterministic=not self.training,
                generator=self.dropout_generator,
                block=self._dropout_block(q.shape[0]),
            )
            B, Tq = out.shape[0], out.shape[1]
            return self.linear_out(out.reshape(B, Tq, self.hidden_size))
        scores = torch.einsum("bqhd,bkhd->bhqk", q, k) / math.sqrt(self.d_k)
        return self._attend(scores, v, mask)

    def kv(self, kv_in):
        """Precompute (k, v) projections (cross-attention cache: the
        encoder-side K/V are step-invariant during decoding)."""
        B = kv_in.shape[0]
        shape = lambda x: x.reshape(B, -1, self.num_heads, self.d_k)
        return shape(self.linear_k(kv_in)), shape(self.linear_v(kv_in))

    def attend_kv(self, q_in, k, v, mask=None):
        """Attention with precomputed K/V."""
        B = q_in.shape[0]
        q = self.linear_q(q_in).reshape(B, -1, self.num_heads, self.d_k)
        scores = torch.einsum("bqhd,bkhd->bhqk", q, k) / math.sqrt(self.d_k)
        return self._attend(scores, v, mask)


class RelMultiHeadAttention(MultiHeadAttention):
    """Transformer-XL style relative-position MHSA (conformer.py:57-95).

    With `fused` and `lens` given, the AC product, softmax, dropout and AV
    product run in the fused kernel; the BD term stays a matrix product and
    a `rel_shift` outside it and enters as the kernel's additive score bias,
    with q + pos_bias_u as its queries."""

    def __init__(self, num_heads: int, hidden_size: int, dropout_rate: float = 0.0,
                 fused: bool = False):
        super().__init__(num_heads, hidden_size, dropout_rate, fused)
        self.linear_pos = nn.Linear(hidden_size, hidden_size, bias=False)
        self.pos_bias_u = nn.Parameter(torch.empty(num_heads, self.d_k))
        self.pos_bias_v = nn.Parameter(torch.empty(num_heads, self.d_k))
        nn.init.xavier_uniform_(self.pos_bias_u)
        nn.init.xavier_uniform_(self.pos_bias_v)

    @staticmethod
    def rel_shift(x: torch.Tensor) -> torch.Tensor:
        """(B, H, T, 2T-1): row i keeps relative offsets aligned so column j
        holds position j - i (conformer.py:70-77)."""
        B, H, T, L = x.shape
        x = F.pad(x, (1, 0))
        x = x.reshape(B, H, L + 1, T)[:, :, 1:, :]
        return x.reshape(B, H, T, L)[:, :, :, :T]

    def forward(self, q_in, k_in, v_in, pos_emb=None, mask=None,
                lens: Optional[torch.Tensor] = None):
        q, k, v = self._qkv(q_in, k_in, v_in)
        B = q_in.shape[0]
        # p: (2T-1, H, D), shared across the batch
        p = self.linear_pos(pos_emb).reshape(-1, self.num_heads, self.d_k)
        bias_u = self.pos_bias_u.to(q.dtype)
        bias_v = self.pos_bias_v.to(q.dtype)
        matrix_bd = self.rel_shift(torch.einsum("bqhd,khd->bhqk", q + bias_v[None, None], p))
        if self.fused and lens is not None:
            out = fused_self_attention(
                q + bias_u[None, None], k, v, lens,
                scale=1.0 / math.sqrt(self.d_k),
                dropout_rate=self.dropout_rate,
                deterministic=not self.training,
                bias=matrix_bd,
                generator=self.dropout_generator,
                block=self._dropout_block(B),
            )
            return self.linear_out(out.reshape(B, out.shape[1], self.hidden_size))
        matrix_ac = torch.einsum("bqhd,bkhd->bhqk", q + bias_u[None, None], k)
        scores = (matrix_ac + matrix_bd) / math.sqrt(self.d_k)
        return self._attend(scores, v, mask)


class PositionwiseFeedForward(nn.Module):
    """w2(drop(act(w1(x)))) (transformer.py:102-118); act is relu or swish."""

    def __init__(self, intermediate_size: int, hidden_size: int, dropout_rate: float = 0.0,
                 activation: str = "relu"):
        super().__init__()
        self.w1 = nn.Linear(hidden_size, intermediate_size)
        self.w2 = nn.Linear(intermediate_size, hidden_size)
        self.dropout = nn.Dropout(dropout_rate)
        self.activation = activation

    def forward(self, x):
        h = self.w1(x)
        h = torch.relu(h) if self.activation == "relu" else F.silu(h)
        return self.w2(self.dropout(h))


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


def cache_write_index(flat_pos: torch.Tensor, cache_len: int) -> torch.Tensor:
    """Row n's position pos[n] as an index into a cache flattened over
    (rows, cache_len); one index serves every layer of a step."""
    rows = torch.arange(flat_pos.shape[0], device=flat_pos.device)
    return rows * cache_len + flat_pos.long()


def _write_cache(cache: torch.Tensor, index: torch.Tensor, new: torch.Tensor) -> None:
    """cache[..., pos, :, :] = new, in place (one launch); `cache` is
    contiguous (..., Lc, H, dk), `index` from `cache_write_index`."""
    H, dk = cache.shape[-2], cache.shape[-1]
    cache.view(-1, H, dk).index_copy_(0, index, new.reshape(-1, H, dk))


class TransformerDecoderLayer(nn.Module):
    """Pre-norm self-attn + cross-attn + FF (transformer.py:156-198).

    `cross_kv` takes precomputed encoder-side (K, V) so the decode loop does
    not re-project the encoder memory every step; `compute_cross_kv` builds
    them once per utterance."""

    def __init__(self, num_heads: int, hidden_size: int, intermediate_size: int,
                 dropout_rate: float = 0.1, dropout_attn_rate: float = 0.1,
                 memory_size: Optional[int] = None):
        super().__init__()
        self.num_heads = num_heads
        self.hidden_size = hidden_size
        self.norm1 = nn.LayerNorm(hidden_size, eps=1e-12)
        self.norm2 = nn.LayerNorm(hidden_size, eps=1e-12)
        self.norm3 = nn.LayerNorm(hidden_size, eps=1e-12)
        self.self_attn = MultiHeadAttention(num_heads, hidden_size, dropout_attn_rate)
        self.src_attn = MultiHeadAttention(num_heads, hidden_size, dropout_attn_rate,
                                           kv_size=memory_size)  # the encoder's width
        self.feed_forward = PositionwiseFeedForward(intermediate_size, hidden_size, dropout_rate)
        self.dropout = nn.Dropout(dropout_rate)

    def compute_cross_kv(self, memory):
        return self.src_attn.kv(memory)

    def _decode_step_weights(self) -> Dict[str, torch.Tensor]:
        """The weights as the fused step takes them (the same tensors the
        dense path reads): kernels as (in, out) views, `weight.t()`."""
        sa, ca, ff = self.self_attn, self.src_attn, self.feed_forward
        return dict(
            ln1_s=self.norm1.weight, ln1_b=self.norm1.bias,
            wq=sa.linear_q.weight.t(), bq=sa.linear_q.bias,
            wk=sa.linear_k.weight.t(), bk=sa.linear_k.bias,
            wv=sa.linear_v.weight.t(), bv=sa.linear_v.bias,
            wo=sa.linear_out.weight.t(), bo=sa.linear_out.bias,
            ln2_s=self.norm2.weight, ln2_b=self.norm2.bias,
            cwq=ca.linear_q.weight.t(), cbq=ca.linear_q.bias,
            cwo=ca.linear_out.weight.t(), cbo=ca.linear_out.bias,
            ln3_s=self.norm3.weight, ln3_b=self.norm3.bias,
            w1=ff.w1.weight.t(), b1=ff.w1.bias,
            w2=ff.w2.weight.t(), b2=ff.w2.bias,
        )

    def _packed_step_weights(self) -> PackedWeights:
        """`_decode_step_weights`, checked and laid out once; built anew when
        a parameter was replaced, moved, cast or written since."""
        key = tuple((p.data_ptr(), p._version, p.dtype) for p in self.parameters())
        if getattr(self, "_pack_key", None) != key:
            self._pack, self._pack_key = PackedWeights(self._decode_step_weights()), key
        return self._pack

    def _cross_ff(self, x, cross_kv, memory_mask, beam_width):
        """The step's cross-attention and feed-forward, x: (B, 1, D)."""
        B = x.shape[0]
        hn = self.norm2(x)
        if beam_width is not None:
            hq = hn.reshape(B // beam_width, beam_width, hn.shape[-1])
            hc = self.src_attn.attend_kv(hq, cross_kv[0], cross_kv[1], memory_mask)
            hc = hc.reshape(B, 1, hn.shape[-1])
        else:
            hc = self.src_attn.attend_kv(hn, cross_kv[0], cross_kv[1], memory_mask)
        x = x + hc
        return x + self.feed_forward(self.norm3(x))

    def decode_step(self, h, cache_k, cache_v, pos, self_mask, memory_mask=None,
                    cross_kv=None, beam_width=None, fused=False, elens=None, cache_index=None):
        """Incremental decode: one new position per row.

        h: (B, 1, D) hidden for the newest token; cache_k/v: (B, Lmax, H, dk)
        self-attention cache; pos: (B,) the new token's position.  Writes
        the new K/V into the cache (in place) and attends over positions
        <= pos, the causal column the full recompute would produce.

        `beam_width=W` marks B as Bu*W beam rows (Bu utterances) sharing
        encoder memory: `cross_kv`/`memory_mask` are then per-utterance
        (Bu, T, ...) and the cross-attention treats the W beams as W query
        positions of one batched attention.

        `fused=True` runs the whole layer step in the fused kernel
        (ops/decoder_step.py); it needs `beam_width` and `elens`, the
        per-utterance encoder lengths that `memory_mask` encodes, and raises
        `ValueError` without them.  `cache_index`: `cache_write_index` of
        `pos`, when the caller has it already (it is the same for every
        layer of a step)."""
        if cache_index is None:
            cache_index = cache_write_index(pos.reshape(-1), cache_k.shape[1])
        if fused:
            if beam_width is None or elens is None:
                raise ValueError("decode_step(fused=True) needs beam_width and elens")
            y, k_new, v_new = fused_decoder_layer_step(
                h[:, 0], cache_k, cache_v, pos, cross_kv[0], cross_kv[1],
                elens, self._packed_step_weights(), beam_width=beam_width,
            )
            _write_cache(cache_k, cache_index, k_new)
            _write_cache(cache_v, cache_index, v_new)
            return y[:, None], cache_k, cache_v
        hn = self.norm1(h)
        _, k, v = self.self_attn._qkv(hn, hn, hn)  # (B, 1, H, dk)
        _write_cache(cache_k, cache_index, k[:, 0])
        _write_cache(cache_v, cache_index, v[:, 0])
        x = h + self.self_attn.attend_kv(hn, cache_k, cache_v, self_mask)
        return self._cross_ff(x, cross_kv, memory_mask, beam_width), cache_k, cache_v

    def decode_step_indirect(self, h, cache_k, cache_v, pos, anc, memory_mask, cross_kv,
                             beam_width, fused=False, elens=None, cache_index=None):
        """`decode_step` with ancestor-indirect self-attention caches.

        cache_k/v: (Bu, W, Lc, H, dk) in physical slot order (never
        beam-permuted); anc: (Bu, W, Lc), the slot that holds beam w's
        column l; pos: (Bu, W).  h: (B, 1, D) with B = Bu*W.

        The beam search composes its per-step beam permutation into `anc`
        instead of permuting the caches; each beam's ancestor rows are
        gathered here (the JAX package selects them with a one-hot
        contraction: the same numbers).  Label-sync only: each physical
        column is written once, at its step.

        `fused=True` runs the whole layer step in the fused kernel, which
        reads cache[u, anc[u, w, l], l] in place; it needs `elens` and raises
        `ValueError` without it.
        `cache_index` as in `decode_step`."""
        B = h.shape[0]
        W = beam_width
        Bu = B // W
        H, dk = self.num_heads, self.hidden_size // self.num_heads
        Lc = cache_k.shape[2]
        if cache_index is None:
            cache_index = cache_write_index(pos.reshape(-1), Lc)

        if fused:
            if elens is None:
                raise ValueError("decode_step_indirect(fused=True) needs elens")
            y, k_new, v_new = fused_decoder_layer_step_indirect(
                h[:, 0], cache_k, cache_v, pos, anc, cross_kv[0], cross_kv[1],
                elens, self._packed_step_weights(), beam_width=W,
            )
            _write_cache(cache_k, cache_index, k_new)
            _write_cache(cache_v, cache_index, v_new)
            return y[:, None], cache_k, cache_v

        hn = self.norm1(h)
        q, k, v = self.self_attn._qkv(hn, hn, hn)  # (B, 1, H, dk)
        qb = q[:, 0].reshape(Bu, W, H, dk)
        _write_cache(cache_k, cache_index, k[:, 0])
        _write_cache(cache_v, cache_index, v[:, 0])

        idx = anc.to(torch.int64)[:, :, :, None, None].expand(Bu, W, Lc, H, dk)
        ck, cv = torch.gather(cache_k, 1, idx), torch.gather(cache_v, 1, idx)
        scores = torch.einsum("bwhd,bwthd->bwht", qb, ck) / math.sqrt(dk)
        tmask = torch.arange(Lc, device=h.device)[None, None, None, :] <= pos[:, :, None, None]
        scores = scores.masked_fill(~tmask, NEG_INF)
        attn = torch.softmax(scores.float(), dim=-1)
        attn = attn.masked_fill(~tmask, 0.0).to(cv.dtype)
        out = torch.einsum("bwht,bwthd->bwhd", attn, cv).reshape(B, 1, self.hidden_size)
        x = h + self.self_attn.linear_out(out)
        return self._cross_ff(x, cross_kv, memory_mask, W), cache_k, cache_v

    def forward(self, x, tgt_mask, memory, memory_mask, cross_kv=None):
        h = self.norm1(x)
        x = x + self.dropout(self.self_attn(h, h, h, tgt_mask))
        h = self.norm2(x)
        if cross_kv is not None:
            h = self.src_attn.attend_kv(h, cross_kv[0], cross_kv[1], memory_mask)
        else:
            h = self.src_attn(h, memory, memory, memory_mask)
        x = x + self.dropout(h)
        return x + self.dropout(self.feed_forward(self.norm3(x)))


class ConvModule(nn.Module):
    """Conformer convolution module (conformer.py:98-143):
    pointwise(2C) -> GLU -> depthwise k=31 SAME -> BN -> swish -> pointwise.

    BatchNorm statistics run over (B, T) including padded frames, matching
    the reference's unmasked BatchNorm1d.  The running averages move as the
    JAX package's do: at flax momentum 0.99 (PyTorch momentum 0.01), and the
    running variance takes the batch's biased variance (`nn.BatchNorm1d`
    would feed it the unbiased one), so that a checkpoint written after
    training holds the statistics the JAX trainer would write.  Under the
    bf16 training policy the statistics stay float32 buffers: the batch's
    are taken in float32 and the running update goes into them.  On a mesh
    that splits the batch the statistics are the global batch's (as GSPMD
    computes them): two all-reduces over the data group, differentiable."""

    def __init__(self, channels: int, kernel_size: int = 31):
        super().__init__()
        self.kernel_size = kernel_size
        self.pointwise_conv1 = nn.Conv1d(channels, 2 * channels, 1)
        self.depthwise_conv = nn.Conv1d(channels, channels, kernel_size, groups=channels)
        self.batch_norm = nn.BatchNorm1d(channels, eps=1e-5, momentum=0.01)
        self.pointwise_conv2 = nn.Conv1d(channels, channels, 1)

    def forward(self, x):
        # x: (B, T, C); PyTorch convolves over (B, C, T)
        h = F.glu(self.pointwise_conv1(x.transpose(1, 2)), dim=1)
        k = self.kernel_size
        h = self.depthwise_conv(F.pad(h, ((k - 1) // 2, k // 2)))  # SAME
        h = F.silu(self._batch_norm(h))
        return self.pointwise_conv2(h).transpose(1, 2)

    def _batch_norm(self, h):
        bn = self.batch_norm
        if not bn.training:
            if h.dtype == bn.weight.dtype == bn.running_mean.dtype:
                return bn(h)
            # bf16 weights beside the float32 running statistics (the
            # training policy's evaluation): computed in float32 and rounded
            # once, as flax promotes x - mean to the statistics' float32
            return F.batch_norm(h.float(), bn.running_mean.float(), bn.running_var.float(), bn.weight.float(),
                                bn.bias.float(), False, 0.0, bn.eps).to(h.dtype)
        stats = batch_stats(h, (0, 2))  # the global batch's, on a mesh that splits it
        with torch.no_grad():
            var, mean = torch.var_mean(h.float(), dim=(0, 2), unbiased=False) if stats is None else stats[::-1]
            bn.running_mean.lerp_(mean.detach().to(bn.running_mean.dtype), bn.momentum)
            bn.running_var.lerp_(var.detach().to(bn.running_var.dtype), bn.momentum)
            bn.num_batches_tracked += 1
        if stats is None:
            return F.batch_norm(h, None, None, bn.weight, bn.bias, True, bn.momentum, bn.eps)
        mean, var = stats
        hn = (h.float() - mean[None, :, None]) * torch.rsqrt(var + bn.eps)[None, :, None]
        return (hn * bn.weight[None, :, None] + bn.bias[None, :, None]).to(h.dtype)


class ConformerEncoderLayer(nn.Module):
    """Macaron FF x0.5 -> (rel)MHSA -> conv -> FF x0.5 -> final LN
    (conformer.py:146-229); inner LayerNorms at `CONFORMER_LN_EPS`.  With
    absolute positions the conv module comes first."""

    def __init__(self, num_heads: int, hidden_size: int, intermediate_size: int,
                 dropout_rate: float = 0.1, dropout_attn_rate: float = 0.1,
                 pos_encode_type: str = "rel", conv_kernel_size: int = 31,
                 fused_attn: bool = False):
        super().__init__()
        self.pos_encode_type = pos_encode_type
        self.norm_ff_macaron = nn.LayerNorm(hidden_size, eps=CONFORMER_LN_EPS)
        self.feed_forward_macaron = PositionwiseFeedForward(
            intermediate_size, hidden_size, dropout_rate, activation="swish")
        self.norm_self_attn = nn.LayerNorm(hidden_size, eps=CONFORMER_LN_EPS)
        if pos_encode_type == "rel":
            self.self_attn = RelMultiHeadAttention(
                num_heads, hidden_size, dropout_attn_rate, fused=fused_attn)
        else:
            self.self_attn = MultiHeadAttention(num_heads, hidden_size, dropout_attn_rate)
        self.norm_conv = nn.LayerNorm(hidden_size, eps=CONFORMER_LN_EPS)
        self.conv = ConvModule(hidden_size, conv_kernel_size)
        self.norm_ff = nn.LayerNorm(hidden_size, eps=CONFORMER_LN_EPS)
        self.feed_forward = PositionwiseFeedForward(
            intermediate_size, hidden_size, dropout_rate, activation="swish")
        self.norm_final = nn.LayerNorm(hidden_size, eps=CONFORMER_LN_EPS)
        self.dropout = nn.Dropout(dropout_rate)

    def forward(self, x, mask=None, pos_emb=None, lens: Optional[torch.Tensor] = None):
        drop = self.dropout
        x = x + 0.5 * drop(self.feed_forward_macaron(self.norm_ff_macaron(x)))
        if self.pos_encode_type == "rel":
            h = self.norm_self_attn(x)
            x = x + drop(self.self_attn(h, h, h, pos_emb, mask, lens=lens))
            x = x + drop(self.conv(self.norm_conv(x)))
        else:  # abs: conv before attention (conformer.py:212-227)
            x = x + drop(self.conv(self.norm_conv(x)))
            h = self.norm_self_attn(x)
            x = x + drop(self.self_attn(h, h, h, mask))
        x = x + 0.5 * drop(self.feed_forward(self.norm_ff(x)))
        return self.norm_final(x)


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
