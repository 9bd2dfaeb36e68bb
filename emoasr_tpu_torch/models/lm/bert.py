"""BERT-style post-norm Transformer stack with a causal switch, the BERT-MLM
head, the ELECTRA generator and discriminator heads, the masked-LM loss and
the discriminator's BCE (PyTorch port of `emoasr_tpu/models/lm/bert.py`).

Module and parameter names are emoASR's torch `state_dict` names (its
vendored HuggingFace `BertForMaskedLM`): `embeddings.{word_embeddings,
position_embeddings, token_type_embeddings, LayerNorm}`,
`encoder.layer.{i}.attention.self.{query,key,value}`,
`encoder.layer.{i}.attention.output.{dense,LayerNorm}`,
`encoder.layer.{i}.intermediate.dense`, `encoder.layer.{i}.output.{dense,
LayerNorm}`, and the head's `predictions.{transform.dense,
transform.LayerNorm, decoder, bias}`; ELECTRA (its vendored
`ElectraForMaskedLM` / `ElectraForPreTraining`) adds the stack's
`embeddings_project` (embedding size -> hidden size), the generator's
`generator_predictions.{dense, LayerNorm}` and `generator_lm_head`, and the
discriminator's `discriminator_predictions.{dense, dense_prediction}`.

Semantics kept from the JAX package: embeddings = word + learned position +
token type 0, LayerNorm eps 1e-12, dropout (0.1, on in `train()` mode: the
embeddings' output, the attention probabilities, and each layer's two
sublayer outputs before their residual sums, as in the JAX stack); post-norm
layers
LN(x + attn), LN(x + FF(gelu exact)); attention scores filled with -1e9 at
masked keys before an f32 softmax; the head is dense + gelu + LN and an
untied vocabulary projection.

The incremental steps (`step`, `step_indirect`) serve LM shallow fusion in
the beam searches; like the port's decoder steps they write the new K/V
into the caches they are given, in place, and return those same tensors
(the JAX package returns updated copies).  `FUSED_INDIRECT_STEP` sends every
layer of `BertStack.step_indirect` to the fused kernel (ops/lm_step.py).
"""

from __future__ import annotations

import math
from typing import List, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from emoasr_tpu_torch.models.criteria import masked_lm_loss
from emoasr_tpu_torch.models.layers import (
    NEG_INF,
    _write_cache,
    cache_write_index,
    make_causal_mask,
    make_pad_mask,
)
from emoasr_tpu_torch.ops.lm_step import fused_bert_layer_step_indirect, pack_weights
from emoasr_tpu_torch.parallel.mesh import batch_mean, global_sum

# fused indirect-step dispatch: None = auto, True/False = forced.  Auto is
# the dense route, as in the JAX package (whose chip measurement found the
# fused TPU kernel slower than XLA's chain for this step).
FUSED_INDIRECT_STEP = None

LN_EPS = 1e-12

Caches = List[Tuple[torch.Tensor, torch.Tensor]]


class _Holder(nn.Module):
    """A container whose only job is to give its children their
    reference `state_dict` prefix."""

    def __init__(self, /, **children: nn.Module):
        super().__init__()
        for name, child in children.items():
            setattr(self, name, child)


class BertSelfAttention(nn.Module):
    def __init__(self, num_heads: int, hidden_size: int, dropout_rate: float = 0.1):
        super().__init__()
        self.num_heads = num_heads
        self.hidden_size = hidden_size
        self.d_k = hidden_size // num_heads
        self.query = nn.Linear(hidden_size, hidden_size)
        self.key = nn.Linear(hidden_size, hidden_size)
        self.value = nn.Linear(hidden_size, hidden_size)
        self.dropout = nn.Dropout(dropout_rate)

    def _heads(self, lin: nn.Linear, x: torch.Tensor) -> torch.Tensor:
        return lin(x).reshape(x.shape[:-1] + (self.num_heads, self.d_k))

    def _softmax(self, scores, mask, dtype):
        scores = scores.masked_fill(~mask, NEG_INF)
        return torch.softmax(scores.float(), dim=-1).to(dtype)

    def forward(self, x, mask=None):
        """x: (B, L, D); mask: bool broadcastable to (B, 1, L, L), True =
        attend."""
        B, L, _ = x.shape
        q, k, v = (self._heads(lin, x) for lin in (self.query, self.key, self.value))
        scores = torch.einsum("bqhd,bkhd->bhqk", q, k) / math.sqrt(self.d_k)
        if mask is not None:
            attn = self._softmax(scores, mask, x.dtype)
        else:
            attn = torch.softmax(scores.float(), dim=-1).to(x.dtype)
        attn = self.dropout(attn)
        return torch.einsum("bhqk,bkhd->bqhd", attn, v).reshape(B, L, self.hidden_size)

    def step(self, x, cache_k, cache_v, pos, cache_index=None):
        """Incremental causal attention for decoding: x (B, D) hidden of the
        newest token; cache_k/v (B, Lmax, H, dk); pos (B,) its position.
        Writes K/V at pos (in place) and attends over positions <= pos, the
        column a full causal forward yields."""
        B, Lmax = x.shape[0], cache_k.shape[1]
        if cache_index is None:
            cache_index = cache_write_index(pos, Lmax)
        q, k, v = (self._heads(lin, x) for lin in (self.query, self.key, self.value))
        _write_cache(cache_k, cache_index, k)
        _write_cache(cache_v, cache_index, v)
        scores = torch.einsum("bhd,bkhd->bhk", q, cache_k) / math.sqrt(self.d_k)
        mask = torch.arange(Lmax, device=x.device)[None, None, :] <= pos[:, None, None]
        attn = self._softmax(scores, mask, x.dtype)
        return torch.einsum("bhk,bkhd->bhd", attn, cache_v).reshape(B, self.hidden_size)

    def step_indirect(self, x, cache_k, cache_v, pos, anc, cache_index=None):
        """`step` over beam-structured caches with ancestor indirection.

        x: (B, W, D); cache_k/v: (B, W, Lc, H, dk) in physical slot order
        (never beam-permuted); pos: (B, W); anc: (B, W, Lc) with anc[b, w, t]
        the slot whose column t holds beam (b, w)'s token at position t (the
        caller keeps it composed across beam reindexes and has set
        anc[b, w, pos] = w for this step's write).  Each beam's ancestor rows
        are gathered here; the JAX package selects them with a one-hot
        contraction: the same numbers."""
        B, W, _ = x.shape
        Lc, H, dk = cache_k.shape[2], self.num_heads, self.d_k
        if cache_index is None:
            cache_index = cache_write_index(pos.reshape(-1), Lc)
        q, k, v = (self._heads(lin, x) for lin in (self.query, self.key, self.value))
        _write_cache(cache_k, cache_index, k)
        _write_cache(cache_v, cache_index, v)
        idx = anc.to(torch.int64)[:, :, :, None, None].expand(B, W, Lc, H, dk)
        ck, cv = torch.gather(cache_k, 1, idx), torch.gather(cache_v, 1, idx)
        scores = torch.einsum("bwhd,bwthd->bwht", q, ck) / math.sqrt(dk)
        tmask = torch.arange(Lc, device=x.device)[None, None, None, :] <= pos[:, :, None, None]
        attn = self._softmax(scores, tmask, x.dtype)
        return torch.einsum("bwht,bwthd->bwhd", attn, cv).reshape(B, W, self.hidden_size)


class BertLayer(nn.Module):
    """Post-norm: LN(x + drop(proj(attn))), LN(x + drop(out(gelu(inter))))."""

    def __init__(self, num_heads: int, hidden_size: int, intermediate_size: int,
                 dropout_rate: float = 0.1, attn_dropout_rate: float = 0.1):
        super().__init__()
        self.attention = _Holder(
            self=BertSelfAttention(num_heads, hidden_size, attn_dropout_rate),
            output=_Holder(dense=nn.Linear(hidden_size, hidden_size),
                           LayerNorm=nn.LayerNorm(hidden_size, eps=LN_EPS)),
        )
        self.intermediate = _Holder(dense=nn.Linear(hidden_size, intermediate_size))
        self.output = _Holder(dense=nn.Linear(intermediate_size, hidden_size),
                              LayerNorm=nn.LayerNorm(hidden_size, eps=LN_EPS))
        self.dropout = nn.Dropout(dropout_rate)

    def _attn_out(self, x, h):
        out = self.attention.output
        return out.LayerNorm(x + self.dropout(out.dense(h)))

    def _ff(self, x):
        h = F.gelu(self.intermediate.dense(x))
        return self.output.LayerNorm(x + self.dropout(self.output.dense(h)))

    def forward(self, x, mask=None):
        return self._ff(self._attn_out(x, self.attention.self(x, mask)))

    def step(self, x, cache_k, cache_v, pos, cache_index=None):
        """Incremental decode for one new position; x: (B, D)."""
        h = self.attention.self.step(x, cache_k, cache_v, pos, cache_index)
        return self._ff(self._attn_out(x, h)), cache_k, cache_v

    def _step_weights(self):
        """The weights as the fused step takes them (the same tensors the
        dense path reads): kernels as (in, out) views, `weight.t()`."""
        sa, ao = self.attention.self, self.attention.output
        return dict(
            wq=sa.query.weight.t(), bq=sa.query.bias,
            wk=sa.key.weight.t(), bk=sa.key.bias,
            wv=sa.value.weight.t(), bv=sa.value.bias,
            wo=ao.dense.weight.t(), bo=ao.dense.bias,
            ln1_s=ao.LayerNorm.weight, ln1_b=ao.LayerNorm.bias,
            wi=self.intermediate.dense.weight.t(), bi=self.intermediate.dense.bias,
            wo2=self.output.dense.weight.t(), bo2=self.output.dense.bias,
            ln2_s=self.output.LayerNorm.weight, ln2_b=self.output.LayerNorm.bias,
        )

    def _packed_step_weights(self):
        """`_step_weights`, checked and laid out once; built anew when a
        parameter was replaced, moved, cast or written since."""
        key = tuple((p.data_ptr(), p._version, p.dtype) for p in self.parameters())
        if getattr(self, "_pack_key", None) != key:
            self._pack, self._pack_key = pack_weights(self._step_weights()), key
        return self._pack

    def step_indirect(self, x, cache_k, cache_v, pos, anc, fused=False, cache_index=None):
        """`step` on (B, W, D) with ancestor-indirect caches.  `fused=True`
        runs the whole layer step as one kernel launch (ops/lm_step.py),
        which reads the pre-write caches; the new K/V are written after it."""
        if cache_index is None:
            cache_index = cache_write_index(pos.reshape(-1), cache_k.shape[2])
        if fused:
            y, k_new, v_new = fused_bert_layer_step_indirect(
                x, cache_k, cache_v, pos, anc, self._packed_step_weights())
            _write_cache(cache_k, cache_index, k_new)
            _write_cache(cache_v, cache_index, v_new)
            return y, cache_k, cache_v
        h = self.attention.self.step_indirect(x, cache_k, cache_v, pos, anc, cache_index)
        return self._ff(self._attn_out(x, h)), cache_k, cache_v


class BertEmbeddings(nn.Module):
    """word + learned position + token type 0, LayerNorm, dropout; at the
    stack's `embedding_size` (ELECTRA) when it is given."""

    def __init__(self, vocab_size: int, hidden_size: int, max_seq_len: int,
                 type_vocab_size: int = 2, dropout_rate: float = 0.1):
        super().__init__()
        self.word_embeddings = nn.Embedding(vocab_size, hidden_size)
        self.position_embeddings = nn.Embedding(max_seq_len, hidden_size)
        self.token_type_embeddings = nn.Embedding(type_vocab_size, hidden_size)
        self.LayerNorm = nn.LayerNorm(hidden_size, eps=LN_EPS)
        self.dropout = nn.Dropout(dropout_rate)

    def forward(self, ys, positions):
        h = (self.word_embeddings(ys.long()) + self.position_embeddings(positions.long())
             + self.token_type_embeddings(torch.zeros_like(ys, dtype=torch.long)))
        return self.dropout(self.LayerNorm(h))


class BertStack(nn.Module):
    """Embeddings + N post-norm layers; `causal` makes it a left-to-right LM.
    An `embedding_size` other than `hidden_size` (ELECTRA) adds the
    projection `embeddings_project` after the embeddings."""

    def __init__(self, vocab_size: int, hidden_size: int, num_layers: int, num_heads: int,
                 intermediate_size: int, max_seq_len: int = 512, type_vocab_size: int = 2,
                 dropout_rate: float = 0.1, attn_dropout_rate: float = 0.1,
                 embedding_size: Optional[int] = None):
        super().__init__()
        self.num_heads = num_heads
        self.hidden_size = hidden_size
        E = embedding_size or hidden_size
        self.embeddings = BertEmbeddings(vocab_size, E, max_seq_len, type_vocab_size, dropout_rate)
        if E != hidden_size:
            self.embeddings_project = nn.Linear(E, hidden_size)
        self.encoder = _Holder(layer=nn.ModuleList(
            BertLayer(num_heads, hidden_size, intermediate_size, dropout_rate, attn_dropout_rate)
            for _ in range(num_layers)
        ))

    def _embed(self, ys, positions):
        h = self.embeddings(ys, positions)
        if hasattr(self, "embeddings_project"):
            h = self.embeddings_project(h)
        return h

    def forward(self, ys, ylens: Optional[torch.Tensor] = None, causal: bool = False):
        B, L = ys.shape
        h = self._embed(ys, torch.arange(L, device=ys.device)[None, :])
        mask = None
        if ylens is not None:
            mask = make_pad_mask(ylens.to(ys.device), L)[:, None, None, :]
        if causal:
            cm = make_causal_mask(L, ys.device)[None, None, :, :]
            mask = cm if mask is None else (mask & cm)
        for layer in self.encoder.layer:
            h = layer(h, mask)
        return h

    def init_cache(self, B: int, max_len: int, dtype=torch.float32, device=None) -> Caches:
        """Per-layer [(k, v)] self-attention caches for incremental causal
        decoding, each (B, max_len, H, dk)."""
        dk = self.hidden_size // self.num_heads
        device = self.embeddings.word_embeddings.weight.device if device is None else device
        return [
            (torch.zeros((B, max_len, self.num_heads, dk), dtype=dtype, device=device),
             torch.zeros((B, max_len, self.num_heads, dk), dtype=dtype, device=device))
            for _ in self.encoder.layer
        ]

    def step(self, tokens, pos, caches: Caches):
        """One incremental causal step: tokens (B,) newest token ids, pos
        (B,) their positions.  Returns (h (B, D), caches), h equal to the
        full causal forward's hidden at `pos`; the caches are written in
        place."""
        pos = pos.long()
        h = self._embed(tokens[:, None], pos[:, None])[:, 0]
        index = cache_write_index(pos, caches[0][0].shape[1])
        for i, layer in enumerate(self.encoder.layer):
            h, _, _ = layer.step(h, caches[i][0], caches[i][1], pos, index)
        return h, caches

    def step_indirect(self, tokens, pos, caches: Caches, anc):
        """`step` over (B, W) beams with physical-slot caches and the
        ancestor table (see BertSelfAttention.step_indirect); every layer
        runs as one fused kernel launch when `FUSED_INDIRECT_STEP` says so."""
        h = self._embed(tokens[..., None], pos[..., None])[..., 0, :]
        fused = bool(FUSED_INDIRECT_STEP)  # None, auto, is the dense route
        index = cache_write_index(pos.reshape(-1), caches[0][0].shape[2])
        step_pos = pos.to(torch.int32) if fused else pos.long()  # as the kernel reads it
        for i, layer in enumerate(self.encoder.layer):
            h, _, _ = layer.step_indirect(h, caches[i][0], caches[i][1], step_pos, anc, fused=fused,
                                          cache_index=index)
        return h, caches


class BertMLMHead(nn.Module):
    """transform (dense + gelu + LN) -> untied vocabulary projection with the
    bias `predictions.bias`, which `predictions.decoder.bias` shares (both
    names are in the reference's `state_dict`, as HuggingFace ties them)."""

    def __init__(self, hidden_size: int, vocab_size: int):
        super().__init__()
        self.predictions = _Holder(
            transform=_Holder(dense=nn.Linear(hidden_size, hidden_size),
                              LayerNorm=nn.LayerNorm(hidden_size, eps=LN_EPS)),
            decoder=nn.Linear(hidden_size, vocab_size),
        )
        self.predictions.bias = self.predictions.decoder.bias

    def forward(self, h):
        t = self.predictions.transform
        h = t.LayerNorm(F.gelu(t.dense(h)))
        return self.predictions.decoder(h)


class ElectraGeneratorHead(nn.Module):
    """dense (hidden -> embedding size) + gelu + LN, then the vocabulary
    projection (bert.py:367-376; `generator_predictions.{dense, LayerNorm}`,
    `generator_lm_head`).  The generator model hangs its stack on the same
    module as `electra`, so that its names are the reference's."""

    def __init__(self, hidden_size: int, embedding_size: int, vocab_size: int):
        super().__init__()
        self.generator_predictions = _Holder(dense=nn.Linear(hidden_size, embedding_size),
                                             LayerNorm=nn.LayerNorm(embedding_size, eps=LN_EPS))
        self.generator_lm_head = nn.Linear(embedding_size, vocab_size)

    def forward(self, h):
        p = self.generator_predictions
        return self.generator_lm_head(p.LayerNorm(F.gelu(p.dense(h))))


class ElectraDiscriminatorHead(nn.Module):
    """dense + gelu, then one logit a position (bert.py:379-386;
    `discriminator_predictions.{dense, dense_prediction}`).  The
    discriminator model hangs its stack on the same module as `electra`."""

    def __init__(self, hidden_size: int):
        super().__init__()
        self.discriminator_predictions = _Holder(dense=nn.Linear(hidden_size, hidden_size),
                                                 dense_prediction=nn.Linear(hidden_size, 1))

    def forward(self, h):
        p = self.discriminator_predictions
        return p.dense_prediction(F.gelu(p.dense(h)))[..., 0]


# the masked-LM loss under its name in the JAX package's bert.py (:389-396)
mlm_loss = masked_lm_loss


def disc_bce_loss(logits: torch.Tensor, labels: torch.Tensor, ylens: Optional[torch.Tensor] = None) -> torch.Tensor:
    """BCE with logits over the positions before `ylens` (bert.py:399-410,
    emoASR `modeling_electra.py:527-535`), their mean; the mean over every
    position without `ylens`."""
    x = logits.float()
    lab = labels.float()
    bce = -(lab * F.logsigmoid(x) + (1.0 - lab) * F.logsigmoid(-x))
    if ylens is None:
        return batch_mean(bce)
    valid = make_pad_mask(ylens.to(x.device), x.shape[1])
    return torch.where(valid, bce, torch.zeros_like(bce)).sum() / global_sum(valid.sum()).clamp(min=1)
