"""Megatron tensor parallelism of the port's models over the mesh's model
axis (the counterpart of JAX `parallel/mesh.py::_tp_spec:69-102` and
`param_partition_specs:105-122`).

GSPMD takes the JAX package's specs as layout and computes the same
function; here each rank holds its share of every Megatron pair and the
conjugate collectives of `parallel/mesh.py` join the shares:

- column-parallel (each rank a block of output features; `nn.Linear`'s
  weight split on dimension 0, its bias too): the feed-forward's `w1`, the
  attention's `linear_q/k/v` and `linear_pos`, BERT's `query/key/value`
  and `intermediate.dense`;
- row-parallel (a block of input features, weight dimension 1; the bias
  whole, added once after the sum): `w2`, `linear_out`, BERT's
  `attention.output.dense` (JAX `attn_output`) and per-layer
  `output.dense`;
- an attention's heads go with their columns: a rank runs its H / m heads
  (K4 on the card), and the Conformer's `pos_bias_u/v` (H, d_k) follow
  them (JAX keeps those whole; GSPMD slices them as the heads flow);
- an attention is split only where its head count divides over the model
  axis, a feed-forward only where its inner width does (JAX splits any
  dimension that divides; a split inside a head is layout to GSPMD but not
  a set of local heads);
- vocabulary-parallel, as JAX splits the vocabulary (`_tp_spec:82-97`):
  every `nn.Embedding` whose first dimension divides (the decoders' and
  LMs' `embed`, the phone encoder's `embed`, BERT's word, position and
  token-type tables) keeps its block of rows, looked up where a rank owns
  the id and summed over the model group (`VocabParallelEmbedding`); every
  vocabulary head (an `nn.Linear` named `output` outside the convolution
  front end: `decoder.output`, `decoder.ctc.output`, the RNN LM's
  `output`) keeps its block of output columns and returns their logits
  (`VocabParallelHead`), which only the vocabulary-parallel losses read
  (`parallel/vocab.py`; K1 and K7 on a rank's columns); the BERT and
  Transformer LM heads (`decoder`) stay whole, as in JAX;
- everything unmatched (LayerNorms, convolutions, LSTMs) stays whole.

`tp_plan(model, m)` names each split parameter and its dimension, on the
port's `state_dict` names; `prepare_model_(model, mesh)` applies it in
place and gives every dropout the global batch's draw.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from emoasr_tpu_torch.models.layers import (
    Conv2dSubsampler,
    MultiHeadAttention,
    PositionwiseFeedForward,
    RelMultiHeadAttention,
)
from emoasr_tpu_torch.models.lm.bert import BertLayer
from emoasr_tpu_torch.parallel.mesh import (
    Dropout,
    Mesh,
    all_reduce_flat_,
    copy_to_model,
    reduce_from_model,
)
from emoasr_tpu_torch.parallel.vocab import VocabShard

COLUMN, ROW = 0, 1  # the dimension of `nn.Linear.weight` that each kind splits


class ColumnParallelLinear(nn.Linear):
    """A block of the output features; the input's gradient is summed over
    the model group."""

    tp_group = None

    def forward(self, x):
        return F.linear(copy_to_model(x, self.tp_group), self.weight, self.bias)


class RowParallelLinear(nn.Linear):
    """A block of the input features; the partial products are summed over
    the model group, then the (whole) bias is added."""

    tp_group = None

    def forward(self, x):
        y = reduce_from_model(F.linear(x, self.weight), self.tp_group)
        return y if self.bias is None else y + self.bias


class VocabParallelEmbedding(nn.Embedding):
    """A block of the table's rows (ids [v0, v0 + V / m)): the rows of the
    ids this rank owns, zeros for the others, summed over the model group
    (exact: one rank contributes each row); the gradient reaches the owned
    rows only."""

    vocab_shard: VocabShard = None

    def forward(self, ids):
        sh = self.vocab_shard
        local = ids - sh.v0
        own = (local >= 0) & (local < sh.local)
        rows = F.embedding(torch.where(own, local, torch.zeros_like(local)), self.weight)
        return reduce_from_model(torch.where(own[..., None], rows, torch.zeros_like(rows)), sh.group)


class VocabParallelHead(nn.Linear):
    """A block of the vocabulary's columns: the (..., V / m) logits of the
    rank's columns; the input's gradient is summed over the model group."""

    vocab_shard: VocabShard = None

    def forward(self, x):
        return F.linear(copy_to_model(x, self.vocab_shard.group), self.weight, self.bias)


def _vocab_modules(model: nn.Module, m: int):
    """(name, module) of every embedding table and vocabulary head whose
    vocabulary divides over a model axis of `m`."""
    convs = {n for n, mod in model.named_modules() if isinstance(mod, Conv2dSubsampler)}
    for name, mod in model.named_modules():
        if isinstance(mod, nn.Embedding) and mod.num_embeddings % m == 0:
            yield name, mod
        elif (type(mod) is nn.Linear and name.rsplit(".", 1)[-1] == "output"
              and name.rpartition(".")[0] not in convs and mod.out_features % m == 0):
            yield name, mod


def _linear(prefix: str, kind: int, bias: bool = True) -> Dict[str, int]:
    plan = {f"{prefix}.weight": kind}
    if bias and kind == COLUMN:
        plan[f"{prefix}.bias"] = 0
    return plan


def _pairs(model: nn.Module, m: int):
    """(module name, module, kind) of every Megatron pair the model holds
    and `m` divides; kind is "attn", "ff", "bert_attn" or "bert_ff"."""
    for name, mod in model.named_modules():
        if isinstance(mod, MultiHeadAttention) and mod.num_heads % m == 0:
            yield name, mod, "attn"
        elif isinstance(mod, PositionwiseFeedForward) and mod.w1.out_features % m == 0:
            yield name, mod, "ff"
        elif isinstance(mod, BertLayer):
            if mod.attention.self.num_heads % m == 0:
                yield name, mod, "bert_attn"
            if mod.intermediate.dense.out_features % m == 0:
                yield name, mod, "bert_ff"


def _join(*parts: str) -> str:
    return ".".join(p for p in parts if p)


def _pair_linears(name: str, mod: nn.Module, kind: str) -> List[Tuple[str, nn.Linear, int]]:
    if kind == "attn":
        out = [(_join(name, n), getattr(mod, n), COLUMN) for n in ("linear_q", "linear_k", "linear_v")]
        if isinstance(mod, RelMultiHeadAttention):
            out.append((_join(name, "linear_pos"), mod.linear_pos, COLUMN))
        return out + [(_join(name, "linear_out"), mod.linear_out, ROW)]
    if kind == "ff":
        return [(_join(name, "w1"), mod.w1, COLUMN), (_join(name, "w2"), mod.w2, ROW)]
    sa = mod.attention.self
    if kind == "bert_attn":
        return [(_join(name, "attention.self", n), getattr(sa, n), COLUMN) for n in ("query", "key", "value")] + [
            (_join(name, "attention.output.dense"), mod.attention.output.dense, ROW)]
    return [(_join(name, "intermediate.dense"), mod.intermediate.dense, COLUMN),
            (_join(name, "output.dense"), mod.output.dense, ROW)]


def tp_plan(model: nn.Module, m: int) -> Dict[str, int]:
    """{parameter name: the dimension split over a model axis of `m`} of an
    unsplit model; empty for m = 1."""
    plan: Dict[str, int] = {}
    if m <= 1:
        return plan
    for name, mod, kind in _pairs(model, m):
        for prefix, lin, dim in _pair_linears(name, mod, kind):
            plan.update(_linear(prefix, dim, lin.bias is not None))
        if kind == "attn" and isinstance(mod, RelMultiHeadAttention):
            plan[_join(name, "pos_bias_u")] = 0
            plan[_join(name, "pos_bias_v")] = 0
    for name, mod in _vocab_modules(model, m):
        plan[_join(name, "weight")] = 0
        if getattr(mod, "bias", None) is not None:
            plan[_join(name, "bias")] = 0
    return plan


def _share(t: torch.Tensor, dim: int, mesh: Mesh) -> torch.Tensor:
    n = t.shape[dim] // mesh.model_size
    return t.narrow(dim, mesh.model_rank * n, n).contiguous()


def _set_share(mod: nn.Module, attr: str, dim: int, mesh: Mesh) -> None:
    p = getattr(mod, attr)
    setattr(mod, attr, nn.Parameter(_share(p.data, dim, mesh), requires_grad=p.requires_grad))


def _split_heads(attn: nn.Module, mesh: Mesh, rel: bool) -> None:
    """An attention's bookkeeping for its local heads: the reshape widths,
    the heads' place among all of them (the dropout's key), the dropout's
    split of its (B, H, T, T) probabilities."""
    heads = attn.num_heads
    local = heads // mesh.model_size
    attn.tp_heads = (mesh.model_rank * local, heads)
    attn.num_heads = local
    attn.hidden_size = attn.d_k * local
    if rel:
        _set_share(attn, "pos_bias_u", 0, mesh)
        _set_share(attn, "pos_bias_v", 0, mesh)


def prepare_model_(model: nn.Module, mesh: Optional[Mesh]) -> Dict[str, int]:
    """Lay `model` (built whole, on every rank from one seed) out on `mesh`
    in place: every `nn.Dropout` draws the global batch's mask, and over a
    model axis every pair of `tp_plan` keeps this rank's share.  Returns the
    plan (also kept as `model.tp_plan`).  No mesh, or a mesh of one rank:
    the model is left as it is."""
    if mesh is None or mesh.world == 1:
        return {}
    m = mesh.model_size
    plan = tp_plan(model, m)
    splits: Dict[int, Tuple[int, int, int]] = {}
    for name, mod, kind in list(_pairs(model, m)) if m > 1 else []:
        for _, lin, dim in _pair_linears(name, mod, kind):
            _set_share(lin, "weight", dim, mesh)
            if lin.bias is not None and dim == COLUMN:
                _set_share(lin, "bias", 0, mesh)
            lin.__class__ = ColumnParallelLinear if dim == COLUMN else RowParallelLinear
            lin.tp_group = mesh.model_group
            lin.in_features, lin.out_features = lin.weight.shape[1], lin.weight.shape[0]
        if kind == "attn":
            _split_heads(mod, mesh, isinstance(mod, RelMultiHeadAttention))
            splits[id(mod.attn_drop)] = (1,) + mod.tp_heads
        elif kind == "bert_attn":
            _split_heads(mod.attention.self, mesh, False)
            splits[id(mod.attention.self.dropout)] = (1,) + mod.attention.self.tp_heads
        elif kind == "ff":  # the dropout on its (B, T, F / m) inner activations
            inner = mod.w1.out_features
            splits[id(mod.dropout)] = (-1, mesh.model_rank * inner, inner * m)
    for _, mod in list(_vocab_modules(model, m)) if m > 1 else []:
        _set_share(mod, "weight", 0, mesh)
        if isinstance(mod, nn.Embedding):
            mod.__class__ = VocabParallelEmbedding
            mod.num_embeddings = mod.weight.shape[0]
        else:
            if mod.bias is not None:
                _set_share(mod, "bias", 0, mesh)
            mod.__class__ = VocabParallelHead
            mod.out_features = mod.weight.shape[0]
        mod.vocab_shard = VocabShard(mesh.model_group, mesh.model_rank, m, mod.weight.shape[0])
    for parent in list(model.modules()):
        for child_name, child in list(parent.named_children()):
            if type(child) is nn.Dropout:
                setattr(parent, child_name, Dropout(child.p, split=splits.get(id(child))))
    model.tp_plan = plan
    return plan


def full_tensors(mesh: Mesh, plan: Dict[str, int], tensors: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """`tensors` (by parameter name; this rank's shares where `plan` splits
    them) with the shares gathered whole, on every rank of the model group
    (one all-reduce of the zero-padded shares a dtype, on the mesh's
    device)."""
    if mesh.model_size == 1 or not plan:
        return dict(tensors)
    names = [n for n in tensors if n in plan]
    out = dict(tensors)
    fulls = []
    for n in names:
        t = tensors[n]
        dim = plan[n]
        shape = list(t.shape)
        shape[dim] *= mesh.model_size
        full = torch.zeros(shape, dtype=t.dtype, device=mesh.device)  # where the backend reduces
        full.narrow(dim, mesh.model_rank * t.shape[dim], t.shape[dim]).copy_(t)
        fulls.append(full)
    by_dtype: Dict[torch.dtype, List[torch.Tensor]] = {}
    for f in fulls:
        by_dtype.setdefault(f.dtype, []).append(f)
    for group in by_dtype.values():
        all_reduce_flat_(group, mesh.model_group)
    out.update(zip(names, fulls))
    return out


def shard_tensors(mesh: Mesh, plan: Dict[str, int], tensors: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """Whole `tensors` cut to this rank's shares where `plan` splits them."""
    if mesh.model_size == 1 or not plan:
        return dict(tensors)
    return {n: _share(t, plan[n], mesh) if n in plan else t for n, t in tensors.items()}
