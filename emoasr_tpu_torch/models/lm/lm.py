"""Language models with a unified facade (PyTorch port of the Transformer,
BERT and RNN LMs of `emoasr_tpu/models/lm/lm.py`).

Parity targets: emoASR `lm/modeling/{transformer,bert,rnn}.py` and the `LM`
facade (`lm/modeling/lm.py:22-66`):

- `TransformerLM`: a BERT stack with a causal mask under `transformer.`
  (`transformer.bert.*`, `transformer.cls.predictions.*`); its stateless
  `predict` re-runs the full prefix, `score` sums next-token log-probs; the
  incremental steps (`predict_step`, `predict_step_indirect`) serve shallow
  fusion in the beam searches (`search/common.py::make_lm_fusion`).
- `BERTMaskedLM`: the same stack, bidirectional, under `bert.`; trained on
  masked tokens; `score` is the pseudo-log-likelihood, each position masked
  in turn (`pseudo_log_likelihood`: chunks of masked copies, the vocabulary
  head applied at each copy's masked position only).
- `RNNLM`: embedding, one multi-layer LSTM (`rnns.*_l{k}`, the recurrence
  through `ops/lstm.py::lstm_scan`, K8 on the card for 8 steps or more),
  dropout, output projection; a one-token stateful `predict` from each
  row's last valid token; `score` with the Transformer LM's semantics.

Training (`labels` given) returns (loss, {"loss_total": loss}), the mean
cross-entropy over the labels that are not -100 (`bert.py::mlm_loss`).
ELECTRA, P-ELECTRA and the phone-to-word types raise `NotImplementedError`
until slice 6b (ROADMAP.md §1).
"""

from __future__ import annotations

from typing import Dict

import torch
from torch import nn

from emoasr_tpu_torch.config import ExpConfig
from emoasr_tpu_torch.models.lm.bert import BertMLMHead, BertStack, _Holder, mlm_loss
from emoasr_tpu_torch.ops.lstm import MultiLayerLSTM

SLICE_6B = "(ROADMAP.md §1, slice 6b: ELECTRA, P-ELECTRA and the phone-to-word LMs)"
LM_TYPES_6B = ("electra", "electra-disc", "pelectra", "pelectra-disc", "ptransformer", "pbert", "pctc")

# reference checkpoint entries an LM of this package does not use
POOLER = "bert.pooler."
HEAD_BIAS = "cls.predictions.bias"
HEAD_DECODER_BIAS = "cls.predictions.decoder.bias"

# masked copies a chunk of the pseudo-log-likelihood holds, in tokens
PLL_CHUNK_TOKENS = 1 << 16


def _bert_lm(cfg: ExpConfig) -> _Holder:
    return _Holder(
        bert=BertStack(
            vocab_size=cfg.vocab_size, hidden_size=cfg.hidden_size,
            num_layers=cfg.num_layers, num_heads=cfg.num_attention_heads,
            intermediate_size=cfg.intermediate_size, max_seq_len=cfg.max_seq_len,
        ),
        cls=BertMLMHead(cfg.hidden_size, cfg.vocab_size),
    )


def _next_token_score(logp: torch.Tensor, ys: torch.Tensor, ylens: torch.Tensor) -> torch.Tensor:
    """Sum of log p(ys[t + 1]) over positions 0..ylen-2 (B,)."""
    L = logp.shape[1]
    nxt = torch.nn.functional.pad(ys.long(), (0, 1))[:, 1:]
    tok_lp = torch.gather(logp, 2, nxt[:, :, None])[:, :, 0]
    valid = torch.arange(L, device=logp.device)[None, :] < (ylens.to(logp.device) - 1)[:, None]
    return torch.where(valid, tok_lp, torch.zeros_like(tok_lp)).sum(dim=1)


def _loss_or_logits(logits, labels):
    if labels is None:
        return logits
    loss = mlm_loss(logits, labels)
    return loss, {"loss_total": loss}


class TransformerLM(nn.Module):
    def __init__(self, cfg: ExpConfig):
        super().__init__()
        self.cfg = cfg
        self.transformer = _bert_lm(cfg)

    @property
    def stack(self) -> BertStack:
        return self.transformer.bert

    @property
    def head(self) -> BertMLMHead:
        return self.transformer.cls

    def logits(self, ys, ylens=None):
        return self.head(self.stack(ys, ylens, causal=True))

    def forward(self, ys, ylens=None, labels=None, ps=None, plens=None):
        return _loss_or_logits(self.logits(ys, ylens), labels)

    def zero_states(self, bs: int):
        return None  # stateless

    def predict(self, ys, ylens, states=None):
        """log p(next token) after each row's last valid token (B, V).  The
        last hidden is gathered before the vocabulary head: the head is
        position-wise, so head(h)[last] == head(h[last])."""
        h = self.stack(ys, ylens, causal=True)
        idx = (ylens.to(h.device).long() - 1)[:, None, None].expand(-1, 1, h.shape[-1])
        logits = self.head(torch.gather(h, 1, idx)[:, 0])
        return torch.log_softmax(logits.float(), dim=-1), states

    def init_cache(self, B: int, max_len: int, dtype=torch.float32, device=None):
        """Self-attention KV caches for incremental `predict_step`."""
        return self.stack.init_cache(B, max_len, dtype, device)

    def predict_step(self, tokens, pos, caches):
        """Incremental fusion step: consume `tokens` (B,) at `pos` (B,),
        return (log p(next) (B, V), caches).  Equals `predict` on the full
        prefix; the caches are written in place."""
        h, caches = self.stack.step(tokens, pos, caches)
        return torch.log_softmax(self.head(h).float(), dim=-1), caches

    def predict_step_indirect(self, tokens, pos, caches, anc):
        """`predict_step` over (B, W) beams with physical-slot caches and an
        ancestor table (see bert.py::BertSelfAttention.step_indirect)."""
        h, caches = self.stack.step_indirect(tokens, pos, caches, anc)
        return torch.log_softmax(self.head(h).float(), dim=-1), caches

    def score(self, ys, ylens):
        """Sum of next-token log-probs over positions 0..ylen-2 (B,)."""
        return _next_token_score(torch.log_softmax(self.logits(ys, ylens).float(), dim=-1), ys, ylens)


def pseudo_log_likelihood(stack: BertStack, head: BertMLMHead, ys: torch.Tensor, ylens: torch.Tensor,
                          mask_id: int) -> torch.Tensor:
    """(B, L) log p(ys[b, p] | ys[b] with position p masked), 0 at p >=
    ylens[b] (bert.py:54-86; the JAX package's `BERTMaskedLM.score` and
    `test_ppl._masked_nll` in one (B L, L) batch).

    The masked copies of the valid positions go through the stack in chunks
    of about PLL_CHUNK_TOKENS tokens, and the vocabulary head runs only at
    each copy's masked position (it is position-wise), so no (B L, L, V)
    logits are made: at a (11, 256) batch and V = 10000 those would take
    28.8 GB in float32."""
    B, L = ys.shape
    dev = ys.device
    ylens = ylens.to(dev).long()
    out = torch.zeros((B, L), dtype=torch.float32, device=dev)
    b_idx, p_idx = torch.nonzero(torch.arange(L, device=dev)[None, :] < ylens[:, None], as_tuple=True)
    per_chunk = max(1, PLL_CHUNK_TOKENS // L)
    for i in range(0, b_idx.numel(), per_chunk):
        b, p = b_idx[i:i + per_chunk], p_idx[i:i + per_chunk]
        n = torch.arange(b.numel(), device=dev)
        masked = ys[b].clone()
        masked[n, p] = mask_id
        h = stack(masked, ylens[b], causal=False)
        logp = torch.log_softmax(head(h[n, p]).float(), dim=-1)
        out[b, p] = logp[n, ys[b, p].long()]
    return out


class BERTMaskedLM(nn.Module):
    def __init__(self, cfg: ExpConfig):
        super().__init__()
        self.cfg = cfg
        self.bert = _bert_lm(cfg)

    @property
    def stack(self) -> BertStack:
        return self.bert.bert

    @property
    def head(self) -> BertMLMHead:
        return self.bert.cls

    def logits(self, ys, ylens=None):
        return self.head(self.stack(ys, ylens, causal=False))

    def forward(self, ys, ylens=None, labels=None, ps=None, plens=None):
        return _loss_or_logits(self.logits(ys, ylens), labels)

    def zero_states(self, bs: int):
        return None

    def predict(self, ys, ylens, states=None):
        """MLM fill-in: log-probs at every position (B, L, V)."""
        return torch.log_softmax(self.logits(ys, ylens).float(), dim=-1), states

    def score(self, ys, ylens):
        """Pseudo-log-likelihood: each valid position masked in turn, the
        target's log-prob summed (B,)."""
        return pseudo_log_likelihood(self.stack, self.head, ys, ylens, self.cfg.mask_id).sum(dim=1)


class RNNLM(nn.Module):
    def __init__(self, cfg: ExpConfig):
        super().__init__()
        self.cfg = cfg
        emb = cfg.embedding_size or cfg.hidden_size
        self.embed = nn.Embedding(cfg.vocab_size, emb)
        self.rnns = MultiLayerLSTM(emb, cfg.hidden_size, cfg.num_layers, cfg.dropout_rate)
        self.output = nn.Linear(cfg.hidden_size, cfg.vocab_size)
        self.dropout = nn.Dropout(cfg.dropout_rate)

    def logits(self, ys, states=None):
        """(logits (B, L, V), new states (layers, 2, B, H))."""
        out, new_states = self.rnns(self.dropout(self.embed(ys.long())), states)
        return self.output(self.dropout(out)), new_states

    def forward(self, ys, ylens=None, labels=None, ps=None, plens=None):
        return _loss_or_logits(self.logits(ys)[0], labels)

    def zero_states(self, bs: int):
        w = self.output.weight
        return torch.zeros((self.cfg.num_layers, 2, bs, self.cfg.hidden_size), dtype=w.dtype, device=w.device)

    def predict(self, ys, ylens, states=None):
        """One step from each row's last valid token (rnn.py:62-81): (log
        p(next) (B, V), new states)."""
        last = torch.gather(ys, 1, (ylens.to(ys.device).long() - 1)[:, None])
        if states is None:
            states = self.zero_states(ys.shape[0])
        logits, new_states = self.logits(last, states)
        return torch.log_softmax(logits.float(), dim=-1)[:, -1], new_states

    def score(self, ys, ylens):
        """Sum of next-token log-probs over positions 0..ylen-2 (B,) (the
        reference leaves it unimplemented; the JAX package gives it the
        Transformer LM's semantics)."""
        return _next_token_score(torch.log_softmax(self.logits(ys)[0].float(), dim=-1), ys, ylens)


class LM(nn.Module):
    """Dispatching facade (lm/modeling/lm.py:22-66); the submodule `lm`
    gives reference checkpoints their `lm.` prefix."""

    def __init__(self, cfg: ExpConfig):
        super().__init__()
        self.cfg = cfg
        t = cfg.lm_type
        if t == "transformer":
            self.lm = TransformerLM(cfg)
        elif t == "bert":
            self.lm = BERTMaskedLM(cfg)
        elif t == "rnn":
            self.lm = RNNLM(cfg)
        elif t in LM_TYPES_6B:
            raise NotImplementedError(f"lm_type={t!r} is not ported yet {SLICE_6B}")
        else:
            raise ValueError(t)

    def forward(self, ys, ylens=None, labels=None, ps=None, plens=None):
        return self.lm(ys, ylens, labels, ps, plens)

    def zero_states(self, bs: int):
        return self.lm.zero_states(bs)

    def predict(self, ys, ylens, states=None):
        return self.lm.predict(ys, ylens, states)

    def init_cache(self, B: int, max_len: int, dtype=torch.float32, device=None):
        return self.lm.init_cache(B, max_len, dtype, device)

    def predict_step(self, tokens, pos, caches):
        return self.lm.predict_step(tokens, pos, caches)

    def predict_step_indirect(self, tokens, pos, caches, anc):
        return self.lm.predict_step_indirect(tokens, pos, caches, anc)

    def score(self, ys, ylens):
        return self.lm.score(ys, ylens)


def load_lm_state_dict(model: LM, sd: Dict[str, torch.Tensor]) -> None:
    """Load a reference-layout LM checkpoint into `model`.

    Its keys may carry the facade's `lm.` prefix or not.  The pooler
    entries (`transformer.bert.pooler.*`, `bert.bert.pooler.*`), present in
    reference checkpoints and unused here, are dropped; every other key
    must match.  The MLM head's bias is `<prefix>cls.predictions.bias`,
    which `...predictions.decoder.bias` shares."""
    prefix = "lm." if any(k.startswith("lm.") for k in sd) else ""
    inner = {k[len(prefix):] if k.startswith(prefix) else k: v for k, v in sd.items()}
    for top in ("transformer.", "bert."):
        inner = {k: v for k, v in inner.items() if not k.startswith(top + POOLER)}
        if top + HEAD_BIAS in inner:
            inner[top + HEAD_DECODER_BIAS] = inner[top + HEAD_BIAS]
    model.lm.load_state_dict(inner)
