"""Language models with a unified facade (PyTorch port of the Transformer LM
of `emoasr_tpu/models/lm/lm.py`).

Parity target: emoASR `lm/modeling/transformer.py:19-105` and the `LM`
facade (`lm/modeling/lm.py:22-66`): the Transformer LM is a BERT stack with
a causal mask under `transformer.` (`transformer.bert.*`,
`transformer.cls.predictions.*`); its stateless `predict` re-runs the full
prefix, `score` sums next-token log-probs.  The incremental steps
(`predict_step`, `predict_step_indirect`) serve shallow fusion in the beam
searches (`search/common.py::make_lm_fusion`).

The other LM types (BERT, RNN, ELECTRA, P-ELECTRA, P2W) and LM training
raise `NotImplementedError` until slice 6, the LM package (ROADMAP.md §1).
"""

from __future__ import annotations

from typing import Dict

import torch
from torch import nn

from emoasr_tpu_torch.config import ExpConfig
from emoasr_tpu_torch.models.lm.bert import BertMLMHead, BertStack, _Holder

SLICE_6 = "(ROADMAP.md §1, slice 6: the LM package)"

# reference checkpoint entries a causal LM does not use
POOLER_PREFIX = "transformer.bert.pooler."
HEAD_BIAS = "transformer.cls.predictions.bias"
HEAD_DECODER_BIAS = "transformer.cls.predictions.decoder.bias"


class TransformerLM(nn.Module):
    def __init__(self, cfg: ExpConfig):
        super().__init__()
        self.cfg = cfg
        self.transformer = _Holder(
            bert=BertStack(
                vocab_size=cfg.vocab_size, hidden_size=cfg.hidden_size,
                num_layers=cfg.num_layers, num_heads=cfg.num_attention_heads,
                intermediate_size=cfg.intermediate_size, max_seq_len=cfg.max_seq_len,
            ),
            cls=BertMLMHead(cfg.hidden_size, cfg.vocab_size),
        )

    @property
    def stack(self) -> BertStack:
        return self.transformer.bert

    @property
    def head(self) -> BertMLMHead:
        return self.transformer.cls

    def logits(self, ys, ylens=None):
        return self.head(self.stack(ys, ylens, causal=True))

    def forward(self, ys, ylens=None, labels=None, ps=None, plens=None):
        if labels is not None:
            raise NotImplementedError(f"LM training comes with its trainer {SLICE_6}")
        return self.logits(ys, ylens)

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
        logp = torch.log_softmax(self.logits(ys, ylens).float(), dim=-1)
        B, L, _ = logp.shape
        nxt = torch.nn.functional.pad(ys.long(), (0, 1))[:, 1:]
        tok_lp = torch.gather(logp, 2, nxt[:, :, None])[:, :, 0]
        valid = torch.arange(L, device=logp.device)[None, :] < (ylens.to(logp.device) - 1)[:, None]
        return torch.where(valid, tok_lp, torch.zeros_like(tok_lp)).sum(dim=1)


class LM(nn.Module):
    """Dispatching facade (lm/modeling/lm.py:22-66); the submodule `lm`
    gives reference checkpoints their `lm.` prefix."""

    def __init__(self, cfg: ExpConfig):
        super().__init__()
        self.cfg = cfg
        if cfg.lm_type != "transformer":
            raise NotImplementedError(f"lm_type={cfg.lm_type!r} is not ported yet {SLICE_6}")
        self.lm = TransformerLM(cfg)

    def forward(self, ys, ylens=None, labels=None, ps=None, plens=None):
        return self.lm(ys, ylens, labels, ps, plens)

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
    entries (`transformer.bert.pooler.*`), present in reference checkpoints
    and unused by a causal LM, are dropped; every other key must match.
    The head's bias is `transformer.cls.predictions.bias`, which
    `...predictions.decoder.bias` shares."""
    prefix = "lm." if any(k.startswith("lm.") for k in sd) else ""
    inner = {k[len(prefix):] if k.startswith(prefix) else k: v for k, v in sd.items()}
    inner = {k: v for k, v in inner.items() if not k.startswith(POOLER_PREFIX)}
    if HEAD_BIAS in inner:
        inner[HEAD_DECODER_BIAS] = inner[HEAD_BIAS]
    model.lm.load_state_dict(inner)

