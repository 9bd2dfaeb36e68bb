"""Language models with a unified facade (PyTorch port of
`emoasr_tpu/models/lm/lm.py`).

Parity targets: emoASR `lm/modeling/{transformer,bert,rnn,electra,p2w}.py`
and the `LM` facade (`lm/modeling/lm.py:22-66`):

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
- `ELECTRAModel` (`gmodel.*`, `dmodel.*`, electra.py:33-133): a generator
  (masked LM) and a discriminator, each a BERT stack with an embedding
  projection; training samples the generator at the masked positions
  (`sample_categorical`, from the `torch.Generator` the caller passes in),
  detaches the sample, and adds `electra_disc_weight` times the
  discriminator's BCE on "replaced" to the generator's loss; `score` is
  minus the sum of the discriminator's sigmoid over the valid positions;
  `predict` is the generator's log-probs at each row's last position.
- `P2W` (`encoder.*`, `decoder.*`, p2w.py:20-107): a phone encoder (the
  Transformer encoder with the `embed` input layer, K4 with
  `enc_fused_attn`) and a word decoder: autoregressive (`ptransformer`,
  `ylens - 1` into the decoder), CMLM (`pbert`, pad-only mask, masked-LM
  loss) or CTC (`pctc`, with greedy decoding).
- `PELECTRAModel` (`gmodel.encoder.*`, `gmodel.decoder.*`, `dmodel.*`,
  electra.py:136-233): a CMLM P2W generator and a BERT discriminator.

Training (`labels` given) returns (loss, loss_dict); the `*-disc` types
train the discriminator alone on ASR error labels (`forward_disc`).
"""

from __future__ import annotations

from typing import Dict, Optional

import torch
from torch import nn

from emoasr_tpu_torch.config import ExpConfig
from emoasr_tpu_torch.models.decoders.ctc import CTCDecoder
from emoasr_tpu_torch.models.decoders.transformer import TransformerDecoder
from emoasr_tpu_torch.models.encoders import TransformerEncoder
from emoasr_tpu_torch.models.layers import make_pad_mask
from emoasr_tpu_torch.models.lm.bert import (
    BertMLMHead,
    BertStack,
    ElectraDiscriminatorHead,
    ElectraGeneratorHead,
    _Holder,
    disc_bce_loss,
    mlm_loss,
)
from emoasr_tpu_torch.ops.lstm import MultiLayerLSTM
from emoasr_tpu_torch.parallel.mesh import gather_model, global_rows, rows_block
from emoasr_tpu_torch.parallel.vocab import vocab_shard

ELECTRA_TYPES = ("electra", "electra-disc")
PELECTRA_TYPES = ("pelectra", "pelectra-disc")
P2W_TYPES = ("ptransformer", "pbert", "pctc")
DISC_TYPES = ("electra-disc", "pelectra-disc")
# the types whose batches carry phones (`ps`, `plens`)
PHONE_TYPES = P2W_TYPES + PELECTRA_TYPES
LM_TYPES = ("transformer", "bert", "rnn") + ELECTRA_TYPES + PELECTRA_TYPES + P2W_TYPES

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


def _loss_or_logits(logits, labels, shard=None):
    if labels is None:
        return logits
    loss = mlm_loss(logits, labels, shard=shard)
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
        return _loss_or_logits(self.logits(ys)[0], labels, vocab_shard(self.output))

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



def _gather_last(h: torch.Tensor, ylens: torch.Tensor) -> torch.Tensor:
    """(B, L, D), (B,) -> (B, D) at position ylen - 1."""
    idx = (ylens.to(h.device).long() - 1)[:, None, None].expand(-1, 1, h.shape[-1])
    return torch.gather(h, 1, idx)[:, 0]


def sample_categorical(logits: torch.Tensor, generator: Optional[torch.Generator] = None,
                       temp: float = 1.0, shard=None) -> torch.Tensor:
    """One draw from softmax(logits / temp) over the last axis, by the
    Gumbel-max rule from `generator`'s uniforms (electra.py:20-30; temp 0
    is the argmax).  On a mesh that splits the batch the whole batch's
    uniforms are drawn and this rank's rows kept; under a vocabulary
    `shard` (logits: the rank's columns) the whole vocabulary's, the rank's
    columns kept, and the ranks' best columns compared (the first of equal
    ones, as `torch.argmax` takes it)."""
    if temp == 0.0:
        scores = logits
    else:
        first, total = rows_block(logits.shape[0]) or (0, logits.shape[0])
        V = logits.shape[-1] if shard is None else shard.total
        u = torch.rand((total,) + tuple(logits.shape[1:-1]) + (V,), generator=generator,
                       device=logits.device)[first:first + logits.shape[0]]
        if shard is not None:
            u = u[..., shard.v0:shard.v0 + shard.local]
        gumbel = -torch.log(-torch.log(u.clamp(min=torch.finfo(torch.float32).tiny)))
        scores = logits.float() / temp + gumbel
    best = torch.argmax(scores, dim=-1)
    if shard is None:
        return best
    top = torch.gather(scores, -1, best[..., None])[..., 0]
    tops = gather_model(top.float(), shard.group, shard.rank, shard.size)
    cols = gather_model((best + shard.v0).float(), shard.group, shard.rank, shard.size)
    return torch.gather(cols, 0, torch.argmax(tops, dim=0)[None])[0].long()


def _electra_stack(cfg: ExpConfig, part: str) -> BertStack:
    g = lambda k: getattr(cfg, f"{part}_{k}")  # noqa: E731
    return BertStack(
        vocab_size=cfg.vocab_size, hidden_size=g("hidden_size"), num_layers=g("num_layers"),
        num_heads=g("num_attention_heads"), intermediate_size=g("intermediate_size"),
        max_seq_len=cfg.max_seq_len, embedding_size=g("embedding_size"),
    )


def _electra_discriminator(cfg: ExpConfig) -> ElectraDiscriminatorHead:
    """`dmodel`: the head, with the discriminator's stack as `electra`."""
    dmodel = ElectraDiscriminatorHead(cfg.disc_hidden_size)
    dmodel.electra = _electra_stack(cfg, "disc")
    return dmodel


class _Discriminated(nn.Module):
    """What ELECTRA and P-ELECTRA share: the discriminator (`dmodel`), its
    joint loss with a generator's, the `*-disc` training and `score`."""

    def discriminator(self, ys, ylens):
        """(B, L) logits: "this token was replaced"."""
        return self.dmodel(self.dmodel.electra(ys, ylens, causal=False))

    def joint(self, gloss, ys, ylens, labels, generated):
        """(loss, loss_dict) of one ELECTRA step given the generator's loss
        and the (detached) tokens it produced (electra.py:71-113): a token
        counts as replaced where `generated` differs from the original."""
        masked = labels != -100
        original = torch.where(masked, labels, ys)
        replaced = (generated != original).long()
        dloss = disc_bce_loss(self.discriminator(generated, ylens), replaced, ylens)
        loss = gloss + self.cfg.electra_disc_weight * dloss
        B = ys.shape[0]
        return loss, {
            "loss_total": loss,
            "loss_gen": gloss,
            "loss_disc": dloss,
            "num_replaced": replaced.sum() / global_rows(B),
            "num_masked": masked.sum() / global_rows(B),
        }

    def sample_replacements(self, glogits, ys, labels, generator=None, shard=None):
        """The generator's draws at the masked positions, `ys` elsewhere,
        detached (the JAX package's `stop_gradient`); `shard`: glogits are
        the rank's columns of a vocabulary-split head."""
        with torch.no_grad():
            masked = labels != -100
            sample = (sample_categorical(glogits.detach(), generator) if shard is None
                      else sample_categorical(glogits.detach(), generator, shard=shard))
            return torch.where(masked, sample, ys.long())

    def forward_disc(self, ys, ylens=None, error_labels=None):
        """Discriminator-only training on ASR error labels ("*-disc")."""
        loss = disc_bce_loss(self.discriminator(ys, ylens), error_labels, ylens)
        return loss, {"loss_total": loss}

    def zero_states(self, bs: int):
        return None

    def score(self, ys, ylens):
        """-sum sigmoid(discriminator logits) over the valid positions (B,)
        (electra.py:116-132)."""
        probs = torch.sigmoid(self.discriminator(ys, ylens).float())
        valid = make_pad_mask(ylens.to(ys.device), ys.shape[1])
        return -torch.where(valid, probs, torch.zeros_like(probs)).sum(dim=1)


class ELECTRAModel(_Discriminated):
    def __init__(self, cfg: ExpConfig):
        super().__init__()
        self.cfg = cfg
        self.gmodel = ElectraGeneratorHead(cfg.gen_hidden_size, cfg.gen_embedding_size or cfg.gen_hidden_size,
                                           cfg.vocab_size)
        self.gmodel.electra = _electra_stack(cfg, "gen")
        self.dmodel = _electra_discriminator(cfg)

    def generator_logits(self, ys, ylens):
        return self.gmodel(self.gmodel.electra(ys, ylens, causal=False))

    def forward(self, ys, ylens=None, labels=None, ps=None, plens=None, generator=None):
        """Joint generator + discriminator training (electra.py:71-113);
        `generator` draws the replacements."""
        glogits = self.generator_logits(ys, ylens)
        gloss = mlm_loss(glogits, labels)
        return self.joint(gloss, ys, ylens, labels, self.sample_replacements(glogits, ys, labels, generator))

    def predict(self, ys, ylens, states=None):
        """The generator's log-probs at each row's last position (B, V); the
        head is position-wise, so it runs there only."""
        h = _gather_last(self.gmodel.electra(ys, ylens, causal=False), ylens)
        return torch.log_softmax(self.gmodel(h).float(), dim=-1), states


class P2W(nn.Module):
    """Phone-to-word model (PC-MLM family): a phone encoder and a word
    decoder of type `decoder_type` (transformer | bert | ctc; from
    `lm_type` when None)."""

    def __init__(self, cfg: ExpConfig, decoder_type: Optional[str] = None):
        super().__init__()
        self.cfg = cfg
        dt = decoder_type or {"ptransformer": "transformer", "pbert": "bert", "pctc": "ctc"}[cfg.lm_type]
        self.decoder_type = dt
        self.encoder = TransformerEncoder(cfg.replace(input_layer="embed"))
        if dt == "transformer":
            self.decoder = TransformerDecoder(cfg)
        elif dt == "bert":
            self.decoder = TransformerDecoder(cfg, cmlm=True)
        elif dt == "ctc":
            self.decoder = CTCDecoder(cfg)
        else:
            raise ValueError(dt)

    def forward(self, ys=None, ylens=None, labels=None, ps=None, plens=None, return_logits: bool = False):
        """The logits without `labels` (the CTC decoder: always its loss),
        else (loss, loss_dict[, logits]).  The autoregressive decoder gets
        `ylens - 1`: it builds its causal mask over `ylens + 1`
        (p2w.py:85-87)."""
        eouts, elens, _ = self.encoder(ps, plens)
        if self.decoder_type == "ctc":
            loss, loss_dict, logits = self.decoder(eouts, elens, ys=ys, ylens=ylens)
            return (loss, loss_dict, logits) if return_logits else (loss, loss_dict)
        dec_ylens = ylens - 1 if self.decoder_type == "transformer" else ylens
        if labels is None:
            return self.decoder(eouts, elens, None, ys, dec_ylens, ys_in=ys, ys_out=None)
        loss, loss_dict, logits = self.decoder(eouts, elens, None, ys, dec_ylens, ys_in=ys, ys_out=labels)
        return (loss, loss_dict, logits) if return_logits else (loss, loss_dict)

    def predict(self, ys, ylens, ps=None, plens=None):
        """Fill-in log-probs conditioned on phones (B, L, V) (for error
        correction)."""
        eouts, elens, _ = self.encoder(ps, plens)
        logits = self.decoder(eouts, elens, None, ys, ylens, ys_in=ys, ys_out=None)
        return torch.log_softmax(logits.float(), dim=-1), None

    def decode_greedy(self, ps, plens):
        """The cascade's phone -> word path (p2w.py:101-107), CTC only."""
        if self.decoder_type != "ctc":
            raise NotImplementedError("P2W greedy decoding is the CTC decoder's (lm_type 'pctc')")
        eouts, elens, _ = self.encoder(ps, plens)
        hyps, hyp_lens, _, _ = self.decoder.greedy(eouts, elens)
        return hyps, hyp_lens


class PELECTRAModel(_Discriminated):
    """Phone-conditioned ELECTRA: a CMLM P2W generator, a BERT
    discriminator."""

    def __init__(self, cfg: ExpConfig):
        super().__init__()
        self.cfg = cfg
        self.gmodel = P2W(cfg, decoder_type="bert")
        self.dmodel = _electra_discriminator(cfg)

    def forward(self, ys, ylens=None, labels=None, ps=None, plens=None, generator=None):
        gloss, _, glogits = self.gmodel(ys, ylens, labels, ps, plens, return_logits=True)
        return self.joint(gloss, ys, ylens, labels, self.sample_replacements(
            glogits, ys, labels, generator, vocab_shard(self.gmodel.decoder.output)))


def p2w_pseudo_log_likelihood(model: P2W, ys: torch.Tensor, ylens: torch.Tensor, ps: torch.Tensor,
                              plens: torch.Tensor, mask_id: int) -> torch.Tensor:
    """(B, L) log p(ys[b, p] | ys[b] with position p masked, phones ps[b]),
    0 at p >= ylens[b]: the JAX package's `test_ppl._masked_nll` for a CMLM
    P2W (`pbert`), which repeats the phones L times into one (B L, L) batch.

    The phones are encoded once an utterance; the masked copies of the
    valid positions go through the decoder in chunks of about
    PLL_CHUNK_TOKENS word tokens, each over its utterance's encoder output,
    and the output layer runs at each copy's masked position only."""
    B, L = ys.shape
    dev = ys.device
    ylens = ylens.to(dev).long()
    eouts, elens, _ = model.encoder(ps, plens)
    emask = make_pad_mask(elens.to(dev), eouts.shape[1])[:, None, None, :]
    dec = model.decoder
    out = torch.zeros((B, L), dtype=torch.float32, device=dev)
    b_idx, p_idx = torch.nonzero(torch.arange(L, device=dev)[None, :] < ylens[:, None], as_tuple=True)
    per_chunk = max(1, PLL_CHUNK_TOKENS // L)
    for i in range(0, b_idx.numel(), per_chunk):
        b, p = b_idx[i:i + per_chunk], p_idx[i:i + per_chunk]
        n = torch.arange(b.numel(), device=dev)
        masked = ys[b].clone()
        masked[n, p] = mask_id
        ymask = make_pad_mask(ylens[b], L)[:, None, None, :]
        h = dec._decode_stack(masked, ymask, eouts[b], emask[b])
        logp = torch.log_softmax(dec.output(dec.norm(h[n, p])).float(), dim=-1)
        out[b, p] = logp[n, ys[b, p].long()]
    return out


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
        elif t in ELECTRA_TYPES:
            self.lm = ELECTRAModel(cfg)
        elif t in PELECTRA_TYPES:
            self.lm = PELECTRAModel(cfg)
        elif t in P2W_TYPES:
            self.lm = P2W(cfg)
        else:
            raise ValueError(t)

    def forward(self, ys, ylens=None, labels=None, ps=None, plens=None, generator=None, error_labels=None):
        """`generator` draws ELECTRA's and P-ELECTRA's replacements (the
        other types draw nothing); with `error_labels`, `forward_disc`."""
        if error_labels is not None:
            return self.forward_disc(ys, ylens, error_labels)
        if isinstance(self.lm, _Discriminated):
            return self.lm(ys, ylens, labels, ps, plens, generator=generator)
        return self.lm(ys, ylens, labels, ps, plens)

    def forward_disc(self, ys, ylens=None, error_labels=None):
        return self.lm.forward_disc(ys, ylens, error_labels)

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
