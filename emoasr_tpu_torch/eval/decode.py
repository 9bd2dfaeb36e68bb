"""Batched decoding front-end (PyTorch port of
`emoasr_tpu/eval/decode.py::build_decode_fn`).

One call decodes a whole padded bucket batch: greedy or the CTC prefix beam
search for a CTC model, greedy or the ALSD beam search for an RNN-T model,
the joint-CTC attention beam search for a Transformer decoder, greedy or
the LAS beam (`search/las_beam.py`) for a LAS decoder; every beam takes LM
shallow fusion (an `LMFusion`, search/common.py).
The JAX package's packing and coalescing helpers worked around a remote
transport and are not carried.
"""

from __future__ import annotations

from typing import Callable, Optional

import torch

from emoasr_tpu_torch.config import ExpConfig
from emoasr_tpu_torch.models.asr import ASR
from emoasr_tpu_torch.models.layers import make_pad_mask
from emoasr_tpu_torch.search.attention_beam import attention_beam_search
from emoasr_tpu_torch.search.common import LMFusion
from emoasr_tpu_torch.search.ctc_beam import ctc_beam_search
from emoasr_tpu_torch.search.rnnt_beam import rnnt_beam_search
from emoasr_tpu_torch.train.step import preprocess
from emoasr_tpu_torch.utils.device import resolve_device
from emoasr_tpu_torch.utils.precision import cast_floating, dtype_of, is_half


DEC_STEP_MODES = ("auto", "dense", "fused", "indirect", "fused_indirect")


def ctc_len_caps(cfg: ExpConfig, ctc_log_probs: torch.Tensor, elens: torch.Tensor) -> torch.Tensor:
    """Per-utterance decode-step budget from the collapsed CTC greedy
    length: cap = ratio * est + margin (clamped to max_decode_ylen)."""
    am = torch.argmax(ctc_log_probs, dim=-1)  # (B, T)
    prev = torch.nn.functional.pad(am[:, :-1], (1, 0), value=-1)
    valid = torch.arange(am.shape[1], device=am.device)[None, :] < elens[:, None]
    est = ((am != cfg.blank_id) & (am != prev) & valid).sum(dim=1).to(torch.float32)
    return _caps(cfg, est)


def _caps(cfg: ExpConfig, est: torch.Tensor) -> torch.Tensor:
    return (
        torch.ceil(cfg.decode_cap_ratio * est) + cfg.decode_cap_margin
    ).clamp(1, cfg.max_decode_ylen).to(torch.int32)


def build_decode_fn(
    model: ASR,
    cfg: ExpConfig,
    beam_width: int = 0,
    len_weight: float = 0.0,
    decode_ctc_weight: float = 0.0,
    lm: Optional[LMFusion] = None,
    top1: bool = False,
    device=None,
    decode_phone: bool = False,
) -> Callable:
    """Returns fn(xs, xlens) -> (hyps, hyp_lens, scores), tensors on the
    model's device.

    The model moves to `device` (the card when None; "cpu" must be asked
    for) and is put in eval mode; under a half compute dtype its floating
    parameters are cast once.  Beam hyps carry framing eos tokens (the
    caller strips them); greedy returns collapsed label sequences with
    zero scores.  `lm` fuses an LM into either beam (its states live on the
    device of the LM's parameters: build it there).
    `fn.with_weights(lm_w, len_w)` returns a sibling bound to another LM
    weight and length weight (None keeps the current one; without `lm` the
    LM weight has nothing to weigh).

    Transformer decoder: `cfg.dec_step_mode` picks the step route (`auto` =
    `indirect`; `fused` and `fused_indirect` send every layer step to the
    fused kernel), `cfg.decode_len_cap` the per-utterance step budgets, and
    `top1=True` (every eval mode except --nbest) lets the beam stop a row as
    soon as its stored best is provably unbeatable (exact for the returned
    hypothesis, see `attention_beam_search`).

    `decode_phone` decodes a CTC model's phone head (greedy or the prefix
    beam), from the intermediate layer when `hie_mtl_phone`.

    RNN-T decoder: greedy for `beam_width <= 1` or `decode_ctc_weight == 1`
    (as the JAX package chooses), else the ALSD beam with hypotheses of at
    most `max_decode_ylen` labels after the leading eos.

    LAS decoder: greedy for `beam_width <= 1`, else the LAS beam (JAX
    `decode.py:429-443`)."""
    if cfg.decoder_type not in ("ctc", "transformer", "rnn_transducer", "las"):
        raise ValueError(f"decoder_type={cfg.decoder_type!r}")
    if cfg.dec_step_mode not in DEC_STEP_MODES:
        raise ValueError(f"dec_step_mode={cfg.dec_step_mode!r}: one of {DEC_STEP_MODES}")
    # the attention decoder has no greedy path (the reference also runs its
    # beam loop for width 1, transformer.py:160+): clamp to a 1-wide beam
    if cfg.decoder_type == "transformer" and beam_width <= 1:
        beam_width = 1
    dev = resolve_device(device)
    model = model.to(dev).eval()
    half = is_half(cfg)
    if half:
        cast_floating(model, dtype_of(cfg))

    def inputs(xs, xlens):
        xs = torch.as_tensor(xs).to(dev, dtype_of(cfg) if half else torch.float32)
        return preprocess(cfg, xs, torch.as_tensor(xlens).to(dev, torch.int64))

    def make(lw: float, lm_t: Optional[LMFusion]):
        @torch.no_grad()
        def decode_greedy(xs, xlens):
            xs, xlens = inputs(xs, xlens)
            hyps, hyp_lens, _, _ = model.decode_greedy(xs, xlens, decode_phone)
            return hyps, hyp_lens, torch.zeros(hyp_lens.shape, dtype=torch.float32, device=dev)

        @torch.no_grad()
        def decode_ctc_beam(xs, xlens):
            xs, xlens = inputs(xs, xlens)
            eouts, elens, eouts_inter = model.encode(xs, xlens)
            if decode_phone and cfg.hie_mtl_phone:
                eouts = eouts_inter
            head = model.decoder.phone_logits if decode_phone else model.decoder.logits
            lp = torch.log_softmax(head(eouts).float(), dim=-1)
            return ctc_beam_search(
                lp, elens, beam_width, cfg.blank_id, cfg.eos_id, lw, lm=lm_t,
            )

        @torch.no_grad()
        def decode_att_beam(xs, xlens):
            xs, xlens = inputs(xs, xlens)
            eouts, elens, _ = model.encode(xs, xlens)
            B, T = eouts.shape[0], eouts.shape[1]
            W = beam_width
            dec = model.decoder
            # encoder-side cross-attention K/V projected once per batch and
            # kept per-utterance: the beam step attends all W beams as W
            # query positions, so the K/V are read once per utterance per step
            cross_kvs = dec.precompute_cross_kv(eouts)
            emask = make_pad_mask(elens, T)[:, None, None, :]
            cache_dtype = dtype_of(cfg) if half else torch.float32
            elens_step = elens.to(torch.int32)  # as the fused step reads them

            def init_cache_fn(N, Lmax):
                return dec.init_cache(N, Lmax, dtype=cache_dtype, device=dev)

            # "auto" selects the ancestor-indirect step: it never permutes
            # the (B, W, Lc, H, dk) caches and is exact for this label-sync
            # search
            step_mode = "indirect" if cfg.dec_step_mode == "auto" else cfg.dec_step_mode

            def step_cached_fn(tokens, pos, caches):
                return dec.decode_step_cached(
                    tokens, pos, caches, cross_kvs, emask,
                    beam_width=W, step_mode=step_mode, elens=elens_step,
                )

            cached_step = (init_cache_fn, step_cached_fn)
            if step_mode in ("indirect", "fused_indirect"):
                def step_indirect_fn(tokens, pos, caches, anc):
                    return dec.decode_step_cached_indirect(
                        tokens, pos, caches, anc, cross_kvs, emask,
                        beam_width=W, step_mode=step_mode, elens=elens_step,
                    )

                cached_step += (step_indirect_fn,)

            def ctc_log_probs():
                return torch.log_softmax(dec.ctc.logits(eouts).float(), dim=-1)

            ctc_lp = ctc_log_probs() if decode_ctc_weight > 0 else None
            row_caps = None
            if cfg.decode_len_cap == "on" or (cfg.decode_len_cap == "auto" and ctc_lp is not None):
                if ctc_lp is not None:
                    row_caps = ctc_len_caps(cfg, ctc_lp, elens)
                elif cfg.mtl_ctc_weight > 0:
                    # the aux CTC head exists even when joint scoring is off
                    row_caps = ctc_len_caps(cfg, ctc_log_probs(), elens)
                else:
                    # no CTC head: bound by the (subsampled) frame count with
                    # the same ratio + margin (attention decoders have no
                    # monotonic alignment, so frames alone are no hard bound)
                    row_caps = _caps(cfg, elens.to(torch.float32))

            return attention_beam_search(
                eouts, elens, None,
                vocab_size=cfg.vocab_size,
                beam_width=W,
                eos_id=cfg.eos_id,
                blank_id=cfg.blank_id,
                len_weight=lw,
                lm=lm_t,
                decode_ctc_weight=decode_ctc_weight,
                ctc_log_probs=ctc_lp,
                max_decode_ylen=cfg.max_decode_ylen,
                cached_step=cached_step,
                row_caps=row_caps,
                need_results=1 if top1 else None,
            )

        @torch.no_grad()
        def decode_rnnt_beam(xs, xlens):
            xs, xlens = inputs(xs, xlens)
            eouts, elens, _ = model.encode(xs, xlens)
            dec = model.decoder

            def rec(tok, ds):
                d, st = dec.recurrency(tok, ds)
                return d[:, 0], st

            return rnnt_beam_search(
                eouts, elens, rec, dec.joint_step,
                num_layers=cfg.dec_num_layers,
                dec_hidden=cfg.dec_hidden_size,
                beam_width=beam_width,
                vocab_size=cfg.vocab_size,
                blank_id=cfg.blank_id,
                eos_id=cfg.eos_id,
                max_hyp_len=cfg.max_decode_ylen + 1,
                lm=lm_t,
            )

        @torch.no_grad()
        def decode_las_beam(xs, xlens):
            xs, xlens = inputs(xs, xlens)
            eouts, elens, _ = model.encode(xs, xlens)
            return model.decoder.decode_beam(eouts, elens, beam_width, lw, lm=lm_t)

        if cfg.decoder_type == "transformer":
            fn = decode_att_beam
        elif cfg.decoder_type == "las":
            fn = decode_greedy if beam_width <= 1 else decode_las_beam
        elif cfg.decoder_type == "rnn_transducer":
            greedy = beam_width <= 1 or decode_ctc_weight == 1
            fn = decode_greedy if greedy else decode_rnnt_beam
        else:
            fn = decode_greedy if beam_width <= 1 else decode_ctc_beam

        def with_weights(lm_w=None, len_w=None):
            lm_w_t = lm_t if lm_t is None or lm_w is None else lm_t._replace(weight=float(lm_w))
            return make(lw if len_w is None else float(len_w), lm_w_t)

        fn.with_weights = with_weights
        return fn

    return make(float(len_weight), lm)
