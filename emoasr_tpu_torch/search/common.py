"""Shared machinery for batched beam search (PyTorch port of the parts of
`emoasr_tpu/search/common.py` that the CTC prefix beam and the attention
beam need: hashes, top-k, beam gathers, and the LM-fusion adapter).

Every search advances a fixed-width (B, W) beam tensor.  Hypothesis
identity for path merging uses a pair of incremental 32-bit polynomial
hashes instead of exact string compare: collision probability is ~2^-64
per candidate pair, and the merge stays O(C^2) in scalars.

The hashes wrap modulo 2^32 exactly as the JAX package's uint32 arithmetic
does.  PyTorch's uint32 support is thin, so they are held in int64 and
masked with 0xFFFFFFFF after every multiply and add; the products stay
below 2^57, so no int64 overflow occurs before the mask.
"""

from __future__ import annotations

from typing import Any, Callable, NamedTuple, Optional, Tuple

import torch

from emoasr_tpu_torch.models.lm.lm import PHONE_TYPES
from emoasr_tpu_torch.ops.topk import topk_lastdim_kernel, topk_plain

DEAD = -1e30  # score of dead/pruned beam slots

HASH_P1 = 1000003
HASH_P2 = 0x01000193  # FNV prime
_MASK32 = 0xFFFFFFFF

# the kernel's gate, as in the JAX package (`search/common.py:324`)
TOPK_KERNEL_MAX_K = 32
TOPK_KERNEL_MIN_V = 256


def hash_init(shape, device=None) -> Tuple[torch.Tensor, torch.Tensor]:
    return (
        torch.full(shape, 17, dtype=torch.int64, device=device),
        torch.full(shape, 2166136261, dtype=torch.int64, device=device),
    )


def hash_extend(h: Tuple[torch.Tensor, torch.Tensor], token: torch.Tensor):
    """Extend both hashes by `token`; values stay in [0, 2^32)."""
    t = token.to(torch.int64) & _MASK32
    h1 = ((h[0] * HASH_P1) & _MASK32) + t + 1
    h2 = ((h[1] ^ ((t + 1) & _MASK32)) * HASH_P2) & _MASK32
    return h1 & _MASK32, h2


def topk_lastdim(x: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Exact top-k along the last axis (values descending, ties to the
    lowest index; indices int32).  Small k over a long axis goes to the
    top-k kernel (ops/topk.py); anything else to the stable sort."""
    if k <= TOPK_KERNEL_MAX_K and x.shape[-1] >= TOPK_KERNEL_MIN_V:
        return topk_lastdim_kernel(x, k)
    return topk_plain(x, k)


def gather_beams(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Gather a (B, W, ...) tensor with (B, W') indices along the beam
    axis (axis 1)."""
    idx = idx.to(torch.int64)
    idx = idx.reshape(idx.shape + (1,) * (x.dim() - 2)).expand(idx.shape + x.shape[2:])
    return torch.gather(x, 1, idx)


def tree_map(fn: Callable, tree: Any, *rest: Any) -> Any:
    """Apply `fn` leaf by leaf to a nest of lists, tuples and dicts of
    tensors (and to the matching leaves of `rest`); None stays None."""
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest)) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, *xs) for xs in zip(tree, *rest))
    return fn(tree, *rest)


class IndirectLM(NamedTuple):
    """Ancestor-indirect cached fusion for label-synchronous searches.

    The caches stay in physical slot order and a small (B, W, Lc) ancestor
    table carries the beam permutations; the LM resolves it inside its
    attention (bert.py::BertSelfAttention.step_indirect), so the search
    gathers only the table.

    Sound only for label-sync searches (attention_beam): every slot writes
    cache column t exactly once, at step t, so physical columns are never
    clobbered across steps.  Searches with per-beam hypothesis lengths (the
    CTC prefix beam) use the standard fields of `LMFusion`.

    predict_beams(hyps (B,W,L), lens (B,W), states) -> (logp, states):
      writes this step's columns of the caches and of `anc` in place
    init_states(B, W, init_len=None) -> {"caches": [...], "anc": ...}
    gather_states(states, parent (B,W)) -> states (gathers `anc` only)
    """

    predict_beams: Callable
    init_states: Callable
    gather_states: Callable


class LMFusion(NamedTuple):
    """Adapter bundling an LM for in-loop shallow fusion over (B, W) beams.

    predict_beams(hyps (B,W,L), lens (B,W), states) -> (logp (B,W,V), states):
      the given states stay as they are
    init_states(B, W, init_len=None) -> states with (B, W, ...) leaves, or
      None; `init_len` lets a staged search start with short caches.

    `state_pad_axis`/`state_max_len`: set when the state leaves carry a
    growable length axis; a staged search (attention_beam) then inits the
    states at its first stage bound and zero-pads that axis at stage
    transitions (capped at state_max_len).

    `indirect`: the IndirectLM protocol; a label-sync search uses it in
    place of the standard fields when present.
    """

    predict_beams: Callable
    init_states: Callable
    weight: float
    state_pad_axis: Optional[int] = None
    state_max_len: Optional[int] = None
    indirect: Optional[IndirectLM] = None


LM_FUSION_MODES = ("auto", "stateless", "cached", "indirect")


def check_lm_fusion_type(lm_type: Optional[str]) -> None:
    """Refuse, with a `ValueError` that names the type, an LM that shallow
    fusion cannot take."""
    if lm_type == "bert":
        raise ValueError("a masked LM (lm_type 'bert') has no next-token distribution for shallow fusion")
    if lm_type in PHONE_TYPES:
        raise ValueError(f"lm_type {lm_type!r} is conditioned on phones, which a beam does not have: "
                         "no shallow fusion")
    if lm_type not in ("transformer", "rnn", "electra", "electra-disc"):
        raise ValueError(f"lm_type={lm_type!r}")


def make_lm_fusion(lm_model, weight: float, max_len: Optional[int] = None,
                   mode: str = "auto") -> LMFusion:
    """An LMFusion around a Transformer, RNN or ELECTRA LM
    (`models/lm/lm.py`, the facade or the inner module), on the device and
    in the dtype of its parameters.

    RNN LM (`search/common.py:249-279` of the JAX package): the beams carry
    its states as (B, W, layers, 2, H), (layers, 2, B W, H) to the LM; each
    step is one `predict` from every beam's last token (`init_states` from
    `zero_states`); the one-token LSTM steps take the plain scan, as in JAX.

    Transformer LM, three modes, all exact (equivalence pinned in
    tests/test_torch_lm_fusion.py):

    - "stateless": re-encode the full prefix each beam step.
    - "cached": per-layer KV caches, O(1) work per step, kept batch-major
      (B, W, Lc, H, dk) so that the beam reindex is a leading-axis gather;
      length-staged by the attention beam (`state_pad_axis` 2, up to
      `max_len`, the LM's `max_seq_len` by default).  The advance-on-extend /
      keep-parent rule of the CTC beam holds because predict_beams leaves
      the given states untouched.
    - "indirect": the cached fields plus the IndirectLM protocol, which the
      attention beam takes: no per-step cache gather.

    "auto" selects "indirect".  Positions are clamped to the cache:
    min(max(lens - 1, 0), Lc - 1).

    ELECTRA (`electra`, `electra-disc`) fuses by the stateless route, its
    `predict` being the generator's log-probs at each prefix's last
    position, as the JAX package's stateless route calls the facade's
    `predict` (`search/common.py:250-260`).  Refused with a `ValueError`: a
    masked LM (BERT) has no next-token distribution; the phone-conditioned
    types need phones that a beam does not have (the JAX adapter passes
    its states as the phones and fails; P-ELECTRA has no `predict`).
    """
    if mode not in LM_FUSION_MODES:
        raise ValueError(f"LM fusion mode {mode!r}: one of {LM_FUSION_MODES}")
    lm_type = getattr(getattr(lm_model, "cfg", None), "lm_type", None)
    check_lm_fusion_type(lm_type)
    if lm_type == "rnn":
        return _rnn_lm_fusion(lm_model, weight)
    if lm_type in ("electra", "electra-disc"):
        mode = "stateless"
    if mode == "auto":
        mode = "indirect"
    param = next(p for p in lm_model.parameters() if p.is_floating_point())

    if mode == "stateless":
        def predict_beams(hyps, lens, states):
            B, W, L = hyps.shape
            logp, _ = lm_model.predict(hyps.reshape(B * W, L), lens.reshape(B * W))
            return logp.reshape(B, W, -1), states

        return LMFusion(predict_beams, lambda B, W, init_len=None: None, weight)

    if max_len is None:
        max_len = lm_model.cfg.max_seq_len

    def predict_beams_cached(hyps, lens, states):
        B, W, L = hyps.shape
        Lc = states[0][0].shape[2]
        idx = (lens.reshape(B * W) - 1).clamp(min=0)
        tokens = torch.gather(hyps.reshape(B * W, L), 1, idx[:, None])[:, 0]
        # (B, W, Lc, H, dk) -> (B*W, Lc, H, dk) copies: the step writes them
        caches = [tuple(x.reshape((B * W,) + x.shape[2:]).clone() for x in kv) for kv in states]
        logp, caches = lm_model.predict_step(tokens, idx.clamp(max=Lc - 1), caches)
        out = [tuple(x.reshape((B, W) + x.shape[1:]) for x in kv) for kv in caches]
        return logp.reshape(B, W, -1), out

    def init_states_cached(B, W, init_len=None):
        L0 = max_len if init_len is None else min(init_len, max_len)
        caches = lm_model.init_cache(B * W, L0, param.dtype, param.device)
        return [tuple(x.reshape((B, W) + x.shape[1:]) for x in kv) for kv in caches]

    indirect = None
    if mode == "indirect":
        def predict_beams_ind(hyps, lens, states):
            B, W, _ = hyps.shape
            caches, anc = states["caches"], states["anc"]
            pos = (lens - 1).clamp(min=0).clamp(max=anc.shape[2] - 1)
            tokens = torch.gather(hyps, 2, pos[:, :, None])[..., 0]
            # this step's column is ours: anc[b, w, pos] = w
            b_idx = torch.arange(B, device=anc.device)[:, None]
            w_idx = torch.arange(W, device=anc.device)[None, :]
            anc[b_idx, w_idx, pos] = w_idx.expand(B, W).to(anc.dtype)
            logp, caches = lm_model.predict_step_indirect(tokens, pos, caches, anc)
            return logp, {"caches": caches, "anc": anc}

        def init_states_ind(B, W, init_len=None):
            st = init_states_cached(B, W, init_len)
            anc = torch.zeros((B, W, st[0][0].shape[2]), dtype=torch.int32, device=param.device)
            return {"caches": st, "anc": anc}

        def gather_states_ind(states, parent):
            # compose the beam permutation into the ancestor table; the
            # caches stay in physical slot order
            anc = states["anc"]
            return {"caches": states["caches"],
                    "anc": torch.gather(anc, 1, parent[:, :, None].expand(-1, -1, anc.shape[2]))}

        indirect = IndirectLM(predict_beams_ind, init_states_ind, gather_states_ind)

    return LMFusion(predict_beams_cached, init_states_cached, weight,
                    state_pad_axis=2, state_max_len=max_len, indirect=indirect)


def _rnn_lm_fusion(lm_model, weight: float) -> LMFusion:
    """The RNN LM's stateful fusion: states (B, W, layers, 2, H)."""

    def predict_beams(hyps, lens, states):
        B, W, L = hyps.shape
        st = states.reshape((B * W,) + states.shape[2:]).permute(1, 2, 0, 3)  # (layers, 2, B W, H)
        logp, new = lm_model.predict(hyps.reshape(B * W, L), lens.reshape(B * W), st)
        return logp.reshape(B, W, -1), new.permute(2, 0, 1, 3).reshape((B, W) + new.shape[:2] + new.shape[3:])

    def init_states(B, W, init_len=None):
        st = lm_model.zero_states(B * W)  # (layers, 2, B W, H)
        return st.permute(2, 0, 1, 3).reshape((B, W) + st.shape[:2] + st.shape[3:])

    return LMFusion(predict_beams, init_states, weight)
