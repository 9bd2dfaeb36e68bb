"""Fused Transformer-decoder layer step for beam decoding: CUDA kernels
(direct and ancestor-indirect caches) and their plain versions.

Port of `emoasr_tpu/ops/decoder_step_pallas.py`.  One call runs a whole
pre-norm decoder-layer step for N = Bu * W rows (Bu utterances, W beams):

    LN1 -> Q/K/V proj -> cached self-attention -> out proj -> +res
    -> LN2 -> beam-shared cross-attention (precomputed encoder K/V)
    -> out proj -> +res -> LN3 -> FF(relu) -> +res

and returns (y, k_new, v_new).  The cache write stays with the caller: the
step attends the cache positions `< pos` plus the freshly projected
(k_new, v_new) as an explicit extra column, term for term the softmax the
dense path (`models/layers.py::TransformerDecoderLayer.decode_step`)
computes after writing the cache at `pos` and masking `<= pos`.

Semantics kept: LayerNorm eps 1e-12 with f32 statistics; scores in f32,
-1e9 fill before the softmax and zeroing after it, probabilities rounded to
the activation dtype before the AV product; the W beams of an utterance
share that utterance's encoder K/V, masked by `elens`.

`weights` maps `WEIGHT_NAMES` to tensors shaped as the JAX package's: 2-D
kernels (in, out), 1-D biases and scales.  A `.t()` view of an `nn.Linear`
weight is such a kernel, and the CUDA kernel reads it in place (it wants
(out, in) rows); a kernel stored (in, out) contiguously is copied to that
layout.  `PackedWeights(weights)` does that check and layout once; a caller
that steps many times passes it in place of the dict.

Types: h, the caches, the encoder K/V and the weights share one dtype,
float32 or bfloat16 (the activations' dtype `adt` of the JAX kernel), and
so do the outputs.  In bf16 the step rounds where the JAX kernel rounds:
each dense product once after its f32 bias, the LayerNorm output, p and
each head's output, and every residual add (an add in bf16); scores,
softmax and LayerNorm statistics are f32.

For a CUDA tensor the functions launch `csrc/decoder_step.cu`; for a CPU
tensor they take the plain versions.  On the card: float32 or bfloat16,
all of one dtype (`TypeError` otherwise), D, d_k and F multiples of four
(eight in bfloat16), and the shared memory one block needs within 227 KB
(five (W', D) activations plus the largest of the FF hidden layer (W', F),
one head's cross-attention scores (W', T) in f32 and the warps' f32
self-attention scratch 16 (L + 1)); anything else raises `ValueError`.
W' is the row group (`group_width`): an utterance's W beam rows go to
ceil(W / W') clusters of blocks, W' the widest of 16, 12 and 4, at most W
rounded up to one of them, whose shared memory fits; any W >= 1 is taken.
Decode-only: no dropout, no gradient.
"""

from __future__ import annotations

import ctypes
import math
from typing import Dict, Tuple, Union

import torch

from emoasr_tpu_torch.ops.cuda_lib import I, P, CudaKernel

NEG_INF = -1e9  # matches models/layers.py
LN_EPS = 1e-12

WEIGHT_NAMES = (
    "ln1_s", "ln1_b",
    "wq", "bq", "wk", "bk", "wv", "bv", "wo", "bo",
    "ln2_s", "ln2_b",
    "cwq", "cbq", "cwo", "cbo",
    "ln3_s", "ln3_b",
    "w1", "b1", "w2", "b2",
)

# the launchers' suffix by storage dtype, and the elements a 16-byte word holds
SUFFIX = {torch.float32: "f32", torch.bfloat16: "bf16"}
VEC = {torch.float32: 4, torch.bfloat16: 8}

# one source, two libraries (nvcc compiles the variants side by side)
KERNEL = CudaKernel(
    "decoder_step.cu",
    {**{f"emo_decoder_step_{s}": [P] * 11 + [I] * 9 + [P] for s in SUFFIX.values()},
     "emo_decoder_step_smem_bytes": [I] * 7},
    defines=["EMO_DECODER_STEP_INDIRECT=0"],
)
KERNEL_INDIRECT = CudaKernel(
    "decoder_step.cu",
    {**{f"emo_decoder_step_indirect_{s}": [P] * 12 + [I] * 9 + [P] for s in SUFFIX.values()},
     "emo_decoder_step_smem_bytes": [I] * 7},
    defines=["EMO_DECODER_STEP_INDIRECT=1"], name="decoder_step_indirect",
)

MAX_SMEM_BYTES = 232448  # what one block may use on sm_90
GROUP_WIDTHS = (16, 12, 4)  # the kernels' row-group instances, widest first


def _layer_norm(x, scale, bias):
    """flax nn.LayerNorm semantics: f32 statistics, eps inside the sqrt."""
    xf = x.float()
    mean = xf.mean(-1, keepdim=True)
    var = ((xf - mean) ** 2).mean(-1, keepdim=True)
    y = (xf - mean) * torch.rsqrt(var + LN_EPS)
    return (y * scale.float() + bias.float()).to(x.dtype)


def _dense(x, w, b):
    return (x.float() @ w.float() + b.float()).to(x.dtype)


def cached_self_attention(q, k_new, v_new, ck, cv, pos):
    """One new position per row over per-row caches ck/cv (N, L, H, dk):
    the columns l < pos plus (k_new, v_new) as an explicit extra column of
    one softmax; scores in f32, probabilities rounded to the activation
    dtype before the AV product.  q, k_new, v_new: (N, D).  Returns the
    attention output (N, H, dk) in the activation dtype."""
    N, L, H, dk = ck.shape
    adt, scale = q.dtype, 1.0 / math.sqrt(dk)
    qh = q.reshape(N, H, dk).float()
    knh = k_new.reshape(N, H, dk).float()
    vnh = v_new.reshape(N, H, dk).float()
    past = (torch.arange(L, device=q.device)[None, :] < pos.reshape(N, 1))[:, None, :]  # l < pos
    s_past = torch.einsum("nhd,nlhd->nhl", qh, ck.float()) * scale
    s_past = torch.where(past, s_past, torch.full_like(s_past, NEG_INF))
    s_new = (qh * knh).sum(-1, keepdim=True) * scale  # (N, H, 1)
    m = torch.maximum(s_past.max(-1, keepdim=True).values, s_new)
    e_past = torch.where(past, torch.exp(s_past - m), torch.zeros_like(s_past))
    e_new = torch.exp(s_new - m)
    denom = e_past.sum(-1, keepdim=True) + e_new
    p_past = (e_past / denom).to(adt).float()
    p_new = (e_new / denom).to(adt).float()
    return (torch.einsum("nhl,nlhd->nhd", p_past, cv.float()) + p_new * vnh).to(adt)


def _step_plain(h, ck, cv, pos, cross_k, cross_v, elens, wt, W):
    """The layer step over per-row caches ck/cv (N, L, H, dk)."""
    N, D = h.shape
    L, H, dk = ck.shape[1], ck.shape[2], ck.shape[3]
    Bu, T = cross_k.shape[0], cross_k.shape[1]
    adt, dev = h.dtype, h.device
    scale = 1.0 / math.sqrt(dk)

    # ---- self-attention (cached, one new position per row) ----
    hn = _layer_norm(h, wt["ln1_s"], wt["ln1_b"])
    q = _dense(hn, wt["wq"], wt["bq"])
    k_new = _dense(hn, wt["wk"], wt["bk"])
    v_new = _dense(hn, wt["wv"], wt["bv"])
    out = cached_self_attention(q, k_new, v_new, ck, cv, pos)
    x = h + _dense(out.reshape(N, D), wt["wo"], wt["bo"])

    # ---- beam-shared cross-attention ----
    hn2 = _layer_norm(x, wt["ln2_s"], wt["ln2_b"])
    q2 = _dense(hn2, wt["cwq"], wt["cbq"]).reshape(Bu, W, H, dk)
    valid = (torch.arange(T, device=dev)[None, :] < elens.reshape(Bu, 1))[:, None, None, :]
    s = torch.einsum("uwhd,uthd->uhwt", q2.float(), cross_k.float()) * scale
    s = torch.where(valid, s, torch.full_like(s, NEG_INF))
    e = torch.exp(s - s.max(-1, keepdim=True).values)
    p = e / e.sum(-1, keepdim=True)
    p = torch.where(valid, p, torch.zeros_like(p)).to(adt)
    o = torch.einsum("uhwt,uthd->uwhd", p.float(), cross_v.float())
    x = x + _dense(o.to(adt).reshape(N, D), wt["cwo"], wt["cbo"])

    # ---- feed-forward ----
    hn3 = _layer_norm(x, wt["ln3_s"], wt["ln3_b"])
    ff = _dense(torch.relu(_dense(hn3, wt["w1"], wt["b1"])), wt["w2"], wt["b2"])
    return x + ff, k_new.reshape(N, H, dk), v_new.reshape(N, H, dk)


def decoder_layer_step_plain(h, cache_k, cache_v, pos, cross_k, cross_v, elens, weights,
                             beam_width: int):
    """`decoder_step_pallas.py::_kernel` in PyTorch ops; shapes as
    `fused_decoder_layer_step`."""
    return _step_plain(h, cache_k, cache_v, pos.to(h.device), cross_k, cross_v,
                       elens.to(h.device), weights, int(beam_width))


def decoder_layer_step_indirect_plain(h, cache_k, cache_v, pos, anc, cross_k, cross_v, elens,
                                      weights, beam_width: int):
    """`decoder_step_pallas.py::_kernel_indirect` in PyTorch ops: each
    beam's cache rows are gathered through `anc` (the TPU kernel's sum of W
    masked terms has exactly this one nonzero term), then the same step."""
    Bu, W, L, H, dk = cache_k.shape
    idx = anc.to(h.device, torch.int64)[:, :, :, None, None].expand(Bu, W, L, H, dk)
    ck = torch.gather(cache_k, 1, idx).reshape(Bu * W, L, H, dk)
    cv = torch.gather(cache_v, 1, idx).reshape(Bu * W, L, H, dk)
    return _step_plain(h, ck, cv, pos.to(h.device).reshape(-1), cross_k, cross_v,
                       elens.to(h.device), weights, int(beam_width))


class PackedWeights:
    """A layer's weights checked once and held as the kernel reads them
    (2-D ones as contiguous (out, in) rows), with the host array of their
    device pointers.  Build one per layer and pass it as `weights` where
    the step runs many times; `source` keeps the dict for the plain
    versions.  `names` orders the weights as the kernel takes them; `ff`
    names the feed-forward's first kernel, its bias and its second kernel
    (shapes (D, F), (F,), (F, D)); every other kernel is (D, D), every other
    vector (D,).  On the card all are of one dtype, float32 or bfloat16
    (`dtype`), which the step's activations must share."""

    def __init__(self, weights: Dict[str, torch.Tensor], names=WEIGHT_NAMES, ff=("w1", "b1", "w2"),
                 what: str = "decoder-step kernel"):
        self.source = weights
        self.D, self.F = weights[ff[0]].shape
        D, F = self.D, self.F
        self.device = weights[ff[0]].device
        self.dtype = weights[ff[0]].dtype
        self.tensors = []
        shapes = {ff[0]: (F, D), ff[1]: (F,), ff[2]: (D, F)}
        for n in names:
            w = weights[n].detach()
            if w.dim() == 2:
                w = w.t()  # (out, in) rows
            w = w.contiguous()
            if tuple(w.shape) != shapes.get(n, (D, D) if w.dim() == 2 else (D,)):
                raise ValueError(f"{what}: weight {n} is {tuple(weights[n].shape)}")
            if self.device.type == "cuda":
                if self.dtype not in SUFFIX or w.dtype != self.dtype or w.device != self.device:
                    raise TypeError(f"{what}: {n} is {w.dtype} on {w.device}, want float32 or bfloat16 "
                                    f"(all weights of one dtype) on {self.device}")
                if w.data_ptr() % 16:
                    raise ValueError(f"{what}: {n} must be 16-byte aligned")
            self.tensors.append(w)
        self.ptrs = (ctypes.c_void_p * len(self.tensors))(*[w.data_ptr() for w in self.tensors])


_SM_COUNT: Dict[int, int] = {}
_GROUPS: Dict[Tuple, Tuple[int, int]] = {}


def _pick_cluster(groups: int, device: torch.device) -> int:
    """Blocks per row group (a thread-block cluster): the largest of 8, 4, 2,
    1 that keeps every cluster of the launch on the card at once."""
    sms = _SM_COUNT.get(device.index)
    if sms is None:
        sms = _SM_COUNT[device.index] = torch.cuda.get_device_properties(device).multi_processor_count
    for c in (8, 4, 2):
        if groups * c <= sms:
            return c
    return 1


def padded_width(W: int) -> int:
    """The row padding of a group of W rows (`beam_step.cuh::padded_width`)."""
    return 4 if W <= 4 else 12 if W <= 12 else 16


def group_width(W: int, smem_bytes, what: str, shape: str) -> Tuple[int, int]:
    """(W', shared memory a block): the widest row group W' of
    `GROUP_WIDTHS`, at most `padded_width(W)`, whose `smem_bytes(W')` fits
    one block; raises `ValueError` where even groups of 4 do not."""
    need = 0
    for wp in GROUP_WIDTHS:
        if wp <= padded_width(W):
            need = smem_bytes(wp)
            if need <= MAX_SMEM_BYTES:
                return wp, need
    raise ValueError(f"{what}: {shape} need {need} bytes of shared memory a block even in row groups of "
                     f"{GROUP_WIDTHS[-1]}, the card allows {MAX_SMEM_BYTES}")


def _launch(kernel, name, h, cache_k, cache_v, pos, anc, cross_k, cross_v, elens, weights, W):
    N, D = h.shape
    L, H, dk = cache_k.shape[-3], cache_k.shape[-2], cache_k.shape[-1]
    Bu, T = cross_k.shape[0], cross_k.shape[1]
    dev, dt = h.device, h.dtype
    what = "decoder-step kernel"
    if dt not in SUFFIX:
        raise TypeError(f"{what} takes float32 or bfloat16, not {dt}")
    if torch.is_grad_enabled() and h.requires_grad:
        raise ValueError(f"{what}: decode-only, it has no backward")
    if H * dk != D or N != Bu * W or W < 1:
        raise ValueError(f"{what}: h {tuple(h.shape)}, caches {tuple(cache_k.shape)}, "
                         f"cross K {tuple(cross_k.shape)}, beam_width {W} do not fit together")
    pack = weights if isinstance(weights, PackedWeights) else PackedWeights(weights)
    F = pack.F
    if pack.D != D or pack.device != dev:
        raise ValueError(f"{what}: weights of width {pack.D} on {pack.device}, h of width {D} on {dev}")
    if pack.dtype != dt:
        raise TypeError(f"{what}: weights are {pack.dtype}, h is {dt}")
    vec = VEC[dt]
    if D % vec or dk % vec or F % vec:
        raise ValueError(f"{what}: needs D, d_k, F multiples of {vec} in {dt}; got D={D}, d_k={dk}, F={F}")
    want_cache = (N, L, H, dk) if anc is None else (Bu, W, L, H, dk)
    if cache_k.shape != want_cache or cache_v.shape != want_cache:
        raise ValueError(f"{what}: caches must be {want_cache}, got {tuple(cache_k.shape)}, {tuple(cache_v.shape)}")
    if cross_k.shape != (Bu, T, H, dk) or cross_v.shape != (Bu, T, H, dk) or L < 1 or T < 1:
        raise ValueError(f"{what}: encoder K/V must be ({Bu}, T, {H}, {dk}), got {tuple(cross_k.shape)}, {tuple(cross_v.shape)}")
    if pos.numel() != N or elens.numel() != Bu or (anc is not None and anc.shape != (Bu, W, L)):
        raise ValueError(f"{what}: pos needs {N} entries, elens {Bu}, anc ({Bu}, {W}, {L})")
    for n, t in (("h", h), ("cache_k", cache_k), ("cache_v", cache_v), ("cross_k", cross_k),
                 ("cross_v", cross_v)):
        if t.dtype != dt or t.device != dev:
            raise TypeError(f"{what}: {n} is {t.dtype} on {t.device}, want {dt} on {dev}")
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"{what}: {n} must be contiguous and 16-byte aligned")
    key = (kernel.name, W, L, T, D, F, H, h.element_size())
    group = _GROUPS.get(key)
    if group is None:
        group = _GROUPS[key] = group_width(
            W, lambda wp: kernel.lib().emo_decoder_step_smem_bytes(wp, L, T, D, F, H, h.element_size()),
            what, f"W={W}, D={D}, F={F}, T={T}, L={L} in {dt}")
    wp = group[0]
    # int32 inputs pass through as they are; anything else is converted
    pos32 = pos.to(device=dev, dtype=torch.int32).contiguous()
    elens32 = elens.to(device=dev, dtype=torch.int32).contiguous()
    out = torch.empty((3, N, D), dtype=dt, device=dev)
    args = [h.data_ptr(), cache_k.data_ptr(), cache_v.data_ptr(), pos32.data_ptr()]
    if anc is not None:
        anc32 = anc.to(device=dev, dtype=torch.int32).contiguous()
        args.append(anc32.data_ptr())
    args += [cross_k.data_ptr(), cross_v.data_ptr(), elens32.data_ptr(), pack.ptrs,
             out[0].data_ptr(), out[1].data_ptr(), out[2].data_ptr(),
             Bu, W, L, T, D, F, H, wp, _pick_cluster(Bu * -(-W // wp), dev)]
    name = f"{name}_{SUFFIX[dt]}"
    if torch.cuda.current_device() == dev.index:
        kernel.launch(name, *args, torch.cuda.current_stream(dev).cuda_stream)
    else:
        with torch.cuda.device(dev):
            kernel.launch(name, *args, torch.cuda.current_stream(dev).cuda_stream)
    return out[0], out[1].view(N, H, dk), out[2].view(N, H, dk)


def _plain_weights(weights):
    return weights.source if isinstance(weights, PackedWeights) else weights


def fused_decoder_layer_step(
    h: torch.Tensor, cache_k: torch.Tensor, cache_v: torch.Tensor, pos: torch.Tensor,
    cross_k: torch.Tensor, cross_v: torch.Tensor, elens: torch.Tensor,
    weights: Union[Dict[str, torch.Tensor], PackedWeights], *, beam_width: int,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """One fused pre-norm decoder-layer step for beam decoding.

    h: (N, D) newest-token hidden (N = Bu * beam_width rows); cache_k/v:
    (N, Lmax, H, dk) self-attention caches (positions < pos valid); pos:
    (N,); cross_k/v: (Bu, T, H, dk) per-utterance encoder K/V; elens: (Bu,)
    valid encoder lengths; weights: see the module docstring.

    Returns (y (N, D), k_new, v_new (N, H, dk)); the caller writes k/v_new
    into the caches at `pos`, exactly as the dense path does."""
    if h.device.type == "cpu":
        return decoder_layer_step_plain(h, cache_k, cache_v, pos, cross_k, cross_v, elens,
                                        _plain_weights(weights), beam_width)
    if h.device.type != "cuda":
        raise ValueError(f"decoder-step kernel: unsupported device {h.device}")
    return _launch(KERNEL, "emo_decoder_step", h, cache_k, cache_v, pos, None, cross_k, cross_v,
                   elens, weights, int(beam_width))


def fused_decoder_layer_step_indirect(
    h: torch.Tensor, cache_k: torch.Tensor, cache_v: torch.Tensor, pos: torch.Tensor,
    anc: torch.Tensor, cross_k: torch.Tensor, cross_v: torch.Tensor, elens: torch.Tensor,
    weights: Union[Dict[str, torch.Tensor], PackedWeights], *, beam_width: int,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """One fused ancestor-indirect decoder-layer step.

    h: (N, D) rows in (utterance, beam) order; cache_k/v: (Bu, W, Lc, H, dk)
    in physical slot order (pre-write: the step attends cache[< pos] plus
    the freshly projected column); pos: (Bu, W); anc: (Bu, W, Lc), the slot
    that holds beam w's column l; cross_k/v: (Bu, T, H, dk); elens: (Bu,).

    Returns (y (N, D), k_new, v_new (N, H, dk)); the caller writes k/v_new
    into each row's own physical slot at `pos`."""
    if h.device.type == "cpu":
        return decoder_layer_step_indirect_plain(h, cache_k, cache_v, pos, anc, cross_k, cross_v,
                                                 elens, _plain_weights(weights), beam_width)
    if h.device.type != "cuda":
        raise ValueError(f"decoder-step kernel: unsupported device {h.device}")
    return _launch(KERNEL_INDIRECT, "emo_decoder_step_indirect", h, cache_k, cache_v, pos, anc, cross_k,
                   cross_v, elens, weights, int(beam_width))
