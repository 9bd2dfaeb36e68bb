"""Fused post-norm Transformer-LM layer step for beam decoding with
ancestor-indirect caches: a CUDA kernel and its plain version.

Port of `emoasr_tpu/ops/lm_step_pallas.py`.  One call runs a whole
post-norm layer step (`models/lm/bert.py::BertLayer.step_indirect`) for
N = Bu * W rows (Bu utterances, W beams):

    Q/K/V proj -> causal self-attention over the ancestor-indirect caches
    -> out proj -> LN(x + .) -> FF (exact gelu) -> LN(x + .)

and returns (y, k_new, v_new).  The caches are the pre-write ones, in
physical slot order; the step attends the columns `< pos` through the
ancestor table plus the freshly projected (k_new, v_new) as an explicit
extra column, term for term the softmax the dense path computes after
writing the caches at `pos` and masking `<= pos`.  The cache write stays
with the caller.

Semantics kept: LayerNorm eps 1e-12 with f32 statistics; scores in f32,
-1e9 fill before the softmax and zeroing after it, probabilities rounded to
the activation dtype before the AV product; gelu as 0.5 x (1 + erf(x /
sqrt 2)) with XLA's float32 erf polynomial (`erf_f32`: clamp to [-4, 4], a
ratio of an odd and an even polynomial), the one the TPU kernel inlines and
the CUDA kernel computes.

`weights` maps `WEIGHT_NAMES` to tensors shaped as the JAX package's: 2-D
kernels (in, out), 1-D biases and scales.  A `.t()` view of an `nn.Linear`
weight is such a kernel.  `PackedWeights` (`ops/decoder_step.py`) checks
them and lays them out once for the products on the tensor cores (bf16
terms in fragment order, `pack_fragments`); a caller that steps many times
passes it in place of the dict.

Types: h, the caches and the weights share one dtype, float32 or bfloat16
(the JAX kernel's `adt`), and so do the outputs.  In bf16 the step rounds
where the JAX kernel rounds: each dense product once after its f32 bias,
p and each head's output, each residual add before its LayerNorm (f32
statistics, output rounded), and dense(x, wi) before and after the f32
gelu (`erf_f32` stays f32).

For a CUDA tensor `fused_bert_layer_step_indirect` launches
`csrc/lm_step.cu`; for a CPU tensor it takes the plain version.  On the
card: float32 or bfloat16, all of one dtype (`TypeError` otherwise),
D, d_k and F multiples of four (eight in bfloat16), and the shared memory
one block needs within 227 KB (`decoder_step.smem_bytes`: the residual
stream (W', D), the bf16 A planes of D columns, the products' partial sums,
and the larger of three (W', D) activations with the warps' f32 attention
scratch and the A planes of the FF hidden layer); anything else raises
`ValueError`.  W' is the row group (`decoder_step.launch_geometry`): the
N = Bu W rows go in groups of W' consecutive rows, a cluster of blocks a
group, so any W >= 1 is taken.  Decode-only: no dropout, no gradient.
"""

from __future__ import annotations

from typing import Dict, Tuple, Union

import torch

from emoasr_tpu_torch.ops.cuda_lib import I, P, CudaKernel
from emoasr_tpu_torch.ops.decoder_step import (
    SUFFIX,
    VEC,
    PackedWeights,
    _dense,
    _layer_norm,
    cached_self_attention,
    device_geometry,
)

WEIGHT_NAMES = (
    "wq", "bq", "wk", "bk", "wv", "bv", "wo", "bo",
    "ln1_s", "ln1_b",
    "wi", "bi", "wo2", "bo2",
    "ln2_s", "ln2_b",
)
FF_NAMES = ("wi", "bi", "wo2")
WHAT = "LM-step kernel"

KERNEL = CudaKernel(
    "lm_step.cu",
    {**{f"emo_lm_step_indirect_{s}": [P] * 9 + [I] * 8 + [P] for s in SUFFIX.values()},
     "emo_lm_step_smem_bytes": [I] * 5, "emo_lm_step_max_clusters": [I] * 6},
)

# XLA's float32 erf (ErfImpl32), as `emoasr_tpu/ops/lm_step_pallas.py`
# inlines it for the TPU kernel
ERF_ALPHA = (
    -2.72614225801306e-10, 2.77068142495902e-08, -2.10102402082508e-06,
    -5.69250639462346e-05, -7.34990630326855e-04, -2.95459980854025e-03,
    -1.60960333262415e-02,
)
ERF_BETA = (
    -1.45660718464996e-05, -2.13374055278905e-04, -1.68282697438203e-03,
    -7.37332916720468e-03, -1.42647390514189e-02,
)


def erf_f32(x: torch.Tensor) -> torch.Tensor:
    x = x.clamp(-4.0, 4.0)
    x2 = x * x
    p = torch.full_like(x, ERF_ALPHA[0])
    for c in ERF_ALPHA[1:]:
        p = p * x2 + c
    p = p * x
    q = torch.full_like(x, ERF_BETA[0])
    for c in ERF_BETA[1:]:
        q = q * x2 + c
    return p / q


def gelu_erf_f32(x: torch.Tensor) -> torch.Tensor:
    """0.5 x (1 + erf(x / sqrt 2)) with `erf_f32`, in float32."""
    x = x.float()
    return 0.5 * x * (1.0 + erf_f32(x * 0.7071067811865476))


def bert_layer_step_indirect_plain(h, cache_k, cache_v, pos, anc, weights):
    """`lm_step_pallas.py::_kernel` in PyTorch ops; shapes as
    `fused_bert_layer_step_indirect`.  Each beam's cache rows are gathered
    through `anc` (the TPU kernel's sum of W masked terms has exactly this
    one nonzero term)."""
    wt = weights.source if isinstance(weights, PackedWeights) else weights
    Bu, W, L, H, dk = cache_k.shape
    D, N = H * dk, Bu * W
    dev = h.device
    idx = anc.to(dev, torch.int64)[:, :, :, None, None].expand(Bu, W, L, H, dk)
    ck = torch.gather(cache_k, 1, idx).reshape(N, L, H, dk)
    cv = torch.gather(cache_v, 1, idx).reshape(N, L, H, dk)
    x = h.reshape(N, D)
    q = _dense(x, wt["wq"], wt["bq"])
    k_new = _dense(x, wt["wk"], wt["bk"])
    v_new = _dense(x, wt["wv"], wt["bv"])
    out = cached_self_attention(q, k_new, v_new, ck, cv, pos.to(dev).reshape(-1))
    x = _layer_norm(x + _dense(out.reshape(N, D), wt["wo"], wt["bo"]), wt["ln1_s"], wt["ln1_b"])
    inter = gelu_erf_f32(_dense(x, wt["wi"], wt["bi"])).to(x.dtype)
    y = _layer_norm(x + _dense(inter, wt["wo2"], wt["bo2"]), wt["ln2_s"], wt["ln2_b"])
    return y.reshape(Bu, W, D), k_new.reshape(Bu, W, H, dk), v_new.reshape(Bu, W, H, dk)


def pack_weights(weights: Dict[str, torch.Tensor]) -> PackedWeights:
    """`weights` checked and laid out once for the kernel."""
    return PackedWeights(weights, WEIGHT_NAMES, FF_NAMES, WHAT)


def _launch(h, cache_k, cache_v, pos, anc, weights):
    Bu, W, L, H, dk = cache_k.shape
    D, N = H * dk, Bu * W
    dev, dt = h.device, h.dtype
    if dt not in SUFFIX:
        raise TypeError(f"{WHAT} takes float32 or bfloat16, not {dt}")
    if torch.is_grad_enabled() and h.requires_grad:
        raise ValueError(f"{WHAT}: decode-only, it has no backward")
    if h.shape != (Bu, W, D) or cache_v.shape != cache_k.shape or L < 1:
        raise ValueError(f"{WHAT}: h {tuple(h.shape)} and caches {tuple(cache_k.shape)}, "
                         f"{tuple(cache_v.shape)} do not fit together")
    if pos.shape != (Bu, W) or anc.shape != (Bu, W, L):
        raise ValueError(f"{WHAT}: pos must be ({Bu}, {W}) and anc ({Bu}, {W}, {L}), "
                         f"got {tuple(pos.shape)}, {tuple(anc.shape)}")
    pack = weights if isinstance(weights, PackedWeights) else pack_weights(weights)
    F = pack.F
    if pack.D != D or pack.device != dev:
        raise ValueError(f"{WHAT}: weights of width {pack.D} on {pack.device}, h of width {D} on {dev}")
    if pack.dtype != dt:
        raise TypeError(f"{WHAT}: weights are {pack.dtype}, h is {dt}")
    vec = VEC[dt]
    if D % vec or dk % vec or F % vec:
        raise ValueError(f"{WHAT}: needs D, d_k, F multiples of {vec} in {dt}; got D={D}, d_k={dk}, F={F}")
    for n, t in (("h", h), ("cache_k", cache_k), ("cache_v", cache_v)):
        if t.dtype != dt or t.device != dev:
            raise TypeError(f"{WHAT}: {n} is {t.dtype} on {t.device}, want {dt} on {dev}")
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"{WHAT}: {n} must be contiguous and 16-byte aligned")
    geo = device_geometry(KERNEL, "lm", Bu, W, D, F, H, L, 1, dt, dev, WHAT)
    # int32 inputs pass through as they are; anything else is converted
    pos32 = pos.to(device=dev, dtype=torch.int32).contiguous()
    anc32 = anc.to(device=dev, dtype=torch.int32).contiguous()
    out = torch.empty((3, N, D), dtype=dt, device=dev)
    args = [h.data_ptr(), cache_k.data_ptr(), cache_v.data_ptr(), pos32.data_ptr(), anc32.data_ptr(),
            pack.ptrs, out[0].data_ptr(), out[1].data_ptr(), out[2].data_ptr(),
            Bu, W, L, D, F, H, geo["group"], geo["cluster"]]
    name = f"emo_lm_step_indirect_{SUFFIX[dt]}"
    if torch.cuda.current_device() == dev.index:
        KERNEL.launch(name, *args, torch.cuda.current_stream(dev).cuda_stream)
    else:
        with torch.cuda.device(dev):
            KERNEL.launch(name, *args, torch.cuda.current_stream(dev).cuda_stream)
    return out[0].view(Bu, W, D), out[1].view(Bu, W, H, dk), out[2].view(Bu, W, H, dk)


def fused_bert_layer_step_indirect(
    h: torch.Tensor, cache_k: torch.Tensor, cache_v: torch.Tensor, pos: torch.Tensor,
    anc: torch.Tensor, weights: Union[Dict[str, torch.Tensor], PackedWeights],
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """One fused post-norm LM layer step with ancestor-indirect caches.

    h: (Bu, W, D) newest-token hiddens; cache_k/v: (Bu, W, Lc, H, dk) in
    physical slot order (pre-write); pos: (Bu, W); anc: (Bu, W, Lc), the
    slot that holds beam w's column l (the caller has set anc[b, w, pos] =
    w); weights: see the module docstring.

    Returns (y (Bu, W, D), k_new, v_new (Bu, W, H, dk)); the caller writes
    k/v_new into each row's own physical slot at `pos`."""
    if h.device.type == "cpu":
        return bert_layer_step_indirect_plain(h, cache_k, cache_v, pos, anc, weights)
    if h.device.type != "cuda":
        raise ValueError(f"{WHAT}: unsupported device {h.device}")
    return _launch(h, cache_k, cache_v, pos, anc, weights)
