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
weight is such a kernel.  The CUDA kernel runs its products on the tensor
cores and reads each kernel split into bf16 terms (two for float32, one
for bfloat16) in the order of its B fragments (`pack_fragments`);
`PackedWeights(weights)` does that check and layout once, and a caller
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
(`smem_bytes`: four (W', D) activations, the bf16 planes of the products'
A operands of D and of F columns, and the attention's scratch, which holds
one window of encoder frames, `cross_window`, whatever T');
anything else raises `ValueError`.  W' is the row group: the N = Bu W rows
go in groups of W' consecutive rows (so a group may hold several
utterances' rows), a cluster of blocks a group, W' the widest of 16, 12
and 4 (at most N rounded up to one of them) whose shared memory fits
(`launch_geometry`); any W >= 1 is taken.  Decode-only: no dropout, no
gradient.
"""

from __future__ import annotations

import ctypes
import math
from typing import Callable, Dict, Tuple, Union

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
     "emo_decoder_step_smem_bytes": [I] * 7, "emo_decoder_step_max_clusters": [I] * 8},
    defines=["EMO_DECODER_STEP_INDIRECT=0"],
)
KERNEL_INDIRECT = CudaKernel(
    "decoder_step.cu",
    {**{f"emo_decoder_step_indirect_{s}": [P] * 12 + [I] * 9 + [P] for s in SUFFIX.values()},
     "emo_decoder_step_smem_bytes": [I] * 7, "emo_decoder_step_max_clusters": [I] * 8},
    defines=["EMO_DECODER_STEP_INDIRECT=1"], name="decoder_step_indirect",
)

MAX_SMEM_BYTES = 232448  # what one block may use on sm_90
GROUP_WIDTHS = (16, 12, 4)  # the kernels' row-group instances, widest first

# mirrored from csrc/beam_step.cuh (the products' tiling), decoder_step.cu and
# lm_step.cu (their shared-memory layouts)
WARPS = 8
THREADS = 32 * WARPS
MAX_SLICES = 4
LM_PART_BYTES = 16384  # lm_step.cu kPartBytes


def n_terms(dtype: torch.dtype) -> int:
    """bf16 terms of a product operand: two for float32, one for bfloat16."""
    return 2 if dtype == torch.float32 else 1


def ksteps(K: int) -> int:
    return -(-K // 16)


def slices(K: int) -> int:
    """The fixed slices of K a product sums separately and adds in order."""
    return max(1, min(MAX_SLICES, ksteps(K) // 4))


def ksteps_padded(K: int) -> int:
    return -(-ksteps(K) // slices(K)) * slices(K)


def plane_ld(K: int) -> int:
    """bf16 elements a row of an A plane of K columns."""
    return 16 * ksteps_padded(K) + 8


def planes_bytes(K: int, terms: int, group: int) -> int:
    """An operand's A planes: `group` rows of K columns a term, then a zero row."""
    return (terms * group + 1) * plane_ld(K) * 2


def cross_window(T: int, es: int) -> Tuple[int, int]:
    """K5's cross-attention over T encoder frames (decoder_step.cu
    `CrossLayout`): (frames a window, frames a chunk).  A window is T
    padded to 16, at most 512 frames in float32 (es 4) and 1024 in bf16; a
    chunk at most half of that."""
    most = 256 if es == 4 else 512
    tw = min(-(-T // 16) * 16, 2 * most)
    return tw, min(tw, most)


def cross_bytes(dk: int, T: int, es: int) -> int:
    """K5's cross-attention scratch (decoder_step.cu `CrossLayout`): a
    window's scores (16 rows of its frames, at most T padded to 4, f32), the
    planes of its p (16 rows of the window, plus 8) and of the queries (16
    rows of d_k padded to 16, plus 8), and the planes of a chunk of frames
    of keys or values."""
    terms = 2 if es == 4 else 1
    dkp = -(-dk // 16) * 16
    tw, tc = cross_window(T, es)
    return (16 * min((T + 3) // 4 * 4, tw) * 4 + terms * 16 * (tw + 8) * 2 + terms * 16 * (dkp + 8) * 2
            + terms * tc * (dkp + 8) * 2)


def smem_bytes(kind: str, group: int, D: int, F: int, H: int, L: int, T: int, es: int) -> int:
    """Shared memory one block of K5 (`kind` "decoder") or K6 ("lm") needs
    for row groups of `group` rows and elements of `es` bytes (the sources'
    `Layout`, which `emo_*_smem_bytes` export)."""
    terms = 2 if es == 4 else 1
    act, lp = group * D * es, (L + 4) // 4 * 4
    if kind == "lm":
        pa = max(planes_bytes(D, terms, group), act)
        region = max(planes_bytes(F, terms, group), 3 * act + WARPS * 2 * lp * 4)
        return act + pa + LM_PART_BYTES + region
    qkv = max(3 * act, slices(F) * 1024)
    cross = cross_bytes(D // H, T, es)
    region = max(planes_bytes(F, terms, group), slices(D) * 1024, WARPS * 2 * lp * 4, cross)
    return act + qkv + planes_bytes(D, terms, group) + region


def padded_width(N: int) -> int:
    """The widest row group N rows need: 4, 12 or 16."""
    return 4 if N <= 4 else 12 if N <= 12 else 16


def launch_geometry(kind: str, Bu: int, W: int, D: int, F: int, H: int, L: int, T: int, dtype: torch.dtype,
                    holds: Callable[[int, int], int], what: str = "decoder-step kernel") -> Dict[str, int]:
    """How K5 ("decoder") or K6 ("lm") lays out a launch of N = Bu W rows:
    the widest row group of `GROUP_WIDTHS` ("group": consecutive rows, so
    that a group may hold several utterances' rows or part of one), at most
    `padded_width(N)`, whose shared memory fits a block, the groups, the
    blocks a group's cluster (the most, up to 8, for which
    `holds(group, cluster)`, the clusters the card keeps at once, is at
    least the groups; `device_geometry` asks the card), the blocks, the
    shared memory and the threads of a block.  Raises `ValueError` where
    even buffers of 4 rows do not fit."""
    es, N = torch.tensor([], dtype=dtype).element_size(), Bu * W
    need = 0
    for width in GROUP_WIDTHS:
        if width <= padded_width(N):
            need = smem_bytes(kind, width, D, F, H, L, T, es)
            if need <= MAX_SMEM_BYTES:
                group, smem, groups = width, need, -(-N // width)
                cluster = next((c for c in range(8, 1, -1) if holds(group, c) >= groups), 1)
                return {"group": group, "groups": groups, "cluster": cluster,
                        "blocks": groups * cluster, "smem": smem, "threads": THREADS}
    shape = f"W={W}, D={D}, F={F}, L={L}" + (f", T={T}" if kind == "decoder" else "")
    raise ValueError(f"{what}: {shape} in {dtype} need {need} bytes of shared memory a block even in row groups "
                     f"of {GROUP_WIDTHS[-1]}, the card allows {MAX_SMEM_BYTES}")


def pack_fragments(w: torch.Tensor, terms: int) -> torch.Tensor:
    """A weight as (out, in) rows, (N, K), as the products read it: split
    into `terms` bf16 terms (hi = bf16(w), lo = bf16(w - hi)), padded with
    zeros to whole groups of 16 output columns and `ksteps_padded(K)`
    k-steps of 16, and laid out as the B fragments of mma.m16n8k16: for
    each column group and k-step, per term, lane g * 4 + c of a warp holds
    16 bytes, the words b0 (k 2c, 2c + 1) and b1 (k 2c + 8, 2c + 9) of
    column 8 j + g for the n8 tiles j = 0, 1.  Returns a (groups, k-steps,
    terms, 8, 4, 2, 2, 2) bf16 tensor."""
    N, K = w.shape
    groups, ksp = -(-N // 16), ksteps_padded(K)
    x = torch.zeros(groups * 16, ksp * 16, dtype=torch.float32, device=w.device)
    x[:N, :K] = w.float()
    planes = []
    for _ in range(terms):
        t = x.to(torch.bfloat16)
        planes.append(t)
        x = x - t.float()
    f = torch.stack(planes).view(terms, groups, 2, 8, ksp, 2, 4, 2)  # (term, group, j, g, k-step, half, c, pair)
    return f.permute(1, 4, 0, 3, 6, 2, 5, 7).contiguous()


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


QKV = (("wq", "wk", "wv"), ("bq", "bk", "bv"))  # the projections the kernels run as one product


class PackedWeights:
    """A layer's weights checked once and held as the kernel reads them,
    with the host array of their device pointers.  Build one per layer and
    pass it as `weights` where the step runs many times; `source` keeps the
    dict for the plain versions.  `names` orders the weights as the kernel
    takes them; `ff` names the feed-forward's first kernel, its bias and its
    second kernel (shapes (D, F), (F,), (F, D)); every other kernel is
    (D, D), every other vector (D,).  On the card all are of one dtype,
    float32 or bfloat16 (`dtype`), which the step's activations must share;
    the kernels are laid out by `pack_fragments`, the vectors kept
    contiguous, and the query, key and value projections (`QKV`) packed as
    one (3 D, D) kernel with one (3 D,) bias, which the pointers of all three
    name."""

    def __init__(self, weights: Dict[str, torch.Tensor], names=WEIGHT_NAMES, ff=("w1", "b1", "w2"),
                 what: str = "decoder-step kernel"):
        self.source = weights
        self.D, self.F = weights[ff[0]].shape
        D, F = self.D, self.F
        self.device = weights[ff[0]].device
        self.dtype = weights[ff[0]].dtype
        shapes = {ff[0]: (F, D), ff[1]: (F,), ff[2]: (D, F)}
        rows = {}
        for n in names:
            w = weights[n].detach()
            if w.dim() == 2:
                w = w.t()  # (out, in) rows
            if tuple(w.shape) != shapes.get(n, (D, D) if w.dim() == 2 else (D,)):
                raise ValueError(f"{what}: weight {n} is {tuple(weights[n].shape)}")
            if self.device.type == "cuda" and (self.dtype not in SUFFIX or w.dtype != self.dtype
                                               or w.device != self.device):
                raise TypeError(f"{what}: {n} is {w.dtype} on {w.device}, want float32 or bfloat16 "
                                f"(all weights of one dtype) on {self.device}")
            rows[n] = w
        self.tensors = {}
        if self.device.type == "cuda":
            for fused in QKV:
                cat = torch.cat([rows[n] for n in fused])
                for n in fused:
                    rows[n] = cat
            for n in names:
                w = rows[n]
                if w.data_ptr() not in self.tensors:
                    self.tensors[w.data_ptr()] = pack_fragments(w, n_terms(self.dtype)) if w.dim() == 2 else w.contiguous()
                rows[n] = self.tensors[w.data_ptr()]
                if rows[n].data_ptr() % 16:
                    raise ValueError(f"{what}: {n} must be 16-byte aligned")
        self.ptrs = (ctypes.c_void_p * len(names))(*[rows[n].data_ptr() for n in names])


_GEOMETRY: Dict[Tuple, Dict[str, int]] = {}


def device_geometry(kernel: CudaKernel, kind: str, Bu: int, W: int, D: int, F: int, H: int, L: int, T: int,
                    dtype: torch.dtype, device: torch.device, what: str) -> Dict[str, int]:
    """`launch_geometry` for `kernel`, the library that launches (K5 or K5
    indirect, `kind` "decoder"; K6, "lm"), on `device`, which says how many
    clusters of each size it keeps at once (`emo_*_max_clusters`); cached by
    library and shape.  Raises `RuntimeError` where the card cannot say."""
    key = (kernel.name, kind, Bu, W, D, F, H, L, T, dtype, device.index)
    geo = _GEOMETRY.get(key)
    if geo is None:
        es = torch.tensor([], dtype=dtype).element_size()

        def holds(group: int, c: int) -> int:
            lib = kernel.lib()
            n = (lib.emo_decoder_step_max_clusters(group, c, L, T, D, F, H, es) if kind == "decoder"
                 else lib.emo_lm_step_max_clusters(group, c, L, D, F, es))
            if n < 0:
                raise RuntimeError(f"{what}: the card does not say how many clusters of {c} blocks "
                                   f"(row groups of {group}) it holds at once")
            return n

        with torch.cuda.device(device):
            geo = _GEOMETRY[key] = launch_geometry(kind, Bu, W, D, F, H, L, T, dtype, holds, what)
    return geo


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
    geo = device_geometry(kernel, "decoder", Bu, W, D, F, H, L, T, dt, dev, what)
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
             Bu, W, L, T, D, F, H, geo["group"], geo["cluster"]]
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
