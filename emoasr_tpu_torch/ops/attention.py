"""Fused masked self-attention: CUDA kernels (forward, backward, dropout)
and plain version.

Port of `emoasr_tpu/ops/attention_pallas.py::fused_self_attention`.  The
public function keeps the JAX layout: q/k/v (B, T, H, D), `lens` (B,) valid
key counts, output (B, T, H, D) in v.dtype.  Semantics are those of the
dense path (`models/layers.py::MultiHeadAttention._attend`): -1e9 key-pad
fill before an f32 softmax, zeroing after it, dropout on the normalised
probabilities, P cast to v.dtype before the AV product.

For a CUDA tensor `fused_self_attention` launches `csrc/attention.cu`; for
a CPU tensor it takes `attention_plain` and, for its gradient,
`attention_bwd_plain`.  Both directions take float32 and bfloat16.  The
backward rounds where the TPU kernel rounds: P stays float32, the dropped
P is rounded to v's dtype before dV, dS (scaled) to q's dtype before dQ, dK
and d bias, and every product accumulates in float32.  The additive score
`bias` (the Conformer's shifted relative-position term), (B, H, T, T)
float32 or bfloat16, enters before the scale, `(q k^T + bias) * scale`; the
backward returns its gradient too, in the bias's dtype.

Both dtypes run one design on the tensor cores (`mma.sync`, bf16 operands,
float32 sums): bfloat16 on its operands as they stand, the TPU kernel's own
arithmetic; float32 on each operand split into three bf16 terms, the six
leading cross products summed in float32 (TF32 stays off).  D <= 128 in
both dtypes; bfloat16 takes a head size D that is a multiple of 8 (others
raise `ValueError`), float32 any.  The float32 launchers' geometry
(threads, grid, shared memory and, for the backward at D <= 64, the bf16
scratch that holds its operands' split) comes from `launch_geometry`,
which the source mirrors (`emo_attention_smem_bytes`).

Dropout on the card draws its bits from a Philox generator inside the
kernel, keyed by one 64-bit seed per call; the backward regenerates them.
The seed comes from `seed=` or is drawn from `generator`.  The bits are not
those of any other framework; one seed draws the same bits in both dtypes
(one map of the generator's words onto the elements a thread holds in a
score accumulator), which `dropout_keep_mask` exports so that the kernel
can be held against the plain version with the same mask.

`block=(row0, rows, head0, heads)` says that the call's (B, H) are rows
row0.. of a batch of `rows` and heads head0.. of `heads` (a rank's share
under data and tensor parallelism, `parallel/mesh.py`): the kernels then
key each element by its place in that batch, and the CPU path draws the
whole batch's mask and keeps the call's block, so that the call drops what
the whole batch's call drops there.  None is (0, B, 0, H).
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import torch

from emoasr_tpu_torch.ops.cuda_lib import F, I, P, U, CudaKernel, aligned16

NEG_INF = -1e9  # matches models/layers.py

# each launcher ends with the dropout's seed, threshold, scale and the key
# of its (row, head) blocks (`_key_args`), then the stream
_FWD_SIG = [P] * 7 + [I] * 5 + [F, U, U, U, F, I, I, P]
_BWD_SIG = [P] * 12 + [I, P, I, I, I, I, F, U, U, U, F, I, I, P]
# the float32 backward also takes a bf16 scratch for its operands' split
# (`launch_geometry`)
_BWD_F32_SIG = [P] * 13 + [I, P] + [I] * 4 + [F, U, U, U, F, I, I, P]
KERNEL = CudaKernel(
    "attention.cu",
    {
        "emo_attention_fwd_f32": _FWD_SIG,
        "emo_attention_fwd_bf16": _FWD_SIG,
        "emo_attention_bwd_f32": _BWD_F32_SIG,
        "emo_attention_bwd_bf16": _BWD_SIG,
        "emo_attention_keep_mask": [P, I, I, I, U, U, U, I, I, P],
        "emo_attention_smem_bytes": [I, I, I],
    },
)

# launches that carried a score bias, by direction and dtype, counted
# beside the launchers' own counts (the launchers are the same with and
# without a bias)
KERNEL.counts.update(bias_fwd=0, bias_bwd=0, bias_fwd_bf16=0, bias_bwd_bf16=0)
_BIAS_COUNT = {torch.float32: "", torch.bfloat16: "_bf16"}

MAX_D = 128
BF16_D_MULTIPLE = 8  # the bf16 launchers stage rows in 16-byte words
_LAUNCHERS = {
    torch.float32: "emo_attention_fwd_f32",
    torch.bfloat16: "emo_attention_fwd_bf16",
}
_BWD_LAUNCHERS = {
    torch.float32: "emo_attention_bwd_f32",
    torch.bfloat16: "emo_attention_bwd_bf16",
}
_BIAS_KINDS = {torch.float32: 1, torch.bfloat16: 2}  # 0: no bias

# The float32 kernels' geometry (csrc/attention.cu keeps the same
# constants): blocks of 64 queries (forward, backward pass 1) or keys (pass
# 2), four warps of 16 rows, 128 threads.  An operand's tile of 64 rows is,
# for D <= 64, the TERMS bf16 planes of its split (rows of D rounded up to
# 16, + 8): split by the block in the forward, in the backward by a first
# launch into a scratch of TERMS planes of (B, H, T, D rounded up to 16) for
# each of q, k, v and dO; for 64 < D <= 128, its float32 rows (D rounded
# up to 32, + 4).  A block holds its own tiles (Q; pass 1 also dO; pass 2 K
# and V), one copy of the streamed ones (K and V; pass 2 Q and dO, and
# their lse and delta), a 64 x BIAS_LD float32 tile of the bias, and in
# pass 2 a warp's 64 x 16 keep bits.  The backward's own tiles at D <= 64
# are their float32 rows (D rounded up to 32, + 8), so that two blocks share
# an SM.
BLOCK = 64
WARPS = 4
THREADS = 32 * WARPS
TERMS = 3
BIAS_LD = BLOCK + 8
KINDS = ("fwd", "dq", "dkv")
MAX_SMEM = 232448  # bytes of shared memory a block may take on sm_90
PLANES_MAX_D = 64  # the instance that holds its operands as bf16 planes


def tile_bytes(D: int) -> int:
    """Shared memory of one operand's tile of BLOCK rows."""
    if D <= PLANES_MAX_D:
        return TERMS * BLOCK * (math.ceil(D / 16) * 16 + 8) * 2
    return BLOCK * (math.ceil(D / 32) * 32 + 4) * 4


def smem_bytes(kind: str, D: int, with_bias: bool) -> int:
    """Dynamic shared memory of a float32 kernel (`KINDS`)."""
    tile = tile_bytes(D)
    own_rows = kind != "fwd" and D <= PLANES_MAX_D
    own = tile if kind == "fwd" else 2 * (BLOCK * (math.ceil(D / 32) * 32 + 8) * 4 if own_rows else tile)
    bias_tile = 4 * BLOCK * BIAS_LD if with_bias else 0
    stats = 4 * 2 * BLOCK if kind == "dkv" else 0  # the streamed queries' lse and delta
    masks = 2 * WARPS * BLOCK if kind == "dkv" else 0  # a warp's keep bits
    return own + 2 * tile + bias_tile + stats + masks


def launch_geometry(B: int, T: int, H: int, D: int, with_bias: bool) -> dict:
    """Threads, grid and shared memory of each float32 kernel (`KINDS`) for
    these shapes, and the bf16 scratch (elements) of the backward's planes
    of q, k, v and dO, `planes_bwd` (0 where D > 64)."""
    geo = {kind: {"threads": THREADS, "grid": (math.ceil(T / BLOCK), H, B), "smem": smem_bytes(kind, D, with_bias)}
           for kind in KINDS}
    geo["planes_bwd"] = 4 * TERMS * B * H * T * math.ceil(D / 16) * 16 if D <= PLANES_MAX_D else 0
    return geo


def attention_plain(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    lens: torch.Tensor,
    scale: float,
    dropout_rate: float = 0.0,
    bias: Optional[torch.Tensor] = None,
    dropout_mask: Optional[torch.Tensor] = None,
    generator: Optional[torch.Generator] = None,
) -> torch.Tensor:
    """The einsum/where/softmax pipeline of `attention_pallas.py::_fallback`.

    `bias`: optional (B, H, Tq, Tk) additive pre-scale score term.
    Dropout (`dropout_rate > 0`) keeps each probability with chance
    1 - rate and scales kept ones by 1/(1 - rate); the keep mask is
    `dropout_mask` (bool, (B, H, Tq, Tk)) when given, else drawn from
    `generator`."""
    T = q.shape[1]
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float())
    if bias is not None:
        s = s + bias.float()
    s = s * scale
    m = torch.arange(T, device=q.device)[None, None, None, :] < lens.to(q.device)[:, None, None, None]
    s = torch.where(m, s, torch.full_like(s, NEG_INF))
    p = torch.softmax(s, dim=-1)
    p = torch.where(m, p, torch.zeros_like(p))
    if dropout_rate > 0.0:
        if dropout_mask is None:
            u = torch.rand(p.shape, generator=generator, device=p.device)
            dropout_mask = u >= dropout_rate
        p = torch.where(dropout_mask, p * (1.0 / (1.0 - dropout_rate)), torch.zeros_like(p))
    out = torch.einsum("bhqk,bkhd->bqhd", p.to(v.dtype).float(), v.float())
    return out.to(v.dtype)


def attention_bwd_plain(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    d_out: torch.Tensor,
    lens: torch.Tensor,
    scale: float,
    dropout_rate: float = 0.0,
    bias: Optional[torch.Tensor] = None,
    dropout_mask: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, Optional[torch.Tensor]]:
    """(dq, dk, dv, d bias) of `attention_plain`, with the rounding of
    `attention_pallas.py::_bwd_kernel`: P float32, Pd rounded to v's dtype
    before dV = Pd^T dO, dS * scale rounded to q's dtype before dQ, dK and
    d bias, every product summed in float32.  `dropout_mask` is the keep
    mask the forward applied (needed when `dropout_rate > 0`)."""
    T = q.shape[1]
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float())
    if bias is not None:
        s = s + bias.float()
    s = s * scale
    m = torch.arange(T, device=q.device)[None, None, None, :] < lens.to(q.device)[:, None, None, None]
    p = torch.softmax(torch.where(m, s, torch.full_like(s, NEG_INF)), dim=-1)
    p = torch.where(m, p, torch.zeros_like(p))
    inv = 1.0 / (1.0 - dropout_rate) if dropout_rate > 0.0 else 1.0
    pd = torch.where(dropout_mask, p * inv, torch.zeros_like(p)) if dropout_rate > 0.0 else p
    do = d_out.to(v.dtype).float()
    dv = torch.einsum("bhqk,bqhd->bkhd", pd.to(v.dtype).float(), do).to(v.dtype)
    dp = torch.einsum("bqhd,bkhd->bhqk", do, v.float())
    if dropout_rate > 0.0:
        dp = torch.where(dropout_mask, dp * inv, torch.zeros_like(dp))
    dp = torch.where(m, dp, torch.zeros_like(dp))
    ds = p * (dp - (dp * p).sum(dim=-1, keepdim=True))
    ds = (ds * scale).to(q.dtype).float()
    dq = torch.einsum("bhqk,bkhd->bqhd", ds, k.float()).to(q.dtype)
    dk = torch.einsum("bhqk,bqhd->bkhd", ds, q.float()).to(k.dtype)
    return dq, dk, dv, None if bias is None else ds.to(bias.dtype)


class _PlainAttention(torch.autograd.Function):
    """`attention_plain` forward, `attention_bwd_plain` backward (CPU)."""

    @staticmethod
    def forward(ctx, q, k, v, lens, scale, rate, bias, mask):
        ctx.save_for_backward(q, k, v, lens, bias, mask)
        ctx.scale, ctx.rate = scale, rate
        return attention_plain(q, k, v, lens, scale, rate, bias=bias, dropout_mask=mask)

    @staticmethod
    def backward(ctx, d_out):
        q, k, v, lens, bias, mask = ctx.saved_tensors
        dq, dk, dv, d_bias = attention_bwd_plain(q, k, v, d_out, lens, ctx.scale, ctx.rate, bias, mask)
        return dq, dk, dv, None, None, None, d_bias, None


def _dropout_args(rate: float, seed: int) -> Tuple[int, int, int, float]:
    """(seed_lo, seed_hi, threshold, 1/(1 - rate)) as the launchers take
    them; keep where a 32-bit word >= threshold = rate * 2^32."""
    if rate <= 0.0:
        return 0, 0, 0, 1.0
    if rate >= 1.0:
        raise ValueError(f"attention kernel: dropout rate {rate} must be below 1")
    threshold = min(int(rate * 2 ** 32), 2 ** 32 - 1)
    return seed & 0xFFFFFFFF, (seed >> 32) & 0xFFFFFFFF, threshold, 1.0 / (1.0 - rate)


def _key_args(B: int, H: int, block: Optional[Tuple[int, int, int, int]]) -> Tuple[int, int]:
    """(key_stride, key_offset) of the launchers: element (b, h) draws the
    bits of row row0 + b, head head0 + h of the whole batch."""
    if block is None:
        return H, 0
    row0, rows, head0, heads = block
    if row0 < 0 or head0 < 0 or row0 + B > rows or head0 + H > heads:
        raise ValueError(f"attention kernel: block {block} does not hold a ({B}, {H}) share")
    return heads, row0 * heads + head0


def block_keep_mask(shape, rate: float, generator: Optional[torch.Generator], device,
                    block: Optional[Tuple[int, int, int, int]] = None) -> torch.Tensor:
    """The CPU path's keep mask (B, H, T, T): drawn from `generator` for the
    whole batch of `block` and cut to the call's rows and heads."""
    B, H, T, _ = shape
    if block is None:
        return torch.rand(shape, generator=generator, device=device) >= rate
    _key_args(B, H, block)
    row0, rows, head0, heads = block
    u = torch.rand((rows, heads, T, T), generator=generator, device=device)
    return u[row0:row0 + B, head0:head0 + H] >= rate


def draw_seed(generator: Optional[torch.Generator] = None) -> int:
    """One fresh 62-bit dropout seed from `generator` (PyTorch's global CPU
    generator when None)."""
    dev = generator.device if generator is not None else "cpu"
    return int(torch.randint(0, 2 ** 62, (1,), generator=generator, device=dev).item())


def dropout_keep_mask(B: int, T: int, H: int, rate: float, seed: int,
                      device: torch.device, dtype: torch.dtype = torch.float32,
                      block: Optional[Tuple[int, int, int, int]] = None) -> torch.Tensor:
    """The keep mask (B, H, T, T) bool that the kernels apply for `seed`
    (and `block`, see the module note): one map for both dtypes, so `dtype`
    does not change it."""
    device = torch.device(device)
    if device.type != "cuda":
        raise ValueError("dropout_keep_mask: the kernel's bits exist on the card only")
    lo, hi, threshold, _ = _dropout_args(rate, seed)
    key_stride, key_offset = _key_args(B, H, block)
    out = torch.empty((B, H, T, T), dtype=torch.uint8, device=device)
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        KERNEL.launch("emo_attention_keep_mask", out.data_ptr(), B, T, H, lo, hi, threshold,
                      key_stride, key_offset, stream)
    return out.bool()


def _bias_args(bias: Optional[torch.Tensor]) -> Tuple[Optional[int], int]:
    return (None, 0) if bias is None else (bias.data_ptr(), _BIAS_KINDS[bias.dtype])


def _launch_fwd(q, k, v, lens32, scale, rate, seed, want_lse, bias=None, block=None):
    B, T, H, D = q.shape
    out = torch.empty_like(v)
    lse = torch.empty((B, H, T), dtype=torch.float32, device=q.device) if want_lse else None
    lo, hi, threshold, inv_keep = _dropout_args(rate, seed)
    key_stride, key_offset = _key_args(B, H, block)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        KERNEL.launch(
            _LAUNCHERS[q.dtype], q.data_ptr(), k.data_ptr(), v.data_ptr(),
            lens32.data_ptr(), out.data_ptr(), lse.data_ptr() if want_lse else None,
            *_bias_args(bias), B, T, H, D, float(scale), lo, hi, threshold, inv_keep,
            key_stride, key_offset, stream,
        )
        KERNEL.counts["bias_fwd" + _BIAS_COUNT[q.dtype]] += bias is not None
    return out, lse


class _FusedAttention(torch.autograd.Function):
    """Forward and backward kernels; saves q, k, v, the bias, the output and
    the rows' log-sum-exp, and regenerates the dropout bits from the seed."""

    @staticmethod
    def forward(ctx, q, k, v, lens32, scale, rate, seed, bias, block):
        out, lse = _launch_fwd(q, k, v, lens32, scale, rate, seed, want_lse=True, bias=bias, block=block)
        ctx.save_for_backward(q, k, v, out, lse, lens32, bias)
        ctx.scale, ctx.rate, ctx.seed, ctx.block = scale, rate, seed, block
        return out

    @staticmethod
    def backward(ctx, d_out):
        q, k, v, out, lse, lens32, bias = ctx.saved_tensors
        B, T, H, D = q.shape
        d_out = d_out.to(v.dtype).contiguous()
        planes = ()
        if q.dtype == torch.float32:  # the scratch of its operands' planes
            n = launch_geometry(B, T, H, D, bias is not None)["planes_bwd"]
            scratch = torch.empty(n, dtype=torch.bfloat16, device=q.device) if n else None
            planes = (scratch.data_ptr() if n else None,)
        else:  # its launchers move rows as 16-byte words
            d_out = aligned16(d_out)
        dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
        delta = torch.empty_like(lse)
        d_bias = None
        if bias is not None and ctx.needs_input_grad[7]:
            d_bias = torch.empty_like(bias)
        lo, hi, threshold, inv_keep = _dropout_args(ctx.rate, ctx.seed)
        key_stride, key_offset = _key_args(B, H, ctx.block)
        with torch.cuda.device(q.device):
            stream = torch.cuda.current_stream(q.device).cuda_stream
            KERNEL.launch(
                _BWD_LAUNCHERS[q.dtype], q.data_ptr(), k.data_ptr(), v.data_ptr(),
                out.data_ptr(), d_out.data_ptr(), lens32.data_ptr(), lse.data_ptr(),
                dq.data_ptr(), dk.data_ptr(), dv.data_ptr(), delta.data_ptr(), *planes,
                *_bias_args(bias), None if d_bias is None else d_bias.data_ptr(),
                B, T, H, D, float(ctx.scale), lo, hi, threshold, inv_keep, key_stride, key_offset, stream,
            )
            KERNEL.counts["bias_bwd" + _BIAS_COUNT[q.dtype]] += bias is not None
        return dq, dk, dv, None, None, None, None, d_bias, None


def fused_self_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    lens: torch.Tensor,
    *,
    scale: float,
    dropout_rate: float = 0.0,
    deterministic: bool = True,
    bias: Optional[torch.Tensor] = None,
    dropout_mask: Optional[torch.Tensor] = None,
    generator: Optional[torch.Generator] = None,
    seed: Optional[int] = None,
    block: Optional[Tuple[int, int, int, int]] = None,
) -> torch.Tensor:
    """Masked self-attention, (B, T, H, D) -> (B, T, H, D) in v.dtype.

    With dropout on, a CPU tensor takes `dropout_mask` or draws one from
    `generator` (`block_keep_mask`); a CUDA tensor takes `seed` or draws one
    from `generator` (see `draw_seed`) and refuses a `dropout_mask`.
    `block`: the call's rows and heads in a larger batch (module note)."""
    rate = 0.0 if deterministic else float(dropout_rate)
    needs_grad = torch.is_grad_enabled() and any(
        t is not None and t.requires_grad for t in (q, k, v, bias)
    )
    if q.device.type == "cpu":
        if rate > 0.0 and dropout_mask is None:
            B, T, H = q.shape[:3]
            dropout_mask = block_keep_mask((B, H, T, T), rate, generator, q.device, block)
        if needs_grad:
            return _PlainAttention.apply(q, k, v, lens, float(scale), rate, bias, dropout_mask)
        return attention_plain(q, k, v, lens, scale, rate, bias=bias, dropout_mask=dropout_mask)
    if q.device.type != "cuda":
        raise ValueError(f"attention kernel: unsupported device {q.device}")
    if rate > 0.0 and dropout_mask is not None:
        raise ValueError("attention kernel: it draws its own dropout bits; pass `seed`, not a mask")
    if q.dtype not in _LAUNCHERS:
        raise TypeError(f"attention kernel takes float32 or bfloat16, not {q.dtype}")
    if not (q.dtype == k.dtype == v.dtype):
        raise TypeError("attention kernel: q, k and v must share one dtype")
    if q.dim() != 4 or q.shape != k.shape or q.shape != v.shape:
        raise ValueError(f"attention kernel: q/k/v must be (B, T, H, D) alike, got {q.shape}, {k.shape}, {v.shape}")
    B, T, H, D = q.shape
    if D > MAX_D:
        raise ValueError(f"attention kernel: d_k={D} > {MAX_D}")
    if q.dtype == torch.bfloat16 and D % BF16_D_MULTIPLE:
        raise ValueError(f"attention kernel: bfloat16 takes d_k a multiple of {BF16_D_MULTIPLE}, not {D}")
    if lens.shape != (B,):
        raise ValueError(f"attention kernel: lens must be ({B},), got {tuple(lens.shape)}")
    if bias is not None:
        if bias.dtype not in _BIAS_KINDS:
            raise TypeError(f"attention kernel: bias must be float32 or bfloat16, not {bias.dtype}")
        if bias.shape != (B, H, T, T):
            raise ValueError(f"attention kernel: bias must be ({B}, {H}, {T}, {T}), got {tuple(bias.shape)}")
        if bias.device != q.device:
            raise ValueError(f"attention kernel: bias on {bias.device}, q on {q.device}")
        bias = bias.contiguous()  # the shifted view of the rel-pos term is strided
    for name, t in (("q", q), ("k", k), ("v", v)):
        if not t.is_contiguous():
            raise ValueError(f"attention kernel: {name} must be contiguous")
        if t.device != q.device:
            raise ValueError(f"attention kernel: {name} on {t.device}, q on {q.device}")
    lens32 = lens.to(device=q.device, dtype=torch.int32).contiguous()
    if q.dtype == torch.bfloat16:  # its launchers move rows as 16-byte words
        q, k, v = aligned16(q), aligned16(k), aligned16(v)
    if v.numel() == 0:
        return torch.empty_like(v)
    if rate > 0.0 and seed is None:
        seed = draw_seed(generator)
    seed = int(seed or 0)
    if needs_grad:
        return _FusedAttention.apply(q, k, v, lens32, float(scale), rate, seed, bias, block)
    return _launch_fwd(q, k, v, lens32, scale, rate, seed, want_lse=False, bias=bias, block=block)[0]
