"""Fused CTC vocabulary head: CUDA kernels (forward, grad-e, grad-w) and
plain version.

Port of `emoasr_tpu/ops/ctc_head_pallas.py::fused_ctc_head`.  The CTC loss
needs two things of the head: the per-frame normaliser
`lse[b, t] = logsumexp_v(eouts[b, t] @ w + b)` and the path columns
`xs[b, t, s] = logits[b, t, z[b, s]]`.  Interface kept: `eouts` (B, T, H),
`w` (H, V) (contiguous, or the `.t()` view of an `nn.Linear` weight, which
the kernels read in place), `b` (V,), `z` (B, S) int path labels; returns
`lse` (B, T) and `xs` (B, T, S), both float32 (the JAX function pads S to a
multiple of 8; this one does not).  Gradients flow
to `eouts`, `w` and `b`; `z` is data and holds repeats, whose cotangents
add up in one vocabulary column.

For a CUDA tensor `fused_ctc_head` launches `csrc/ctc_head.cu` and the
(B, T, V) logits never exist; for a CPU tensor it takes `ctc_head_plain`,
the dense product with `logsumexp` and `gather`.  The kernels take any
hidden size and `eouts`, `w` and `b` of one dtype, float32 or bfloat16
(others raise `TypeError`), and run every product on the tensor cores.  In
bfloat16 they compute what the TPU kernel computes: the products of bf16
values accumulate in float32, the float32 d logits enter the backward's
second product split into two bf16 terms, `lse` and `xs` are float32, and
the gradients are rounded to the inputs' dtype once, at the end; the plain
version rounds at the same points.  In float32 every operand is split into
three bf16 terms and the six leading cross products are summed in float32
(TF32 stays off).  The forward and grad-e split V, and grad-w the B T
rows, between blocks (`launch_geometry`); a second launch of the same
launcher sums the partials in a fixed order, so two calls give
bit-identical outputs.

Under a model axis that splits the vocabulary (`parallel/tensor.py`),
`fused_ctc_head_shard` runs the same kernels on a rank's (H, V / m) block
with the path labels shifted by its first column: a label outside the
block is none of its columns (no logit, no cotangent), so each rank's xs
holds the logits of the labels it owns and 0 elsewhere.  The ranks'
partial lse are combined by a log-sum-exp in rank order and their xs by an
exact sum (`parallel/mesh.py`), the gradient of a partial lse is g_lse
exp(lse_r - lse), and the encoder output's gradient is summed over the
model group.  No rank holds the (B, T, V) logits or the whole head.
"""

from __future__ import annotations

import math
from typing import Tuple

import torch
import torch.nn.functional as F

from emoasr_tpu_torch.ops.cuda_lib import I, P, CudaKernel, aligned16
from emoasr_tpu_torch.parallel.mesh import copy_to_model, model_logsumexp, reduce_from_model

_SUFFIX = {torch.float32: "f32", torch.bfloat16: "bf16"}
KERNEL = CudaKernel(
    "ctc_head.cu",
    {
        **{f"emo_ctc_head_fwd_{s}": [P] * 8 + [I] * 6 + [P] for s in _SUFFIX.values()},
        **{f"emo_ctc_head_grad_e_{s}": [P] * 10 + [I] * 6 + [P] for s in _SUFFIX.values()},
        **{f"emo_ctc_head_grad_w_{s}": [P] * 11 + [I] * 6 + [P] for s in _SUFFIX.values()},
        "emo_ctc_head_smem_bytes": [I, I, I, I],
    },
)

# The kernels' launch geometry (csrc/ctc_head.cu keeps the same constants):
# tiles of 64 rows by 64 columns, eight warps (four groups of 16 rows by
# two halves of the columns, each half with partial sums of its own); the hidden size streams in
# chunks of CHUNK[dtype] columns, staged as TERMS[dtype] bf16 planes of 64
# rows, CHUNK + 8 apart; with H <= RANGE the operand a block keeps (e in the
# forward and grad-e, w in grad-w) stays whole in shared memory (rows RANGE
# + 8 apart), and a block writes d e or d w for one RANGE of columns.
TILE = 64
HALVES = 2
RANGE = 256
CHUNK = {torch.bfloat16: 256, torch.float32: 128}
TERMS = {torch.bfloat16: 1, torch.float32: 3}
MAX_SMEM = 232448  # bytes of shared memory a block may take on sm_90
H100_SMS = 132
KINDS = ("fwd", "grad_e", "grad_w")


def smem_bytes(kind: str, dtype: torch.dtype, H: int, S: int) -> int:
    """Dynamic shared memory of one block of kernel `kind`: the operand it
    keeps (e in the forward and grad-e, w in grad-w) whole and two buffers
    of the other when H <= RANGE, else two buffers of each, plus grad-w's
    two path lists of S ints."""
    tile = TERMS[dtype] * TILE * (CHUNK[dtype] + 8) * 2
    tiles = TERMS[dtype] * TILE * (RANGE + 8) * 2 + 2 * tile if H <= RANGE else 4 * tile
    return tiles + (2 * 4 * S if kind == "grad_w" else 0)


def _spread(base_blocks: int, most: int, n_sm: int) -> int:
    """How many ways to split a grid of `base_blocks` for some four blocks
    of eight warps a SM, between 1 and `most`."""
    return max(1, min(most, math.ceil(4 * n_sm / base_blocks)))


def launch_geometry(B: int, T: int, H: int, V: int, S: int, dtype: torch.dtype,
                    n_sm: int = H100_SMS) -> dict:
    """Grid, shared memory, splits and scratch of each kernel for these
    shapes (H as the kernels see it, a multiple of 8): the forward and
    grad-e split V between NS blocks, grad-w the B T rows between G groups;
    each writes float32 partials that a second launch sums in a fixed
    order.  float32 inputs are split into three bf16 planes first."""
    N, ranges = B * math.ceil(T / TILE), math.ceil(H / RANGE)
    v_tiles = math.ceil(V / TILE)
    ns_fwd = _spread(N, v_tiles, n_sm)
    ns_e = _spread(N * ranges, v_tiles, n_sm)
    G = _spread(v_tiles * ranges, N, n_sm)
    rows = B * T
    planes = 3 * (rows * H + V * H) if TERMS[dtype] == 3 else 0
    return {
        "fwd": {"grid": (math.ceil(T / TILE), B, ns_fwd), "smem": smem_bytes("fwd", dtype, H, S),
                "splits": ns_fwd, "scratch": HALVES * ns_fwd * rows * 2, "planes": planes},
        "grad_e": {"grid": (math.ceil(T / TILE), B, ns_e * ranges), "smem": smem_bytes("grad_e", dtype, H, S),
                   "splits": ns_e, "scratch": HALVES * ns_e * rows * H, "planes": planes},
        "grad_w": {"grid": (v_tiles, G, ranges), "smem": smem_bytes("grad_w", dtype, H, S),
                   "splits": G, "scratch": HALVES * G * (V * H + V) + rows * S + B * S, "planes": planes},
    }


def _scratch(geo: dict, device) -> tuple:
    """(f32 partials, bf16 planes or None) of one kernel's geometry."""
    part = torch.empty(geo["scratch"], dtype=torch.float32, device=device)
    planes = torch.empty(geo["planes"], dtype=torch.bfloat16, device=device) if geo["planes"] else None
    return part, planes


def _n_sm(device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


def ctc_head_plain(eouts, w, b, z) -> Tuple[torch.Tensor, torch.Tensor]:
    """Dense logits, `logsumexp` over V, `gather` of the path columns; a
    label outside [0, V) selects nothing (0), as a one-hot of it would.
    The logits are float32 products of the inputs' values; autograd rounds
    each gradient to its input's dtype once, after its float32 sum."""
    logits = eouts.float() @ w.float() + b.float()
    V = logits.shape[-1]
    lse = torch.logsumexp(logits, dim=-1)
    z = z.long()
    ok = (z >= 0) & (z < V)
    idx = torch.where(ok, z, torch.zeros_like(z))[:, None, :].expand(-1, logits.shape[1], -1)
    xs = torch.gather(logits, 2, idx)
    return lse, torch.where(ok[:, None, :], xs, torch.zeros_like(xs))


class _FusedCTCHead(torch.autograd.Function):
    """The three kernels on e (B, T, H) and w in nn.Linear's layout, (V, H),
    both contiguous with H a multiple of 8 and 16-byte aligned rows."""

    @staticmethod
    def forward(ctx, eouts, wt, b, z32):
        B, T, H = eouts.shape
        V, S = wt.shape[0], z32.shape[1]
        lse = torch.empty((B, T), dtype=torch.float32, device=eouts.device)
        xs = torch.empty((B, T, S), dtype=torch.float32, device=eouts.device)
        geo = launch_geometry(B, T, H, V, S, eouts.dtype, _n_sm(eouts.device))["fwd"]
        part, planes = _scratch(geo, eouts.device)
        with torch.cuda.device(eouts.device):
            stream = torch.cuda.current_stream(eouts.device).cuda_stream
            KERNEL.launch(
                f"emo_ctc_head_fwd_{_SUFFIX[eouts.dtype]}", eouts.data_ptr(), wt.data_ptr(), b.data_ptr(),
                z32.data_ptr(), lse.data_ptr(), xs.data_ptr(), part.data_ptr(),
                None if planes is None else planes.data_ptr(), geo["splits"], B, T, H, V, S, stream,
            )
        ctx.save_for_backward(eouts, wt, b, z32, lse)
        return lse, xs

    @staticmethod
    def backward(ctx, g_lse, g_xs):
        eouts, wt, b, z32, lse = ctx.saved_tensors
        B, T, H = eouts.shape
        V, S = wt.shape[0], z32.shape[1]
        g_lse = g_lse.to(torch.float32).contiguous()
        g_xs = g_xs.to(torch.float32).contiguous()
        g_e = g_w = g_b = None
        sfx = _SUFFIX[eouts.dtype]
        geos = launch_geometry(B, T, H, V, S, eouts.dtype, _n_sm(eouts.device))
        with torch.cuda.device(eouts.device):
            stream = torch.cuda.current_stream(eouts.device).cuda_stream
            common = (eouts.data_ptr(), wt.data_ptr(), b.data_ptr(), z32.data_ptr(),
                      lse.data_ptr(), g_lse.data_ptr(), g_xs.data_ptr())
            if ctx.needs_input_grad[0]:
                g_e = torch.empty_like(eouts)
                part, planes = _scratch(geos["grad_e"], eouts.device)
                KERNEL.launch(f"emo_ctc_head_grad_e_{sfx}", *common, g_e.data_ptr(), part.data_ptr(),
                              None if planes is None else planes.data_ptr(), geos["grad_e"]["splits"],
                              B, T, H, V, S, stream)
            if ctx.needs_input_grad[1] or ctx.needs_input_grad[2]:
                g_w, g_b = torch.empty_like(wt), torch.empty_like(b)
                part, planes = _scratch(geos["grad_w"], eouts.device)
                KERNEL.launch(f"emo_ctc_head_grad_w_{sfx}", *common, g_w.data_ptr(), g_b.data_ptr(),
                              part.data_ptr(), None if planes is None else planes.data_ptr(),
                              geos["grad_w"]["splits"], B, T, H, V, S, stream)
        return g_e, g_w, g_b, None


def fused_ctc_head(eouts, w, b, z) -> Tuple[torch.Tensor, torch.Tensor]:
    """(lse (B, T), xs (B, T, S)) of the un-materialised head; see the module note."""
    if eouts.device.type == "cpu":
        return ctc_head_plain(eouts, w, b, z)
    if eouts.device.type != "cuda":
        raise ValueError(f"ctc head kernel: unsupported device {eouts.device}")
    if eouts.dtype not in _SUFFIX:
        raise TypeError(f"ctc head kernel takes float32 or bfloat16, not {eouts.dtype}")
    for name, t in (("eouts", eouts), ("w", w), ("b", b)):
        if t.dtype != eouts.dtype:
            raise TypeError(f"ctc head kernel: {name} is {t.dtype}, eouts {eouts.dtype}; one dtype expected")
        if t.device != eouts.device:
            raise ValueError(f"ctc head kernel: {name} on {t.device}, eouts on {eouts.device}")
    if eouts.dim() != 3 or w.dim() != 2 or b.dim() != 1 or z.dim() != 2:
        raise ValueError("ctc head kernel: eouts (B, T, H), w (H, V), b (V,), z (B, S) expected")
    B, T, H = eouts.shape
    V, S = w.shape[1], z.shape[1]
    if w.shape[0] != H or b.shape[0] != V or z.shape[0] != B:
        raise ValueError(
            f"ctc head kernel: shapes disagree: eouts {tuple(eouts.shape)}, w {tuple(w.shape)}, "
            f"b {tuple(b.shape)}, z {tuple(z.shape)}"
        )
    if min(B, T, V, S) < 1:
        raise ValueError("ctc head kernel: empty input")
    if z.is_floating_point():
        raise TypeError(f"ctc head kernel: z must hold integers, not {z.dtype}")
    z32 = z.to(device=eouts.device, dtype=torch.int32).contiguous()
    wt = w.t()  # (V, H): read in place when w is the .t() of an nn.Linear weight
    if H % 8:  # the kernels stage rows in 16-byte words: zero columns add nothing
        eouts, wt = F.pad(eouts, (0, 8 - H % 8)), F.pad(wt, (0, 8 - H % 8))
    return _FusedCTCHead.apply(aligned16(eouts), aligned16(wt), b.contiguous(), z32)


def fused_ctc_head_shard(eouts, w, b, z, shard) -> Tuple[torch.Tensor, torch.Tensor]:
    """`fused_ctc_head` of a vocabulary split over the model group: w (H,
    V / m) and b (V / m,) the rank's columns from `shard.v0`, z the whole
    vocabulary's path labels; -> the whole head's (lse, xs), the same bits on
    every model rank (see the module note)."""
    lse_r, xs_r = fused_ctc_head(copy_to_model(eouts, shard.group), w, b, z - shard.v0)
    return model_logsumexp(lse_r, shard.group, shard.rank, shard.size), reduce_from_model(xs_r, shard.group)
