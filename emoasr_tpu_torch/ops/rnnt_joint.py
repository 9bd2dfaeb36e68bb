"""Fused RNN-T joint: CUDA kernel and plain version.

Port of `emoasr_tpu/ops/rnnt_pallas.py::fused_joint_gather` (forward
`fused_joint_gather_fwd`, kernel `_kernel`).  Interface kept: `h_enc`
(B, T, J) = W_enc eouts, `h_dec` (B, U+1, J) = W_dec douts (biases folded
in), `w_out` (J, V) (contiguous, or the `.t()` view of an `nn.Linear`
weight, which the kernel reads in place), `b_out` (V,), `labels` (B, U)
int; returns `lp_blank` (B, T, U+1) and `lp_label` (B, T, U), float32,
without ever holding the (B, T, U+1, V) joint output.

For a CUDA tensor the forward launches `csrc/rnnt_joint.cu`; for a CPU
tensor it takes `rnnt_joint_plain` (the dense product a time chunk at a
time).  The backward is the chunked plain path's on both
(`ops/rnnt.py::joint_gather_backward`, recomputing each chunk, in the
inputs' dtype), as the JAX custom VJP hands its backward to
`rnnt_gathered_from_joint`: those matrix products are outside the TPU
kernel.  The kernel takes float32 or bfloat16 activations (others raise
`TypeError`) and J up to 2794 (wider raises `ValueError`).  As the TPU
kernel does, it casts h_dec and w to h_enc's dtype, forms z = tanh(h_enc +
h_dec) in that dtype, sums the products z w in float32 on the tensor cores
(bf16 operands; in float32, z and w each split into two bf16 terms and the
three leading cross products summed), adds the float32 bias and returns
float32 log-probabilities.  A label outside [0, V) selects nothing (logit
0).  The bfloat16 kernel reads w in `nn.Linear`'s (V, J) layout: the
`.t()` view of a linear layer's weight in place, anything else (a
contiguous (J, V) w, J not a multiple of 8) through one copy of w in that
layout, zero-padded to a multiple of 8 columns (V J bf16, 4 MB at J = 512,
V = 4000).  The float32 kernel splits w, in whatever layout, into two bf16
planes of that shape (a scratch the wrapper allocates) by a first launch.

Under a model axis that splits the vocabulary (`parallel/tensor.py`),
`joint_gather_shard` takes a rank's block of V / m columns from `shard.v0`
and the whole vocabulary's blank and labels.  Its `pallas` route launches
the kernel's vocabulary-split launcher (`emo_rnnt_joint_shard_*`, the same
kernel with a column offset), which writes per cell the block's float32
lse and the blank and label logits the block owns (0 elsewhere); its
`chunked` route computes the same three from the plain chunks.  The ranks'
lse are combined by a log-sum-exp in rank order and the owned logits by an
exact sum (`parallel/mesh.py`), so every rank holds the same
log-probabilities.  The backward is the chunked one against the combined
normaliser on the rank's columns (`ops/rnnt.py::joint_gather_backward`'s
`lse`); the caller sums h_enc's and h_dec's gradients over the model group.
`rnnt_joint_plain(..., v0=...)` gives the launcher's three outputs.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from emoasr_tpu_torch.ops.cuda_lib import I, L, P, CudaKernel
from emoasr_tpu_torch.ops.rnnt import (
    TIME_CHUNK,
    joint_gather_backward,
    joint_gather_plain,
    joint_parts_plain,
    zero_cotangents,
)
from emoasr_tpu_torch.parallel.mesh import all_reduce_, gather_model, lse_in_order

_SUFFIX = {torch.float32: "f32", torch.bfloat16: "bf16"}
KERNEL = CudaKernel(
    "rnnt_joint.cu",
    {**{f"emo_rnnt_joint_{s}": [P] * 8 + [I] * 6 + [L, L, I, I, P] for s in _SUFFIX.values()},
     **{f"emo_rnnt_joint_shard_{s}": [P] * 8 + [I] * 7 + [P, L, L, I, I, P] for s in _SUFFIX.values()},
     "emo_rnnt_joint_smem_bytes": [I, I, I, I]},
)

# The kernel's launch geometry (csrc/rnnt_joint.cu keeps the same
# constants): V tiles of 256 columns, four warp columns of 64; W streamed in
# ring stages of 64 joint columns in bf16, 32 in float32, 16 at 16 cells a
# block (planes of 256 rows, chunk + 8 bf16 apart); z kept as TERMS bf16
# planes of CELLS rows, J rounded up to 64 plus 8 apart.
# A block of BM cells has one row of warps (BM <= 32) or two, each warp 16
# MT = BM / (16 rows) cells tall; float32 takes at most 64 cells.
TILE_V = 256
WARP_COLUMNS = 4
TERMS = {torch.bfloat16: 1, torch.float32: 2}
CELLS = {torch.bfloat16: (128, 64, 32, 16), torch.float32: (64, 32, 16)}
STAGES = (2, 4)  # the fewest and the most ring stages
MAX_J = 2794  # the widest joint the kernel has taken since its port
MAX_SMEM = 232448  # bytes of shared memory a block may take on sm_90


def smem_bytes(terms: int, bm: int, stages: int, J: int) -> int:
    """Dynamic shared memory of a block of `bm` cells: the z planes, the
    ring of W, the warp columns' (max, sum) and each cell's blank and label
    logit."""
    ldz = math.ceil(J / 64) * 64 + 8
    chunk = 16 if bm == 16 else 64 if terms == 1 else 32
    return 2 * (terms * bm * ldz + stages * terms * TILE_V * (chunk + 8)) + 4 * (2 * WARP_COLUMNS + 2) * bm


def launch_geometry(B: int, T: int, U1: int, J: int, V: int, dtype: torch.dtype) -> Optional[dict]:
    """Cells a block (the widest z tile that fits with two ring stages),
    ring stages (as many as then fit), threads, grid, shared memory and the
    bf16 scratch of W's split (float32) for these shapes; None where J is
    wider than MAX_J or no z tile fits."""
    terms = TERMS[dtype]
    if not 1 <= J <= MAX_J:
        return None
    for bm in CELLS[dtype]:
        if smem_bytes(terms, bm, STAGES[0], J) <= MAX_SMEM:
            stages = max(s for s in range(STAGES[0], STAGES[1] + 1) if smem_bytes(terms, bm, s, J) <= MAX_SMEM)
            return {"cells": bm, "stages": stages, "threads": 32 * WARP_COLUMNS * (2 if bm >= 64 else 1),
                    "grid": (math.ceil(T * U1 / bm), B), "smem": smem_bytes(terms, bm, stages, J),
                    "planes": 2 * V * math.ceil(J / 8) * 8 if terms == 2 else 0}
    return None


def rnnt_joint_plain(h_enc, h_dec, w_out, b_out, labels, blank_id: int = 0, v0: Optional[int] = None) -> tuple:
    """The kernel's arithmetic, a time chunk at a time: h_dec and w cast to
    h_enc's dtype, z in that dtype, float32 logits of z's and w's values
    plus the float32 bias, float32 lse and log-probabilities.  With `v0`
    (w_out, b_out the block of columns from v0; blank and labels ids of the
    whole vocabulary): the vocabulary-split launcher's (lse, owned blank
    logit, owned label logit)."""
    dt = h_enc.dtype
    # one layout of w, so that its (J, V) and `.t()` forms give the same bits
    w = w_out.to(dt).float().contiguous()
    if v0 is None:
        return joint_gather_plain(h_enc, h_dec.to(dt), w, b_out.float(), labels, blank_id)
    return joint_parts_plain(h_enc, h_dec.to(dt), w, b_out.float(), labels - v0, blank_id - v0)


def _launch(h_enc, h_dec, w_out, b_out, labels32, blank_id: int, geo: dict, v0: Optional[int] = None):
    """The kernel on CUDA tensors (h_enc contiguous, labels int32) with the
    cells a block and ring stages of `geo`; with `v0`, the vocabulary-split
    launcher: (lse, owned blank logit, owned label logit)."""
    B, T, J = h_enc.shape
    U1, V = h_dec.shape[1], w_out.shape[1]
    dt = h_enc.dtype
    hd, w = h_dec.to(dt).contiguous(), w_out.to(dt)
    planes = None
    if dt == torch.bfloat16:  # rows of the (V, J) layout, 16-byte words
        w = w.t()
        if J % 8 or w.stride(1) != 1 or w.stride(0) % 8 or w.stride(0) < J or w.data_ptr() % 16:
            w = F.pad(w, (0, -J % 8)).contiguous()  # the one copy of W
        w_strides = (1, w.stride(0))
    else:
        planes = torch.empty(geo["planes"], dtype=torch.bfloat16, device=h_enc.device)
        w_strides = w.stride()
    bias = b_out.float().contiguous()
    lpb = torch.empty((B, T, U1), dtype=torch.float32, device=h_enc.device)
    lpl = torch.empty((B, T, U1 - 1), dtype=torch.float32, device=h_enc.device)
    args = (h_enc.data_ptr(), hd.data_ptr(), w.data_ptr(), bias.data_ptr(), labels32.data_ptr(), lpb.data_ptr(),
            lpl.data_ptr(), None if planes is None else planes.data_ptr(), B, T, U1, J, V, blank_id)
    tail = (*w_strides, geo["cells"], geo["stages"], torch.cuda.current_stream(h_enc.device).cuda_stream)
    with torch.cuda.device(h_enc.device):
        if v0 is None:
            KERNEL.launch(f"emo_rnnt_joint_{_SUFFIX[dt]}", *args, *tail)
            return lpb, lpl
        lse = torch.empty((B, T, U1), dtype=torch.float32, device=h_enc.device)
        KERNEL.launch(f"emo_rnnt_joint_shard_{_SUFFIX[dt]}", *args, v0, lse.data_ptr(), *tail)
    return lse, lpb, lpl


class _FusedJointGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, h_enc, h_dec, w_out, b_out, labels, blank_id, geo):
        if geo is None:  # a CPU tensor
            lpb, lpl = rnnt_joint_plain(h_enc, h_dec, w_out, b_out, labels, blank_id)
        else:
            lpb, lpl = _launch(h_enc, h_dec, w_out, b_out, labels, blank_id, geo)
        ctx.save_for_backward(h_enc, h_dec, w_out, b_out, labels)
        ctx.blank_id = blank_id
        return lpb, lpl

    @staticmethod
    def backward(ctx, g_blank, g_label):
        h_enc, h_dec, w_out, b_out, labels = ctx.saved_tensors
        g_blank, g_label = zero_cotangents(h_enc, h_dec, g_blank, g_label)
        grads = joint_gather_backward(h_enc, h_dec, w_out, b_out, labels, g_blank, g_label,
                                      ctx.blank_id, TIME_CHUNK)
        return (*grads, None, None, None)


def _geometry(h_enc, h_dec, w_out, b_out, labels, blank_id: int, whole: bool = True) -> Optional[dict]:
    """The inputs checked; the kernel's geometry for CUDA tensors, None for
    CPU ones.  `whole`: w_out holds the whole vocabulary, the blank's
    column too (a block of it need not)."""
    if h_enc.dim() != 3 or h_dec.dim() != 3 or w_out.dim() != 2 or b_out.dim() != 1 or labels.dim() != 2:
        raise ValueError("rnnt joint: h_enc (B, T, J), h_dec (B, U+1, J), w (J, V), b (V,), labels (B, U) expected")
    B, T, J = h_enc.shape
    U1, V = h_dec.shape[1], w_out.shape[1]
    if (h_dec.shape[0], h_dec.shape[2], w_out.shape[0], b_out.shape[0], labels.shape[0]) != (B, J, J, V, B):
        raise ValueError(
            f"rnnt joint: shapes disagree: h_enc {tuple(h_enc.shape)}, h_dec {tuple(h_dec.shape)}, "
            f"w {tuple(w_out.shape)}, b {tuple(b_out.shape)}, labels {tuple(labels.shape)}"
        )
    if labels.shape[1] != U1 - 1:
        raise ValueError(
            f"rnnt joint: labels length {labels.shape[1]} != h_dec length - 1 ({U1 - 1}); the "
            "prediction network's output is U+1 long (eos-led, data/asr_dataset.py)"
        )
    if labels.is_floating_point():
        raise TypeError(f"rnnt joint: labels must hold integers, not {labels.dtype}")
    if h_enc.device.type == "cpu":
        return None
    if h_enc.device.type != "cuda":
        raise ValueError(f"rnnt joint kernel: unsupported device {h_enc.device}")
    if h_enc.dtype not in _SUFFIX:
        raise TypeError(f"rnnt joint kernel takes float32 or bfloat16 activations, not {h_enc.dtype}")
    for name, t in (("h_enc", h_enc), ("h_dec", h_dec), ("w", w_out), ("b", b_out)):
        if not t.is_floating_point():
            raise TypeError(f"rnnt joint kernel: {name} is {t.dtype}")
        if t.device != h_enc.device:
            raise ValueError(f"rnnt joint kernel: {name} on {t.device}, h_enc on {h_enc.device}")
    if min(B, T, U1, J, V) < 1 or blank_id < 0 or (whole and blank_id >= V):
        raise ValueError(f"rnnt joint kernel: B={B}, T={T}, U+1={U1}, J={J}, V={V}, blank {blank_id}")
    geo = launch_geometry(B, T, U1, J, V, h_enc.dtype)
    if geo is None:
        raise ValueError(f"rnnt joint kernel: J={J} is wider than the kernel takes ({MAX_J})")
    return geo


def fused_joint_gather(
    h_enc: torch.Tensor, h_dec: torch.Tensor, w_out: torch.Tensor, b_out: torch.Tensor,
    labels: torch.Tensor, blank_id: int = 0,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """(lp_blank (B, T, U+1), lp_label (B, T, U)); see the module note."""
    geo = _geometry(h_enc, h_dec, w_out, b_out, labels, blank_id)
    if geo is None:
        return _FusedJointGather.apply(h_enc, h_dec, w_out, b_out, labels, blank_id, None)
    labels32 = labels.to(device=h_enc.device, dtype=torch.int32).contiguous()
    return _FusedJointGather.apply(h_enc.contiguous(), h_dec, w_out, b_out, labels32, blank_id, geo)


def joint_parts_shard(h_enc, h_dec, w_out, b_out, labels, blank_id: int, v0: int) -> tuple:
    """(lse, owned blank logit, owned label logit) of the block of columns
    from `v0` (w_out (J, V / m), b_out (V / m,); blank and labels ids of the
    whole vocabulary), float32, no gradient: the vocabulary-split launcher
    on a CUDA tensor, `rnnt_joint_plain(..., v0=v0)` on a CPU one."""
    geo = _geometry(h_enc, h_dec, w_out, b_out, labels, blank_id, whole=False)
    if geo is None:
        return rnnt_joint_plain(h_enc, h_dec, w_out, b_out, labels, blank_id, v0)
    labels32 = labels.to(device=h_enc.device, dtype=torch.int32).contiguous()
    return _launch(h_enc.contiguous(), h_dec, w_out, b_out, labels32, blank_id, geo, v0)


class _ShardedJointGather(torch.autograd.Function):
    """(lp_blank, lp_label) of a rank's block of the vocabulary, combined
    over the model group in the forward; the backward is the rank's
    columns' share (see the module note)."""

    @staticmethod
    def forward(ctx, h_enc, h_dec, w_out, b_out, labels, blank_id, shard, route):
        if route == "pallas":
            lse_r, blank, label = joint_parts_shard(h_enc, h_dec, w_out, b_out, labels, blank_id, shard.v0)
        else:
            lse_r, blank, label = joint_parts_plain(h_enc, h_dec, w_out, b_out, labels - shard.v0,
                                                    blank_id - shard.v0)
        lse = lse_in_order(gather_model(lse_r, shard.group, shard.rank, shard.size))
        for t in (blank, label):  # owned logits: one non-zero term each, an exact sum
            all_reduce_(t, shard.group)
        ctx.save_for_backward(h_enc, h_dec, w_out, b_out, labels, lse)
        ctx.blank_id, ctx.v0 = blank_id, shard.v0
        return blank - lse, label - lse[:, :, :label.shape[2]]

    @staticmethod
    def backward(ctx, g_blank, g_label):
        h_enc, h_dec, w_out, b_out, labels, lse = ctx.saved_tensors
        g_blank, g_label = zero_cotangents(h_enc, h_dec, g_blank, g_label)
        grads = joint_gather_backward(h_enc, h_dec, w_out, b_out, labels - ctx.v0, g_blank, g_label,
                                      ctx.blank_id - ctx.v0, TIME_CHUNK, lse=lse)
        return (*grads, None, None, None, None)


def joint_gather_shard(h_enc, h_dec, w_out, b_out, labels, blank_id: int, shard, route: str = "pallas"
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(lp_blank (B, T, U+1), lp_label (B, T, U)) of the whole vocabulary
    from a rank's block of it: w_out (J, V / m) and b_out (V / m,) the
    columns from `shard.v0`, labels and `blank_id` ids of the whole
    vocabulary.  `route`: "pallas" (the kernel on the card, its plain
    version on the CPU) or "chunked".  h_enc and h_dec are replicated
    inputs; their gradients are this rank's share, which the caller sums
    over the model group."""
    return _ShardedJointGather.apply(h_enc, h_dec, w_out, b_out, labels, blank_id, shard, route)
