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
`TypeError`) and any J whose z tile of 16 cells fits a block's shared
memory (J <= 2794 on sm_90; it takes 64 cells a block up to J = 819, then
32, then 16).  As the TPU kernel does, it casts h_dec and
w to h_enc's dtype, forms z = tanh(h_enc + h_dec) in that dtype, sums the
products z w in float32, adds the float32 bias and returns float32
log-probabilities.  A label outside [0, V) selects nothing (logit 0).
"""

from __future__ import annotations

from typing import Tuple

import torch

from emoasr_tpu_torch.ops.cuda_lib import I, L, P, CudaKernel
from emoasr_tpu_torch.ops.rnnt import TIME_CHUNK, zero_cotangents, joint_gather_backward, joint_gather_plain

_SUFFIX = {torch.float32: "f32", torch.bfloat16: "bf16"}
KERNEL = CudaKernel(
    "rnnt_joint.cu",
    {**{f"emo_rnnt_joint_{s}": [P] * 7 + [I] * 6 + [L, L, P] for s in _SUFFIX.values()},
     "emo_rnnt_joint_cells": [I]},
)


def rnnt_joint_plain(h_enc, h_dec, w_out, b_out, labels, blank_id: int = 0
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The kernel's arithmetic, a time chunk at a time: h_dec and w cast to
    h_enc's dtype, z in that dtype, float32 logits of z's and w's values
    plus the float32 bias, float32 lse and log-probabilities."""
    dt = h_enc.dtype
    # one layout of w, so that its (J, V) and `.t()` forms give the same bits
    w = w_out.to(dt).float().contiguous()
    return joint_gather_plain(h_enc, h_dec.to(dt), w, b_out.float(), labels, blank_id)


class _FusedJointGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, h_enc, h_dec, w_out, b_out, labels, blank_id):
        if h_enc.device.type == "cpu":
            lpb, lpl = rnnt_joint_plain(h_enc, h_dec, w_out, b_out, labels, blank_id)
        else:
            B, T, J = h_enc.shape
            U1, V = h_dec.shape[1], w_out.shape[1]
            dt = h_enc.dtype
            hd, w = h_dec.to(dt).contiguous(), w_out.to(dt)
            if w.stride() not in ((V, 1), (1, J)):
                w = w.contiguous()
            bias = b_out.float().contiguous()
            lpb = torch.empty((B, T, U1), dtype=torch.float32, device=h_enc.device)
            lpl = torch.empty((B, T, U1 - 1), dtype=torch.float32, device=h_enc.device)
            with torch.cuda.device(h_enc.device):
                KERNEL.launch(
                    f"emo_rnnt_joint_{_SUFFIX[dt]}", h_enc.data_ptr(), hd.data_ptr(), w.data_ptr(),
                    bias.data_ptr(), labels.data_ptr(), lpb.data_ptr(), lpl.data_ptr(),
                    B, T, U1, J, V, blank_id, *w.stride(),
                    torch.cuda.current_stream(h_enc.device).cuda_stream,
                )
        ctx.save_for_backward(h_enc, h_dec, w_out, b_out, labels)
        ctx.blank_id = blank_id
        return lpb, lpl

    @staticmethod
    def backward(ctx, g_blank, g_label):
        h_enc, h_dec, w_out, b_out, labels = ctx.saved_tensors
        g_blank, g_label = zero_cotangents(h_enc, h_dec, g_blank, g_label)
        grads = joint_gather_backward(h_enc, h_dec, w_out, b_out, labels, g_blank, g_label,
                                      ctx.blank_id, TIME_CHUNK)
        return (*grads, None, None)


def fused_joint_gather(
    h_enc: torch.Tensor, h_dec: torch.Tensor, w_out: torch.Tensor, b_out: torch.Tensor,
    labels: torch.Tensor, blank_id: int = 0,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """(lp_blank (B, T, U+1), lp_label (B, T, U)); see the module note."""
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
        return _FusedJointGather.apply(h_enc, h_dec, w_out, b_out, labels, blank_id)
    if h_enc.device.type != "cuda":
        raise ValueError(f"rnnt joint kernel: unsupported device {h_enc.device}")
    if h_enc.dtype not in _SUFFIX:
        raise TypeError(f"rnnt joint kernel takes float32 or bfloat16 activations, not {h_enc.dtype}")
    for name, t in (("h_enc", h_enc), ("h_dec", h_dec), ("w", w_out), ("b", b_out)):
        if not t.is_floating_point():
            raise TypeError(f"rnnt joint kernel: {name} is {t.dtype}")
        if t.device != h_enc.device:
            raise ValueError(f"rnnt joint kernel: {name} on {t.device}, h_enc on {h_enc.device}")
    if min(B, T, U1, J, V) < 1 or not 0 <= blank_id < V:
        raise ValueError(f"rnnt joint kernel: B={B}, T={T}, U+1={U1}, J={J}, V={V}, blank {blank_id}")
    if KERNEL.lib().emo_rnnt_joint_cells(J) == 0:
        raise ValueError(f"rnnt joint kernel: J={J} is wider than the z tile of 16 cells that a block's "
                         "shared memory holds")
    labels32 = labels.to(device=h_enc.device, dtype=torch.int32).contiguous()
    return _FusedJointGather.apply(h_enc.contiguous(), h_dec, w_out, b_out, labels32, blank_id)
