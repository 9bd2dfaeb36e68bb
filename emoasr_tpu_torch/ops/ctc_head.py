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
(others raise `TypeError`).  In bfloat16 they compute what the TPU kernel
computes: the products of bf16 values accumulate in float32, `lse` and `xs`
are float32, and the gradients are rounded to the inputs' dtype once, at
the end; the plain version rounds at the same points.
"""

from __future__ import annotations

from typing import Tuple

import torch

from emoasr_tpu_torch.ops.cuda_lib import I, L, P, CudaKernel

_SUFFIX = {torch.float32: "f32", torch.bfloat16: "bf16"}
KERNEL = CudaKernel(
    "ctc_head.cu",
    {
        **{f"emo_ctc_head_fwd_{s}": [P] * 6 + [I] * 5 + [L, L, P] for s in _SUFFIX.values()},
        **{f"emo_ctc_head_grad_e_{s}": [P] * 8 + [I] * 5 + [L, L, P] for s in _SUFFIX.values()},
        **{f"emo_ctc_head_grad_w_{s}": [P] * 9 + [I] * 5 + [L, L, P] for s in _SUFFIX.values()},
    },
)


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
    @staticmethod
    def forward(ctx, eouts, w, b, z32):
        B, T, H = eouts.shape
        V, S = w.shape[1], z32.shape[1]
        lse = torch.empty((B, T), dtype=torch.float32, device=eouts.device)
        xs = torch.empty((B, T, S), dtype=torch.float32, device=eouts.device)
        with torch.cuda.device(eouts.device):
            stream = torch.cuda.current_stream(eouts.device).cuda_stream
            KERNEL.launch(
                f"emo_ctc_head_fwd_{_SUFFIX[eouts.dtype]}", eouts.data_ptr(), w.data_ptr(), b.data_ptr(),
                z32.data_ptr(), lse.data_ptr(), xs.data_ptr(), B, T, H, V, S, *w.stride(), stream,
            )
        ctx.save_for_backward(eouts, w, b, z32, lse)
        return lse, xs

    @staticmethod
    def backward(ctx, g_lse, g_xs):
        eouts, w, b, z32, lse = ctx.saved_tensors
        B, T, H = eouts.shape
        V, S = w.shape[1], z32.shape[1]
        g_lse = g_lse.to(torch.float32).contiguous()
        g_xs = g_xs.to(torch.float32).contiguous()
        g_e = g_w = g_b = None
        sfx = _SUFFIX[eouts.dtype]
        with torch.cuda.device(eouts.device):
            stream = torch.cuda.current_stream(eouts.device).cuda_stream
            common = (eouts.data_ptr(), w.data_ptr(), b.data_ptr(), z32.data_ptr(),
                      lse.data_ptr(), g_lse.data_ptr(), g_xs.data_ptr())
            if ctx.needs_input_grad[0]:
                g_e = torch.empty_like(eouts)
                KERNEL.launch(f"emo_ctc_head_grad_e_{sfx}", *common, g_e.data_ptr(),
                              B, T, H, V, S, *w.stride(), stream)
            if ctx.needs_input_grad[1] or ctx.needs_input_grad[2]:
                g_w = torch.empty_strided(w.shape, w.stride(), dtype=w.dtype, device=w.device)
                g_b = torch.empty_like(b)
                KERNEL.launch(f"emo_ctc_head_grad_w_{sfx}", *common, g_w.data_ptr(), g_b.data_ptr(),
                              B, T, H, V, S, *w.stride(), stream)
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
    if w.stride() not in ((V, 1), (1, H)):
        w = w.contiguous()
    return _FusedCTCHead.apply(eouts.contiguous(), w, b.contiguous(), z32)
