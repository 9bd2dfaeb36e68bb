"""The whole LSTM recurrence in one launch, forward and backward: CUDA
kernels and plain versions.

Port of `emoasr_tpu/ops/lstm_pallas.py::lstm_scan_pallas` (`_fwd_kernel`,
`_bwd_kernel`).  Interface kept: `x_proj` (B, T, 4H) = x @ W_ih^T + b_ih +
b_hh in torch gate order (i, f, g, o), `w_hh` (4H, H), `h0`, `c0` (B, H) ->
(ys (B, T, H), (h_T, c_T)).  The forward keeps the TPU kernel's residuals,
the post-activation gates (T, B, 4H) and [h_{t-1}, c_{t-1}] (T, B, 2H); the
backward is the exact reverse recurrence from them and returns d x_proj,
d w_hh (summed in float32 over time and batch in a fixed order), d h0 and
d c0.

For CUDA tensors `lstm_scan_fused` launches `csrc/lstm_scan.cu`; for CPU
tensors both directions take the plain versions `lstm_fwd_plain` and
`lstm_bwd_plain`, which do the kernels' arithmetic a step at a time.  The
kernels take float32 (other dtypes raise `TypeError`) and H <= `MAX_H`.
"""

from __future__ import annotations

from typing import Tuple

import torch

from emoasr_tpu_torch.ops.cuda_lib import I, P, CudaKernel

KERNEL = CudaKernel(
    "lstm_scan.cu",
    {
        "emo_lstm_fwd_f32": [P] * 10 + [I] * 3 + [P],
        "emo_lstm_bwd_f32": [P] * 11 + [I] * 3 + [P],
    },
)

MAX_H = 512  # a warp keeps one gate column of w_hh (4H values) in registers


def lstm_fwd_plain(x_proj, w_hh, h0, c0):
    """-> ys (B, T, H), h_T, c_T, gates (T, B, 4H), hcprev (T, B, 2H)."""
    h, c = h0, c0
    w_t = w_hh.t()
    ys, gates, hcprev = [], [], []
    for t in range(x_proj.shape[1]):
        hcprev.append(torch.cat([h, c], dim=-1))
        pre = torch.addmm(x_proj[:, t], h, w_t)
        i, f, g, o = pre.chunk(4, dim=-1)
        i, f, g, o = torch.sigmoid(i), torch.sigmoid(f), torch.tanh(g), torch.sigmoid(o)
        gates.append(torch.cat([i, f, g, o], dim=-1))
        c = f * c + i * g
        h = o * torch.tanh(c)
        ys.append(h)
    return torch.stack(ys, dim=1), h, c, torch.stack(gates), torch.stack(hcprev)


def lstm_bwd_plain(gates, hcprev, dys, dhT, dcT, w_hh):
    """The reverse recurrence (`_bwd_kernel`'s arithmetic) -> d x_proj
    (B, T, 4H), d w_hh (4H, H) float32, d h0, d c0."""
    T, B, H4 = gates.shape
    H = H4 // 4
    dh_c, dc_c = dhT, dcT
    dxp = torch.empty((B, T, H4), dtype=gates.dtype, device=gates.device)
    dw = torch.zeros((H4, H), dtype=torch.float32, device=gates.device)
    for t in range(T - 1, -1, -1):
        gi, gf, gg, go = gates[t].chunk(4, dim=-1)
        hprev, cprev = hcprev[t, :, :H], hcprev[t, :, H:]
        tc = torch.tanh(gf * cprev + gi * gg)
        dh = dys[:, t] + dh_c
        dc = dc_c + dh * go * (1.0 - tc * tc)
        dg = torch.cat([dc * gg * gi * (1.0 - gi), dc * cprev * gf * (1.0 - gf),
                        dc * gi * (1.0 - gg * gg), dh * tc * go * (1.0 - go)], dim=-1)
        dxp[:, t] = dg
        dw += dg.t().float() @ hprev.float()
        dh_c = dg @ w_hh
        dc_c = dc * gf
    return dxp, dw, dh_c, dc_c


def _stream(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


class _LSTMScan(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x_proj, w_hh, h0, c0):
        if x_proj.device.type == "cpu":
            ys, hT, cT, gates, hcprev = lstm_fwd_plain(x_proj, w_hh, h0, c0)
        else:
            B, T, H4 = x_proj.shape
            H, dev = H4 // 4, x_proj.device
            ys = torch.empty((B, T, H), dtype=torch.float32, device=dev)
            gates = torch.empty((T, B, H4), dtype=torch.float32, device=dev)
            hcprev = torch.empty((T, B, 2 * H), dtype=torch.float32, device=dev)
            hT, cT = (torch.empty((B, H), dtype=torch.float32, device=dev) for _ in range(2))
            bar = torch.zeros(1, dtype=torch.int32, device=dev)  # grid barrier counter
            with torch.cuda.device(dev):
                KERNEL.launch(
                    "emo_lstm_fwd_f32", x_proj.data_ptr(), w_hh.data_ptr(), h0.data_ptr(), c0.data_ptr(),
                    ys.data_ptr(), gates.data_ptr(), hcprev.data_ptr(), hT.data_ptr(), cT.data_ptr(),
                    bar.data_ptr(), B, T, H, _stream(x_proj),
                )
        ctx.save_for_backward(w_hh, gates, hcprev)
        return ys, hT, cT

    @staticmethod
    def backward(ctx, dys, dhT, dcT):
        w_hh, gates, hcprev = ctx.saved_tensors
        T, B, H4 = gates.shape
        H = H4 // 4
        dys = torch.zeros((B, T, H), dtype=gates.dtype, device=gates.device) if dys is None else dys
        dhT = torch.zeros((B, H), dtype=gates.dtype, device=gates.device) if dhT is None else dhT
        dcT = torch.zeros((B, H), dtype=gates.dtype, device=gates.device) if dcT is None else dcT
        if gates.device.type == "cpu":
            dxp, dw, dh0, dc0 = lstm_bwd_plain(gates, hcprev, dys, dhT, dcT, w_hh)
            return dxp, dw.to(w_hh.dtype), dh0, dc0
        dev = gates.device
        dys, dhT, dcT = (g.to(torch.float32).contiguous() for g in (dys, dhT, dcT))
        dxp = torch.empty((B, T, H4), dtype=torch.float32, device=dev)
        dw = torch.empty((H4, H), dtype=torch.float32, device=dev)
        dh0, dc0 = (torch.empty((B, H), dtype=torch.float32, device=dev) for _ in range(2))
        bar = torch.zeros(1, dtype=torch.int32, device=dev)
        with torch.cuda.device(dev):
            KERNEL.launch(
                "emo_lstm_bwd_f32", gates.data_ptr(), hcprev.data_ptr(), dys.data_ptr(), dhT.data_ptr(),
                dcT.data_ptr(), w_hh.data_ptr(), dxp.data_ptr(), dw.data_ptr(), dh0.data_ptr(),
                dc0.data_ptr(), bar.data_ptr(), B, T, H, _stream(gates),
            )
        return dxp, dw, dh0, dc0


def lstm_scan_fused(
    x_proj: torch.Tensor, w_hh: torch.Tensor, h0: torch.Tensor, c0: torch.Tensor
) -> Tuple[torch.Tensor, Tuple[torch.Tensor, torch.Tensor]]:
    """(ys (B, T, H), (h_T, c_T)) by one launch; see the module note."""
    if x_proj.device.type == "cuda":
        for name, t in (("x_proj", x_proj), ("w_hh", w_hh), ("h0", h0), ("c0", c0)):
            if t.dtype != torch.float32:
                raise TypeError(f"lstm kernel takes float32, {name} is {t.dtype}")
            if t.device != x_proj.device:
                raise ValueError(f"lstm kernel: {name} on {t.device}, x_proj on {x_proj.device}")
        if x_proj.dim() != 3 or x_proj.shape[-1] % 4:
            raise ValueError(f"lstm kernel: x_proj (B, T, 4H) expected, got {tuple(x_proj.shape)}")
        B, T, H4 = x_proj.shape
        H = H4 // 4
        if tuple(w_hh.shape) != (H4, H) or tuple(h0.shape) != (B, H) or tuple(c0.shape) != (B, H):
            raise ValueError(
                f"lstm kernel: shapes disagree: x_proj {tuple(x_proj.shape)}, w_hh {tuple(w_hh.shape)}, "
                f"h0 {tuple(h0.shape)}, c0 {tuple(c0.shape)}"
            )
        if not 1 <= H <= MAX_H or min(B, T) < 1:
            raise ValueError(f"lstm kernel: B={B}, T={T}, H={H}; needs B, T >= 1 and 1 <= H <= {MAX_H}")
        x_proj, w_hh, h0, c0 = (t.contiguous() for t in (x_proj, w_hh, h0, c0))
    elif x_proj.device.type != "cpu":
        raise ValueError(f"lstm kernel: unsupported device {x_proj.device}")
    ys, hT, cT = _LSTMScan.apply(x_proj, w_hh, h0, c0)
    return ys, (hT, cT)
