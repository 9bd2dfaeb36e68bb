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

For CUDA tensors `lstm_scan_fused` launches `csrc/lstm_scan.cu` (its
products on the tensor cores, float32 operands as two bf16 terms; d w_hh
by a second kernel after the recurrence); for CPU tensors both directions
take the plain versions `lstm_fwd_plain` and `lstm_bwd_plain`, which do the
kernels' arithmetic a step at a time in float32.  The kernels take any
B, T >= 1, 1 <= H <= `MAX_H` and an `x_proj` of float32 or bfloat16 (others
raise `TypeError`), which is the storage dtype: as in the TPU kernel, h0
and c0 are cast to it, w_hh and the carried h and c are float32, and ys,
h_T, c_T and the residuals `gates` and `hcprev` are stored rounded to it;
the backward recomputes from those rounded residuals, sums d w_hh in
float32 from the unrounded d pre and rounds d x_proj, d h0 and d c0.  A
w_hh given in bfloat16 is one bf16 term on the tensor cores (the same sums
as two terms whose second is zero).  `launch_geometry` says how the
kernels are laid out on the card; a shape whose geometry does not fit
raises `ValueError`.
"""

from __future__ import annotations

import math
from collections import Counter
from typing import Tuple

import torch

from emoasr_tpu_torch.ops.cuda_lib import I, P, CudaKernel

_SUFFIX = {torch.float32: "f32", torch.bfloat16: "bf16"}
KERNEL = CudaKernel(
    "lstm_scan.cu",
    {
        **{f"emo_lstm_fwd_{s}": [P] * 11 + [I] * 6 + [P] for s in _SUFFIX.values()},
        **{f"emo_lstm_bwd_{s}": [P] * 12 + [I] * 5 + [P] for s in _SUFFIX.values()},
        "emo_lstm_smem_bytes": [I] * 6,
    },
)

# launches by shape class (("fwd" | "bwd", B, T, H, dtype) of the call), for
# the reports; `KERNEL.counts` counts the same launches
SHAPE_LAUNCHES: Counter = Counter()

# The kernels' geometry, mirrored from csrc/lstm_scan.cu (`SmemPlan`): one
# block of 256 threads (8 warps) an SM; a block owns `units` hidden units
# (forward 4 while H <= 512, one m16 tile of gate rows, else 8; backward 8)
# and the grid of ceil(H / units) blocks must be co-resident (132 SMs on the
# H100); K (H forward, 4H backward, each gate padded to Hp, a multiple of
# 128) splits over the warps, 16 columns a k-step; each warp streams its K
# slice of h_{t-1} (forward) or d pre_t (backward) through a ring of
# `stages` slots of CHUNK k-steps.
MAX_H = 1024
TERMS = 2  # bf16 terms of a float32 operand of the kernels' products (three leading cross products)
THREADS, WARPS = 256, 8
MAX_SMEM = 232448  # what one block may use on sm_90
MAX_STAGES = 8
CHUNK = {"fwd": 1, "bwd": 4}
BWD_UNITS = 8
PAD = 8  # floats after each staged row
DW_TILE = 64  # the d w_hh kernel's square output tile
DW_SMEM = 2 * 2 * 32 * (DW_TILE + 8) * 2  # its static bf16 planes of d pre and h_{t-1}


def padded_h(H: int) -> int:
    return -(-H // 128) * 128


def _tile_rows(B: int) -> int:
    return 16 if B <= 16 else 32


def smem_bytes(kind: str, B: int, H: int, units: int, stages: int, w_terms: int) -> int:
    """Shared memory of one block of kind "fwd" or "bwd" (`SmemPlan`): the
    second bf16 term of its w_hh fragments (w_terms 2), the warps' partial
    sums, two floats a cell, and the warps' rings."""
    Hp = padded_h(H)
    ksteps, n = (Hp // 128, 4 * units) if kind == "fwd" else (Hp // 32, BWD_UNITS)
    w1 = WARPS * ksteps * (n // 8) * 32 * 8 if w_terms == 2 else 0
    rows = _tile_rows(B)
    part = WARPS * rows * (n + 8) * 4
    cells = 2 * B * units * 4
    slots = WARPS * stages * min(B, rows) * (16 * CHUNK[kind] + PAD) * 4
    return w1 + part + cells + slots


def launch_geometry(B: int, T: int, H: int, dtype=torch.float32, w_dtype=None) -> dict:
    """How the kernels run (B, T, H) with x_proj of `dtype` and w_hh of
    `w_dtype` (default `dtype`): for "fwd" and "bwd" the blocks (one an
    SM, co-resident), units a block, ring stages (as many as fit, at most
    one a chunk of the warp's K slice), tile rows, shared memory a block,
    and where w_hh's terms live (the first in registers, `w_registers` a
    thread, the second in shared memory); the cluster size (1: no clusters);
    the d w_hh kernel's grid; the f32 scratch shapes.  Raises `ValueError`
    where it does not fit."""
    if B < 1 or T < 1 or not 1 <= H <= MAX_H:
        raise ValueError(f"lstm kernel: B={B}, T={T}, H={H}; needs B, T >= 1 and 1 <= H <= {MAX_H}")
    w_terms = 1 if (dtype if w_dtype is None else w_dtype) == torch.bfloat16 else TERMS
    Hp = padded_h(H)
    geo = {"Hp": Hp, "w_terms": w_terms, "threads": THREADS, "cluster": 1}
    for kind, units in (("fwd", 4 if Hp <= 512 else 8), ("bwd", BWD_UNITS)):
        ksteps, n = (Hp // 128, 4 * units) if kind == "fwd" else (Hp // 32, BWD_UNITS)
        chunks = ksteps // CHUNK[kind]
        fits = [s for s in range(1, min(chunks, MAX_STAGES) + 1)
                if smem_bytes(kind, B, H, units, s, w_terms) <= MAX_SMEM]
        if not fits:
            raise ValueError(f"lstm kernel: B={B}, H={H} need {smem_bytes(kind, B, H, units, 1, w_terms)} "
                             f"bytes of shared memory a block ({kind}), the card allows {MAX_SMEM}")
        stages = fits[-1]
        geo[kind] = {
            "blocks": math.ceil(H / units), "units": units, "stages": stages, "tile_rows": _tile_rows(B),
            "smem": smem_bytes(kind, B, H, units, stages, w_terms),
            "w_registers": ksteps * (n // 8) * 2,
            "w_smem": smem_bytes(kind, B, H, units, stages, w_terms) - smem_bytes(kind, B, H, units, stages, 1),
        }
    geo["dw"] = {"grid": (4 * Hp // DW_TILE, Hp // DW_TILE), "threads": THREADS, "smem": DW_SMEM}
    geo["scratch"] = {"hbuf": (2, B, Hp), "dpre": (T, B, 4 * Hp)}
    return geo


def lstm_fwd_plain(x_proj, w_hh, h0, c0):
    """-> ys (B, T, H), h_T, c_T, gates (T, B, 4H), hcprev (T, B, 2H), each
    stored in x_proj's dtype; w_hh, h and c are float32 (see the module
    note)."""
    dt = x_proj.dtype
    h, c = h0.to(dt).float(), c0.to(dt).float()
    w_t = w_hh.float().t()
    ys, gates, hcprev = [], [], []
    for t in range(x_proj.shape[1]):
        hcprev.append(torch.cat([h, c], dim=-1).to(dt))
        pre = torch.addmm(x_proj[:, t].float(), h, w_t)
        i, f, g, o = pre.chunk(4, dim=-1)
        i, f, g, o = torch.sigmoid(i), torch.sigmoid(f), torch.tanh(g), torch.sigmoid(o)
        gates.append(torch.cat([i, f, g, o], dim=-1).to(dt))
        c = f * c + i * g
        h = o * torch.tanh(c)
        ys.append(h.to(dt))
    return torch.stack(ys, dim=1), h.to(dt), c.to(dt), torch.stack(gates), torch.stack(hcprev)


def lstm_bwd_plain(gates, hcprev, dys, dhT, dcT, w_hh):
    """The reverse recurrence (`_bwd_kernel`'s arithmetic) from the stored
    residuals -> d x_proj (B, T, 4H) in the residuals' dtype, d w_hh
    (4H, H) float32, d h0, d c0 in the residuals' dtype."""
    T, B, H4 = gates.shape
    H = H4 // 4
    dt = gates.dtype
    dh_c, dc_c = dhT.to(dt).float(), dcT.to(dt).float()
    w = w_hh.float()
    dxp = torch.empty((B, T, H4), dtype=dt, device=gates.device)
    dw = torch.zeros((H4, H), dtype=torch.float32, device=gates.device)
    for t in range(T - 1, -1, -1):
        gi, gf, gg, go = gates[t].float().chunk(4, dim=-1)
        hc = hcprev[t].float()
        hprev, cprev = hc[:, :H], hc[:, H:]
        tc = torch.tanh(gf * cprev + gi * gg)
        dh = dys[:, t].to(dt).float() + dh_c
        dc = dc_c + dh * go * (1.0 - tc * tc)
        dg = torch.cat([dc * gg * gi * (1.0 - gi), dc * cprev * gf * (1.0 - gf),
                        dc * gi * (1.0 - gg * gg), dh * tc * go * (1.0 - go)], dim=-1)
        dxp[:, t] = dg.to(dt)
        dw += dg.t() @ hprev
        dh_c = dg @ w
        dc_c = dc * gf
    return dxp, dw, dh_c.to(dt), dc_c.to(dt)


def _padding_zeroed(shape: tuple, H: int, dev) -> torch.Tensor:
    """A scratch of 4-byte words whose last dimension holds gates of Hp
    columns each: the kernels write every column below H before they read
    it, so only columns H..Hp-1 of each gate are zeroed (none where
    H % 128 == 0)."""
    buf = torch.empty(shape, dtype=torch.float32, device=dev)
    Hp = padded_h(H)
    if H < Hp:
        buf.view(*shape[:-1], shape[-1] // Hp, Hp)[..., H:].zero_()
    return buf


def _stream(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


class _LSTMScan(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x_proj, w_hh, h0, c0, w_dtype, geo):
        if x_proj.device.type == "cpu":
            ys, hT, cT, gates, hcprev = lstm_fwd_plain(x_proj, w_hh, h0, c0)
        else:
            B, T, H4 = x_proj.shape
            H, dev, dt = H4 // 4, x_proj.device, x_proj.dtype
            ys = torch.empty((B, T, H), dtype=dt, device=dev)
            gates = torch.empty((T, B, H4), dtype=dt, device=dev)
            hcprev = torch.empty((T, B, 2 * H), dtype=dt, device=dev)
            hT, cT = (torch.empty((B, H), dtype=dt, device=dev) for _ in range(2))
            hbuf = _padding_zeroed(geo["scratch"]["hbuf"], H, dev)  # the f32 h carry
            bar = torch.zeros(1, dtype=torch.int32, device=dev)  # grid barrier counter
            h0s, c0s = h0.to(dt).contiguous(), c0.to(dt).contiguous()
            with torch.cuda.device(dev):
                KERNEL.launch(
                    f"emo_lstm_fwd_{_SUFFIX[dt]}", x_proj.data_ptr(), w_hh.data_ptr(), h0s.data_ptr(),
                    c0s.data_ptr(), ys.data_ptr(), gates.data_ptr(), hcprev.data_ptr(), hT.data_ptr(),
                    cT.data_ptr(), hbuf.data_ptr(), bar.data_ptr(), B, T, H, geo["fwd"]["units"],
                    geo["fwd"]["stages"], geo["w_terms"], _stream(x_proj),
                )
            SHAPE_LAUNCHES[("fwd", B, T, H, _SUFFIX[dt])] += 1
        ctx.save_for_backward(w_hh, gates, hcprev)
        ctx.dtypes = (h0.dtype, c0.dtype, w_dtype)
        ctx.geo = geo
        return ys, hT, cT

    @staticmethod
    def backward(ctx, dys, dhT, dcT):
        w_hh, gates, hcprev = ctx.saved_tensors
        T, B, H4 = gates.shape
        H, dev, dt = H4 // 4, gates.device, gates.dtype
        dys = torch.zeros((B, T, H), dtype=dt, device=dev) if dys is None else dys
        dhT = torch.zeros((B, H), dtype=dt, device=dev) if dhT is None else dhT
        dcT = torch.zeros((B, H), dtype=dt, device=dev) if dcT is None else dcT
        if dev.type == "cpu":
            dxp, dw, dh0, dc0 = lstm_bwd_plain(gates, hcprev, dys, dhT, dcT, w_hh)
        else:
            geo = ctx.geo
            dys, dhT, dcT = (g.to(dt).contiguous() for g in (dys, dhT, dcT))
            dxp = torch.empty((B, T, H4), dtype=dt, device=dev)
            dw = torch.empty((H4, H), dtype=torch.float32, device=dev)
            dh0, dc0 = (torch.empty((B, H), dtype=dt, device=dev) for _ in range(2))
            # d pre of every step, split into two bf16 terms by the cells that compute
            # it: the broadcast buffer, then d w_hh's operand
            dpre = _padding_zeroed(geo["scratch"]["dpre"], H, dev)
            bar = torch.zeros(1, dtype=torch.int32, device=dev)
            with torch.cuda.device(dev):
                KERNEL.launch(
                    f"emo_lstm_bwd_{_SUFFIX[dt]}", gates.data_ptr(), hcprev.data_ptr(), dys.data_ptr(),
                    dhT.data_ptr(), dcT.data_ptr(), w_hh.data_ptr(), dxp.data_ptr(), dw.data_ptr(),
                    dh0.data_ptr(), dc0.data_ptr(), dpre.data_ptr(), bar.data_ptr(), B, T, H,
                    geo["bwd"]["stages"], geo["w_terms"], _stream(gates),
                )
            SHAPE_LAUNCHES[("bwd", B, T, H, _SUFFIX[dt])] += 1
        return dxp, dw.to(ctx.dtypes[2]), dh0.to(ctx.dtypes[0]), dc0.to(ctx.dtypes[1]), None, None


def lstm_scan_fused(
    x_proj: torch.Tensor, w_hh: torch.Tensor, h0: torch.Tensor, c0: torch.Tensor
) -> Tuple[torch.Tensor, Tuple[torch.Tensor, torch.Tensor]]:
    """(ys (B, T, H), (h_T, c_T)) by one launch; see the module note."""
    if x_proj.device.type == "cuda":
        if x_proj.dtype not in _SUFFIX:
            raise TypeError(f"lstm kernel takes float32 or bfloat16, not {x_proj.dtype}")
        for name, t in (("x_proj", x_proj), ("w_hh", w_hh), ("h0", h0), ("c0", c0)):
            if not t.is_floating_point():
                raise TypeError(f"lstm kernel: {name} is {t.dtype}")
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
        geo = launch_geometry(B, T, H, x_proj.dtype, w_hh.dtype)  # raises where the shape does not fit
        x_proj, h0, c0 = (t.contiguous() for t in (x_proj, h0, c0))
    elif x_proj.device.type == "cpu":
        geo = None
    else:
        raise ValueError(f"lstm kernel: unsupported device {x_proj.device}")
    w_dtype = w_hh.dtype
    if x_proj.device.type == "cuda":
        w_hh = w_hh.float().contiguous()
    ys, hT, cT = _LSTMScan.apply(x_proj, w_hh, h0, c0, w_dtype, geo)
    return ys, (hT, cT)
