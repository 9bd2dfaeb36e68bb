"""CTC log-likelihood from blank-interleaved path emissions: CUDA kernels
(alpha forward, beta backward) and plain version.

Port of `emoasr_tpu/ops/ctc_pallas.py::ctc_ll_from_path`.  Interface kept:
`lp_path` (T, B, S) float32 per-state emissions, `allow2f`/`initf`/`finalf`
(B, S) {0,1} float masks (skip transition allowed / states alive at t = 0 /
final states), `xlens` (B,); returns ll (B,) float32.  The recursion
freezes each row past its `xlens`; `LOG_0 = -1e10` is finite on purpose, so
a row with no feasible alignment gives about `LOG_0`, never -inf.  The
gradient to `lp_path` is the forward-backward identity
`g * exp(alpha + beta - ll)`, zero at `t >= xlens` and, exactly, for rows
whose ll is below `LOG_0 / 2`.

For a CUDA tensor `ctc_ll_from_path` launches `csrc/ctc_lattice.cu` (both
directions through one `autograd.Function`; `lp_path` may be a transposed
view of a (B, T, S) tensor, read in place); for a CPU tensor it takes
`ctc_ll_plain`, a Python loop over T differentiated by autograd.
"""

from __future__ import annotations

import torch

from emoasr_tpu_torch.ops.common import LOG_0, logaddexp3
from emoasr_tpu_torch.ops.cuda_lib import I, L, P, CudaKernel

KERNEL = CudaKernel(
    "ctc_lattice.cu",
    {
        "emo_ctc_alpha_f32": [P, P, P, P, P, P, P, I, I, I, L, L, P],
        "emo_ctc_beta_grad_f32": [P, P, P, P, P, P, P, P, I, I, I, L, L, P],
    },
)

# two rows of S floats (and 32 words) in a block's default 48 KB of shared memory
MAX_S = (48 * 1024 // 4 - 32) // 2


def _shift_right(x: torch.Tensor, k: int) -> torch.Tensor:
    """x[:, s - k], `LOG_0` where s < k."""
    if k >= x.shape[1]:
        return torch.full_like(x, LOG_0)
    return torch.cat([x.new_full((x.shape[0], k), LOG_0), x[:, :-k]], dim=1)


def ctc_ll_plain(lp_path, allow2f, initf, finalf, xlens) -> torch.Tensor:
    """The scan of `emoasr_tpu/ops/ctc.py::ctc_loss` as a loop over T of
    (B, S) tensor operations, in float32 (float64 emissions stay float64)."""
    if lp_path.dtype != torch.float64:
        lp_path = lp_path.float()
    T = lp_path.shape[0]
    allow2 = allow2f > 0.5
    log0 = lp_path.new_full((), LOG_0)
    alpha = torch.where(initf > 0.5, lp_path[0], log0)
    for t in range(1, T):
        a2 = torch.where(allow2, _shift_right(alpha, 2), log0)
        new = logaddexp3(alpha, _shift_right(alpha, 1), a2) + lp_path[t]
        alpha = torch.where((t < xlens)[:, None], new, alpha)  # freeze past the length
    ll = torch.logsumexp(torch.where(finalf > 0.5, alpha, log0), dim=1)
    # no gradient through a row without a feasible alignment
    return torch.where(ll < LOG_0 / 2, ll.detach(), ll)


class _CTCLattice(torch.autograd.Function):
    @staticmethod
    def forward(ctx, lp_path, allow2f, initf, finalf, xlens32):
        T, B, S = lp_path.shape
        alpha = torch.empty((T, B, S), dtype=torch.float32, device=lp_path.device)
        ll = torch.empty((B,), dtype=torch.float32, device=lp_path.device)
        with torch.cuda.device(lp_path.device):
            stream = torch.cuda.current_stream(lp_path.device).cuda_stream
            KERNEL.launch(
                "emo_ctc_alpha_f32", lp_path.data_ptr(), allow2f.data_ptr(), initf.data_ptr(),
                finalf.data_ptr(), xlens32.data_ptr(), alpha.data_ptr(), ll.data_ptr(),
                T, B, S, lp_path.stride(0), lp_path.stride(1), stream,
            )
        ctx.save_for_backward(lp_path, allow2f, finalf, xlens32, alpha, ll)
        return ll

    @staticmethod
    def backward(ctx, g):
        lp_path, allow2f, finalf, xlens32, alpha, ll = ctx.saved_tensors
        T, B, S = lp_path.shape
        g = g.to(torch.float32).contiguous()
        grad = torch.empty_strided(lp_path.shape, lp_path.stride(), dtype=torch.float32,
                                   device=lp_path.device)
        with torch.cuda.device(lp_path.device):
            stream = torch.cuda.current_stream(lp_path.device).cuda_stream
            KERNEL.launch(
                "emo_ctc_beta_grad_f32", lp_path.data_ptr(), allow2f.data_ptr(),
                finalf.data_ptr(), xlens32.data_ptr(), alpha.data_ptr(), ll.data_ptr(),
                g.data_ptr(), grad.data_ptr(), T, B, S, lp_path.stride(0), lp_path.stride(1),
                stream,
            )
        return grad, None, None, None, None


def _layout_ok(x: torch.Tensor) -> bool:
    """(T, B, S) contiguous, or the transpose(0, 1) of a contiguous
    (B, T, S) tensor; the stride of an axis of size 1 is never used."""
    T, B, S = x.shape
    return any(
        all(n == 1 or st == want for n, st, want in zip(x.shape, x.stride(), strides))
        for strides in ((B * S, S, 1), (S, T * S, 1))
    )


def ctc_ll_from_path(lp_path, allow2f, initf, finalf, xlens) -> torch.Tensor:
    """Log-likelihood (B,) from path emissions (T, B, S); see the module note."""
    if lp_path.device.type == "cpu":
        return ctc_ll_plain(lp_path, allow2f, initf, finalf, xlens)
    if lp_path.device.type != "cuda":
        raise ValueError(f"ctc lattice kernel: unsupported device {lp_path.device}")
    if lp_path.dtype != torch.float32:
        raise TypeError(f"ctc lattice kernel takes float32 emissions, not {lp_path.dtype}")
    if lp_path.dim() != 3:
        raise ValueError(f"ctc lattice kernel: lp_path must be (T, B, S), got {tuple(lp_path.shape)}")
    T, B, S = lp_path.shape
    if T < 1 or B < 1 or S < 1:
        raise ValueError(f"ctc lattice kernel: empty lattice {tuple(lp_path.shape)}")
    if S > MAX_S:
        raise ValueError(f"ctc lattice kernel: S={S} does not fit shared memory (max {MAX_S})")
    if not _layout_ok(lp_path):
        raise ValueError(
            "ctc lattice kernel: lp_path must be contiguous or the transpose(0, 1) of a "
            f"contiguous (B, T, S) tensor, got strides {lp_path.stride()}"
        )
    masks = []
    for name, m in (("allow2f", allow2f), ("initf", initf), ("finalf", finalf)):
        if m.shape != (B, S) or m.device != lp_path.device:
            raise ValueError(f"ctc lattice kernel: {name} must be ({B}, {S}) on {lp_path.device}")
        masks.append(m.to(torch.float32).contiguous())
    if xlens.shape != (B,):
        raise ValueError(f"ctc lattice kernel: xlens must be ({B},), got {tuple(xlens.shape)}")
    xlens32 = xlens.to(device=lp_path.device, dtype=torch.int32).contiguous()
    return _CTCLattice.apply(lp_path, *masks, xlens32)
