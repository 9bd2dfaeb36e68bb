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
view of a (B, T, S) tensor, read in place), a block an utterance laid out
by `launch_geometry`, alpha and beta carried in float64 (alpha is kept in
float64 for the backward, ll too); for a CPU tensor it takes
`ctc_ll_plain`, a Python loop over T differentiated by autograd.
"""

from __future__ import annotations

import torch

from emoasr_tpu_torch.ops.common import LOG_0, logaddexp3
from emoasr_tpu_torch.ops.cuda_lib import I, L, P, CudaKernel

KERNEL = CudaKernel(
    "ctc_lattice.cu",
    {
        "emo_ctc_alpha_f32": [P] * 8 + [I, I, I, L, L, I, I, P],
        "emo_ctc_beta_grad_f32": [P] * 8 + [I, I, I, L, L, I, I, P],
    },
)

# the most states the kernels took when two rows of S floats lived in a
# block's 48 KB of shared memory; kept as the limit
MAX_S = (48 * 1024 // 4 - 32) // 2

# mirrored from csrc/ctc_lattice.cu
MAX_SPL = 8         # states a thread
FILL_WARPS = 2      # the backward's warps beside the chain
CHAIN_WARPS = 30    # the most warps a chain takes, where the launch bounds allow it


def depth(spl: int) -> int:
    """Steps whose emissions a thread loads ahead of the chain."""
    return 8 if spl == 1 else 4 if spl == 2 else 2 if spl <= 4 else 1


def max_threads(spl: int) -> int:
    """The kernels' `__launch_bounds__` at `spl` states a thread."""
    return 640 if spl <= 2 else 832


def chain_cap(spl: int) -> int:
    """The most warps a chain of `spl` states a thread may take."""
    return min(CHAIN_WARPS, max_threads(spl) // 32 - FILL_WARPS)


def launch_geometry(S: int) -> dict:
    """How a block carries an utterance's S states: the fewest states a
    thread (`spl`) whose warps (`warps`, warps x 32 x spl >= S) fit
    `chain_cap`; the threads of the forward's block and of the backward's
    (the chain and FILL_WARPS more)."""
    if not 1 <= S <= MAX_S:
        raise ValueError(f"ctc lattice kernel: S={S} outside 1..{MAX_S}")
    spl = next((n for n in range(1, MAX_SPL + 1) if -(-S // (32 * n)) <= chain_cap(n)), None)
    if spl is None:
        raise ValueError(f"ctc lattice kernel: S={S} does not fit {chain_cap(MAX_SPL)} warps of {MAX_SPL} states")
    warps = -(-S // (32 * spl))
    return {"spl": spl, "warps": warps, "depth": depth(spl), "alpha_threads": 32 * warps,
            "beta_threads": 32 * (warps + FILL_WARPS)}


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
        dev = lp_path.device
        # the kernels carry alpha and beta in float64; ll also in float64 for the backward
        alpha = torch.empty((T, B, S), dtype=torch.float64, device=dev)
        ll = torch.empty((B,), dtype=torch.float32, device=dev)
        ll64 = torch.empty((B,), dtype=torch.float64, device=dev)
        geo = launch_geometry(S)
        with torch.cuda.device(dev):
            stream = torch.cuda.current_stream(dev).cuda_stream
            KERNEL.launch(
                "emo_ctc_alpha_f32", lp_path.data_ptr(), allow2f.data_ptr(), initf.data_ptr(),
                finalf.data_ptr(), xlens32.data_ptr(), alpha.data_ptr(), ll.data_ptr(), ll64.data_ptr(),
                T, B, S, lp_path.stride(0), lp_path.stride(1), geo["spl"], geo["warps"], stream,
            )
        ctx.save_for_backward(lp_path, allow2f, finalf, xlens32, alpha, ll64)
        return ll

    @staticmethod
    def backward(ctx, g):
        lp_path, allow2f, finalf, xlens32, alpha, ll64 = ctx.saved_tensors
        T, B, S = lp_path.shape
        g = g.to(torch.float32).contiguous()
        grad = torch.empty_strided(lp_path.shape, lp_path.stride(), dtype=torch.float32,
                                   device=lp_path.device)
        geo = launch_geometry(S)
        with torch.cuda.device(lp_path.device):
            stream = torch.cuda.current_stream(lp_path.device).cuda_stream
            KERNEL.launch(
                "emo_ctc_beta_grad_f32", lp_path.data_ptr(), allow2f.data_ptr(),
                finalf.data_ptr(), xlens32.data_ptr(), alpha.data_ptr(), ll64.data_ptr(),
                g.data_ptr(), grad.data_ptr(), T, B, S, lp_path.stride(0), lp_path.stride(1),
                geo["spl"], geo["warps"], stream,
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
        raise ValueError(f"ctc lattice kernel: S={S} is above the kernel's limit {MAX_S}")
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
