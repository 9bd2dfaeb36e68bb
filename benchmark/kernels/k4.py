"""K4, the fused masked self-attention (`csrc/attention.cu`): operations
and bytes of one launch from its shapes and the real lengths.

Counted over real queries and real keys only (padded rows are not work
that the result needs), float32 operands (4 bytes).  Forward: Q K^T and
P V, 4 H L^2 D a row of L frames; reads q, k, v (and the score bias),
writes the output.  Backward: dV = P^T dO, dP = dO V^T, dQ = dS K,
dK = dS^T Q, 8 H L^2 D (the recomputed scores are not counted); reads q,
k, v, dO (and the bias), writes dq, dk, dv (and d bias)."""

from typing import Sequence, Tuple

# the device functions of attention.cu (its helper `split_kernel` is a
# template, which tells it from the CTC head's)
NAMES = [r"tc::fwd_kernel<", r"tc::bwd_dq_kernel<", r"tc::bwd_dkv_kernel<", r"tc::fwd_f32_split_kernel<",
         r"tc::fwd_f32_kernel<", r"tc::bwd_dq_f32_kernel<", r"tc::bwd_dkv_f32_kernel<", r"tc::split_kernel<"]
LAUNCHERS = ("emo_attention_fwd_f32", "emo_attention_bwd_f32", "emo_attention_fwd_bf16", "emo_attention_bwd_bf16")


def fwd(lens: Sequence[int], H: int, D: int, bias: bool, elem: int = 4) -> Tuple[float, float]:
    ops = sum(4.0 * H * L * L * D for L in lens)
    nbytes = sum(4.0 * L * H * D * elem + (H * L * L * elem if bias else 0) for L in lens) + 4 * len(lens)
    return ops, nbytes


def bwd(lens: Sequence[int], H: int, D: int, bias: bool, elem: int = 4) -> Tuple[float, float]:
    ops = sum(8.0 * H * L * L * D for L in lens)
    nbytes = sum(7.0 * L * H * D * elem + (2 * H * L * L * elem if bias else 0) for L in lens) + 4 * len(lens)
    return ops, nbytes
