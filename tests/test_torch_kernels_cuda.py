"""The port's CUDA kernels against their plain PyTorch versions, on the card.

These tests need an NVIDIA GPU with nvcc; elsewhere they skip.  On the
card, run them without the JAX test configuration:

    python -m pytest --noconftest -m cuda tests/test_torch_kernels_cuda.py

The cases and tolerances are those of `chip_smoke.py` (top-k exact;
attention forward f32 within 1e-5, bf16 within 2e-2; attention backward,
CTC head and CTC lattice: the constants beside their checks there).
"""

import pytest
import torch

import chip_smoke

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda_dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (kernels have no CPU mode)")
    from emoasr_tpu_torch.utils.device import set_matmul_precision

    set_matmul_precision("float32")
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    return torch.device("cuda", 0), gen


def test_topk_kernel_matches_plain(cuda_dev):
    from emoasr_tpu_torch.ops import topk

    before = topk.KERNEL.launches
    chip_smoke.check_topk(*cuda_dev)
    assert topk.KERNEL.launches - before == len(chip_smoke.topk_cases(*cuda_dev))


def test_attention_kernel_matches_plain(cuda_dev):
    from emoasr_tpu_torch.ops import attention

    before = attention.KERNEL.launches
    chip_smoke.check_attention(*cuda_dev)
    assert attention.KERNEL.launches - before == len(chip_smoke.attention_cases(*cuda_dev))


def test_attention_kernel_rejects_training_options(cuda_dev):
    """Only the score bias is refused now; dropout runs in the kernel."""
    from emoasr_tpu_torch.ops.attention import fused_self_attention

    dev, _ = cuda_dev
    q = torch.randn(1, 8, 2, 16, device=dev)
    lens = torch.tensor([8], device=dev)
    out = fused_self_attention(q, q, q, lens, scale=0.25, dropout_rate=0.1, deterministic=False, seed=1)
    assert out.shape == q.shape and torch.isfinite(out).all()
    with pytest.raises(NotImplementedError):
        fused_self_attention(q, q, q, lens, scale=0.25, bias=torch.zeros(1, 2, 8, 8, device=dev))
    with pytest.raises(TypeError):  # the backward takes float32 only
        qb = q.bfloat16().requires_grad_(True)
        fused_self_attention(qb, qb, qb, lens, scale=0.25)


def test_attention_backward_and_dropout_match_plain(cuda_dev):
    from emoasr_tpu_torch.ops import attention

    before = attention.KERNEL.counts["emo_attention_bwd_f32"]
    chip_smoke.check_attention_backward(*cuda_dev)
    assert attention.KERNEL.counts["emo_attention_bwd_f32"] - before == 5


def test_ctc_lattice_kernels_match_plain(cuda_dev):
    from emoasr_tpu_torch.ops import ctc_lattice

    before = dict(ctc_lattice.KERNEL.counts)
    chip_smoke.check_ctc_lattice(*cuda_dev)
    assert ctc_lattice.KERNEL.counts["emo_ctc_alpha_f32"] - before["emo_ctc_alpha_f32"] == 3
    assert ctc_lattice.KERNEL.counts["emo_ctc_beta_grad_f32"] - before["emo_ctc_beta_grad_f32"] == 3


def test_ctc_head_kernels_match_plain(cuda_dev):
    from emoasr_tpu_torch.ops import ctc_head

    before = dict(ctc_head.KERNEL.counts)
    chip_smoke.check_ctc_head(*cuda_dev)
    for name in ("emo_ctc_head_fwd_f32", "emo_ctc_head_grad_e_f32", "emo_ctc_head_grad_w_f32"):
        assert ctc_head.KERNEL.counts[name] - before[name] == 8  # four cases, two cotangents each


def test_new_kernels_reject_what_they_do_not_take(cuda_dev):
    from emoasr_tpu_torch.ops.ctc_head import fused_ctc_head
    from emoasr_tpu_torch.ops.ctc_lattice import ctc_ll_from_path

    dev, _ = cuda_dev
    e, w, b = torch.zeros(1, 4, 8, device=dev), torch.zeros(8, 5, device=dev), torch.zeros(5, device=dev)
    z = torch.zeros(1, 3, dtype=torch.int64, device=dev)
    with pytest.raises(TypeError):
        fused_ctc_head(e.bfloat16(), w.bfloat16(), b.bfloat16(), z)
    with pytest.raises(ValueError):
        fused_ctc_head(torch.zeros(1, 4, 512, device=dev), torch.zeros(512, 5, device=dev), b, z)
    lp = torch.zeros(4, 1, 3, device=dev)
    m = torch.ones(1, 3, device=dev)
    with pytest.raises(TypeError):
        ctc_ll_from_path(lp.double(), m, m, m, torch.tensor([4], device=dev))
    with pytest.raises(ValueError):
        ctc_ll_from_path(lp[:, :, ::2], m[:, ::2], m[:, ::2], m[:, ::2], torch.tensor([4], device=dev))
