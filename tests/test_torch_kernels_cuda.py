"""The port's CUDA kernels against their plain PyTorch versions, on the card.

These tests need an NVIDIA GPU with nvcc; elsewhere they skip.  On the
card, run them without the JAX test configuration:

    python -m pytest --noconftest -m cuda tests/test_torch_kernels_cuda.py

The cases and tolerances are those of `chip_smoke.py` (top-k exact, every
case twice, bit-identical, make_label's (N, V) k = 8 class also through
its temperature softmax against the CPU within 1e-6; the CTC lattice within LATTICE_TOL, every case
twice, bit-identical;
attention forward f32 within 1e-5, bf16 within 2e-2, with and without the
score bias, and both dtypes' launchers at the edge cases of their tiling
(`k4_edge_cases`: the f32 ones forward and backward, bias none, f32 and
bf16, dropout 0, 0.1 and 0.3), each launched twice with bit-identical
outputs; one dropout map for both dtypes; attention backward, CTC head, CTC lattice, the decoder layer
step, the LM layer step, the RNN-T joint and the LSTM recurrence forward
and backward: the constants beside their checks there; the bf16 parts of
the attention backward, the CTC head (and the head at H > 256) and the
LSTM: one bf16 step, `BF16_STEP`, beside `_require_close_bf16`;
the decoder and LM layer steps in bf16: one bf16 step of each entry plus
one of the largest, beside `check_decoder_step`; the RNN-T joint in both
dtypes, at every width and at the edges of its tiling (`check_rnnt_joint_
edges`), each launched twice with bit-identical outputs: RNNT_JOINT_TOL;
the LSTM above H = 512: the tolerances of its narrower check, beside
`check_lstm_wide`; every LSTM case twice, bit-identical, the RNN LM's
three bucket shapes included, and the RNN LM's layers through it against
the CPU's plain scan; the beam steps
at W = 17 and 33, each launched twice (bit-identical), rows 0-15 of W = 20
equal to W = 16 bit for bit, and their launch geometry against the
libraries' and the card's own accounts; K4 at the phone encoder's
largest bucket in both dtypes, forward and backward with dropout, twice
and bit-identical, and the phone-to-word pseudo-log-likelihood on the card
against the CPU: beside `check_attention_phone` and PPL_RTOL).
"""

import numpy as np
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
    # every case twice (bit-identical)
    assert topk.KERNEL.launches - before == 2 * len(chip_smoke.topk_cases(*cuda_dev))


@pytest.mark.parametrize("N,V", [(1, 10000), (128, 10000), (1423, 10000), (4096, 10000), (1390, 1000)])
def test_topk_at_the_make_label_class_matches_plain(cuda_dev, N, V):
    """K3 at make_label's class, (N, V) LM logits with k = 8, as
    `eval/make_label.py::_topk_temp` launches it: the ids equal the plain
    version's on the CPU exactly, the temperature softmax of the 8 values
    within 1e-6; one launch a call, twice bit-identical."""
    from emoasr_tpu_torch.eval.make_label import _topk_temp
    from emoasr_tpu_torch.ops import topk

    dev, gen = cuda_dev
    x = 3 * torch.randn(N, V, generator=gen, device=dev)
    before = topk.KERNEL.launches
    got, again = _topk_temp(x, 8, 3.0), _topk_temp(x, 8, 3.0)
    assert topk.KERNEL.launches - before == 2
    want = _topk_temp(x.cpu(), 8, 3.0)
    assert got.shape == (N, 2, 8) and np.array_equal(got, again)
    np.testing.assert_array_equal(got[:, 0], want[:, 0])
    np.testing.assert_allclose(got[:, 1], want[:, 1], rtol=0, atol=1e-6)
    np.testing.assert_allclose(got[:, 1].sum(-1), 1.0, rtol=0, atol=1e-6)


def test_topk_kernel_refuses_what_it_cannot_take(cuda_dev):
    """k above 32 or V, V above MAX_V, other dtypes, a strided row: raised
    by the wrapper; a geometry the source cannot take: refused by the
    launcher, never launched."""
    from emoasr_tpu_torch.ops import topk

    dev, _ = cuda_dev
    x = torch.randn(2, 300, device=dev)
    for bad in ((x, 33), (x[:, :20], 21), (x.half(), 4), (x[:, ::2], 4),
                (torch.randn(1, topk.MAX_V + 1, device=dev), 4)):
        with pytest.raises((ValueError, TypeError)):
            topk.topk_lastdim_kernel(*bad)
    vals, idx = torch.empty(2, 4, device=dev), torch.empty(2, 4, dtype=torch.int32, device=dev)
    stream = torch.cuda.current_stream().cuda_stream
    for parts, wpt in ((16, 1), (1, 9), (1, 0)):
        with pytest.raises(RuntimeError):
            topk.KERNEL.launch("emo_topk_f32", x.data_ptr(), vals.data_ptr(), idx.data_ptr(), 2, 300, 4, parts, wpt,
                               stream)
    with pytest.raises(RuntimeError):  # bf16 takes at most 4 words a thread
        topk.KERNEL.launch("emo_topk_bf16", x.bfloat16().data_ptr(), vals.data_ptr(), idx.data_ptr(), 2, 300, 4, 1, 5,
                           stream)


def test_attention_kernel_matches_plain(cuda_dev):
    from emoasr_tpu_torch.ops import attention

    before = attention.KERNEL.launches
    chip_smoke.check_attention(*cuda_dev)
    # the cases once, and the edge cases of both dtypes twice each (bit-identical)
    edges = sum(len(chip_smoke.k4_edge_cases(cuda_dev[0], dt)) for dt in (torch.float32, torch.bfloat16))
    assert attention.KERNEL.launches - before == len(chip_smoke.attention_cases(*cuda_dev)) + 2 * edges


def test_attention_kernel_rejects_training_options(cuda_dev):
    """Dropout and the score bias run in the kernel (a zero bias changes
    nothing, a bias of another shape or dtype is refused); a bfloat16
    backward runs in the kernel and matches `attention_bwd_plain` (one bf16
    step of each entry, plus one of the largest)."""
    from emoasr_tpu_torch.ops.attention import attention_bwd_plain, fused_self_attention

    dev, _ = cuda_dev
    q = torch.randn(1, 8, 2, 16, device=dev)
    lens = torch.tensor([8], device=dev)
    out = fused_self_attention(q, q, q, lens, scale=0.25, dropout_rate=0.1, deterministic=False, seed=1)
    assert out.shape == q.shape and torch.isfinite(out).all()
    plain = fused_self_attention(q, q, q, lens, scale=0.25)
    biased = fused_self_attention(q, q, q, lens, scale=0.25, bias=torch.zeros(1, 2, 8, 8, device=dev))
    assert torch.equal(biased, plain)
    with pytest.raises(ValueError):
        fused_self_attention(q, q, q, lens, scale=0.25, bias=torch.zeros(1, 2, 8, 7, device=dev))
    with pytest.raises(TypeError):
        fused_self_attention(q, q, q, lens, scale=0.25, bias=torch.zeros(1, 2, 8, 8, device=dev).half())
    qkv = [torch.randn_like(q).bfloat16() for _ in range(3)]
    ins = [x.clone().requires_grad_(True) for x in qkv]
    d_out = torch.randn_like(qkv[0])
    got = torch.autograd.grad(fused_self_attention(*ins, lens, scale=0.25), ins, d_out)
    want = attention_bwd_plain(*qkv, d_out, lens, 0.25)
    for name, a, b in zip(("dq", "dk", "dv"), got, want):
        assert a.dtype == torch.bfloat16
        chip_smoke._require_close_bf16(f"attention bf16 {name}", a, b)


def test_attention_bias_matches_plain(cuda_dev):
    from emoasr_tpu_torch.ops import attention

    before = dict(attention.KERNEL.counts)
    chip_smoke.check_attention_bias(*cuda_dev)
    used = {k: attention.KERNEL.counts[k] - before[k] for k in before}
    # three shapes: one forward per dtype, and a forward + backward with and without dropout;
    # then the edge cases, bias f32 and bf16, three dropout rates, twice each: the f32
    # launchers forward and backward, the bf16 ones forward
    edges = len(chip_smoke.k4_edge_cases(cuda_dev[0]))
    edges32 = len(chip_smoke.k4_edge_cases(cuda_dev[0], torch.float32))
    assert used["emo_attention_fwd_f32"] == 9 + 2 * 2 * 3 * edges32
    assert used["emo_attention_fwd_bf16"] == 3 + 2 * 2 * 3 * edges
    assert used["emo_attention_bwd_f32"] == 6 + 2 * 2 * 3 * edges32


def test_decoder_step_kernels_match_plain(cuda_dev):
    from emoasr_tpu_torch.ops import decoder_step

    before = (decoder_step.KERNEL.launches, decoder_step.KERNEL_INDIRECT.launches)
    chip_smoke.check_decoder_step(*cuda_dev)
    # W up to 33: direct (twice, bit-identical), and direct on gathered caches; indirect twice
    n = len(chip_smoke.dec_step_cases(torch.float32))
    assert decoder_step.KERNEL.launches - before[0] == 3 * n
    assert decoder_step.KERNEL_INDIRECT.launches - before[1] == 2 * n


def test_beam_rows_do_not_depend_on_their_group(cuda_dev):
    """K5 (both variants) and K6 at W = 20, groups of 16 and 4: beams 0-15
    equal a W = 16 launch bit for bit, in both dtypes."""
    for dtype in (torch.float32, torch.bfloat16):
        chip_smoke.check_beam_groups(*cuda_dev, dtype)


def test_beam_step_geometry_matches_the_kernels(cuda_dev):
    """K5's and K6's shared memory as `decoder_step.smem_bytes` accounts it
    equals the libraries' own (`emo_*_smem_bytes`, their `Layout`s) for
    every row group at the shipped shapes, narrow ones and an encoder output
    longer than the cross-attention's window, in both dtypes;
    and the card keeps every cluster of the launches that
    `device_geometry` plans for the L3 buckets at once."""
    from emoasr_tpu_torch.ops import decoder_step as ds
    from emoasr_tpu_torch.ops import lm_step

    dev = cuda_dev[0]
    for es in (4, 2):
        for group in ds.GROUP_WIDTHS:
            for D, F, H, L, T in ((256, 2048, 4, 258, 399), (64, 96, 2, 9, 50), (128, 256, 8, 16, 21),
                                  (256, 2048, 4, 258, 1100), (100, 100, 5, 9, 30)):
                assert ds.smem_bytes("decoder", group, D, F, H, L, T, es) == \
                    ds.KERNEL_INDIRECT.lib().emo_decoder_step_smem_bytes(group, L, T, D, F, H, es)
            for D, F, L in ((512, 2048, 256), (64, 96, 9)):
                assert ds.smem_bytes("lm", group, D, F, 8, L, 1, es) == lm_step.KERNEL.lib().emo_lm_step_smem_bytes(
                    group, L, D, F, es)
    for dtype in (torch.float32, torch.bfloat16):
        es = torch.tensor([], dtype=dtype).element_size()
        for Bu, W in ((18, 10), (18, 17), (18, 33), (50, 17)):
            for kernel in (ds.KERNEL, ds.KERNEL_INDIRECT):
                g = ds.device_geometry(kernel, "decoder", Bu, W, 256, 2048, 4, 258, 399, dtype, dev, "test")
                assert kernel.lib().emo_decoder_step_max_clusters(
                    g["group"], g["cluster"], 258, 399, 256, 2048, 4, es) >= g["groups"] or g["cluster"] == 1
            g = ds.device_geometry(lm_step.KERNEL, "lm", Bu, W, 512, 2048, 8, 256, 1, dtype, dev, "test")
            assert lm_step.KERNEL.lib().emo_lm_step_max_clusters(
                g["group"], g["cluster"], 256, 512, 2048, es) >= g["groups"] or g["cluster"] == 1


def test_decoder_step_rejects_what_it_does_not_take(cuda_dev):
    """float32 or bfloat16, all of one dtype: a bf16 step matches the plain
    version (one bf16 step of each entry + one of the largest); float16
    and mixed dtypes are refused, as are shapes that do not fit."""
    from emoasr_tpu_torch.ops import decoder_step as ds

    dev, gen = cuda_dev
    c = chip_smoke.decoder_step_case(dev, gen, 2, 3, 6, 9, 2, 32, 64)
    args = lambda c, **over: {**dict(
        h=c["h"], cache_k=c["cache_k"].reshape(6, 6, 2, 16), cache_v=c["cache_v"].reshape(6, 6, 2, 16),
        pos=c["pos"].reshape(-1), cross_k=c["cross_k"], cross_v=c["cross_v"], elens=c["elens"],
        weights=c["weights"]), **over}
    y, k_new, v_new = ds.fused_decoder_layer_step(**args(c), beam_width=3)
    assert y.shape == (6, 32) and k_new.shape == v_new.shape == (6, 2, 16)
    c16 = chip_smoke._cast_case(c, torch.bfloat16)
    got = ds.fused_decoder_layer_step(**args(c16), beam_width=3)
    want = ds.decoder_layer_step_plain(**args(c16), beam_width=3)
    for name, a, b in zip(("y", "k_new", "v_new"), got, want):
        assert a.dtype == torch.bfloat16
        chip_smoke._require_close_bf16(f"decoder step bf16 {name}", a, b)
    with pytest.raises(TypeError):  # float16
        ds.fused_decoder_layer_step(**args(chip_smoke._cast_case(c, torch.float16)), beam_width=3)
    with pytest.raises(TypeError):  # bf16 activations, f32 weights
        ds.fused_decoder_layer_step(**args(c16, weights=c["weights"]), beam_width=3)
    with pytest.raises(ValueError):  # rows do not split into beams of 4
        ds.fused_decoder_layer_step(**args(c), beam_width=4)
    with pytest.raises(ValueError):  # a strided cache
        ds.fused_decoder_layer_step(**args(c, cache_k=c["cache_k"].reshape(6, 6, 2, 16).transpose(1, 2)), beam_width=3)
    # W = 17 (two row groups) and a layer too wide for a group of 16 in
    # shared memory (groups of 4), which both raised before: now their plain
    # versions' results
    for W, shape in ((17, (1, 17, 4, 5, 2, 32, 64)), (16, (1, 16, 4, 5, 4, 512, 4096))):
        c = chip_smoke.decoder_step_case(dev, gen, *shape)
        ins = (c["h"], c["cache_k"], c["cache_v"], c["pos"], c["anc"], c["cross_k"], c["cross_v"], c["elens"],
               c["weights"])
        got = ds.fused_decoder_layer_step_indirect(*ins, beam_width=W)
        want = ds.decoder_layer_step_indirect_plain(*ins, W)
        for name, a, b in zip(("y", "k_new", "v_new"), got, want):
            chip_smoke._require_close(f"decoder step W={W} {shape} {name}", a, b, chip_smoke.DEC_STEP_TOL, 0.0)
    huge = chip_smoke.decoder_step_case(dev, gen, 1, 4, 4, 5, 4, 512, 16384)
    with pytest.raises(ValueError, match="shared memory"):  # (4, F) f32 alone is 256 KB
        ds.fused_decoder_layer_step_indirect(
            huge["h"], huge["cache_k"], huge["cache_v"], huge["pos"], huge["anc"], huge["cross_k"],
            huge["cross_v"], huge["elens"], huge["weights"], beam_width=4)


def test_decoder_step_bf16_kernels_match_plain(cuda_dev):
    from emoasr_tpu_torch.ops import decoder_step

    before = (dict(decoder_step.KERNEL.counts), dict(decoder_step.KERNEL_INDIRECT.counts))
    chip_smoke.check_decoder_step(*cuda_dev, torch.bfloat16)
    n = len(chip_smoke.dec_step_cases(torch.bfloat16))
    assert decoder_step.KERNEL.counts["emo_decoder_step_bf16"] - before[0]["emo_decoder_step_bf16"] == 3 * n
    assert (decoder_step.KERNEL_INDIRECT.counts["emo_decoder_step_indirect_bf16"]
            - before[1]["emo_decoder_step_indirect_bf16"]) == 2 * n
    assert decoder_step.KERNEL.counts["emo_decoder_step_f32"] == before[0]["emo_decoder_step_f32"]


def test_lm_step_kernel_matches_plain(cuda_dev):
    from emoasr_tpu_torch.ops import lm_step

    before = lm_step.KERNEL.launches
    chip_smoke.check_lm_step(*cuda_dev)
    # W up to 33: the step (twice, bit-identical), and the step on gathered caches
    assert lm_step.KERNEL.launches - before == 3 * len(chip_smoke.lm_step_cases(torch.float32))


def test_lm_step_rejects_what_it_does_not_take(cuda_dev):
    """float32 or bfloat16, all of one dtype: a bf16 step matches the plain
    version; float16 and mixed dtypes are refused, as are shapes that do
    not fit."""
    from emoasr_tpu_torch.ops import lm_step

    dev, gen = cuda_dev
    c = chip_smoke.lm_step_case(dev, gen, 2, 3, 6, 2, 32, 64)
    args = lambda c, **over: {**dict(h=c["h"], cache_k=c["cache_k"], cache_v=c["cache_v"], pos=c["pos"],
                                     anc=c["anc"], weights=c["weights"]), **over}
    y, k_new, v_new = lm_step.fused_bert_layer_step_indirect(**args(c))
    assert y.shape == (2, 3, 32) and k_new.shape == v_new.shape == (2, 3, 2, 16)
    c16 = chip_smoke._cast_case(c, torch.bfloat16)
    got = lm_step.fused_bert_layer_step_indirect(**args(c16))
    want = lm_step.bert_layer_step_indirect_plain(**args(c16))
    for name, a, b in zip(("y", "k_new", "v_new"), got, want):
        assert a.dtype == torch.bfloat16
        chip_smoke._require_close_bf16(f"LM step bf16 {name}", a, b)
    with pytest.raises(TypeError):  # float16
        lm_step.fused_bert_layer_step_indirect(**args(chip_smoke._cast_case(c, torch.float16)))
    with pytest.raises(TypeError):  # f32 activations, bf16 weights
        lm_step.fused_bert_layer_step_indirect(**args(c, weights=c16["weights"]))
    with pytest.raises(ValueError):  # an ancestor table of the wrong length
        lm_step.fused_bert_layer_step_indirect(**args(c, anc=c["anc"][:, :, :5]))
    with pytest.raises(ValueError):  # a strided cache
        lm_step.fused_bert_layer_step_indirect(**args(c, cache_k=c["cache_k"].transpose(2, 3).contiguous().transpose(2, 3)))
    # W = 17 (two row groups) and a layer too wide for a group of 16 in
    # shared memory (groups of 4), which both raised before: now their plain
    # versions' results
    for shape in ((1, 17, 4, 2, 32, 64), (1, 16, 4, 8, 512, 4096)):
        c = chip_smoke.lm_step_case(dev, gen, *shape)
        ins = (c["h"], c["cache_k"], c["cache_v"], c["pos"], c["anc"], c["weights"])
        for name, a, b in zip(("y", "k_new", "v_new"), lm_step.fused_bert_layer_step_indirect(*ins),
                              lm_step.bert_layer_step_indirect_plain(*ins)):
            chip_smoke._require_close(f"LM step {shape} {name}", a, b, chip_smoke.LM_STEP_TOL, 0.0)
    huge = chip_smoke.lm_step_case(dev, gen, 1, 4, 4, 8, 512, 16384)
    with pytest.raises(ValueError, match="shared memory"):  # (4, F) f32 alone is 256 KB
        lm_step.fused_bert_layer_step_indirect(huge["h"], huge["cache_k"], huge["cache_v"], huge["pos"],
                                               huge["anc"], huge["weights"])


def test_lm_step_bf16_kernel_matches_plain(cuda_dev):
    from emoasr_tpu_torch.ops import lm_step

    before = dict(lm_step.KERNEL.counts)
    chip_smoke.check_lm_step(*cuda_dev, torch.bfloat16)
    n = len(chip_smoke.lm_step_cases(torch.bfloat16))
    assert lm_step.KERNEL.counts["emo_lm_step_indirect_bf16"] - before["emo_lm_step_indirect_bf16"] == 3 * n
    assert lm_step.KERNEL.counts["emo_lm_step_indirect_f32"] == before["emo_lm_step_indirect_f32"]


def test_attention_backward_and_dropout_match_plain(cuda_dev):
    from emoasr_tpu_torch.ops import attention

    before = attention.KERNEL.counts["emo_attention_bwd_f32"]
    chip_smoke.check_attention_backward(*cuda_dev)
    # five shapes, then the f32 edge cases at three dropout rates, twice each
    edges32 = len(chip_smoke.k4_edge_cases(cuda_dev[0], torch.float32))
    assert attention.KERNEL.counts["emo_attention_bwd_f32"] - before == 5 + 2 * 3 * edges32


def test_dropout_keep_mask_is_one_map_for_both_dtypes(cuda_dev):
    """`dropout_keep_mask` gives one map whatever the dtype, and the f32
    and bf16 launchers drop the same elements for one seed: their outputs
    agree within the bf16 forward's tolerance (two maps would differ by
    O(1))."""
    from emoasr_tpu_torch.ops.attention import dropout_keep_mask, fused_self_attention

    dev, gen = cuda_dev
    for B, T, H in ((2, 37, 3), (18, 399, 4)):
        assert torch.equal(dropout_keep_mask(B, T, H, 0.3, 11, dev), dropout_keep_mask(B, T, H, 0.3, 11, dev,
                                                                                        torch.bfloat16))
    q, k, v = (torch.randn(2, 70, 3, 64, generator=gen, device=dev) for _ in range(3))
    lens = torch.tensor([70, 41], device=dev)
    outs = [fused_self_attention(q.to(dt), k.to(dt), v.to(dt), lens, scale=0.125, dropout_rate=0.3,
                                 deterministic=False, seed=11).float() for dt in (torch.float32, torch.bfloat16)]
    assert (outs[0] - outs[1]).abs().max().item() <= chip_smoke.ATTN_TOL[torch.bfloat16]


def test_attention_geometry_matches_the_kernel(cuda_dev):
    """The f32 launchers' shared memory as `ops/attention.py` accounts it
    equals the library's own (`emo_attention_smem_bytes`) in both instances,
    every kind, with and without the bias; the backward at D <= 64 refuses
    to run without its scratch."""
    from emoasr_tpu_torch.ops import attention

    lib = attention.KERNEL.lib()
    for D in (1, 3, 8, 20, 40, 64, 65, 100, 128):
        for with_bias in (False, True):
            for kind_i, kind in enumerate(attention.KINDS):
                assert (lib.emo_attention_smem_bytes(kind_i, D, int(with_bias))
                        == attention.smem_bytes(kind, D, with_bias)), (D, with_bias, kind)
    dev, _ = cuda_dev
    x = torch.zeros(1, 8, 1, 16, device=dev)
    stats = torch.zeros(1, 1, 8, device=dev)
    lens = torch.tensor([8], device=dev, dtype=torch.int32)
    with pytest.raises(RuntimeError):  # no scratch for the planes
        attention.KERNEL.launch("emo_attention_bwd_f32", *[x.data_ptr()] * 5, lens.data_ptr(), stats.data_ptr(),
                                *[x.clone().data_ptr() for _ in range(3)], stats.clone().data_ptr(), None, None, 0,
                                None, 1, 8, 1, 16, 0.25, 0, 0, 0, 1.0, 1, 0, torch.cuda.current_stream().cuda_stream)


def test_ctc_lattice_kernels_match_plain(cuda_dev):
    from emoasr_tpu_torch.ops import ctc_lattice

    before = dict(ctc_lattice.KERNEL.counts)
    chip_smoke.check_ctc_lattice(*cuda_dev)
    n = 2 * len(chip_smoke.lattice_cases())  # every case twice (bit-identical)
    assert ctc_lattice.KERNEL.counts["emo_ctc_alpha_f32"] - before["emo_ctc_alpha_f32"] == n
    assert ctc_lattice.KERNEL.counts["emo_ctc_beta_grad_f32"] - before["emo_ctc_beta_grad_f32"] == n


def test_ctc_lattice_launcher_refuses_a_geometry_it_cannot_take(cuda_dev):
    """States a thread outside 1..8, too few warps for S, or more threads
    than the launch bounds: refused, never launched; and the latency-floor
    variant `chip_smoke.py` times builds from this tree's source."""
    from emoasr_tpu_torch.ops import ctc_lattice

    dev, _ = cuda_dev
    T, B, S = 4, 1, 257
    lp, m = torch.zeros(T, B, S, device=dev), torch.ones(B, S, device=dev)
    xl = torch.full((B,), T, dtype=torch.int32, device=dev)
    alpha, ll = torch.empty(T, B, S, dtype=torch.float64, device=dev), torch.empty(B, device=dev)
    ll64 = torch.empty(B, dtype=torch.float64, device=dev)
    stream = torch.cuda.current_stream().cuda_stream
    for spl, warps in ((9, 1), (0, 9), (2, 4), (3, 27), (8, 31)):
        with pytest.raises(RuntimeError):
            ctc_lattice.KERNEL.launch("emo_ctc_alpha_f32", lp.data_ptr(), m.data_ptr(), m.data_ptr(), m.data_ptr(),
                                      xl.data_ptr(), alpha.data_ptr(), ll.data_ptr(), ll64.data_ptr(), T, B, S,
                                      B * S, S, spl, warps, stream)
    floor = chip_smoke.lattice_floor_kernel()
    floor.lib()


def test_ctc_head_kernels_match_plain(cuda_dev):
    from emoasr_tpu_torch.ops import ctc_head

    before = dict(ctc_head.KERNEL.counts)
    chip_smoke.check_ctc_head(*cuda_dev)
    sweep = len(chip_smoke.HEAD_SWEEP_V) * len(chip_smoke.HEAD_SWEEP_H)
    for name in ("emo_ctc_head_fwd_f32", "emo_ctc_head_grad_e_f32", "emo_ctc_head_grad_w_f32"):
        # four cases and the V x H sweep, two cotangents each, two launches each
        assert ctc_head.KERNEL.counts[name] - before[name] == (4 + sweep) * 2 * 2


def test_new_kernels_reject_what_they_do_not_take(cuda_dev):
    """The CTC head takes bf16 and any H (it matches its plain version
    there, `test_ctc_head_bf16_and_wide_match_plain`), but not float16 nor
    mixed dtypes; the lattice takes float32 and a contiguous lattice."""
    from emoasr_tpu_torch.ops.ctc_head import ctc_head_plain, fused_ctc_head
    from emoasr_tpu_torch.ops.ctc_lattice import ctc_ll_from_path

    dev, _ = cuda_dev
    e, w, b = torch.zeros(1, 4, 8, device=dev), torch.zeros(8, 5, device=dev), torch.zeros(5, device=dev)
    z = torch.zeros(1, 3, dtype=torch.int64, device=dev)
    with pytest.raises(TypeError):
        fused_ctc_head(e.half(), w.half(), b.half(), z)
    with pytest.raises(TypeError):
        fused_ctc_head(e.bfloat16(), w, b, z)
    lse, xs = fused_ctc_head(e.bfloat16(), w.bfloat16(), b.bfloat16(), z)
    assert lse.dtype == xs.dtype == torch.float32
    wide = torch.randn(1, 4, 512, device=dev), torch.randn(512, 5, device=dev) / 512 ** 0.5
    for got, want in zip(fused_ctc_head(*wide, b, z), ctc_head_plain(*wide, b, z)):
        torch.testing.assert_close(got, want, rtol=0, atol=chip_smoke.HEAD_TOL[0] + 1e-4 * want.abs().max().item())
    lp = torch.zeros(4, 1, 3, device=dev)
    m = torch.ones(1, 3, device=dev)
    with pytest.raises(TypeError):
        ctc_ll_from_path(lp.double(), m, m, m, torch.tensor([4], device=dev))
    with pytest.raises(ValueError):
        ctc_ll_from_path(lp[:, :, ::2], m[:, ::2], m[:, ::2], m[:, ::2], torch.tensor([4], device=dev))


def test_rnnt_joint_kernel_matches_plain(cuda_dev):
    from emoasr_tpu_torch.ops import rnnt_joint

    before = rnnt_joint.KERNEL.launches
    chip_smoke.check_rnnt_joint(*cuda_dev)
    assert rnnt_joint.KERNEL.launches - before == 10  # five shapes, twice each


def test_lstm_kernels_match_plain(cuda_dev):
    from emoasr_tpu_torch.ops import lstm_scan

    before = dict(lstm_scan.KERNEL.counts)
    chip_smoke.check_lstm(*cuda_dev)
    for name in ("emo_lstm_fwd_f32", "emo_lstm_bwd_f32"):  # every shape twice (bit-identical)
        assert lstm_scan.KERNEL.counts[name] - before[name] == 2 * len(chip_smoke.LSTM_CASES)


def test_lstm_geometry_matches_the_kernel(cuda_dev):
    """`ops/lstm_scan.py::smem_bytes` (which `launch_geometry` sizes the
    launches by) equals the library's own account (`emo_lstm_smem_bytes`)
    for both kinds, both w_hh term counts and a range of B, H and stages."""
    from emoasr_tpu_torch.ops import lstm_scan

    lib = lstm_scan.KERNEL.lib()
    for B in (1, 16, 17, 18, 50):
        for H in (1, 40, 136, 512, 640, 1024):
            for w_terms in (1, 2):
                for stages in (1, 3, 8):
                    for kind, units in (("fwd", 4 if H <= 512 else 8), ("fwd", 8), ("bwd", 8)):
                        want = lstm_scan.smem_bytes(kind, B, H, units, stages, w_terms)
                        assert lib.emo_lstm_smem_bytes(int(kind == "bwd"), B, H, units, stages, w_terms) == want


def test_rnnt_kernels_reject_what_they_do_not_take(cuda_dev):
    """float32 or bfloat16 (K7 in bf16 matches its plain version,
    `test_rnnt_joint_bf16_matches_plain`; float16 is refused); K7 at
    J = 800 and K8 at H = 520, which they refused before, match their
    plain versions, and the widths the card cannot hold are refused (K7
    above J = 2794, K8 above H = 1024); the LSTM's short sequences (T < 8)
    take the scan, as in the JAX package."""
    from emoasr_tpu_torch.ops import lstm, lstm_scan
    from emoasr_tpu_torch.ops.rnnt import joint_gather_plain
    from emoasr_tpu_torch.ops.rnnt_joint import fused_joint_gather

    dev, gen = cuda_dev
    he, hd, w, b, lab = chip_smoke.rnnt_joint_case(dev, gen, 2, 5, 4, 32, 40)
    lpb, lpl = fused_joint_gather(he, hd, w.t(), b, lab)
    assert lpb.shape == (2, 5, 4) and lpl.shape == (2, 5, 3)
    with pytest.raises(TypeError):
        fused_joint_gather(he.half(), hd.half(), w.t().half(), b.half(), lab)
    lpb16, _ = fused_joint_gather(he.bfloat16(), hd.bfloat16(), w.t().bfloat16(), b.bfloat16(), lab)
    assert lpb16.dtype == torch.float32 and torch.isfinite(lpb16).all()
    wide = chip_smoke.rnnt_joint_case(dev, gen, 1, 2, 2, 800, 40)
    for got, want in zip(fused_joint_gather(wide[0], wide[1], wide[2].t(), wide[3], wide[4]),
                         joint_gather_plain(wide[0], wide[1], wide[2].t(), wide[3], wide[4])):
        chip_smoke._require_close("rnnt joint J=800", got, want, chip_smoke.RNNT_JOINT_TOL, 0.0)
    too_wide = chip_smoke.rnnt_joint_case(dev, gen, 1, 2, 2, 2800, 40)
    with pytest.raises(ValueError):
        fused_joint_gather(too_wide[0], too_wide[1], too_wide[2].t(), too_wide[3], too_wide[4])
    x_proj, w_hh, h0, c0, _ = chip_smoke.lstm_case(dev, gen, 2, 9, 16)
    with pytest.raises(TypeError):
        lstm_scan.lstm_scan_fused(x_proj.double(), w_hh.double(), h0.double(), c0.double())
    mid = chip_smoke.lstm_case(dev, gen, 2, 9, 520)
    ys, (hT, cT) = lstm_scan.lstm_scan_fused(*mid[:4])
    p_ys, p_h, p_c, _, _ = lstm_scan.lstm_fwd_plain(*mid[:4])
    for name, a, b in (("ys", ys, p_ys), ("h_T", hT, p_h), ("c_T", cT, p_c)):
        chip_smoke._require_close(f"lstm H=520 {name}", a, b, chip_smoke.LSTM_FWD_TOL, 0.0)
    big = chip_smoke.lstm_case(dev, gen, 2, 9, 1032)
    with pytest.raises(ValueError):
        lstm_scan.lstm_scan_fused(*big[:4])
    before = lstm_scan.KERNEL.launches
    lstm.lstm_scan(x_proj[:, :7], w_hh, h0, c0)
    assert lstm_scan.KERNEL.launches == before
    lstm.lstm_scan(x_proj, w_hh, h0, c0)
    assert lstm_scan.KERNEL.launches == before + 1


def test_rnnt_joint_wide_matches_plain(cuda_dev):
    """K7 at J = 1024, 1500 and 2048 (64, 32 and 16 cells a block), f32 and bf16."""
    from emoasr_tpu_torch.ops import rnnt_joint

    before = dict(rnnt_joint.KERNEL.counts)
    chip_smoke.check_rnnt_joint_wide(*cuda_dev)
    # three shapes in f32 and two in bf16, twice each
    assert rnnt_joint.KERNEL.counts["emo_rnnt_joint_f32"] - before["emo_rnnt_joint_f32"] == 6
    assert rnnt_joint.KERNEL.counts["emo_rnnt_joint_bf16"] - before["emo_rnnt_joint_bf16"] == 4


def test_lstm_wide_matches_plain(cuda_dev):
    """K8 at H = 1024 and 640 (eight units a block), forward and
    backward, f32 and bf16."""
    from emoasr_tpu_torch.ops import lstm_scan

    before = dict(lstm_scan.KERNEL.counts)
    chip_smoke.check_lstm_wide(*cuda_dev)
    for name in ("emo_lstm_fwd_f32", "emo_lstm_bwd_f32", "emo_lstm_fwd_bf16", "emo_lstm_bwd_bf16"):
        assert lstm_scan.KERNEL.counts[name] - before[name] == 2 * len(chip_smoke.LSTM_WIDE_CASES)


def test_lstm_at_the_rnn_lm_shapes_matches_plain(cuda_dev):
    """K8 at the RNN LM's buckets, (B, T, H) = (11, 256, 512), (23, 128,
    512) and (46, 64, 512), forward and backward, each twice
    (bit-identical), counted by shape."""
    from emoasr_tpu_torch.ops import lstm_scan

    before, shapes = dict(lstm_scan.KERNEL.counts), dict(lstm_scan.SHAPE_LAUNCHES)
    chip_smoke.check_lstm_cases(*cuda_dev, chip_smoke.LSTM_RNNLM_CASES, "RNN LM")
    for name in ("emo_lstm_fwd_f32", "emo_lstm_bwd_f32"):
        assert lstm_scan.KERNEL.counts[name] - before[name] == 2 * len(chip_smoke.LSTM_RNNLM_CASES)
    for (B, T, H), _ in chip_smoke.LSTM_RNNLM_CASES:
        for kind in ("fwd", "bwd"):
            key = (kind, B, T, H, "f32")
            assert lstm_scan.SHAPE_LAUNCHES[key] - shapes.get(key, 0) == 2


def test_rnn_lm_runs_its_layers_through_the_lstm_kernel(cuda_dev):
    """The RNN LM's two-layer LSTM (`ops/lstm.py::MultiLayerLSTM`) on the
    card: one K8 launch a layer forward and backward for T >= 8, none for
    the one-token `predict`; logits, states and gradients as the CPU's
    plain scan (LSTM_FWD_TOL; gradients 1e-4 of their largest entry)."""
    from emoasr_tpu_torch.config import config_from_dict
    from emoasr_tpu_torch.models.lm.lm import LM
    from emoasr_tpu_torch.ops import lstm_scan

    dev, _ = cuda_dev
    cfg = config_from_dict(dict(lm_type="rnn", vocab_size=300, embedding_size=64, hidden_size=128, num_layers=2,
                                dropout_rate=0.0))
    torch.manual_seed(0)
    cpu = LM(cfg).eval()
    card = LM(cfg).to(dev).eval()
    card.load_state_dict(cpu.state_dict())
    ys = torch.randint(3, 300, (5, 40))
    labels = torch.randint(3, 300, (5, 40))
    before = dict(lstm_scan.KERNEL.counts)
    out = {}
    for name, m, d in (("cuda", card, dev), ("cpu", cpu, "cpu")):
        loss, _ = m(ys.to(d), None, labels.to(d))
        grads = torch.autograd.grad(loss, list(m.parameters()))
        out[name] = (loss.item(), [g.cpu() for g in grads])
    for name in ("emo_lstm_fwd_f32", "emo_lstm_bwd_f32"):
        assert lstm_scan.KERNEL.counts[name] - before[name] == 2
    np.testing.assert_allclose(out["cuda"][0], out["cpu"][0], rtol=1e-5)
    for a, b in zip(out["cuda"][1], out["cpu"][1]):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=0, atol=1e-4 * b.abs().max().item() + 1e-7)
    with torch.no_grad():
        lp1, st1 = card.predict(ys.to(dev), torch.full((5,), 40, device=dev), card.zero_states(5))
        lp0, st0 = cpu.predict(ys, torch.full((5,), 40), cpu.zero_states(5))
    assert lstm_scan.KERNEL.counts["emo_lstm_fwd_f32"] - before["emo_lstm_fwd_f32"] == 2  # predict: the scan
    np.testing.assert_allclose(lp1.cpu().numpy(), lp0.numpy(), rtol=0, atol=1e-5)
    np.testing.assert_allclose(st1.cpu().numpy(), st0.numpy(), rtol=0, atol=1e-5)


def test_ctc_head_bf16_and_wide_match_plain(cuda_dev):
    """K1 in bf16 at H = 256, 512 and 600, and in f32 at H = 512, against
    `ctc_head_plain`, both cotangents."""
    from emoasr_tpu_torch.ops import ctc_head

    before = dict(ctc_head.KERNEL.counts)
    chip_smoke.check_ctc_head_bf16(*cuda_dev)
    used = {k: ctc_head.KERNEL.counts[k] - before[k] for k in before}
    sweep = len(chip_smoke.HEAD_SWEEP_V) * len(chip_smoke.HEAD_SWEEP_H)
    for stage in ("fwd", "grad_e", "grad_w"):  # two cotangents, two launches each
        assert used[f"emo_ctc_head_{stage}_bf16"] == (3 + sweep) * 4 and used[f"emo_ctc_head_{stage}_f32"] == 4


def test_attention_backward_bf16_matches_plain(cuda_dev):
    """K4's backward in bf16 with and without the score bias, dropout on
    and off, against `attention_bwd_plain` with the kernel's keep mask."""
    from emoasr_tpu_torch.ops import attention

    before = dict(attention.KERNEL.counts)
    chip_smoke.check_attention_backward_bf16(*cuda_dev)
    used = {k: attention.KERNEL.counts[k] - before[k] for k in before}
    # four cases once; the edge cases with no bias, an f32 and a bf16 bias, three rates, twice each
    edges = len(chip_smoke.k4_edge_cases(cuda_dev[0]))
    assert used["emo_attention_bwd_bf16"] == 4 + 2 * 3 * 3 * edges
    assert used["bias_bwd_bf16"] == 2 + 2 * 2 * 3 * edges and used["emo_attention_bwd_f32"] == 0


def test_attention_bf16_rejects_depth_not_multiple_of_8(cuda_dev):
    """The bf16 launchers move rows in 16-byte words: a bf16 head size that
    is not a multiple of 8 is refused, forward and backward; float32 takes
    it (its launchers read element by element)."""
    from emoasr_tpu_torch.ops.attention import fused_self_attention

    dev, _ = cuda_dev
    lens = torch.tensor([5, 3], device=dev)
    for D in (12, 20, 36):
        q = torch.randn(2, 5, 2, D, device=dev)
        with pytest.raises(ValueError):
            fused_self_attention(q.bfloat16(), q.bfloat16(), q.bfloat16(), lens, scale=0.3)
        qb = q.bfloat16().requires_grad_(True)
        with pytest.raises(ValueError):
            fused_self_attention(qb, qb, qb, lens, scale=0.3, dropout_rate=0.1, deterministic=False, seed=1)
        assert torch.isfinite(fused_self_attention(q, q, q, lens, scale=0.3)).all()


def test_ctc_head_geometry_matches_the_kernels(cuda_dev):
    """The wrapper's account of each K1 kernel's shared memory
    (`launch_geometry`, which the CPU tests hold to the card's limit) is the
    kernels' own, for chunked and unchunked H in both dtypes."""
    from emoasr_tpu_torch.ops import ctc_head

    lib = ctc_head.KERNEL.lib()
    for dtype, flag in ((torch.bfloat16, 1), (torch.float32, 0)):
        for H in (40, 128, 256, 512, 600):
            for kind_i, kind in enumerate(ctc_head.KINDS):
                assert lib.emo_ctc_head_smem_bytes(kind_i, flag, H, 257) == ctc_head.smem_bytes(kind, dtype, H, 257)


def test_rnnt_joint_bf16_matches_plain(cuda_dev):
    from emoasr_tpu_torch.ops import rnnt_joint

    before = rnnt_joint.KERNEL.counts["emo_rnnt_joint_bf16"]
    chip_smoke.check_rnnt_joint_bf16(*cuda_dev)
    assert rnnt_joint.KERNEL.counts["emo_rnnt_joint_bf16"] - before == 8  # four shapes, twice each


def test_rnnt_joint_edges_match_plain(cuda_dev):
    """K7 on both sides of every change of its cells a block, and at the
    edges of its tiling and its interface (`check_rnnt_joint_edges`), each
    launched twice, bit-identical; and the same outputs at every cells a
    block."""
    from emoasr_tpu_torch.ops import rnnt_joint

    before = dict(rnnt_joint.KERNEL.counts)
    chip_smoke.check_rnnt_joint_edges(*cuda_dev)
    edges = chip_smoke.rnnt_joint_edges()
    for sfx, dtype in (("f32", torch.float32), ("bf16", torch.bfloat16)):
        n = sum(d == dtype for _, d in edges) + 6  # the edges, then six cases of the interface, twice each
        used = rnnt_joint.KERNEL.counts[f"emo_rnnt_joint_{sfx}"] - before[f"emo_rnnt_joint_{sfx}"]
        assert used == 2 * n + len(rnnt_joint.CELLS[dtype])  # then once at every cells a block


def test_rnnt_joint_geometry_matches_the_kernel(cuda_dev):
    """The wrapper's account of K7's shared memory (`launch_geometry`,
    which the CPU tests hold to the card's limit) is the kernel's own, in
    both dtypes at every width where its cells a block change and at the
    widths checked; the launcher refuses cells a block that do not fit."""
    from emoasr_tpu_torch.ops import rnnt_joint

    dev, gen = cuda_dev
    lib = rnnt_joint.KERNEL.lib()
    widths = sorted({J for J, _ in chip_smoke.rnnt_joint_edges()} | {1, 96, 100, 512, 1024, 1500, 2048, 2794})
    for dtype, terms in rnnt_joint.TERMS.items():
        for J in widths:
            geo = rnnt_joint.launch_geometry(18, 399, 129, J, 4000, dtype)
            assert lib.emo_rnnt_joint_smem_bytes(terms, geo["cells"], geo["stages"], J) == geo["smem"], (dtype, J)
    he, hd, w, b, lab = chip_smoke.rnnt_joint_case(dev, gen, 1, 2, 2, 2048, 40)
    he, hd, wt = he.bfloat16(), hd.bfloat16(), w.bfloat16()  # (V, J): the layout the bf16 launcher reads
    out = torch.empty(1, 2, 2, device=dev)
    with pytest.raises(RuntimeError):  # 128 cells of a J = 2048 z tile do not fit
        rnnt_joint.KERNEL.launch("emo_rnnt_joint_bf16", he.data_ptr(), hd.data_ptr(), wt.data_ptr(), b.data_ptr(),
                                 lab.int().data_ptr(), out.data_ptr(), out.data_ptr(), None, 1, 2, 2, 2048, 40, 0,
                                 1, 2048, 128, 2, torch.cuda.current_stream().cuda_stream)


def test_lstm_bf16_matches_plain(cuda_dev):
    from emoasr_tpu_torch.ops import lstm_scan

    before = dict(lstm_scan.KERNEL.counts)
    chip_smoke.check_lstm_bf16(*cuda_dev)
    for name in ("emo_lstm_fwd_bf16", "emo_lstm_bwd_bf16"):  # every shape twice (bit-identical)
        assert lstm_scan.KERNEL.counts[name] - before[name] == 2 * len(chip_smoke.LSTM_BF16_CASES)


def test_attention_at_the_phone_encoder_bucket_matches_plain(cuda_dev):
    """K4 at the phone encoder's largest bucket, (39, 512, 4, 64), in both
    dtypes, forward and backward with dropout 0.1, each launched twice
    (bit-identical), against the plain version on the kernel's keep mask."""
    from emoasr_tpu_torch.ops import attention

    before = dict(attention.KERNEL.counts)
    errs = chip_smoke.check_attention_phone(*cuda_dev)
    assert errs["fwd"] <= chip_smoke.ATTN_TOL[torch.float32] and errs["bwd"] <= chip_smoke.ATTN_BWD_TOL
    for name in ("emo_attention_fwd_f32", "emo_attention_bwd_f32", "emo_attention_fwd_bf16",
                 "emo_attention_bwd_bf16"):
        assert attention.KERNEL.counts[name] - before[name] == 2


def test_p2w_pseudo_log_likelihood_on_the_card_matches_the_cpu(cuda_dev):
    """`pbert`'s chunked pseudo-log-likelihood on the card (the phone
    encoder's attention by K4, chunks of a few copies) against the CPU's
    plain path: each position within 1e-4, the sum within PPL_RTOL."""
    from emoasr_tpu_torch.config import config_from_dict
    from emoasr_tpu_torch.models.lm import lm as lm_mod
    from emoasr_tpu_torch.ops import attention

    dev, _ = cuda_dev
    cfg = config_from_dict(dict(lm_type="pbert", vocab_size=500, src_vocab_size=45, enc_hidden_size=128,
                                enc_num_attention_heads=2, enc_num_layers=2, enc_intermediate_size=256,
                                dec_hidden_size=128, dec_num_attention_heads=2, dec_num_layers=2,
                                dec_intermediate_size=256, mask_id=499, eos_id=2, max_seq_len=64,
                                enc_fused_attn=True))
    torch.manual_seed(0)
    cpu = lm_mod.LM(cfg).eval()
    card = lm_mod.LM(cfg).to(dev).eval()
    card.load_state_dict(cpu.state_dict())
    rng = np.random.default_rng(0)
    ys = torch.from_numpy(rng.integers(3, 498, (4, 40)))
    ylens = torch.tensor([40, 31, 17, 5])
    ps = torch.from_numpy(rng.integers(3, 43, (4, 150)))
    plens = torch.tensor([150, 120, 70, 20])
    before = attention.KERNEL.counts["emo_attention_fwd_f32"]
    old = lm_mod.PLL_CHUNK_TOKENS
    lm_mod.PLL_CHUNK_TOKENS = 40 * 7  # 7 copies a chunk
    try:
        with torch.no_grad():
            got = lm_mod.p2w_pseudo_log_likelihood(card.lm, ys.to(dev), ylens.to(dev), ps.to(dev), plens.to(dev), 499)
            want = lm_mod.p2w_pseudo_log_likelihood(cpu.lm, ys, ylens, ps, plens, 499)
    finally:
        lm_mod.PLL_CHUNK_TOKENS = old
    assert attention.KERNEL.counts["emo_attention_fwd_f32"] - before == cfg.enc_num_layers  # the phones once
    np.testing.assert_allclose(got.cpu().numpy(), want.numpy(), rtol=0, atol=1e-4)
    np.testing.assert_allclose(got.sum().item(), want.sum().item(), rtol=chip_smoke.PPL_RTOL)


def test_lstm_at_the_rnn_encoder_shapes_matches_plain(cuda_dev):
    """K8 at the RNN encoder's shapes, (B, T', H) = (18, 399, 256), (46,
    99, 256) and (50, 49, 256), forward and backward, each twice
    (bit-identical), counted by shape."""
    from emoasr_tpu_torch.ops import lstm_scan

    before, shapes = dict(lstm_scan.KERNEL.counts), dict(lstm_scan.SHAPE_LAUNCHES)
    chip_smoke.check_lstm_cases(*cuda_dev, chip_smoke.LSTM_RNN_ENCODER_CASES, "RNN encoder")
    for name in ("emo_lstm_fwd_f32", "emo_lstm_bwd_f32"):
        assert lstm_scan.KERNEL.counts[name] - before[name] == 2 * len(chip_smoke.LSTM_RNN_ENCODER_CASES)
    for (B, T, H), _ in chip_smoke.LSTM_RNN_ENCODER_CASES:
        for kind in ("fwd", "bwd"):
            key = (kind, B, T, H, "f32")
            assert lstm_scan.SHAPE_LAUNCHES[key] - shapes.get(key, 0) == 2


def test_rnn_encoder_runs_each_direction_through_the_lstm_kernel(cuda_dev):
    """The RNN encoder (2 biLSTM layers of 64, directions summed) on the
    card: one K8 launch a direction a layer forward and backward; outputs
    zero past each length; outputs and gradients as the CPU's plain scan
    (LSTM_FWD_TOL; gradients 1e-4 of their largest entry + 1e-6)."""
    from emoasr_tpu_torch.config import config_from_dict
    from emoasr_tpu_torch.models.encoders import RNNEncoder
    from emoasr_tpu_torch.ops import lstm_scan

    dev, gen = cuda_dev
    torch.manual_seed(0)
    enc = RNNEncoder(config_from_dict(dict(encoder_type="rnn", feat_dim=20, enc_hidden_size=64, enc_num_layers=2,
                                           dropout_enc_rate=0.0))).eval()
    xs = torch.randn(3, 90, 20, generator=torch.Generator().manual_seed(1))
    xlens = torch.tensor([90, 61, 40])
    wsum = torch.randn(3, 21, 64, generator=torch.Generator().manual_seed(2))
    res = {}
    for name, d in (("cuda", dev), ("cpu", torch.device("cpu"))):
        enc = enc.to(d)
        before = dict(lstm_scan.KERNEL.counts)
        eouts, elens, _ = enc(xs.to(d), xlens.to(d))
        grads = torch.autograd.grad((eouts * wsum.to(d)).sum(), list(enc.parameters()))
        used = {k: lstm_scan.KERNEL.counts[k] - before[k] for k in before}
        assert used["emo_lstm_fwd_f32"] == used["emo_lstm_bwd_f32"] == (4 if name == "cuda" else 0)
        res[name] = (eouts.detach().cpu(), elens.cpu(), [g.cpu() for g in grads])
    (e1, l1, g1), (e0, l0, g0) = res["cuda"], res["cpu"]
    assert torch.equal(l1, l0)
    for b, n in enumerate(l0.tolist()):
        assert not e1[b, n:].any()
    chip_smoke._require_close("RNN encoder eouts", e1, e0, chip_smoke.LSTM_FWD_TOL, 0.0)
    for a, b in zip(g1, g0):
        chip_smoke._require_close("RNN encoder gradient", a, b, 1e-6, 1e-4)


def test_las_beam_selects_by_the_topk_kernel(cuda_dev):
    """The LAS beam (W = 4, V = 300) on the card: K3 twice a step, the
    (B, 4, V) pre-selection and the (B, 16) pool; hypotheses and lengths
    equal to the CPU's, scores within 1e-4; width 1 equal to greedy on
    every row it ends."""
    from emoasr_tpu_torch.config import config_from_dict
    from emoasr_tpu_torch.models.decoders.las import LASDecoder
    from emoasr_tpu_torch.ops import topk

    dev, _ = cuda_dev
    cfg = config_from_dict(dict(decoder_type="las", vocab_size=300, dec_hidden_size=64, dec_num_layers=2,
                                dec_intermediate_size=64, embedding_size=32, enc_hidden_size=48, max_decode_ylen=12))
    torch.manual_seed(0)
    dec = LASDecoder(cfg).eval()
    with torch.no_grad():  # logits spread apart, and hypotheses of 1-4 labels end within the cap
        dec.output.weight.mul_(8.0)
        dec.output.bias[2] += 2.0
    eouts = torch.randn(5, 23, 48, generator=torch.Generator().manual_seed(3))
    elens = torch.tensor([23, 20, 15, 9, 4])
    out = {}
    for name, d in (("cuda", dev), ("cpu", torch.device("cpu"))):
        dec = dec.to(d)
        before, shapes = topk.KERNEL.launches, dict(topk.SHAPE_LAUNCHES)
        out[name] = [x.cpu() for x in dec.decode_beam(eouts.to(d), elens.to(d), 4, 1.0)]
        steps = topk.SHAPE_LAUNCHES[(300, 4, "float32")] - shapes.get((300, 4, "float32"), 0)
        assert topk.KERNEL.launches - before == (2 * steps if name == "cuda" else 0)
        if name == "cuda":
            assert steps >= 1 and topk.SHAPE_LAUNCHES[(16, 4, "float32")] - shapes.get((16, 4, "float32"), 0) == steps
        out[name + "1"] = [x.cpu() for x in dec.decode_beam(eouts.to(d), elens.to(d), 1)]
        out[name + "g"] = [x.cpu() for x in dec.decode_greedy(eouts.to(d), elens.to(d))]
    (h1, l1, s1), (h0, l0, s0) = out["cuda"], out["cpu"]
    assert torch.equal(h1, h0) and torch.equal(l1, l0) and bool((s1[:, 0] > -1e29).any())
    live = s0 > -1e29
    assert torch.equal(s1 > -1e29, live)
    assert (s1[live] - s0[live]).abs().max().item() <= 1e-4
    (b, bl, bs), (g, gl) = out["cuda1"], out["cudag"]
    for r in range(5):
        if bs[r, 0] > -1e29:
            assert b[r, 0, 1:bl[r, 0] - 1].tolist() == g[r, :gl[r]].tolist()
