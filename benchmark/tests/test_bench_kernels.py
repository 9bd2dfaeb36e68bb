"""Each kernel file's operations and bytes against a count by hand at one
small shape, and the utilisation's model operations of both configurations."""

import pytest

from harness import flops, peaks, spec


def test_k4_by_hand():
    k4 = spec.kernel_counts("k4")
    # two rows of 3 and 5 real frames, 2 heads of 4
    ops, nbytes = k4.fwd([3, 5], 2, 4, bias=False)
    assert ops == 2 * 2 * (3 * 3 * 4 + 5 * 5 * 4) * 2
    assert nbytes == 4 * 4 * (3 + 5) * 2 * 4 + 4 * 2
    ops, nbytes = k4.bwd([3, 5], 2, 4, bias=True)
    assert ops == 4 * 2 * 2 * (9 * 4 + 25 * 4)
    assert nbytes == 7 * 4 * (3 + 5) * 2 * 4 + 2 * 2 * (9 + 25) * 4 + 4 * 2


def test_k1_by_hand():
    k1 = spec.kernel_counts("k1")
    ops, nbytes = k1.fwd([6, 4], [2, 1], D=8, V=10)
    assert ops == 2 * 10 * 8 * 10
    assert nbytes == (10 * 8 + 8 * 10 + 10) * 4 + (10 + 6 * 5 + 4 * 3) * 4
    assert k1.grad_e([6, 4], [2, 1], 8, 10)[0] == ops
    assert k1.grad_w([6, 4], [2, 1], 8, 10)[0] == ops


def test_k7_by_hand():
    k7 = spec.kernel_counts("k7")
    ops, nbytes = k7.fwd([5, 3], [2, 4], J=6, V=7)
    cells = 5 * 3 + 3 * 5
    assert ops == 2 * 6 * 7 * cells
    assert nbytes == ((5 + 3) * 6 + (3 + 5) * 6 + 6 * 7 + 7) * 4 + (cells + 5 * 2 + 3 * 4) * 4


def test_bound_takes_the_larger_of_compute_and_bytes():
    assert peaks.bound_s(989e12, 0) == pytest.approx(1.0)
    assert peaks.bound_s(0, 3.35e12) == pytest.approx(1.0)
    assert peaks.bound_s(989e12, 2 * 3.35e12) == pytest.approx(2.0)


def _cfg(name):
    return spec.load_json(spec.all_names("configs")[name])["config"]


def test_model_flops_l1_by_hand():
    cfg = _cfg("l1_ctc_transformer")
    x = 163  # t1 = 81, f1 = 39, t2 = 40, f2 = 19
    d, f, V = 256, 2048, 10000
    conv = 2 * 9 * d * 81 * 39 + 2 * 9 * d * d * 40 * 19 + 2 * d * 19 * d * 40
    layer = 2 * 4 * d * d * 40 + 2 * 2 * 40 * 40 * d + 2 * 2 * d * f * 40
    assert flops.subsampled(x) == 40
    assert flops.encoder_forward(cfg, x) == conv + 12 * layer
    assert flops.batch_forward(cfg, [x], [7]) == conv + 12 * layer + 2 * d * V * 40
    assert flops.decode_forward(cfg, [x]) == conv + 12 * layer + 2 * d * V * 40


def test_model_flops_l4_by_hand():
    cfg = _cfg("l4_rnnt_conformer")
    x, u = 163, 7
    d, f, V, k = 256, 1024, 1000, 31
    T = 40
    conv = 2 * 9 * d * 81 * 39 + 2 * 9 * d * d * 40 * 19 + 2 * d * 19 * d * 40
    layer = (2 * 4 * d * d * T + 2 * 2 * T * T * d + 2 * 2 * 2 * d * f * T + 2 * (2 * T - 1) * d * d
             + 2 * T * (2 * T - 1) * d + 2 * d * 2 * d * T + 2 * d * k * T + 2 * d * d * T)
    e, h, j = 128, 512, 512
    head = 2 * (e + h) * 4 * h * (u + 1) + 2 * d * j * T + 2 * h * j * (u + 1) + 2 * j * V * T * (u + 1)
    assert flops.batch_forward(cfg, [x], [u]) == pytest.approx(conv + 12 * layer + head, rel=1e-12)
