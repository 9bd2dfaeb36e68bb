"""The arithmetic of K5 and K6 on the tensor cores, emulated on the CPU.

K5 (`csrc/decoder_step.cu`, the fused decoder-layer step, direct and
indirect) and K6 (`csrc/lm_step.cu`, the fused LM-layer step) run every
dense product on bf16 tensor cores with float32 sums (`csrc/beam_step.cuh`):
a float32 operand is split into two bf16 terms (hi = bf16(x), lo =
bf16(x - hi)) and the three leading cross products (hi hi, lo hi, hi lo)
are summed; K is cut into `slices(K)` fixed slices, each summed from zero
and added in order.  The weights reach the kernel split and laid out as
the B fragments of mma.m16n8k16 (`ops/decoder_step.py::pack_fragments`).
`_kernel_dense` computes exactly those products from the packed fragments,
read back by the fragment layout (a product of two bf16 values is exact in
float32); K5's cross-attention takes its scores and its P V product on the
tensor cores too, split the same way (`_split_einsum`).  `_emulate_k5` /
`_emulate_k6` run the plain steps with those in place of theirs.  They are held against the plain
versions and against the JAX package's Pallas kernels (interpret mode, as
the JAX tests run them), in float32 within the tolerances `chip_smoke.py`
holds the kernels to on the card (DEC_STEP_TOL, LM_STEP_TOL) and in bf16
within one bf16 step of each entry and one of the largest, at narrow
widths (D 64, F 96, W up to 33) and at the decode widths (D 256 / 512,
F 2048) with a few rows; one term (the float32 operands rounded to bf16
once) misses the float32 tolerance there.

The launch geometry lives in Python (`ops/decoder_step.py::smem_bytes`,
`launch_geometry`, mirrored from the sources' `Layout`s; the `cuda` test
`test_beam_step_geometry_matches_the_kernels` holds the mirror against the
libraries): every row group of 4, 12 and 16 at the shipped decode shapes
fits the 232,448 bytes of shared memory a block may take on sm_90, and the
launch stays within the card's SMs for every batch of the L3 buckets.
"""

import math
import os
import sys
from unittest import mock

import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

import chip_smoke
from emoasr_tpu.ops import decoder_step_pallas as jdsp
from emoasr_tpu.ops import lm_step_pallas as jls
from emoasr_tpu_torch.ops import decoder_step as ds
from emoasr_tpu_torch.ops import lm_step

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DTYPES = {"float32": (torch.float32, jnp.float32), "bfloat16": (torch.bfloat16, jnp.bfloat16)}


def _split(x: torch.Tensor, n: int) -> list:
    """x (float32) as n bf16 terms, each kept as float32, largest first."""
    terms = []
    for _ in range(n):
        t = x.to(torch.bfloat16).float()
        terms.append(t)
        x = x - t
    return terms


def _unpack(frag: torch.Tensor, N: int, K: int) -> torch.Tensor:
    """(terms, N, K) float32: the weight terms that `pack_fragments` laid
    out, read as mma.m16n8k16 reads its B fragments: lane g * 4 + c of a
    column group and k-step holds, per term, the words (b0, b1) of the n8
    tiles j = 0, 1; b0 holds k 2c, 2c + 1 and b1 k 2c + 8, 2c + 9 of
    column 8 j + g, the lower k in the low half."""
    groups, ksp, terms = frag.shape[:3]
    words = frag.reshape(groups, ksp, terms, 32, 4, 2).float()  # (group, k-step, term, lane, word, half of word)
    out = torch.zeros(terms, groups * 16, ksp * 16)
    lane = torch.arange(32)
    g, c = lane // 4, lane % 4
    for word in range(4):
        j, b = word // 2, word % 2  # n8 tile, b0 / b1
        for e in range(2):
            n = (16 * torch.arange(groups))[:, None] + 8 * j + g[None, :]  # (group, lane)
            k = (16 * torch.arange(ksp))[:, None] + 8 * b + 2 * c[None, :] + e  # (k-step, lane)
            for t in range(terms):
                vals = words[:, :, t, :, word, e]  # (group, k-step, lane)
                out[t, n[:, None, :].expand(-1, ksp, -1), k[None, :, :].expand(groups, -1, -1)] = vals
    return out[:, :N, :K]


def _kernel_dense(terms=None):
    """dense(x, w, b) as K5 / K6 compute it: x's terms (two for float32,
    one for bf16; `terms` overrides) times the packed weight's, the leading
    cross products (hi hi + lo hi) + hi lo of each K slice summed apart, the
    slices added in order, then the f32 bias and one rounding to x's dtype."""
    def dense(x, w, b):
        adt = x.dtype
        K, N = w.shape
        T = terms or ds.n_terms(adt)
        wt = _unpack(ds.pack_fragments(w.t(), T), N, K)
        xs = _split(x.float(), T)
        S = ds.slices(K)
        Ls = ds.ksteps_padded(K) // S
        total = None
        for s in range(S):
            k0, k1 = 16 * s * Ls, min(16 * (s + 1) * Ls, K)
            prods = [xs[i][:, k0:k1] @ wt[j][:, k0:k1].t() for i, j in ((0, 0), (1, 0), (0, 1)) if i < T and j < T]
            p = prods[0]
            for q in prods[1:]:
                p = p + q
            total = p if total is None else total + p
        return (total + b.float()).to(adt)
    return dense


def _split_einsum(eq, a, b, terms):
    """einsum of a and b (float32) as the tensor cores take it: both split
    into `terms` bf16 terms, the leading cross products summed."""
    a_t, b_t = _split(a, terms), _split(b, terms)
    prods = [torch.einsum(eq, a_t[i], b_t[j]) for i, j in ((0, 0), (1, 0), (0, 1)) if i < terms and j < terms]
    out = prods[0]
    for p in prods[1:]:
        out = out + p
    return out


def _window_softmax(sc, valid, tw):
    """The softmax of the scores sc (..., T) over the frames `valid` as K5's
    cross-attention takes it: windows of tw frames, a running max and sum of
    exp(s - max), the sum rescaled where a window raises the max, then
    p = exp(s - max) / sum (0 where not valid)."""
    m = torch.full(sc.shape[:-1] + (1,), -math.inf)
    den = torch.zeros_like(m)
    for f0 in range(0, sc.shape[-1], tw):
        s, v = sc[..., f0:f0 + tw], valid[..., f0:f0 + tw]
        mn = torch.maximum(m, torch.where(v, s, -math.inf).amax(-1, keepdim=True))
        den = den * torch.exp(m - mn) + torch.where(v, torch.exp(s - mn), 0.0).sum(-1, keepdim=True)
        m = mn
    return torch.where(valid, torch.exp(sc - m) / den, 0.0)


def _emulate_k5(c, W, indirect=True, terms=None):
    """(y, k_new, v_new) of K5 on the inputs `c` (see `_k5_case`): the plain
    step (`decoder_step._step_plain`, the self-attention as it is) with the
    kernel's dense products and its cross-attention, whose scores and P V
    product take the same split terms on the tensor cores and whose softmax
    goes over windows of frames (`_window_softmax`)."""
    Bu, W_, L, H, dk = c["ck"].shape
    N, D, adt = Bu * W_, H * dk, c["h"].dtype
    T_ = terms or ds.n_terms(adt)
    dense, wt = _kernel_dense(terms), c["w"]
    if indirect:
        idx = c["anc"][:, :, :, None, None].expand(Bu, W_, L, H, dk)
        ck, cv = (torch.gather(x, 1, idx).reshape(N, L, H, dk) for x in (c["ck"], c["cv"]))
    else:
        ck, cv = c["ck"].reshape(N, L, H, dk), c["cv"].reshape(N, L, H, dk)
    h, pos, xk, xv = c["h"], c["pos"].reshape(-1), c["xk"], c["xv"]
    T = xk.shape[1]
    hn = ds._layer_norm(h, wt["ln1_s"], wt["ln1_b"])
    q, k_new, v_new = (dense(hn, wt["w" + n], wt["b" + n]) for n in "qkv")
    out = ds.cached_self_attention(q, k_new, v_new, ck, cv, pos)
    x = h + dense(out.reshape(N, D), wt["wo"], wt["bo"])
    q2 = dense(ds._layer_norm(x, wt["ln2_s"], wt["ln2_b"]), wt["cwq"], wt["cbq"]).reshape(Bu, W, H, dk)
    valid = (torch.arange(T)[None, :] < c["elens"].reshape(Bu, 1))[:, None, None, :].expand(Bu, H, W, T)
    sc = _split_einsum("uwhd,uthd->uhwt", q2.float(), xk.float(), T_) / math.sqrt(dk)
    p = _window_softmax(sc, valid, ds.cross_window(T, h.element_size())[0]).to(adt)
    o = _split_einsum("uhwt,uthd->uwhd", p.float(), xv.float(), T_)
    x = x + dense(o.to(adt).reshape(N, D), wt["cwo"], wt["cbo"])
    ff = dense(torch.relu(dense(ds._layer_norm(x, wt["ln3_s"], wt["ln3_b"]), wt["w1"], wt["b1"])), wt["w2"], wt["b2"])
    return x + ff, k_new.reshape(N, H, dk), v_new.reshape(N, H, dk)


def _emulate_k6(c, terms=None):
    """(y, k_new, v_new) of K6 on the inputs `c` (see `_k6_case`)."""
    with mock.patch.object(lm_step, "_dense", _kernel_dense(terms)):
        return lm_step.bert_layer_step_indirect_plain(c["h"], c["ck"], c["cv"], c["pos"], c["anc"], c["w"])


def _bf16(x: np.ndarray) -> np.ndarray:
    return np.asarray(x, np.float32).astype(ml_dtypes.bfloat16).astype(np.float32)


def _anc(rng, Bu, W, L, pos):
    """An ancestor table composed from random beam selections, as the
    search composes it, with anc[u, w, pos] = w."""
    anc = np.repeat(np.arange(W)[None, :, None], Bu, 0).repeat(L, 2)
    for step in range(1, L):
        parent = rng.integers(0, W, size=(Bu, W))
        anc[:, :, :step] = np.take_along_axis(anc[:, :, :step], parent[:, :, None], axis=1)
    anc[np.arange(Bu)[:, None], np.arange(W)[None, :], pos] = np.arange(W)[None, :]
    return anc.astype(np.int32)


def _weights(rng, shapes, vectors, dtype):
    """numpy-seeded 2-D kernels (in, out) and vectors (LayerNorm scales near
    1, biases near 0), rounded to bf16 for a bf16 case."""
    w = {n: rng.normal(size=s) / np.sqrt(s[0]) for n, s in shapes.items()}
    w.update({n: (1.0 if n.endswith("_s") else 0.0) + 0.1 * rng.normal(size=d) for n, d in vectors.items()})
    return {n: (_bf16(v) if dtype == "bfloat16" else v).astype(np.float32) for n, v in w.items()}


def _k5_case(seed, Bu, W, L, T, H, D, F, dtype):
    """One K5 step's numpy-seeded inputs: per-row `pos` from 0 to L - 1,
    ragged `elens` (one utterance with none), an ancestor table."""
    rng = np.random.default_rng(seed)
    dk = D // H
    pos = rng.integers(0, L, size=(Bu, W))
    pos.reshape(-1)[0], pos.reshape(-1)[-1] = 0, L - 1
    elens = rng.integers(1, T + 1, size=Bu)
    elens[0] = T
    if Bu > 1:
        elens[-1] = 0
    sq = {n: (D, D) for n in ("wq", "wk", "wv", "wo", "cwq", "cwo")}
    vec = {n: D for n in ("ln1_s", "ln1_b", "ln2_s", "ln2_b", "ln3_s", "ln3_b", "bq", "bk", "bv", "bo", "cbq",
                          "cbo", "b2")}
    w = _weights(rng, {**sq, "w1": (D, F), "w2": (F, D)}, {**vec, "b1": F}, dtype)
    x = {"h": rng.normal(size=(Bu * W, D)), "ck": rng.normal(size=(Bu, W, L, H, dk)),
         "cv": rng.normal(size=(Bu, W, L, H, dk)), "xk": rng.normal(size=(Bu, T, H, dk)),
         "xv": rng.normal(size=(Bu, T, H, dk))}
    x = {k: (_bf16(v) if dtype == "bfloat16" else v).astype(np.float32) for k, v in x.items()}
    return {**x, "pos": pos.astype(np.int32), "anc": _anc(rng, Bu, W, L, pos), "elens": elens.astype(np.int32),
            "w": w}


def _k6_case(seed, Bu, W, L, H, D, F, dtype):
    rng = np.random.default_rng(seed)
    dk = D // H
    pos = rng.integers(0, L, size=(Bu, W))
    pos.reshape(-1)[0], pos.reshape(-1)[-1] = 0, L - 1
    sq = {n: (D, D) for n in ("wq", "wk", "wv", "wo")}
    vec = {n: D for n in ("bq", "bk", "bv", "bo", "ln1_s", "ln1_b", "bo2", "ln2_s", "ln2_b")}
    w = _weights(rng, {**sq, "wi": (D, F), "wo2": (F, D)}, {**vec, "bi": F}, dtype)
    x = {"h": rng.normal(size=(Bu, W, D)), "ck": rng.normal(size=(Bu, W, L, H, dk)),
         "cv": rng.normal(size=(Bu, W, L, H, dk))}
    x = {k: (_bf16(v) if dtype == "bfloat16" else v).astype(np.float32) for k, v in x.items()}
    return {**x, "pos": pos.astype(np.int32), "anc": _anc(rng, Bu, W, L, pos), "w": w}


def _torch(c, dtype):
    tdt = DTYPES[dtype][0]
    cast = lambda v: torch.from_numpy(v).to(tdt) if v.dtype == np.float32 else torch.from_numpy(v).long()
    return {k: ({n: cast(a) for n, a in v.items()} if k == "w" else cast(v)) for k, v in c.items()}


def _jax(c, dtype):
    jdt = DTYPES[dtype][1]
    cast = lambda v: jnp.asarray(v).astype(jdt) if v.dtype == np.float32 else jnp.asarray(v)
    return {k: ({n: cast(a) for n, a in v.items()} if k == "w" else cast(v)) for k, v in c.items()}


def _hold(got, want, dtype, tol, name, margin=1.0):
    """f32: |got - want| <= tol / margin; bf16: one bf16 step of each entry
    and one of the largest, as `chip_smoke.py` holds the kernels."""
    as_f32 = lambda x: x.float() if torch.is_tensor(x) else torch.from_numpy(np.array(x, np.float32))
    for what, a, b in zip(("y", "k_new", "v_new"), got, want):
        a, b = as_f32(a), as_f32(b).reshape(a.shape)
        if dtype == "float32":
            chip_smoke._require_close(f"{name} {what}", a, b, tol / margin, 0.0)
        else:
            chip_smoke._require_close_bf16(f"{name} {what}", a.to(torch.bfloat16), b.to(torch.bfloat16))


# (Bu, W, L, T, H, D, F): narrow widths, beams wider than a row group of 16
# (W = 17: one utterance's rows in two groups, the second shared with the
# next utterance's), an encoder output longer than a window of the
# cross-attention (three windows in float32, two in bf16), and the L3
# decode widths with a few rows
K5_CASES = [(2, 5, 9, 21, 2, 64, 96), (2, 17, 8, 13, 2, 64, 96), (2, 3, 6, 1100, 2, 64, 96),
            (1, 3, 10, 30, 4, 256, 2048)]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("Bu,W,L,T,H,D,F", K5_CASES)
def test_k5_split_products_match_plain_and_jax(Bu, W, L, T, H, D, F, dtype):
    """The emulated K5, indirect and direct, against the plain versions
    (f32: within half of DEC_STEP_TOL) and the JAX kernels (interpret mode,
    within DEC_STEP_TOL); bf16 within one bf16 step."""
    c = _k5_case(Bu * 1000 + W * 10 + D, Bu, W, L, T, H, D, F, dtype)
    t, j = _torch(c, dtype), _jax(c, dtype)
    tol = chip_smoke.DEC_STEP_TOL
    got = _emulate_k5(t, W)
    plain = ds.decoder_layer_step_indirect_plain(t["h"], t["ck"], t["cv"], t["pos"], t["anc"], t["xk"], t["xv"],
                                                 t["elens"], t["w"], W)
    _hold(got, plain, dtype, tol, f"K5 indirect {dtype} vs plain", margin=2.0)
    ref = jdsp.fused_decoder_layer_step_indirect(j["h"], j["ck"], j["cv"], j["pos"], j["anc"], j["xk"], j["xv"],
                                                 j["elens"], j["w"], beam_width=W)
    _hold(got, ref, dtype, tol, f"K5 indirect {dtype} vs JAX")
    got_d = _emulate_k5(t, W, indirect=False)
    N, dk = Bu * W, D // H
    ref_d = jdsp.fused_decoder_layer_step(j["h"], j["ck"].reshape(N, L, H, dk), j["cv"].reshape(N, L, H, dk),
                                          j["pos"].reshape(N), j["xk"], j["xv"], j["elens"], j["w"], beam_width=W)
    _hold(got_d, ref_d, dtype, tol, f"K5 direct {dtype} vs JAX")


# (Bu, W, L, H, D, F)
K6_CASES = [(2, 5, 9, 2, 64, 96), (1, 17, 7, 2, 64, 96), (1, 3, 10, 8, 512, 2048)]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("Bu,W,L,H,D,F", K6_CASES)
def test_k6_split_products_match_plain_and_jax(Bu, W, L, H, D, F, dtype):
    """The emulated K6 against the plain version (f32: within half of
    LM_STEP_TOL) and the JAX kernel (interpret mode, within LM_STEP_TOL);
    bf16 within one bf16 step."""
    c = _k6_case(Bu * 1000 + W * 10 + D, Bu, W, L, H, D, F, dtype)
    t, j = _torch(c, dtype), _jax(c, dtype)
    tol = chip_smoke.LM_STEP_TOL
    got = _emulate_k6(t)
    plain = lm_step.bert_layer_step_indirect_plain(t["h"], t["ck"], t["cv"], t["pos"], t["anc"], t["w"])
    _hold(got, plain, dtype, tol, f"K6 {dtype} vs plain", margin=2.0)
    ref = jls.fused_bert_layer_step_indirect(j["h"], j["ck"], j["cv"], j["pos"], j["anc"], j["w"], interpret=True)
    _hold(got, ref, dtype, tol, f"K6 {dtype} vs JAX")


def test_k5_split_is_needed():
    """One term (one bf16 product, the float32 operands rounded once) misses
    DEC_STEP_TOL at the decode widths: the second term is what holds it."""
    t = _torch(_k5_case(7, 1, 3, 10, 30, 4, 256, 2048, "float32"), "float32")
    plain = ds.decoder_layer_step_indirect_plain(t["h"], t["ck"], t["cv"], t["pos"], t["anc"], t["xk"], t["xv"],
                                                 t["elens"], t["w"], 3)
    with pytest.raises(chip_smoke.CheckFailed):
        _hold(_emulate_k5(t, 3, terms=1), plain, "float32", chip_smoke.DEC_STEP_TOL, "K5 f32, one term")


def test_k6_split_is_needed():
    """The same for K6 at D 512, F 2048 and LM_STEP_TOL."""
    t = _torch(_k6_case(7, 1, 3, 10, 8, 512, 2048, "float32"), "float32")
    plain = lm_step.bert_layer_step_indirect_plain(t["h"], t["ck"], t["cv"], t["pos"], t["anc"], t["w"])
    with pytest.raises(chip_smoke.CheckFailed):
        _hold(_emulate_k6(t, terms=1), plain, "float32", chip_smoke.LM_STEP_TOL, "K6 f32, one term")


@pytest.mark.parametrize("N,K,terms", [(256, 256, 2), (96, 64, 1), (40, 72, 2), (100, 100, 2), (2048, 512, 1)])
def test_pack_fragments_holds_the_split_weight(N, K, terms):
    """The packed fragments, read back as the mma reads them, are the
    weight's bf16 terms (their sum the weight to 2^-16 in float32), zeros
    where N and K are padded, in whole slices of K."""
    w = torch.from_numpy(np.random.default_rng(N + K).normal(size=(N, K)).astype(np.float32))
    frag = ds.pack_fragments(w, terms)
    assert frag.dtype == torch.bfloat16 and frag.shape[1] % ds.slices(K) == 0
    assert frag.shape == (-(-N // 16), ds.ksteps_padded(K), terms, 8, 4, 2, 2, 2)
    back = _unpack(frag, N, K)
    for got, want in zip(back, _split(w, terms)):
        assert torch.equal(got, want)
    full = _unpack(frag, frag.shape[0] * 16, frag.shape[1] * 16)
    assert full[:, N:].abs().sum() == 0 and full[:, :, K:].abs().sum() == 0


# the shipped decode shapes: (kind, D, F, H, L, T) of the L3 decoder (up to
# the largest bucket's T' = 399 and the step cap's L = 258) and of the L3-3 LM
SHAPES = [("decoder", 256, 2048, 4, 258, 399), ("lm", 512, 2048, 8, 256, 1)]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("group", [4, 12, 16])
@pytest.mark.parametrize("kind,D,F,H,L,T", SHAPES, ids=[s[0] for s in SHAPES])
def test_beam_step_smem_fits(kind, D, F, H, L, T, group, dtype):
    """Every row group's shared memory within the 232,448 bytes of a block
    on sm_90 at the shipped shapes, growing with the group."""
    es = DTYPES[dtype][0].itemsize
    need = ds.smem_bytes(kind, group, D, F, H, L, T, es)
    assert need <= ds.MAX_SMEM_BYTES and need % 16 == 0
    if group > 4:
        assert need > ds.smem_bytes(kind, 4, D, F, H, L, T, es)
    assert ds.THREADS == 256 and ds.plane_ld(D) * 2 % 32 == 16 and ds.plane_ld(F) * 2 % 32 == 16


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("Bu", [1, 18, 50, 140])
@pytest.mark.parametrize("kind,D,F,H,L,T", SHAPES, ids=[s[0] for s in SHAPES])
def test_beam_step_sm_plan(kind, D, F, H, L, T, Bu, dtype):
    """The launch of the L3 buckets' batches at W = 10, 17 and 33 on a card
    that keeps 132 // c clusters of c blocks at once (an H100's SMs, a block
    an SM; on the card `device_geometry` asks it): groups of 16 rows (12 for
    N <= 12; one m16 tile), every cluster of the launch on the card at once
    (clusters of one block where even those take more than one wave), as
    many blocks a cluster as fit, up to 8 (the L3 bucket: 12 groups on 96
    SMs; W = 33: 38 groups in clusters of 3)."""
    sms = 132
    holds = lambda group, c: sms // c
    for W in (10, 17, 33):
        N = Bu * W
        g = ds.launch_geometry(kind, Bu, W, D, F, H, L, T, DTYPES[dtype][0], holds)
        assert g["group"] == (12 if N <= 12 else 16)
        assert (g["groups"] - 1) * g["group"] < N <= g["groups"] * g["group"]
        assert 1 <= g["cluster"] <= 8 and g["blocks"] == g["groups"] * g["cluster"]
        assert g["blocks"] <= sms or g["cluster"] == 1
        assert g["cluster"] == 8 or g["groups"] * (g["cluster"] + 1) > sms
        assert g["threads"] == 256 and g["smem"] <= ds.MAX_SMEM_BYTES
    g = ds.launch_geometry(kind, 18, 10, D, F, H, L, T, DTYPES[dtype][0], holds)
    assert (g["groups"], g["cluster"], g["blocks"]) == (12, 8, 96)
    g = ds.launch_geometry(kind, 18, 33, D, F, H, L, T, DTYPES[dtype][0], holds)
    assert (g["groups"], g["cluster"], g["blocks"]) == (38, 3, 114)


def test_beam_step_geometry_refuses_what_does_not_fit():
    """A hidden layer too wide for a block even in groups of 4 raises, and
    one that fits groups of 4 only is launched in groups of 4.  K5 takes any
    encoder output at the L3 widths in groups of 16: its cross-attention
    holds one window of frames (512 in float32, 1024 in bf16), so its
    shared memory stops growing with T' there."""
    holds = lambda group, c: 132 // c
    with pytest.raises(ValueError, match="shared memory"):
        ds.launch_geometry("decoder", 1, 4, 512, 16384, 4, 4, 5, torch.float32, holds)
    with pytest.raises(ValueError, match="shared memory"):
        ds.launch_geometry("lm", 1, 4, 512, 16384, 8, 4, 1, torch.float32, holds)
    for kind in ("decoder", "lm"):
        assert ds.launch_geometry(kind, 1, 16, 512, 4096, 4, 4, 5, torch.float32, holds)["group"] == 4
    for dtype, window in ((torch.float32, 512), (torch.bfloat16, 1024)):
        es = dtype.itemsize
        assert ds.cross_window(399, es)[0] == 400 and ds.cross_window(100000, es)[0] == window
        at = {T: ds.launch_geometry("decoder", 18, 10, 256, 2048, 4, 258, T, dtype, holds) for T in (
            399, window, window + 1, 1029, 1509, 100000)}
        assert all(g["group"] == 16 for g in at.values())
        assert at[window]["smem"] == at[window + 1]["smem"] == at[100000]["smem"]


def test_k5_parts_variants_edit_the_source():
    """Each variant of `tools/k5_parts.py` finds the text it edits in this
    tree's K5 / K6 sources (it raises otherwise) and changes them: the tool
    still measures the kernels that ship."""
    sys.path.insert(0, os.path.join(REPO, "tools"))
    import k5_parts

    src = k5_parts.read_sources()
    variants = k5_parts.variant_sources(src)
    assert set(variants) == {"kernel", "no_products", "no_weight_loads", "no_self_attn", "no_cross_attn", "no_shares",
                             "no_layernorm", "barrier_only"}
    assert variants["kernel"] == src and all(v != src for k, v in variants.items() if k != "kernel")
