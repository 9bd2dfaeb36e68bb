"""The algorithms of K3 (the beams' top-k, `csrc/topk.cu`) and K2 (the CTC
lattice, `csrc/ctc_lattice.cu`), emulated on the CPU at the geometry that
Python computes for the card.

K3: `_emulate_k3` follows the kernel step by step at
`ops/topk.py::launch_geometry`'s layout: a row cut into `parts` slices, one
block of 256 threads each; the 16-byte words of a slice (straddling words
masked), WPT a thread, as order-preserving keys; each thread's largest
word; the bitonic network a warp sorts its 32 thread maxima with; tau, the
k-th largest thread maximum, by ranking the warps' sorted lists with binary
searches; the entries >= tau compacted and ranked against each other; a
split row's lists merged by rank.  It is held bit for bit, values and
indices, against `topk_plain`, `lax.top_k` and the JAX `topk_pallas`
(interpret mode), on random rows, ties, -inf rows, rows whose top entries
crowd the fewest threads (the most candidates the kernel's buffer must
hold), float32 and bf16, k = 1 to 32 and V = 256 to MAX_V; and every beam
shape of the shipped configurations is held to the kernel's limits.

K2: `_emulate_k2` lays the lattice out as the kernel does (SPL consecutive
states a thread, `warps` x 32 threads; s - 1 and s - 2, or s + 1 and
s + 2, taken from the neighbouring thread's registers; lse3 without the
exponential of its largest term, its exponentials and logarithm of float32
differences) and runs alpha, ll, beta and the gradient on float64 carries,
rows frozen past xlens and zero past them, infeasible rows without
gradient.  It is held against `ctc_ll_plain` under autograd and
against the JAX `ctc_ll_from_path` (interpret mode) within `chip_smoke`'s
LATTICE_TOL, at S = 1, 21, 257 and 1025 (several warps a chain), and every
shipped configuration's S is held to the kernel's launch bounds.
"""

import glob
import os

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

import chip_smoke
from emoasr_tpu.ops.ctc_pallas import ctc_ll_from_path as jax_ctc_ll
from emoasr_tpu.ops.topk_pallas import topk_pallas
from emoasr_tpu_torch.config import load_config
from emoasr_tpu_torch.ops import ctc_lattice, topk
from emoasr_tpu_torch.ops.common import LOG_0

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# ---------------------------------------------------------------- K3

KMAX_CAND = topk.MAX_K * topk.MAX_KEYS  # csrc/topk.cu kMaxCand


def _keys(x: np.ndarray) -> np.ndarray:
    """The kernel's order-preserving uint32 keys of float32 or bf16 values."""
    f = x.astype(np.float32) if x.dtype == ml_dtypes.bfloat16 else x
    u = f.view(np.uint32).astype(np.uint64)
    return np.where(u & 0x80000000, ~u & 0xFFFFFFFF, u | 0x80000000).astype(np.uint64)


def _bitonic_desc(v: np.ndarray) -> np.ndarray:
    """The kernel's warp network over the last axis (32 lanes)."""
    lane = np.arange(32)
    size = 2
    while size <= 32:
        stride = size // 2
        while stride > 0:
            o = v[..., lane ^ stride]
            keep_max = ((lane & size) == 0) == ((lane & stride) == 0)
            v = np.where(keep_max, np.maximum(v, o), np.minimum(v, o))
            stride //= 2
        size *= 2
    return v


def _count_greater(lst: np.ndarray, w, n: int) -> int:
    lo, hi = 0, n
    while lo < hi:
        mid = (lo + hi) // 2
        if lst[mid] > w:
            lo = mid + 1
        else:
            hi = mid
    return lo


def _block_list(flat: np.ndarray, keys: np.ndarray, row: int, V: int, k: int, lo: int, hi: int, wpt: int,
                epw: int) -> list:
    """One block's k words, sorted descending, zero-padded."""
    T = topk.THREADS
    base, total = row * V, flat.size
    q0, q1 = (base + lo) // epw, (base + hi - 1) // epw + 1
    q = q0 + np.arange(T)[:, None] + T * np.arange(wpt)[None, :]            # (thread, j)
    e = q[..., None] * epw + np.arange(epw)                                   # (thread, j, c)
    i = e - base
    valid = (q[..., None] < q1) & (i >= lo) & (i < hi) & (e < total)
    kk = keys[np.clip(e, 0, total - 1)]
    words = np.where(valid, (kk << np.uint64(32)) | (np.uint64(0xFFFFFFFF) - i.astype(np.uint64)), np.uint64(0))
    words = words.reshape(T, wpt * epw)
    best = words.max(axis=1)                                                  # thread maxima
    top = _bitonic_desc(best.reshape(T // 32, 32))[:, :k]                     # each warp's k largest
    assert np.all(top[:, :-1] >= top[:, 1:]) if k > 1 else True
    tau = 0
    few = 8 * k * wpt * epw <= KMAX_CAND  # few keys a thread for this k
    if few:  # the largest of the warps' k-th largest
        tau = top[:, k - 1].max()
    else:
        for a in range(top.shape[0]):
            for p in range(k):
                w = top[a, p]
                # its own list counts its position: every list is searched
                if w != 0 and sum(_count_greater(top[b], w, k) for b in range(top.shape[0])) == k - 1:
                    tau = w
    cand = words[words >= max(tau, 1)]
    assert cand.size <= (8 if few else 1) * k * wpt * epw <= KMAX_CAND, (cand.size, k, wpt)
    out = [0] * k
    for w in cand:
        r = int((cand > w).sum())
        if r < k:
            out[r] = int(w)
    return out


def _emulate_k3(x: np.ndarray, k: int, rows_for_geometry: int = None, emulate_rows=None):
    """(values, indices) of the kernel's algorithm over the last axis of x
    (float32 or bf16), at the geometry of `rows_for_geometry` rows (the
    call's own by default); only the rows `emulate_rows` are computed."""
    V = x.shape[-1]
    flat = x.reshape(-1)
    rows = flat.size // V
    dt = torch.bfloat16 if x.dtype == ml_dtypes.bfloat16 else torch.float32
    geo = topk.launch_geometry(rows_for_geometry or rows, V, k, dt)
    epw, parts, chunk = 16 // x.dtype.itemsize, geo["parts"], geo["chunk"]
    assert geo["wpt"] * topk.THREADS >= topk.slice_words(chunk, epw)
    keys = _keys(flat)
    sel = range(rows) if emulate_rows is None else emulate_rows
    vals, idx = [], []
    for row in sel:
        lists = [_block_list(flat, keys, row, V, k, p * chunk, min(V, (p + 1) * chunk), geo["wpt"], epw)
                 for p in range(parts)]
        if parts == 1:
            res = lists[0]
        else:
            res = [0] * k
            for a, lst in enumerate(lists):
                for p, w in enumerate(lst):
                    if w == 0:
                        continue
                    r = sum(_count_greater(lists[b], w, k) for b in range(parts))
                    assert _count_greater(lists[a], w, k) == p
                    if r < k:
                        res[r] = w
        assert all(w != 0 for w in res)
        w = np.array(res, dtype=np.uint64)
        key = (w >> np.uint64(32)).astype(np.uint64)
        bits = np.where(key & 0x80000000, key & 0x7FFFFFFF, ~key & 0xFFFFFFFF).astype(np.uint32)
        vals.append(bits.view(np.float32))
        idx.append((np.uint64(0xFFFFFFFF) - (w & np.uint64(0xFFFFFFFF))).astype(np.int32))
    vals = np.stack(vals)
    return (vals.astype(ml_dtypes.bfloat16) if dt == torch.bfloat16 else vals), np.stack(idx)


def _plain(x: np.ndarray, k: int):
    xt = torch.from_numpy(x.astype(np.float32)).to(torch.bfloat16) if x.dtype == ml_dtypes.bfloat16 \
        else torch.from_numpy(x)
    v, i = topk.topk_plain(xt.reshape(-1, x.shape[-1]), k)
    return v.float().numpy(), i.numpy()


def _rows(kind: str, rows: int, V: int, seed: int, dtype) -> np.ndarray:
    rng = np.random.default_rng(seed)
    if kind == "random":
        x = rng.normal(size=(rows, V)).astype(np.float32)
    elif kind == "ties":
        x = rng.integers(-3, 3, size=(rows, V)).astype(np.float32)
    elif kind == "neg_inf":
        x = np.full((rows, V), -np.inf, np.float32)
        x[min(1, rows - 1), V // 3] = 1.0
        x[-1, ::7] = 0.5
    else:  # crowded: the entries of one thread of a block share a value band
        i = np.arange(V, dtype=np.float32)
        x = np.broadcast_to((i % 1024) // 4 + i * 1e-6, (rows, V)).astype(np.float32)
    return x.astype(dtype)


K3_CASES = [  # (kind, rows, V, k, dtype)
    ("random", 3, 256, 32, np.float32), ("random", 2, 289, 17, np.float32), ("random", 4, 999, 10, np.float32),
    ("random", 2, 10000, 8, np.float32), ("random", 2, 10000, 15, ml_dtypes.bfloat16),
    ("random", 2, 10872, 15, np.float32), ("random", 2, topk.MAX_V, 32, np.float32),
    ("random", 2, topk.MAX_V, 1, ml_dtypes.bfloat16), ("random", 3, 257, 1, ml_dtypes.bfloat16),
    ("ties", 3, 10000, 16, np.float32), ("ties", 3, 999, 32, ml_dtypes.bfloat16), ("ties", 2, 256, 8, np.float32),
    ("neg_inf", 3, 10000, 12, np.float32), ("neg_inf", 3, 289, 17, ml_dtypes.bfloat16),
    ("crowded", 2, 10000, 32, np.float32), ("crowded", 2, 10000, 15, ml_dtypes.bfloat16),
    ("crowded", 2, 2048, 32, np.float32),
]


@pytest.mark.parametrize("kind,rows,V,k,dtype", K3_CASES,
                         ids=[f"{c[0]}-{c[1]}x{c[2]}-k{c[3]}-{np.dtype(c[4]).name}" for c in K3_CASES])
def test_k3_emulation_matches_plain_and_lax(kind, rows, V, k, dtype):
    """Bit for bit, values and indices, against the plain version and
    `lax.top_k`; k = 1, 8, 15, 17, 32 over V = 256 to MAX_V."""
    x = _rows(kind, rows, V, 7, dtype)
    v, i = _emulate_k3(x, k)
    v0, i0 = _plain(x, k)
    np.testing.assert_array_equal(i, i0)
    np.testing.assert_array_equal(v.astype(np.float32), v0)
    v1, i1 = jax.lax.top_k(jnp.asarray(x), k)
    np.testing.assert_array_equal(i, np.asarray(i1))
    np.testing.assert_array_equal(v.astype(np.float32), np.asarray(v1).astype(np.float32))


@pytest.mark.parametrize("kind,V,k,dtype", [("random", 999, 10, np.float32), ("neg_inf", 300, 4, np.float32),
                                            ("ties", 1000, 32, np.float32), ("random", 600, 7, ml_dtypes.bfloat16)])
def test_k3_emulation_matches_topk_pallas(kind, V, k, dtype):
    x = _rows(kind, 3, V, 11, dtype)
    v, i = _emulate_k3(x, k)
    v2, i2 = topk_pallas(jnp.asarray(x), k)
    np.testing.assert_array_equal(i, np.asarray(i2))
    np.testing.assert_array_equal(v.astype(np.float32), np.asarray(v2).astype(np.float32))


@pytest.mark.parametrize("shape,k", [((18, 10, 10000), 15), ((18, 10000), 8), ((18, 10, 999), 10), ((18, 289), 17),
                                     ((18, 17, 10000), 25), ((18, 10, 10872), 15)])
@pytest.mark.parametrize("dtype", [np.float32, ml_dtypes.bfloat16])
def test_k3_emulation_at_the_main_path_geometry(shape, k, dtype):
    """At the geometry of the main paths' full calls (18 or 180 rows: one,
    two or eight blocks a row), the first rows of the call."""
    rng = np.random.default_rng(3)
    V = shape[-1]
    rows = int(np.prod(shape[:-1]))
    x = rng.normal(size=(3, V)).astype(np.float32)
    x = (x - np.log(np.exp(x).sum(-1, keepdims=True))).astype(dtype)
    v, i = _emulate_k3(x, k, rows_for_geometry=rows)
    v0, i0 = _plain(x, k)
    np.testing.assert_array_equal(i, i0)
    np.testing.assert_array_equal(v.astype(np.float32), v0)


def _beam_shapes():
    """(name, rows, V, k) of every K3 call the shipped configurations make
    at B = 18, each once: the CTC beam (B, V) k = W, the attention
    pre-selection (B, W, V) k = 1.5 W, the ALSD expansion (B, W, V - 1)
    k = W, the pool (B, W^2) k = W; W = the config's beam width, 17 and 21."""
    out, seen = [], set()
    for path in sorted(glob.glob(os.path.join(REPO, "configs", "*", "*.yaml"))):
        if os.sep + "lm" + os.sep in path:
            continue
        cfg = load_config(path)
        V = getattr(cfg, "vocab_size", 0)
        if not V:
            continue
        name = os.path.relpath(path, REPO)
        for W in sorted({max(cfg.beam_width, 1), 17, 21}):
            for rows, v, k in ((18, V, W), (18 * W, V, W + W // 2), (18 * W, V - 1, W), (18, W * W, W)):
                if k <= topk.MAX_K and v >= 256 and (rows, v, k) not in seen:
                    seen.add((rows, v, k))
                    out.append((f"{name} W={W} ({rows},{v}) k={k}", rows, v, k))
    return out


@pytest.mark.parametrize("name,rows,V,k", _beam_shapes())
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_k3_launch_geometry_fits_the_kernel(name, rows, V, k, dtype):
    """1 to 8 blocks a row (a portable cluster), a slice's words within
    the threads' WPT words, at most 32 keys a thread, at most k x 32
    candidates a block (the kernel's buffer), the grid within CUDA's
    limits, at least one block an SM where rows are few."""
    geo = topk.launch_geometry(rows, V, k, dtype)
    epw = 16 // torch.tensor([], dtype=dtype).element_size()
    assert geo["parts"] in (1, 2, 4, 8) and 1 <= geo["wpt"] <= topk.MAX_KEYS // epw
    assert topk.slice_words(geo["chunk"], epw) <= geo["wpt"] * topk.THREADS
    assert geo["candidates"] <= KMAX_CAND and geo["blocks"] < 2 ** 31
    assert geo["chunk"] * geo["parts"] >= V > geo["chunk"] * (geo["parts"] - 1)
    if rows * 8 <= topk.SMS and V >= 8 * topk.MIN_CHUNK:
        assert geo["parts"] == 8


def test_k3_geometry_refuses_what_the_kernel_cannot_take():
    with pytest.raises(ValueError):
        topk.launch_geometry(1, topk.MAX_V + 1, 8, torch.float32)
    with pytest.raises(ValueError):
        topk.launch_geometry(1, 1000, 33, torch.float32)
    assert topk.launch_geometry(1, topk.MAX_V, 32, torch.float32)["parts"] == 8


# ---------------------------------------------------------------- K2

def _lse3(a, b, c):
    """The kernel's lse3 on float64 carries: the largest term (by the order
    of the values as float32) as exp(0) = 1, the other two exponentials and
    the logarithm of float32 differences."""
    ab = a.float() >= b.float()
    hi, lo = torch.where(ab, a, b), torch.where(ab, b, a)
    hc = hi.float() >= c.float()
    m, mid = torch.where(hc, hi, c), torch.where(hc, c, hi)
    return m + torch.log1p(torch.exp((lo - m).float()) + torch.exp((mid - m).float())).double()


def _lanes(x: torch.Tensor, slots: int, fill: float) -> torch.Tensor:
    """(B, S) -> (B, slots), states past S at `fill`."""
    B, S = x.shape
    return torch.cat([x, x.new_full((B, slots - S), fill)], 1)


def _emulate_k2(lp, allow2f, initf, finalf, xlens, g):
    """(ll, grad) of the kernel's layout: SPL consecutive states a thread,
    neighbours from the thread before (alpha) or after (beta); alpha and
    beta carried in float64, the gradient's exponent formed in float64
    before a float32 exp."""
    T, B, S = lp.shape
    geo = ctc_lattice.launch_geometry(S)
    spl, n = geo["spl"], geo["warps"] * 32
    slots = n * spl
    L0 = torch.tensor(LOG_0, dtype=torch.float64)

    def shape(x):
        return x.reshape(x.shape[0], n, spl)

    def before(a):  # (p1, p2): states s0 - 1 and s0 - 2 of each thread
        start = L0.expand(a.shape[0], 1)
        last = a[:, :, spl - 1]
        second = a[:, :, spl - 2] if spl >= 2 else torch.cat([start, a[:, :-1, 0]], 1)
        return torch.cat([start, last[:, :-1]], 1), torch.cat([start, second[:, :-1]], 1)

    def after(d):  # (n1, n2): states s0 + SPL and s0 + SPL + 1
        end = L0.expand(d.shape[0], 1)
        first = d[:, :, 0]
        second = d[:, :, 1] if spl >= 2 else torch.cat([d[:, 1:, 0], end], 1)
        return torch.cat([first[:, 1:], end], 1), torch.cat([second[:, 1:], end], 1)

    lpx = torch.stack([shape(_lanes(lp[t], slots, 0.0)) for t in range(T)]).double()
    live = shape(_lanes(torch.ones(B, S), slots, 0.0)) > 0
    skip = shape(_lanes(allow2f, slots, 0.0)) > 0.5
    skip[:, 0, 0] = False
    if spl >= 2:
        skip[:, 0, 1] = False
    else:
        skip[:, 1, 0] = False
    xl_a = xlens.clamp(1, T)
    a = torch.where(shape(_lanes(initf, slots, 0.0)) > 0.5, lpx[0], L0)
    alphas = [a]
    for t in range(1, T):
        p1, p2 = before(a)
        na = torch.empty_like(a)
        for i in range(spl):
            x1 = a[:, :, i - 1] if i >= 1 else p1
            x2 = a[:, :, i - 2] if i >= 2 else (p1 if i == 1 else p2)
            na[:, :, i] = _lse3(a[:, :, i], x1, torch.where(skip[:, :, i], x2, L0)) + lpx[t][:, :, i]
        a = torch.where((t < xl_a)[:, None, None], na, a)
        alphas.append(a)
    fin = shape(_lanes(finalf, slots, 0.0)) > 0.5
    v = torch.where(live, torch.where(fin, a, L0), torch.tensor(-float("inf"), dtype=torch.float64))
    ll64 = torch.logsumexp(v.reshape(B, -1), 1)

    xl = xlens.clamp(0, T)
    g_b = torch.where(ll64 < LOG_0 / 2, torch.zeros_like(g), g)
    t_live = torch.where(g_b == 0, torch.zeros_like(xl), xl)
    skip2 = shape(_lanes(torch.cat([allow2f, torch.zeros(B, 2)], 1)[:, 2:], slots, 0.0)) > 0.5
    grad = torch.zeros(T, B, slots)
    be = torch.where(live & fin, torch.tensor(0.0, dtype=torch.float64), L0)

    def emit(t, b, bb):
        grad[t, b] = (g_b[b] * torch.exp((alphas[t][b] + bb[0] - ll64[b]).float())).reshape(-1)

    for b in range(B):
        if t_live[b] == 0:
            continue
        bb = be[b:b + 1]
        emit(int(xl[b]) - 1, b, bb)
        for t in range(int(xl[b]) - 2, -1, -1):
            d = torch.where(live[b:b + 1], bb + lpx[t + 1][b:b + 1], L0)
            n1, n2 = after(d)
            nb = torch.empty_like(bb)
            for i in range(spl):
                y1 = d[:, :, i + 1] if i + 1 < spl else n1
                y2 = d[:, :, i + 2] if i + 2 < spl else (n1 if i + 2 == spl else n2)
                nb[:, :, i] = _lse3(d[:, :, i], y1, torch.where(skip2[b:b + 1, :, i], y2, L0))
            bb = nb
            emit(t, b, bb)
    return ll64.float(), grad[:, :, :S]


def _k2_case(seed, B, T, U, V):
    gen = torch.Generator().manual_seed(seed)
    return chip_smoke.lattice_case(torch.device("cpu"), gen, B, T, U, V)


K2_CASES = [("S=21", 5, 50, 10, 7), ("S=257", 4, 60, 128, 64), ("S=1025", 3, 40, 512, 64), ("S=1", 4, 9, 0, 5),
            ("S=257 T=1100", 3, 1100, 128, 64)]


@pytest.mark.parametrize("name,B,T,U,V", K2_CASES, ids=[c[0] for c in K2_CASES])
def test_k2_emulation_matches_plain_and_jax(name, B, T, U, V):
    """ll and its gradient within LATTICE_TOL of the float64 plain version
    and of the JAX kernel; exactly 0 past xlens and on infeasible rows."""
    lp_path, allow2f, initf, finalf, xlens = _k2_case(1, B, T, max(U, 1), V)
    if U == 0:
        lp_path, allow2f, initf, finalf = (x[..., :1].contiguous() for x in (lp_path, allow2f, initf, finalf))
        finalf.fill_(1.0)
    g = torch.randn(B, generator=torch.Generator().manual_seed(2))
    ll, grad = _emulate_k2(lp_path, allow2f, initf, finalf, xlens, g)
    x = lp_path.double().requires_grad_(True)
    ll0 = ctc_lattice.ctc_ll_plain(x, allow2f, initf, finalf, xlens)
    (g0,) = torch.autograd.grad(ll0, x, g.double())
    ok = ll0 > LOG_0 / 2
    assert torch.equal(ok, ll > LOG_0 / 2)
    atol, rtol = chip_smoke.LATTICE_TOL["ll"]
    torch.testing.assert_close(ll[ok].double(), ll0[ok].detach(), atol=atol, rtol=rtol)
    atol, rtol = chip_smoke.LATTICE_TOL["grad"]
    torch.testing.assert_close(grad.double(), g0, atol=atol + rtol * g0.abs().max().item(), rtol=0)
    past = torch.arange(T)[:, None] >= xlens[None, :]
    assert not grad[past].any()
    if U > 0:
        assert not ok[2] and not grad[:, 2].any()
    # the JAX kernel (interpret mode), on the same numbers
    args = [jnp.asarray(t.numpy()) for t in (lp_path.contiguous(), allow2f, initf, finalf)]
    jx = jnp.asarray(xlens.numpy().astype(np.int32))
    ll_j, vjp = jax.vjp(lambda lp: jax_ctc_ll(lp, *args[1:], jx), args[0])
    (g_j,) = vjp(jnp.asarray(g.numpy()))
    ll_j, g_j = torch.from_numpy(np.array(ll_j)), torch.from_numpy(np.array(g_j))
    atol, rtol = chip_smoke.LATTICE_TOL["ll"]
    torch.testing.assert_close(ll[ok], ll_j[ok], atol=atol, rtol=rtol)
    atol, rtol = chip_smoke.LATTICE_TOL["grad"]
    torch.testing.assert_close(grad[:, ok], g_j[:, ok], atol=atol + rtol * g_j.abs().max().item(), rtol=0)


def _ctc_S():
    """(name, S) of every shipped ASR configuration with a CTC or joint-CTC
    head at its largest bucket, S = 2 max tokens + 1."""
    out = []
    for path in sorted(glob.glob(os.path.join(REPO, "configs", "*", "*.yaml"))):
        if os.sep + "lm" + os.sep in path:
            continue
        cfg = load_config(path)
        if not getattr(cfg, "vocab_size", 0) or not getattr(cfg, "enc_hidden_size", 0):
            continue
        out.append((os.path.relpath(path, REPO), 2 * max(cfg.buckets)[1] + 1))
    return out


@pytest.mark.parametrize("name,S", _ctc_S() + [("S=1", 1), ("S=1025", 1025), ("MAX_S", ctc_lattice.MAX_S)],
                         ids=[c[0] for c in _ctc_S()] + ["S=1", "S=1025", "MAX_S"])
def test_k2_launch_geometry_fits_the_kernel(name, S):
    """warps x 32 x SPL states cover S with less than one warp to spare,
    SPL <= 8, the fewest states a thread whose warps fit the chain's cap,
    the backward's block (the chain and two fill warps) within the
    kernels' launch bounds and 1024 threads; L1's S = 257 one state a
    thread in 9 warps."""
    geo = ctc_lattice.launch_geometry(S)
    spl, w = geo["spl"], geo["warps"]
    assert 1 <= spl <= ctc_lattice.MAX_SPL and w * 32 * spl >= S > (w - 1) * 32 * spl
    assert geo["beta_threads"] == 32 * (w + ctc_lattice.FILL_WARPS) <= min(1024, ctc_lattice.max_threads(spl))
    assert w <= ctc_lattice.chain_cap(spl)
    assert spl == 1 or -(-S // (32 * (spl - 1))) > ctc_lattice.chain_cap(spl - 1)  # the fewest states a thread
    if S == 257:
        assert (spl, w) == (1, 9)


def test_k2_geometry_refuses_what_the_kernel_cannot_take():
    with pytest.raises(ValueError):
        ctc_lattice.launch_geometry(ctc_lattice.MAX_S + 1)
    with pytest.raises(ValueError):
        ctc_lattice.launch_geometry(0)


# ---------------------------------------------------------------- tools

@pytest.mark.parametrize("tool,source,variants", [
    ("k3_parts", "topk.cu", {"kernel", "no_load", "load_only", "no_rank", "no_merge", "launch_only"}),
    ("k2_parts", "ctc_lattice.cu", {"kernel", "no_loads", "no_transcendentals", "no_barriers", "no_stores",
                                    "chain_only"}),
])
def test_parts_variants_edit_the_source(tool, source, variants):
    """Each variant of `tools/k3_parts.py` / `tools/k2_parts.py` finds the
    text it edits in this tree's source (it raises otherwise) and changes
    it: the tools still measure the kernels that ship."""
    import importlib.util

    spec = importlib.util.spec_from_file_location(tool, os.path.join(REPO, "tools", f"{tool}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    with open(os.path.join(REPO, "emoasr_tpu_torch", "csrc", source)) as f:
        src = f.read()
    assert mod.profile_of(src) == "current"
    got = mod.variant_sources(src)
    assert set(got) == variants
    assert got["kernel"] == src and all(v != src for k, v in got.items() if k != "kernel")
