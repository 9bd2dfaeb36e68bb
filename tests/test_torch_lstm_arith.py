"""K8's arithmetic (`csrc/lstm_scan.cu`), emulated in PyTorch on the CPU.

K8's products (h_{t-1} w^T forward, d pre_t w and d pre^T h_{t-1}
backward) split each float32 operand into two bf16 terms and keep the
three leading cross products (w_hh as one term where it arrives as bf16):
`_emulate_k8` holds that against the plain versions and the JAX
`lstm_scan_pallas` (interpret mode, jitted) over T = 129 dependent steps at
H up to 1024, and shows that one term misses the float32 forward's
tolerance.  The launch geometry (`ops/lstm_scan.py::launch_geometry`)
must fit sm_90 for every shipped transducer and RNN LM.  The split helpers
and the other kernels' emulations are in `test_torch_kernel_arith.py`.
"""

import functools
import glob
import math
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
import emoasr_tpu.ops.lstm_pallas as jlp
from emoasr_tpu_torch.config import load_config
from emoasr_tpu_torch.ops import lstm_scan
from test_torch_kernel_arith import DTYPES, REPO, TRANSDUCER_CONFIGS, _split

# ---------------------------------------------------------------- K8

def _emulate_k8(x_proj, w_hh, h0, c0, dys, dhT, dcT, terms=lstm_scan.TERMS):
    """((ys, h_T, c_T), (d x_proj, d w_hh, d h0, d c0)) as K8 computes them:
    the f32 carry h_{t-1} and d pre_t split into `terms` bf16 terms, w_hh
    into as many (one where it arrives as bf16), the leading cross products
    (i + j < terms) summed in float32; d w_hh from d pre's terms and the
    stored h_{t-1}'s (one in bf16); the rest as `lstm_fwd_plain` /
    `lstm_bwd_plain`, rounding where they round."""
    dt = x_proj.dtype
    nw = 1 if w_hh.dtype == torch.bfloat16 else terms
    W = _split(w_hh.float(), nw)
    prod = lambda x, others, fn: sum(fn(a, b) for i, a in enumerate(_split(x, terms))
                                     for j, b in enumerate(others) if i + j < terms)
    h, c = h0.to(dt).float(), c0.to(dt).float()
    ys, gates, hcprev = [], [], []
    for t in range(x_proj.shape[1]):
        hcprev.append(torch.cat([h, c], -1).to(dt))
        pre = x_proj[:, t].float() + prod(h, W, lambda a, b: a @ b.t())
        i, f, g, o = pre.chunk(4, -1)
        i, f, g, o = torch.sigmoid(i), torch.sigmoid(f), torch.tanh(g), torch.sigmoid(o)
        gates.append(torch.cat([i, f, g, o], -1).to(dt))
        c = f * c + i * g
        h = o * torch.tanh(c)
        ys.append(h.to(dt))
    fwd = (torch.stack(ys, 1), h.to(dt), c.to(dt))
    T, H = x_proj.shape[1], w_hh.shape[1]
    dh_c, dc_c = dhT.to(dt).float(), dcT.to(dt).float()
    dxp = torch.empty_like(x_proj)
    dw = torch.zeros(4 * H, H)
    for t in range(T - 1, -1, -1):
        gi, gf, gg, go = gates[t].float().chunk(4, -1)
        hc = hcprev[t].float()
        hp, cp = hc[:, :H], hc[:, H:]
        tc = torch.tanh(gf * cp + gi * gg)
        dh = dys[:, t].to(dt).float() + dh_c
        dc = dc_c + dh * go * (1.0 - tc * tc)
        dg = torch.cat([dc * gg * gi * (1.0 - gi), dc * cp * gf * (1.0 - gf),
                        dc * gi * (1.0 - gg * gg), dh * tc * go * (1.0 - go)], -1)
        dxp[:, t] = dg.to(dt)
        dw += prod(dg, _split(hp, 1 if dt == torch.bfloat16 else terms), lambda a, b: a.t() @ b)
        dh_c = prod(dg, W, lambda a, b: a @ b)
        dc_c = dc * gf
    return fwd, (dxp, dw.to(w_hh.dtype), dh_c.to(dt), dc_c.to(dt))


def _k8_case(seed, B, T, H, dtype):
    """numpy-seeded x_proj, w_hh, h0, c0 and cotangents (as
    `chip_smoke.lstm_case` scales them), in `dtype` (w_hh too: in bf16 the
    model's weight)."""
    rng = np.random.default_rng(seed)
    xs = [0.5 * rng.normal(size=(B, T, 4 * H)), rng.normal(size=(4 * H, H)) / np.sqrt(H),
          0.5 * rng.normal(size=(B, H)), 0.5 * rng.normal(size=(B, H)),
          rng.normal(size=(B, T, H)), rng.normal(size=(B, H)), rng.normal(size=(B, H))]
    return [torch.from_numpy(x.astype(np.float32)).to(dtype) for x in xs]


def _hold_k8(got, want, dtype, name, margin=1.0):
    """f32: the outputs within LSTM_FWD_TOL, the gradients within
    LSTM_BWD_TOL, over `margin`; bf16: one bf16 step of each entry and one
    of the largest (d w_hh a quarter of that floor), as on the card."""
    (fwd, bwd), (wfwd, wbwd) = got, want
    names = ("ys", "h_T", "c_T"), ("d x_proj", "d w_hh", "d h0", "d c0")
    if dtype == torch.float32:
        atol, rtol = chip_smoke.LSTM_BWD_TOL
        errs = [chip_smoke._require_close(f"{name} {n}", a, b, chip_smoke.LSTM_FWD_TOL / margin, 0.0)
                for n, a, b in zip(names[0], fwd, wfwd)]
        return errs + [chip_smoke._require_close(f"{name} {n}", a, b, atol / margin, rtol / margin)
                       for n, a, b in zip(names[1], bwd, wbwd)]
    errs = [chip_smoke._require_close_bf16(f"{name} {n}", a, b) for n, a, b in zip(names[0], fwd, wfwd)]
    return errs + [chip_smoke._require_close_bf16(f"{name} {n}", a, b.to(a.dtype),
                                                  floor=chip_smoke.BF16_STEP / (4 if n == "d w_hh" else 1))
                   for n, a, b in zip(names[1], bwd, wbwd)]


@functools.partial(jax.jit)
def _jax_k8_fn(x_proj, w_hh, h0, c0, dys, dhT, dcT):
    (ys, (hT, cT)), vjp = jax.vjp(jlp.lstm_scan_pallas, x_proj, w_hh, h0, c0)
    return (ys, hT, cT), vjp((dys, (dhT, dcT)))


def _jax_k8(x_proj, w_hh, h0, c0, dys, dhT, dcT):
    """((ys, h_T, c_T), (d x_proj, d w_hh, d h0, d c0)) of the JAX
    `lstm_scan_pallas` (interpret mode, jitted) on the same values and
    dtypes."""
    jdt = jnp.bfloat16 if x_proj.dtype == torch.bfloat16 else jnp.float32
    j = lambda t: jnp.asarray(t.float().numpy()).astype(jdt)
    fwd, grads = _jax_k8_fn(*(j(t) for t in (x_proj, w_hh, h0, c0, dys, dhT, dcT)))
    back = lambda x: torch.from_numpy(np.asarray(x).astype(np.float32)).to(x_proj.dtype)
    return tuple(back(y) for y in fwd), tuple(back(g) for g in grads)


K8_SHAPES = [(H, T) for H in (40, 136, 512, 1024) for T in (8, 129)]


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
@pytest.mark.parametrize("H,T", K8_SHAPES)
def test_k8_split_products_match_plain_and_jax(H, T, dtype):
    """The emulated kernels (two bf16 terms a float32 operand, three
    products) against `lstm_fwd_plain` / `lstm_bwd_plain` (f32: within half
    the card's tolerances) and against the JAX `lstm_scan_pallas` kernels
    (interpret mode), forward and backward, over the full T and H (B = 2)."""
    tdt = DTYPES[dtype][0]
    x_proj, w_hh, h0, c0, dys, dhT, dcT = _k8_case(H + T, 2, T, H, tdt)
    got = _emulate_k8(x_proj, w_hh, h0, c0, dys, dhT, dcT)
    ys, hT, cT, gates, hcprev = lstm_scan.lstm_fwd_plain(x_proj, w_hh, h0, c0)
    dxp, dw, dh0, dc0 = lstm_scan.lstm_bwd_plain(gates, hcprev, dys, dhT, dcT, w_hh)
    plain = ((ys, hT, cT), (dxp, dw.to(w_hh.dtype), dh0, dc0))
    _hold_k8(got, plain, tdt, f"K8 {dtype} H={H} T={T} vs plain", margin=2.0)
    _hold_k8(got, _jax_k8(x_proj, w_hh, h0, c0, dys, dhT, dcT), tdt, f"K8 {dtype} H={H} T={T} vs JAX")


def test_k8_split_is_needed():
    """One term (one bf16 product, the float32 operands rounded once) misses
    the float32 forward's tolerance over T = 129 at H = 512: the second
    term carries the float32 carry, not the tolerance."""
    x_proj, w_hh, h0, c0, dys, dhT, dcT = _k8_case(3, 2, 129, 512, torch.float32)
    ys, _, _, _, _ = lstm_scan.lstm_fwd_plain(x_proj, w_hh, h0, c0)
    got = _emulate_k8(x_proj, w_hh, h0, c0, dys, dhT, dcT, terms=1)[0][0]
    with pytest.raises(chip_smoke.CheckFailed):
        chip_smoke._require_close("K8 f32 forward, one term", got, ys, chip_smoke.LSTM_FWD_TOL, 0.0)


def _lstm_shapes():
    """(name, B, T, H) of every shipped transducer's prediction network at
    its largest bucket (T = U + 1) and every shipped RNN LM (its batch, its
    max_seq_len)."""
    import yaml

    out = [(name, B, U1, J) for name, B, _, U1, J, _ in TRANSDUCER_CONFIGS]
    out = [(name, B, U1, load_config(os.path.join(REPO, name)).dec_hidden_size) for name, B, U1, _ in out]
    for path in sorted(glob.glob(os.path.join(REPO, "configs", "lm", "*.yaml"))):
        with open(path) as f:
            cfg = yaml.safe_load(f)
        if cfg.get("lm_type") == "rnn":
            out.append((os.path.relpath(path, REPO), cfg["batch_size"], cfg["max_seq_len"], cfg["hidden_size"]))
    return out


LSTM_SHAPES = _lstm_shapes()
LSTM_WIDTHS = [(f"H={H} B={B}", B, 129, H) for H in (1, 40, 136, 512, 640, 1024) for B in (1, 17, 50)]


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
@pytest.mark.parametrize("name,B,T,H", LSTM_SHAPES + LSTM_WIDTHS, ids=[c[0] for c in LSTM_SHAPES + LSTM_WIDTHS])
def test_k8_launch_geometry_fits(name, B, T, H, dtype):
    """Both kernels' shared memory within the 232,448 bytes of a block on
    sm_90, one block an SM and at most 132 blocks (the H100's SMs, all
    co-resident), w_hh's first term within 64 registers a thread, at least
    one ring stage and no more than the warp's K slice has chunks; H = 512
    takes four units a block forward, one m16 tile of gate rows."""
    tdt = DTYPES[dtype][0]
    geo = lstm_scan.launch_geometry(B, T, H, tdt)
    Hp = geo["Hp"]
    assert Hp % 128 == 0 and H <= Hp < H + 128 and geo["w_terms"] == (1 if dtype == "bfloat16" else 2)
    for kind in ("fwd", "bwd"):
        g = geo[kind]
        assert g["smem"] == lstm_scan.smem_bytes(kind, B, H, g["units"], g["stages"], geo["w_terms"])
        assert g["smem"] <= lstm_scan.MAX_SMEM, (kind, g)
        assert g["blocks"] == math.ceil(H / g["units"]) <= 132 and g["w_registers"] <= 64
        assert 1 <= g["stages"] <= min(Hp // 128, lstm_scan.MAX_STAGES)
    assert geo["fwd"]["units"] == (4 if Hp <= 512 else 8) and geo["bwd"]["units"] == 8
    assert geo["scratch"]["dpre"] == (T, B, 4 * Hp) and geo["dw"]["grid"] == (4 * Hp // 64, Hp // 64)
    if H == 512:
        assert geo["fwd"]["blocks"] == 128 and geo["fwd"]["units"] == 4
    with pytest.raises(ValueError):
        lstm_scan.launch_geometry(B, T, 1025, tdt)


def test_k8_parts_variants_edit_the_source():
    """Each variant of `tools/k8_parts.py` finds the text it edits in this
    tree's K8 source (it raises otherwise) and changes it: the tool still
    measures the kernel that ships."""
    import sys

    sys.path.insert(0, os.path.join(REPO, "tools"))
    import k8_parts

    with open(os.path.join(REPO, "emoasr_tpu_torch", "csrc", "lstm_scan.cu")) as f:
        src = f.read()
    variants = k8_parts.variant_sources(src)
    assert set(variants) == {"kernel", "no_products", "no_split", "no_broadcast", "no_cell", "barrier_only"}
    assert variants["kernel"] == src and all(v != src for k, v in variants.items() if k != "kernel")
