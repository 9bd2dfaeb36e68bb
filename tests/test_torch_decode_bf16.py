"""bf16 decoding in the port (`compute_dtype: bfloat16`: the weights cast
once, bf16 activations and caches, float32 search scores) against the JAX
package's, on the CPU, with the same numpy-seeded weights and inputs.

- (a) The plain versions of K5 (direct and ancestor-indirect) and K6 in
  bf16, what CPU tensors take, against the JAX kernels in Pallas interpret
  mode.  Both round where the JAX kernels round (every dense product once
  to bf16 after its f32 bias, bf16 residual adds, p and each head's output
  rounded), so an entry differs where two f32 sums taken in other orders
  straddle a rounding boundary: each entry within one bf16 step (2^-7) of
  itself, plus a floor of one step of the tensor's largest entry for
  entries downstream of such a step.  That is never looser than the JAX
  package's own bf16 kernel tests (0.06 and 0.08 absolute).
- (b) The L3-1 joint-CTC attention beam (every `dec_step_mode`) and, with
  a bf16 LM fused (K6 and the dense route), L3-3, through
  `build_decode_fn` on both sides; (c) the L1 CTC prefix beam and the L4
  ALSD beam, the same way.  The JAX package's own bf16 decode lies some
  way from its float32 decode, and its flax Dense rounds a bf16 product
  and its bias twice where the port's `nn.Linear` rounds once, so the
  port's scores are held within twice the JAX bf16 decode's distance from
  the JAX float32 decode, plus one bf16 step of the largest score (as
  `test_torch_train.py::assert_bf16_micro_step_matches_jax` holds a bf16
  micro-step); one decoder step's log-probabilities the same way; the
  hypotheses and their lengths must be equal.
- (d) The plain K7 at J = 1024 and K8 at H = 640, widths above what the
  CUDA kernels took before, in float32 and bf16, against the JAX kernels
  in interpret mode (their tolerances are those of `test_torch_rnnt_ops.py`,
  `test_torch_lstm.py` and `test_torch_bf16.py`, stated beside each check).

Sizes: decoder layer D = 64, 4 heads, F = 128, W = 5; LM layer D = 32,
F = 64, W = 4 and 10; the decode models as `test_torch_attention_beam.py`
(1 Conformer layer, 2 decoder layers of width 32, V = 50), the LM as
`test_torch_lm_fusion.py`, L1 as `test_torch_encoder.py` (2 Transformer
layers of width 32, V = 300), L4 as `test_torch_rnnt.py`.
"""

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

import emoasr_tpu.ops.lstm_pallas as jlp
import emoasr_tpu.ops.rnnt_pallas as jrp
from emoasr_tpu.config import config_from_dict as jax_config
from emoasr_tpu.eval.decode import build_decode_fn as jax_build_decode_fn
from emoasr_tpu.models.asr import ASR as JaxASR
from emoasr_tpu.models.layers import TransformerDecoderLayer as JaxDecoderLayer
from emoasr_tpu.models.layers import make_pad_mask as jax_pad_mask
from emoasr_tpu.models.lm import bert as jax_bert
from emoasr_tpu.ops import decoder_step_pallas as jdsp
from emoasr_tpu.ops import lm_step_pallas as jls
from emoasr_tpu.search.common import make_lm_fusion as jax_make_lm_fusion
from emoasr_tpu.train.step import preprocess as jax_preprocess
from emoasr_tpu.utils.precision import cast_floating as jax_cast_floating
from emoasr_tpu_torch.eval.decode import build_decode_fn
from emoasr_tpu_torch.models.layers import make_pad_mask
from emoasr_tpu_torch.models.lm import bert
from emoasr_tpu_torch.ops import decoder_step as ds
from emoasr_tpu_torch.ops import lm_step, lstm_scan, rnnt_joint, topk
from emoasr_tpu_torch.search.common import make_lm_fusion
from emoasr_tpu_torch.train.step import preprocess
from emoasr_tpu_torch.utils.precision import cast_floating
from test_torch_attention_beam import BASE as L3_BASE
from test_torch_attention_beam import _batch as l3_batch
from test_torch_attention_beam import _weights as l3_weights
from test_torch_conformer import port_model as l3_port_model
from test_torch_decoder import _layer_case, _port_layer
from test_torch_encoder import SMALL as L1_SMALL
from test_torch_encoder import port_model as l1_port_model
from test_torch_encoder import random_flax_params as l1_params
from test_torch_lm import LM_SMALL, lm_pair
from test_torch_lm_step import _case as lm_case
from test_torch_lm_step import _port_layer as lm_port_layer
from test_torch_rnnt import RNNT_SMALL, random_rnnt_params
from test_torch_rnnt import port_model as rnnt_port_model

T_ = torch.from_numpy
ULP = 2.0 ** -7  # one bf16 step, relative to the value
DEAD_CUT = -1e29
BF16 = torch.bfloat16


def _f32(x) -> np.ndarray:
    """A torch tensor or JAX array of any float type, as float32 numpy."""
    if torch.is_tensor(x):
        return x.detach().float().numpy()
    return np.asarray(x).astype(np.float32)


def _bf16(x: np.ndarray) -> np.ndarray:
    """x rounded to bf16, kept as float32."""
    return np.asarray(x, np.float32).astype(ml_dtypes.bfloat16).astype(np.float32)


def _jbf(x):
    return jnp.asarray(_bf16(x)).astype(jnp.bfloat16)


def _close_bf16(got, want, name="", floor=ULP):
    """Within one bf16 step of each entry, plus `floor` times the largest."""
    g, w = _f32(got), _f32(want)
    np.testing.assert_allclose(g, w, rtol=ULP, atol=floor * np.abs(w).max() + 1e-30, err_msg=name)


# ------------------------------------------------------------ (a) K5 and K6

def _k5_bf16_case(seed, uniform_pos=False):
    """One layer's weights, cast to bf16 on both sides, and one step's
    bf16 inputs; the encoder K/V are the JAX layer's bf16 projection."""
    params, inp, dims = _layer_case(seed, uniform_pos=uniform_pos)
    H, D, F, Bu, W, Lmax, T, N, dk = dims
    jparams = jax_cast_floating(jax.tree_util.tree_map(jnp.asarray, params), jnp.bfloat16)
    jlayer = JaxDecoderLayer(H, D, F, 0.0, 0.0)
    jcross = jlayer.apply({"params": jparams}, _jbf(inp["memory"]), method=JaxDecoderLayer.compute_cross_kv)
    jw = jlayer.apply({"params": jparams}, method=JaxDecoderLayer._decode_step_weights)
    layer = cast_floating(_port_layer(params, H, D, F), BF16)
    port = dict(h=T_(_bf16(inp["h"])).to(BF16), ck=T_(_bf16(inp["ck"])).to(BF16),
                cv=T_(_bf16(inp["cv"])).to(BF16), cross=[T_(_f32(x)).to(BF16) for x in jcross],
                pos=T_(inp["pos"]), anc=T_(inp["anc"]), elens=T_(inp["elens"]))
    jax_in = dict(h=_jbf(inp["h"]), ck=_jbf(inp["ck"]), cv=_jbf(inp["cv"]), cross=jcross,
                  pos=jnp.asarray(inp["pos"]), anc=jnp.asarray(inp["anc"]), elens=jnp.asarray(inp["elens"]))
    return layer, jw, port, jax_in, dims


def test_decoder_step_plain_bf16_matches_jax_kernel():
    """K5 (direct caches) in bf16: y, k_new and v_new, all bf16."""
    layer, jw, t, j, (H, D, F, Bu, W, Lmax, T, N, dk) = _k5_bf16_case(11)
    ref = jdsp.fused_decoder_layer_step(
        j["h"], j["ck"].reshape(N, Lmax, H, dk), j["cv"].reshape(N, Lmax, H, dk), j["pos"].reshape(N),
        j["cross"][0], j["cross"][1], j["elens"], jw, beam_width=W, interpret=True)
    with torch.no_grad():
        got = ds.fused_decoder_layer_step(
            t["h"], t["ck"].reshape(N, Lmax, H, dk), t["cv"].reshape(N, Lmax, H, dk), t["pos"].reshape(N).long(),
            t["cross"][0], t["cross"][1], t["elens"], layer._decode_step_weights(), beam_width=W)
    for name, a, b in zip(("y", "k_new", "v_new"), got, ref):
        assert a.dtype == BF16 and b.dtype == jnp.bfloat16, name
        _close_bf16(a, b, f"K5 bf16 {name}")
    assert ds.KERNEL.launches == 0


@pytest.mark.parametrize("uniform", [False, True])
def test_decoder_step_indirect_plain_bf16_matches_jax_kernel(uniform):
    """K5 indirect in bf16, with per-row and per-utterance `pos`."""
    layer, jw, t, j, (H, D, F, Bu, W, Lmax, T, N, dk) = _k5_bf16_case(12 + uniform, uniform)
    ref = jdsp.fused_decoder_layer_step_indirect(
        j["h"], j["ck"], j["cv"], j["pos"], j["anc"], j["cross"][0], j["cross"][1], j["elens"], jw,
        beam_width=W, interpret=True)
    with torch.no_grad():
        got = ds.fused_decoder_layer_step_indirect(
            t["h"], t["ck"], t["cv"], t["pos"].long(), t["anc"], t["cross"][0], t["cross"][1], t["elens"],
            layer._decode_step_weights(), beam_width=W)
    for name, a, b in zip(("y", "k_new", "v_new"), got, ref):
        assert a.dtype == BF16 and b.dtype == jnp.bfloat16, name
        _close_bf16(a, b, f"K5 indirect bf16 {name}")
    assert ds.KERNEL_INDIRECT.launches == 0


@pytest.mark.parametrize("Bu,W,L,H,D,F", [(2, 4, 9, 2, 32, 64), (2, 10, 12, 2, 16, 40)])
def test_lm_step_plain_bf16_matches_jax_kernel(Bu, W, L, H, D, F):
    """K6 in bf16: y, k_new and v_new; gelu in f32 between two roundings."""
    c = lm_case(Bu * 100 + W + 7, Bu, W, L, H, D, F)
    w16 = {k: _bf16(v) for k, v in c["w"].items()}
    ref = jls.fused_bert_layer_step_indirect(
        _jbf(c["h"]), _jbf(c["ck"]), _jbf(c["cv"]), jnp.asarray(c["pos"]), jnp.asarray(c["anc"]),
        {k: jnp.asarray(v).astype(jnp.bfloat16) for k, v in w16.items()}, interpret=True)
    layer = cast_floating(lm_port_layer(c["w"], H, D, F), BF16)
    args = [T_(_bf16(c[k])).to(BF16) for k in ("h", "ck", "cv")] + [T_(c["pos"]), T_(c["anc"])]
    with torch.no_grad():
        got = lm_step.fused_bert_layer_step_indirect(*args, layer._step_weights())
        dense, _, _ = layer.step_indirect(args[0], args[1].clone(), args[2].clone(), args[3].long(), args[4])
    for name, a, b in zip(("y", "k_new", "v_new"), got, ref):
        assert a.dtype == BF16 and b.dtype == jnp.bfloat16, name
        _close_bf16(a, b, f"K6 bf16 {name}")
    assert dense.dtype == BF16 and lm_step.KERNEL.launches == 0


# --------------------------------------------------------- (b), (c) decodes

def _hold_decode(got, ref16, ref32, name):
    """The live scores, rank by rank, within twice the JAX bf16 decode's
    distance from the JAX f32 decode's, plus one bf16 step of the largest
    score.  Hypotheses: beams whose scores lie within that bound of each
    other may trade ranks, and where the JAX bf16 decode turns a best
    hypothesis away from its own f32 one the port may keep the f32 one, so
    each utterance's best hypothesis (and its length) must be the JAX bf16
    decode's or the JAX f32 decode's."""
    hyps, lens, scores = (np.asarray(x) for x in ref16)
    g_hyps, g_lens, g_scores = (x.numpy() for x in got)
    s32 = np.asarray(ref32[2])
    live = scores > DEAD_CUT
    np.testing.assert_array_equal(g_scores > DEAD_CUT, live, err_msg=name)
    assert g_scores.dtype == np.float32, name
    noise = np.abs(scores[live] - s32[live]).max()
    tol = 2 * noise + ULP * np.abs(s32[live]).max()
    np.testing.assert_allclose(g_scores[live], scores[live], rtol=0, atol=tol, err_msg=name)
    for b in range(len(g_lens)):
        best = g_hyps[b, 0, :g_lens[b, 0]].tolist()
        refs = [np.asarray(r[0])[b, 0, :np.asarray(r[1])[b, 0]].tolist() for r in (ref16, ref32)]
        assert best in refs, (name, b, best, refs)
    return noise


def _jax_pair(conf, variables, beam, len_w, ctc_w, lm=None, top1=False):
    """The JAX decode functions under bf16 and float32."""
    fns = {}
    for dt in ("bfloat16", "float32"):
        jcfg = jax_config(dict(conf, compute_dtype=dt))
        fns[dt] = jax_build_decode_fn(JaxASR(jcfg), variables, jcfg, beam, len_w, ctc_w,
                                      lm=None if lm is None else lm(dt), top1=top1)
    return fns


@pytest.mark.parametrize("mode", ["dense", "fused", "indirect", "fused_indirect"])
def test_l3_1_bf16_beam_matches_jax(mode):
    """L3-1's operating point (joint CTC 0.3, length weight 2, beam 4,
    `enc_fused_attn` on) in bf16, each step route; then one decoder step
    (every layer, the output layer and its log-softmax) of the route."""
    params, stats = l3_weights(3.0)
    conf = dict(L3_BASE, dec_step_mode=mode, enc_fused_attn=True)
    xs, xlens = l3_batch()
    jfns = _jax_pair(conf, {"params": params, "batch_stats": stats}, 4, 2.0, 0.3)
    refs = {dt: fn(jnp.asarray(xs), jnp.asarray(xlens)) for dt, fn in jfns.items()}
    model = l3_port_model(dict(conf, compute_dtype="bfloat16"), params, stats)
    fn = build_decode_fn(model, model.cfg, 4, 2.0, 0.3, device="cpu")
    assert next(model.parameters()).dtype == BF16
    got = fn(xs, xlens)
    assert (got[2][:, 0] > DEAD_CUT).all()
    _hold_decode(got, refs["bfloat16"], refs["float32"], f"L3-1 bf16 {mode}")
    assert ds.KERNEL.launches == 0 and ds.KERNEL_INDIRECT.launches == 0 and topk.KERNEL.launches == 0


def _step_inputs():
    """One cached decoder step of every beam at position 3: tokens, pos, an
    ancestor table with anc[b, w, 3] = w, and per-layer caches of values
    bf16 holds exactly (B = 3, W = 4, Lc = 8, the decoder of L3_BASE)."""
    rng = np.random.default_rng(31)
    B, W, Lc, H, dk, V = 3, 4, 8, 4, 8, 50
    anc = rng.integers(0, W, size=(B, W, Lc))
    anc[:, :, 3] = np.arange(W)[None, :]
    caches = [[_bf16(rng.normal(size=(B, W, Lc, H, dk))) for _ in range(2)] for _ in range(2)]
    return rng.integers(3, V, size=(B * W,)), np.full((B, W), 3), anc.astype(np.int32), caches, (B, W, Lc, H, dk, V)


def _jax_step_logp(variables, conf, dtype, mode):
    """The JAX decoder step's log-probabilities (B, W, V), float32 numpy, on
    the JAX model's own encoder output, under `compute_dtype: dtype`."""
    toks, pos, anc, caches, (B, W, Lc, H, dk, V) = _step_inputs()
    xs, xlens = l3_batch(2)
    jcfg = jax_config(dict(conf, compute_dtype=dtype))
    jm = JaxASR(jcfg)
    half = dtype == "bfloat16"
    v = jax_cast_floating(variables, jnp.bfloat16) if half else variables
    x, xl = jax_preprocess(jcfg, jnp.asarray(xs), jnp.asarray(xlens), None, False)
    eo, el, _ = jm.apply(v, x.astype(jnp.bfloat16) if half else x, xl, method=JaxASR.encode)
    cross = jm.apply(v, eo, method=lambda m, e: m.decoder.precompute_cross_kv(e))
    emask = jax_pad_mask(el, eo.shape[1])[:, None, None, :]
    jc = [tuple(jnp.asarray(c).astype(jnp.bfloat16 if half else jnp.float32) for c in kv) for kv in caches]
    if mode in ("indirect", "fused_indirect"):
        logits, _ = jm.apply(v, jnp.asarray(toks), jnp.asarray(pos), jc, jnp.asarray(anc), cross, emask,
                             method=lambda m, *a: m.decoder.decode_step_cached_indirect(
                                 *a, beam_width=W, step_mode=mode, elens=el))
    else:
        jc = [tuple(c.reshape(B * W, Lc, H, dk) for c in kv) for kv in jc]
        logits, _ = jm.apply(v, jnp.asarray(toks), jnp.asarray(pos).reshape(-1), jc, cross, emask,
                             method=lambda m, *a: m.decoder.decode_step_cached(
                                 *a, beam_width=W, step_mode=mode, elens=el))
    return np.asarray(jax.nn.log_softmax(logits.astype(jnp.float32), -1)).reshape(B, W, V)


def _port_step_logp(model, mode):
    """The same step through the port's bf16 model (the plain versions)."""
    toks, pos, anc, caches, (B, W, Lc, H, dk, V) = _step_inputs()
    xs, xlens = l3_batch(2)
    dec = model.decoder
    with torch.no_grad():
        x, xl = preprocess(model.cfg, T_(xs).to(BF16), T_(xlens).long())
        eo, el, _ = model.encode(x, xl)
        cross = dec.precompute_cross_kv(eo)
        emask = make_pad_mask(el, eo.shape[1])[:, None, None, :]
        tc = [tuple(T_(c).to(BF16) for c in kv) for kv in caches]
        el32 = el.to(torch.int32)
        if mode in ("indirect", "fused_indirect"):
            logits, _ = dec.decode_step_cached_indirect(T_(toks), T_(pos), tc, T_(anc), cross, emask,
                                                        beam_width=W, step_mode=mode, elens=el32)
        else:
            tc = [tuple(c.reshape(B * W, Lc, H, dk) for c in kv) for kv in tc]
            logits, _ = dec.decode_step_cached(T_(toks), T_(pos).reshape(-1), tc, cross, emask,
                                               beam_width=W, step_mode=mode, elens=el32)
    return torch.log_softmax(logits.float(), -1).numpy().reshape(B, W, V)


@pytest.mark.parametrize("mode", ["dense", "fused", "indirect", "fused_indirect"])
def test_l3_1_bf16_decoder_step_matches_jax(mode):
    """One bf16 decoder step's log-probabilities within twice the JAX bf16
    step's distance from its f32 step, plus one bf16 step of the largest."""
    params, stats = l3_weights(3.0)
    conf = dict(L3_BASE, dec_step_mode=mode, enc_fused_attn=True)
    variables = {"params": params, "batch_stats": stats}
    j16 = _jax_step_logp(variables, conf, "bfloat16", mode)
    j32 = _jax_step_logp(variables, conf, "float32", mode)
    model = cast_floating(l3_port_model(dict(conf, compute_dtype="bfloat16"), params, stats), BF16)
    got = _port_step_logp(model, mode)
    noise = np.abs(j16 - j32).max()
    assert noise < 0.5, noise
    np.testing.assert_allclose(got, j16, rtol=0, atol=2 * noise + ULP * np.abs(j32).max(), err_msg=mode)


@pytest.fixture(scope="module")
def lms():
    return lm_pair(dict(LM_SMALL, vocab_size=56), seed=21)


@pytest.mark.parametrize("fused_lm", [True, False])
def test_l3_3_bf16_beam_with_bf16_lm_matches_jax(lms, monkeypatch, fused_lm):
    """L3-3: L3-1's decode (`fused_indirect`) with the LM cast to bf16 and
    fused at 0.5, its layer step by K6 (plain version) or by the dense
    route, as `bench.py` reaches it (`make_lm_fusion(cast_floating(lm,
    bf16), 0.5)`); the LM's caches follow its parameters' dtype."""
    jm, jv, port = lms
    params, stats = l3_weights(-2.0, seed=24)
    conf = dict(L3_BASE, max_decode_ylen=12, decode_len_cap="on", dec_step_mode="fused_indirect")
    monkeypatch.setattr(jax_bert, "FUSED_INDIRECT_STEP", fused_lm)
    monkeypatch.setattr(bert, "FUSED_INDIRECT_STEP", fused_lm)
    lm_of = lambda dt: jax_make_lm_fusion(jm, jv if dt == "float32" else jax_cast_floating(jv, jnp.bfloat16), 0.5)
    jfns = _jax_pair(conf, {"params": params, "batch_stats": stats}, 3, 0.3, 0.3, lm=lm_of)
    xs, xlens = l3_batch(25)
    refs = {dt: fn(jnp.asarray(xs), jnp.asarray(xlens)) for dt, fn in jfns.items()}
    model = l3_port_model(dict(conf, compute_dtype="bfloat16"), params, stats)
    lm16 = cast_floating(port, BF16)
    fusion = make_lm_fusion(lm16, 0.5)
    assert fusion.indirect.init_states(1, 1, 2)["caches"][0][0].dtype == BF16
    fn = build_decode_fn(model, model.cfg, 3, 0.3, 0.3, lm=fusion, device="cpu")
    got = fn(xs, xlens)
    _hold_decode(got, refs["bfloat16"], refs["float32"], f"L3-3 bf16, LM fused={fused_lm}")
    assert int(got[1].max()) > 8 and lm_step.KERNEL.launches == 0


def test_l1_bf16_ctc_beam_matches_jax():
    """L1's CTC prefix beam (width 8, length weight 0.5) in bf16: the
    encoder and the CTC head in bf16, the log-softmax and the search f32."""
    params = l1_params(L1_SMALL, seed=4)
    rng = np.random.default_rng(41)
    xs = rng.normal(size=(3, 45, 20)).astype(np.float32)
    xlens = np.array([45, 30, 17], np.int32)
    jfns = _jax_pair(L1_SMALL, {"params": params}, 8, 0.5, 0.0)
    refs = {dt: fn(jnp.asarray(xs), jnp.asarray(xlens)) for dt, fn in jfns.items()}
    model = l1_port_model(dict(L1_SMALL, compute_dtype="bfloat16"), params)
    fn = build_decode_fn(model, model.cfg, 8, 0.5, 0.0, device="cpu")
    got = fn(xs, xlens)
    assert next(model.parameters()).dtype == BF16
    _hold_decode(got, refs["bfloat16"], refs["float32"], "L1 bf16 CTC beam")
    assert topk.KERNEL.launches == 0


def test_l4_bf16_alsd_beam_matches_jax():
    """L4's ALSD beam (width 4) in bf16 through `build_decode_fn`: the
    encoder, the prediction network and the joint in bf16."""
    conf = dict(RNNT_SMALL, mtl_ctc_weight=0.3)
    params, stats = random_rnnt_params(conf, seed=1)
    rng = np.random.default_rng(6)
    xs = rng.normal(size=(3, 61, 20)).astype(np.float32)
    xlens = np.array([61, 44, 25], np.int32)
    jfns = _jax_pair(conf, {"params": params, "batch_stats": stats}, 4, 0.0, 0.0)
    refs = {dt: fn(jnp.asarray(xs), jnp.asarray(xlens)) for dt, fn in jfns.items()}
    model = rnnt_port_model(dict(conf, compute_dtype="bfloat16"), params, stats)
    fn = build_decode_fn(model, model.cfg, 4, 0.0, 0.0, device="cpu")
    got = fn(xs, xlens)
    _hold_decode(got, refs["bfloat16"], refs["float32"], "L4 bf16 ALSD")
    assert int(got[1].max()) > 1 and topk.KERNEL.launches == 0


# ------------------------------------------------- (d) K7 and K8, any width

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_rnnt_joint_plain_at_j1024_matches_jax_kernel(dtype):
    """K7's plain version at J = 1024 against `fused_joint_gather_fwd`:
    f32 within 1e-4 (sums of 1024 products in two orders, magnitudes of a
    few units); bf16 within 2e-3, where a z that rounds the other way moves
    a logit by ~1e-3 (as `test_torch_bf16.py`), most cells within 1e-5."""
    B, T, U1, J, V = 2, 5, 4, 1024, 40
    rng = np.random.default_rng(13)
    h_enc, h_dec = (_bf16(rng.normal(size=s)) for s in ((B, T, J), (B, U1, J)))
    w = _bf16(rng.normal(size=(J, V)) / np.sqrt(J))
    b = _bf16(0.1 * rng.normal(size=(V,)))
    labels = rng.integers(1, V, size=(B, U1 - 1)).astype(np.int32)
    jdt, tdt = (jnp.float32, torch.float32) if dtype == "float32" else (jnp.bfloat16, BF16)
    kb, kl = jrp.fused_joint_gather_fwd(*(jnp.asarray(a).astype(jdt) for a in (h_enc, h_dec, w, b)),
                                        jnp.asarray(labels), blank_id=0, t_chunk=4, v_chunk=16)
    lpb, lpl = rnnt_joint.fused_joint_gather(*(T_(a).to(tdt) for a in (h_enc, h_dec, w, b)), T_(labels), 0)
    assert lpb.dtype == lpl.dtype == torch.float32
    tol = 1e-4 if dtype == "float32" else 2e-3
    for name, a, r in (("lp_blank", lpb, kb), ("lp_label", lpl, kl)):
        np.testing.assert_allclose(_f32(a), _f32(r), rtol=0, atol=tol, err_msg=name)
        if dtype == "bfloat16":  # most cells agree to float32 noise
            assert np.mean(np.abs(_f32(a) - _f32(r)) <= 1e-5) > 0.9, name
    assert rnnt_joint.KERNEL.launches == 0


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_lstm_scan_plain_at_h640_matches_jax_kernel(dtype):
    """K8's plain versions at H = 640 against `lstm_scan_pallas` (interpret
    mode), outputs and gradients: f32 within 1e-5 of each tensor's largest
    entry + 1e-6 (as `test_torch_lstm.py`); bf16 within one step of each
    entry + 2 steps of the largest (as `test_torch_bf16.py`)."""
    B, T, H = 2, 9, 640
    rng = np.random.default_rng(17)
    xp = _bf16(0.5 * rng.normal(size=(B, T, 4 * H)))
    whh = _bf16(rng.normal(size=(4 * H, H)) / np.sqrt(H))
    h0, c0 = (_bf16(0.5 * rng.normal(size=(B, H))) for _ in range(2))
    cots = [_bf16(rng.normal(size=s)) for s in ((B, T, H), (B, H), (B, H))]
    jdt, tdt = (jnp.float32, torch.float32) if dtype == "float32" else (jnp.bfloat16, BF16)
    jin = [jnp.asarray(a).astype(jdt) for a in (xp, whh, h0, c0)]
    (jys, (jh, jc)), vjp = jax.vjp(jlp.lstm_scan_pallas, *jin)
    jc_ = [jnp.asarray(c).astype(jdt) for c in cots]
    jg = vjp((jc_[0], (jc_[1], jc_[2])))
    tin = [T_(a).to(tdt).requires_grad_(True) for a in (xp, whh, h0, c0)]
    ys, (h, c) = lstm_scan.lstm_scan_fused(*tin)
    tg = torch.autograd.grad((ys, h, c), tin, [T_(a).to(tdt) for a in cots])
    for name, a, r in zip(("ys", "h_T", "c_T", "d x_proj", "d w_hh", "d h0", "d c0"), (ys, h, c, *tg),
                          (jys, jh, jc, *jg)):
        assert a.dtype == tdt, name
        if dtype == "float32":
            want = _f32(r)
            np.testing.assert_allclose(_f32(a), want, rtol=0, atol=1e-5 * np.abs(want).max() + 1e-6, err_msg=name)
        else:
            _close_bf16(a, r, name, floor=2 * ULP)
    assert lstm_scan.KERNEL.launches == 0
