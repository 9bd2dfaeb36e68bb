"""The port's Transformer decoder and its fused layer step against the JAX
package and the emoASR outputs recorded in tests/fixtures_dec_transformer.npz.

Sizes: 2 layers, d=32, 4 heads, FF 64, V=30 or 50; weights and inputs from
numpy seeds.  Tolerances: rtol/atol 1e-4 against the recorded outputs (what
tests/test_decoders.py holds the JAX decoder to); atol 1e-5 against the JAX
modules and between the step routes (f32, the same arithmetic in another
order).  The JAX fused step runs in Pallas interpret mode; the port's runs
its plain versions (CPU tensors), which repeat the kernels term for term."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from emoasr_tpu.config import config_from_dict as jax_config
from emoasr_tpu.models.decoders.transformer import TransformerDecoder as JaxDecoder
from emoasr_tpu.models.layers import TransformerDecoderLayer as JaxDecoderLayer
from emoasr_tpu.models.layers import make_pad_mask as jax_pad_mask
from emoasr_tpu.ops import decoder_step_pallas as jdsp
from emoasr_tpu_torch.config import config_from_dict
from emoasr_tpu_torch.models.asr import ASR
from emoasr_tpu_torch.models.decoders.transformer import TransformerDecoder
from emoasr_tpu_torch.models.layers import make_pad_mask
from emoasr_tpu_torch.ops import decoder_step as ds
from test_torch_conformer import L3_SMALL, port_model, random_l3_params

FIXDIR = os.path.dirname(os.path.abspath(__file__))
TOL = 1e-5

DEC_BASE = dict(
    decoder_type="transformer", vocab_size=30, dec_hidden_size=32, dec_num_attention_heads=4,
    dec_num_layers=2, dec_intermediate_size=64, dropout_dec_rate=0.0, dropout_attn_rate=0.0,
    lsm_prob=0.1, enc_hidden_size=32,
)


def _close(a, b, tol=TOL):
    np.testing.assert_allclose(np.asarray(a, np.float32), np.asarray(b, np.float32), atol=tol, rtol=0)


@pytest.fixture(scope="module")
def weights():
    return random_l3_params(L3_SMALL, seed=3)


def test_decoder_matches_recorded_emoasr_outputs():
    fx = np.load(os.path.join(FIXDIR, "fixtures_dec_transformer.npz"))
    dec = TransformerDecoder(config_from_dict(DEC_BASE)).eval()
    dec.load_state_dict({k[4:]: torch.from_numpy(fx[k]) for k in fx.files if k.startswith("sd::")})
    t = {k: torch.from_numpy(fx[k]) for k in ("eouts", "elens", "ys", "ylens", "ys_in")}
    with torch.no_grad():
        logits = dec(t["eouts"], t["elens"], None, t["ys"], t["ylens"], t["ys_in"])
        U1 = t["ys_in"].shape[1]
        one = dec.forward_one_step(t["ys_in"], torch.full((3,), U1), t["eouts"])
    for b, n in enumerate(fx["ylens"] + 1):  # valid positions
        np.testing.assert_allclose(logits[b, :n].numpy(), fx["logits"][b, :n], rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(one.numpy(), fx["logits_one"], rtol=1e-4, atol=1e-4)
    # with ys_out: the label-smoothed loss and the same logits (the loss is
    # held against JAX in tests/test_torch_att_train.py)
    with torch.no_grad():
        loss, loss_dict, out = dec(t["eouts"], t["elens"], None, t["ys"], t["ylens"], t["ys_in"], t["ys_in"])
    assert torch.equal(out, logits) and set(loss_dict) == {"loss_att", "loss_total"}
    assert torch.isfinite(loss) and loss.item() > 0


def _decoder_pair(weights):
    params, stats = weights
    model = port_model(L3_SMALL, params, stats)
    return JaxDecoder(jax_config(L3_SMALL)), {"params": params["decoder"]}, model.decoder


def _dec_inputs(seed=0, B=3, T=12, U=6, V=50):
    rng = np.random.default_rng(seed)
    eouts = rng.normal(size=(B, T, 32)).astype(np.float32)
    elens = np.array([12, 9, 5], np.int32)
    ys_in = np.concatenate([np.full((B, 1), 2), rng.integers(3, V, size=(B, U))], 1).astype(np.int32)
    ylens = np.array([6, 4, 2], np.int32)
    return eouts, elens, ys_in, ylens


def test_decoder_logits_and_one_step_match_jax(weights):
    jdec, jvars, dec = _decoder_pair(weights)
    eouts, elens, ys_in, ylens = _dec_inputs()
    ref = jdec.apply(jvars, jnp.asarray(eouts), jnp.asarray(elens), None, None,
                     jnp.asarray(ylens), jnp.asarray(ys_in))
    emask_j = jax_pad_mask(jnp.asarray(elens), eouts.shape[1])[:, None, None, :]
    lens_in = np.array([7, 4, 1], np.int32)
    ref_one = jdec.apply(jvars, jnp.asarray(ys_in), jnp.asarray(lens_in), jnp.asarray(eouts), emask_j,
                         method=JaxDecoder.forward_one_step)
    ref_ctc = jdec.apply(jvars, jnp.asarray(eouts), method=lambda m, e: m.ctc.logits(e))
    te, tl = torch.from_numpy(eouts), torch.from_numpy(elens).long()
    with torch.no_grad():
        logits = dec(te, tl, None, None, torch.from_numpy(ylens).long(), torch.from_numpy(ys_in))
        emask = make_pad_mask(tl, eouts.shape[1])[:, None, None, :]
        one = dec.forward_one_step(torch.from_numpy(ys_in), torch.from_numpy(lens_in).long(), te, emask)
        cross = dec.precompute_cross_kv(te)
        one_kv = dec.forward_one_step(torch.from_numpy(ys_in), torch.from_numpy(lens_in).long(), te, emask, cross)
        ctc = dec.ctc.logits(te)
    for b, n in enumerate(ylens + 1):
        _close(logits[b, :n].numpy(), np.asarray(ref)[b, :n])
    _close(one.numpy(), ref_one)
    _close(one_kv.numpy(), ref_one)
    _close(ctc.numpy(), ref_ctc)


@pytest.mark.parametrize("mode", ["dense", "fused", "indirect", "fused_indirect"])
def test_cached_steps_equal_forward_one_step(weights, mode):
    """Four steps of incremental decoding, W = 2 beams per utterance that
    share the encoder K/V: every route gives `forward_one_step`'s logits,
    and the JAX package's route of the same name gives them too."""
    jdec, jvars, dec = _decoder_pair(weights)
    rng = np.random.default_rng(7)
    Bu, W, T, Lmax = 3, 2, 9, 8
    N = Bu * W
    eouts = rng.normal(size=(Bu, T, 32)).astype(np.float32)
    elens = np.array([9, 7, 5], np.int32)
    toks = rng.integers(3, 50, size=(N, Lmax - 1))
    te, tl = torch.from_numpy(eouts), torch.from_numpy(elens).long()
    emask = make_pad_mask(tl, T)[:, None, None, :]
    e_rep = te[:, None].expand(Bu, W, T, 32).reshape(N, T, 32)
    emask_rep = emask[:, None].expand(Bu, W, 1, 1, T).reshape(N, 1, 1, T)
    emask_j = jax_pad_mask(jnp.asarray(elens), T)[:, None, None, :]
    jcross = jdec.apply(jvars, jnp.asarray(eouts), method=JaxDecoder.precompute_cross_kv)
    indirect = mode in ("indirect", "fused_indirect")
    with torch.no_grad():
        cross = dec.precompute_cross_kv(te)
        caches = dec.init_cache(N, Lmax)
        jcaches = jdec.apply(jvars, N, Lmax, method=lambda m, n, L: m.init_cache(n, L))
        if indirect:
            caches = [tuple(x.reshape(Bu, W, Lmax, 4, 8) for x in kv) for kv in caches]
            jcaches = jax.tree_util.tree_map(lambda x: x.reshape(Bu, W, Lmax, 4, 8), jcaches)
        anc = torch.zeros((Bu, W, Lmax), dtype=torch.int32)
        hyps = torch.full((N, Lmax), 2, dtype=torch.int64)
        for step in range(4):
            lens = torch.full((N,), step + 1)
            last = hyps[torch.arange(N), lens - 1]
            if indirect:
                pos = (lens - 1).reshape(Bu, W)
                anc[:, :, step] = torch.arange(W, dtype=torch.int32)[None, :]
                logits, caches = dec.decode_step_cached_indirect(
                    last, pos, caches, anc, cross, emask, beam_width=W, step_mode=mode, elens=tl)
                ref, jcaches = jdec.apply(
                    jvars, jnp.asarray(last.numpy()), jnp.asarray(pos.numpy()), jcaches, jnp.asarray(anc.numpy()),
                    jcross, emask_j,
                    method=lambda m, *a: m.decode_step_cached_indirect(
                        *a, beam_width=W, step_mode=mode, elens=jnp.asarray(elens)))
            else:
                logits, caches = dec.decode_step_cached(
                    last, lens - 1, caches, cross, emask, beam_width=W, step_mode=mode, elens=tl)
                ref, jcaches = jdec.apply(
                    jvars, jnp.asarray(last.numpy()), jnp.asarray((lens - 1).numpy()), jcaches, jcross, emask_j,
                    method=lambda m, *a: m.decode_step_cached(
                        *a, beam_width=W, step_mode=mode, elens=jnp.asarray(elens)))
            full = dec.forward_one_step(hyps, lens, e_rep, emask_rep)
            _close(logits.numpy(), full.numpy())
            _close(logits.numpy(), ref)
            for (ck, cv), (jk, jv) in zip(caches, jcaches):
                _close(ck.numpy(), jk)
                _close(cv.numpy(), jv)
            hyps[:, step + 1] = torch.from_numpy(toks[:, step])
    assert ds.KERNEL.launches == 0 and ds.KERNEL_INDIRECT.launches == 0


def _layer_case(seed, H=4, D=64, F=128, Bu=3, W=5, Lmax=16, T=37, uniform_pos=False):
    """One layer's flax weights and one step's inputs, from numpy."""
    rng = np.random.default_rng(seed)
    dk, N = D // H, Bu * W
    arr = lambda *s: rng.normal(size=s).astype(np.float32)
    dense = lambda i, o: {"kernel": arr(i, o) / np.sqrt(i).astype(np.float32), "bias": 0.1 * arr(o)}
    norm = lambda: {"scale": 1.0 + 0.1 * arr(D), "bias": 0.1 * arr(D)}
    mha = lambda: {n: dense(D, D) for n in ("linear_q", "linear_k", "linear_v", "linear_out")}
    params = {"norm1": norm(), "norm2": norm(), "norm3": norm(), "self_attn": mha(), "src_attn": mha(),
              "feed_forward": {"w1": dense(D, F), "w2": dense(F, D)}}
    pos = rng.integers(0, Lmax, size=(Bu, W))
    if uniform_pos:
        pos = np.repeat(pos[:, :1], W, axis=1)
    anc = np.tile(np.arange(W)[None, :, None], (Bu, 1, Lmax))
    for step in range(1, Lmax):  # compose beam selections, as the search does
        parent = rng.integers(0, W, size=(Bu, W))
        anc[:, :, :step] = np.take_along_axis(anc[:, :, :step], parent[:, :, None], axis=1)
    inputs = dict(
        h=arr(N, D), ck=arr(Bu, W, Lmax, H, dk), cv=arr(Bu, W, Lmax, H, dk), pos=pos.astype(np.int32),
        anc=anc.astype(np.int32), memory=arr(Bu, T, D),
        elens=np.array([T, 3, 20][:Bu], np.int32),
    )
    return params, inputs, (H, D, F, Bu, W, Lmax, T, N, dk)


def _port_layer(params, H, D, F):
    from emoasr_tpu_torch.models.layers import TransformerDecoderLayer
    from emoasr_tpu_torch.utils.flax_import import transformer_decoder_state_dict

    sd = transformer_decoder_state_dict(
        {"embed": {"embedding": np.zeros((1, D), np.float32)}, "layers_0": params,
         "norm": params["norm1"], "output": params["self_attn"]["linear_q"]}, 1)
    layer = TransformerDecoderLayer(H, D, F, 0.0, 0.0).eval()
    layer.load_state_dict({k[len("transformers.0."):]: v for k, v in sd.items() if k.startswith("transformers.0.")})
    return layer


def test_layer_step_plain_matches_jax_kernel_and_dense_route():
    """`decoder_layer_step_plain` == the JAX `fused_decoder_layer_step`
    (interpret mode) == the dense `decode_step`; `pos` from 0 to L - 1 mixed
    within the batch, ragged `elens`."""
    params, inp, (H, D, F, Bu, W, Lmax, T, N, dk) = _layer_case(0)
    jlayer = JaxDecoderLayer(H, D, F, 0.0, 0.0)
    jvars = {"params": params}
    jcross = jlayer.apply(jvars, jnp.asarray(inp["memory"]), method=JaxDecoderLayer.compute_cross_kv)
    jw = jlayer.apply(jvars, method=JaxDecoderLayer._decode_step_weights)
    pos = inp["pos"].reshape(N)
    ck, cv = inp["ck"].reshape(N, Lmax, H, dk), inp["cv"].reshape(N, Lmax, H, dk)
    ref = jdsp.fused_decoder_layer_step(
        jnp.asarray(inp["h"]), jnp.asarray(ck), jnp.asarray(cv), jnp.asarray(pos), jcross[0], jcross[1],
        jnp.asarray(inp["elens"]), jw, beam_width=W)
    layer = _port_layer(params, H, D, F)
    t = {k: torch.from_numpy(v) for k, v in inp.items()}
    tck, tcv, tpos = torch.from_numpy(ck), torch.from_numpy(cv), torch.from_numpy(pos).long()
    with torch.no_grad():
        cross = layer.compute_cross_kv(t["memory"])
        _close(cross[0].numpy(), jcross[0])
        got = ds.fused_decoder_layer_step(t["h"], tck, tcv, tpos, cross[0], cross[1], t["elens"],
                                          layer._decode_step_weights(), beam_width=W)
        for a, b in zip(got, ref):
            _close(a.numpy(), b)
        emask = make_pad_mask(t["elens"].long(), T)[:, None, None, :]
        self_mask = (torch.arange(Lmax)[None, :] <= tpos[:, None])[:, None, None, :]
        dck, dcv = tck.clone(), tcv.clone()
        y, dck, dcv = layer.decode_step(t["h"][:, None], dck, dcv, tpos, self_mask, emask, cross, beam_width=W)
        _close(y[:, 0].numpy(), got[0].numpy())
        _close(dck[torch.arange(N), tpos].numpy(), got[1].numpy())
        _close(dcv[torch.arange(N), tpos].numpy(), got[2].numpy())
        fck, fcv = tck.clone(), tcv.clone()  # the fused route writes the caches as the dense one does
        yf, fck, fcv = layer.decode_step(t["h"][:, None], fck, fcv, tpos, self_mask, emask, cross,
                                         beam_width=W, fused=True, elens=t["elens"])
        _close(yf.numpy(), y.numpy())
        _close(fck.numpy(), dck.numpy())
    assert ds.KERNEL.launches == 0


def test_layer_step_indirect_plain_matches_jax_kernel_and_dense_route():
    """The same for the ancestor-indirect step, with a composed ancestor
    table; against the dense `decode_step_indirect` all beams of an
    utterance share one `pos` (it writes the cache before it attends, so
    beams at different lengths would read each other's new column) and
    anc[b, w, pos] = w, as the search sets it."""
    for uniform in (False, True):
        params, inp, (H, D, F, Bu, W, Lmax, T, N, dk) = _layer_case(1 + uniform, uniform_pos=uniform)
        if uniform:
            inp["anc"][np.arange(Bu)[:, None], np.arange(W)[None, :], inp["pos"]] = np.arange(W)[None, :]
        jlayer = JaxDecoderLayer(H, D, F, 0.0, 0.0)
        jvars = {"params": params}
        jcross = jlayer.apply(jvars, jnp.asarray(inp["memory"]), method=JaxDecoderLayer.compute_cross_kv)
        jw = jlayer.apply(jvars, method=JaxDecoderLayer._decode_step_weights)
        ref = jdsp.fused_decoder_layer_step_indirect(
            jnp.asarray(inp["h"]), jnp.asarray(inp["ck"]), jnp.asarray(inp["cv"]), jnp.asarray(inp["pos"]),
            jnp.asarray(inp["anc"]), jcross[0], jcross[1], jnp.asarray(inp["elens"]), jw, beam_width=W)
        layer = _port_layer(params, H, D, F)
        t = {k: torch.from_numpy(v) for k, v in inp.items()}
        with torch.no_grad():
            cross = layer.compute_cross_kv(t["memory"])
            wt = layer._decode_step_weights()
            got = ds.fused_decoder_layer_step_indirect(
                t["h"], t["ck"], t["cv"], t["pos"].long(), t["anc"], cross[0], cross[1], t["elens"], wt, beam_width=W)
            for a, b in zip(got, ref):
                _close(a.numpy(), b)
            # the direct step on caches gathered by anc: the same numbers
            idx = t["anc"].long()[:, :, :, None, None].expand(Bu, W, Lmax, H, dk)
            gk = torch.gather(t["ck"], 1, idx).reshape(N, Lmax, H, dk)
            gv = torch.gather(t["cv"], 1, idx).reshape(N, Lmax, H, dk)
            direct = ds.fused_decoder_layer_step(
                t["h"], gk, gv, t["pos"].reshape(N).long(), cross[0], cross[1], t["elens"], wt, beam_width=W)
            for a, b in zip(got, direct):
                assert torch.equal(a, b)
            if uniform:
                emask = make_pad_mask(t["elens"].long(), T)[:, None, None, :]
                y, _, _ = layer.decode_step_indirect(
                    t["h"][:, None], t["ck"].clone(), t["cv"].clone(), t["pos"].long(), t["anc"], emask, cross, W)
                _close(y[:, 0].numpy(), got[0].numpy())
    assert ds.KERNEL_INDIRECT.launches == 0


@pytest.mark.parametrize("W", [17, 20, 33])
def test_layer_steps_plain_match_jax_kernels_at_wide_beams(W):
    """Beams wider than the CUDA kernels' row group of 16, which the JAX
    kernels take: `decoder_layer_step_plain` and its indirect variant ==
    the JAX `fused_decoder_layer_step[_indirect]` (interpret mode)."""
    params, inp, (H, D, F, Bu, W, Lmax, T, N, dk) = _layer_case(W, D=32, F=64, Bu=2, W=W, Lmax=8, T=21)
    jlayer = JaxDecoderLayer(H, D, F, 0.0, 0.0)
    jvars = {"params": params}
    jcross = jlayer.apply(jvars, jnp.asarray(inp["memory"]), method=JaxDecoderLayer.compute_cross_kv)
    jw = jlayer.apply(jvars, method=JaxDecoderLayer._decode_step_weights)
    pos = inp["pos"].reshape(N)
    ck, cv = inp["ck"].reshape(N, Lmax, H, dk), inp["cv"].reshape(N, Lmax, H, dk)
    ref = jdsp.fused_decoder_layer_step(
        jnp.asarray(inp["h"]), jnp.asarray(ck), jnp.asarray(cv), jnp.asarray(pos), jcross[0], jcross[1],
        jnp.asarray(inp["elens"]), jw, beam_width=W)
    ref_ind = jdsp.fused_decoder_layer_step_indirect(
        jnp.asarray(inp["h"]), jnp.asarray(inp["ck"]), jnp.asarray(inp["cv"]), jnp.asarray(inp["pos"]),
        jnp.asarray(inp["anc"]), jcross[0], jcross[1], jnp.asarray(inp["elens"]), jw, beam_width=W)
    layer = _port_layer(params, H, D, F)
    t = {k: torch.from_numpy(v) for k, v in inp.items()}
    with torch.no_grad():
        cross = layer.compute_cross_kv(t["memory"])
        wt = layer._decode_step_weights()
        got = ds.fused_decoder_layer_step(t["h"], torch.from_numpy(ck), torch.from_numpy(cv),
                                          torch.from_numpy(pos).long(), cross[0], cross[1], t["elens"], wt,
                                          beam_width=W)
        got_ind = ds.fused_decoder_layer_step_indirect(t["h"], t["ck"], t["cv"], t["pos"].long(), t["anc"],
                                                       cross[0], cross[1], t["elens"], wt, beam_width=W)
    for a, b in zip((*got, *got_ind), (*ref, *ref_ind)):
        _close(a.numpy(), b)
    assert ds.KERNEL.launches == 0 and ds.KERNEL_INDIRECT.launches == 0


@pytest.mark.parametrize("route", ["direct", "indirect"])
def test_fused_step_without_elens_raises(route):
    """A caller that asks for the fused step and leaves out `elens` (or the
    beam width) gets an error, never the dense route in its place."""
    params, inp, (H, D, F, Bu, W, Lmax, T, N, dk) = _layer_case(3, uniform_pos=True)
    layer = _port_layer(params, H, D, F)
    t = {k: torch.from_numpy(v) for k, v in inp.items()}
    h, pos = t["h"][:, None], t["pos"].long()
    with torch.no_grad():
        cross = layer.compute_cross_kv(t["memory"])
        emask = make_pad_mask(t["elens"].long(), T)[:, None, None, :]
        if route == "direct":
            ck, cv = t["ck"].reshape(N, Lmax, H, dk), t["cv"].reshape(N, Lmax, H, dk)
            self_mask = (torch.arange(Lmax)[None, :] <= pos.reshape(N)[:, None])[:, None, None, :]
            for kw in ({"beam_width": W}, {"elens": t["elens"]}):
                with pytest.raises(ValueError, match="needs beam_width and elens"):
                    layer.decode_step(h, ck, cv, pos.reshape(N), self_mask, emask, cross, fused=True, **kw)
        else:
            with pytest.raises(ValueError, match="needs elens"):
                layer.decode_step_indirect(h, t["ck"], t["cv"], pos, t["anc"], emask, cross, W, fused=True)


def test_asr_builds_the_attention_model_and_refuses_to_train_it(weights):
    params, stats = weights
    model = port_model(L3_SMALL, params, stats)
    assert isinstance(model, ASR) and isinstance(model.decoder, TransformerDecoder)
    x = torch.zeros(1, 40, 20)
    # it trains, by distillation too since slice 7b (parity: test_torch_kd.py)
    _, loss_dict = port_model(dict(L3_SMALL, kd_weight=0.5), params, stats)(
        x, torch.tensor([40]), torch.ones(1, 2, dtype=torch.long), torch.tensor([2]),
        torch.full((1, 3), 2), torch.full((1, 3), 2), soft_labels=torch.full((1, 3, 50), 0.02))
    assert "loss_kd" in loss_dict and torch.isfinite(loss_dict["loss_total"])
    with pytest.raises(NotImplementedError, match="greedy"):
        model.decode_greedy(x, torch.tensor([40]))
    cmlm = TransformerDecoder(config_from_dict(L3_SMALL), cmlm=True)  # P2W's pbert decoder builds
    assert cmlm.cmlm and set(cmlm.state_dict()) == set(model.decoder.state_dict())
