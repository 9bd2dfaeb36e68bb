"""The port's ELECTRA, P-ELECTRA and phone-to-word LMs (models/lm/lm.py), the
CMLM decoder, the `embed` input layer and their weight import, against the
emoASR outputs recorded in tests/fixtures_lm_electra.npz and against the JAX
package on the same weights.

- ELECTRA: `score` and `forward_disc` against the recorded outputs (every
  `sd::` key loads); against JAX, the generator's logits, `mlm_loss`, the
  discriminator and `disc_bce_loss` applied to one `generated` drawn with
  numpy on both sides (the joint loss, its terms, `num_replaced`,
  `num_masked`, every gradient), `forward_disc`, `score`, `predict`; the
  sampler draws only at the masked positions, and one seed draws the same.
- P-ELECTRA: the same joint loss and gradients around one `generated`.
- P2W with each decoder (`ptransformer`, `pbert`, `pctc`): loss, logits and
  gradients; `predict`; the CTC decoder's greedy cascade.
- `masked_lm_loss` against the JAX criterion; the `embed` encoder with
  `enc_fused_attn` off and on (K4's plain version here, the Pallas kernel
  interpreted on the JAX side).
- `pbert`'s chunked pseudo-log-likelihood against the JAX `_masked_nll` at
  two chunk sizes.
- `lm_state_dict` round trips: the JAX importers take the port's names
  back to the same tree.
- ELECTRA in the CTC prefix beam by the stateless route, against the JAX
  fusion; the phone-conditioned types are refused.

Sizes: 2 layers x 32 (ELECTRA embeddings 16), 4 heads, FF 64, V = 40, 15
phones.  Tolerances: 1e-4 against the recorded outputs (what tests/test_lm.py
holds the JAX LMs to); losses within 1e-5 relative; logits 1e-5 absolute;
gradients within 1e-4 of the largest entry; the pseudo-NLL rtol 1e-6; beam
hypotheses exact, scores atol 1e-4.
"""

import math
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from emoasr_tpu.config import config_from_dict as jax_config
from emoasr_tpu.eval.test_ppl import _masked_nll as jax_masked_nll
from emoasr_tpu.models import criteria as jax_criteria
from emoasr_tpu.models.encoders import TransformerEncoder as JaxEncoder
from emoasr_tpu.models.lm import bert as jax_bert
from emoasr_tpu.models.lm.lm import LM as JaxLM
from emoasr_tpu.models.lm.lm import ELECTRAModel as JaxELECTRA
from emoasr_tpu.models.lm.lm import PELECTRAModel as JaxPELECTRA
from emoasr_tpu.search.common import make_lm_fusion as jax_make_lm_fusion
from emoasr_tpu.search.ctc_beam import ctc_beam_search as jax_ctc_beam
from emoasr_tpu.utils import torch_import as ti
from emoasr_tpu_torch.config import config_from_dict
from emoasr_tpu_torch.eval.test_ppl import masked_nll
from emoasr_tpu_torch.models import criteria
from emoasr_tpu_torch.models.encoders import TransformerEncoder
from emoasr_tpu_torch.models.lm import lm as lm_mod
from emoasr_tpu_torch.models.lm.bert import mlm_loss
from emoasr_tpu_torch.models.lm.lm import LM, load_lm_state_dict, sample_categorical
from emoasr_tpu_torch.search.common import make_lm_fusion
from emoasr_tpu_torch.search.ctc_beam import ctc_beam_search
from emoasr_tpu_torch.utils.flax_import import lm_state_dict, transformer_encoder_state_dict
from test_torch_attention_beam import _same
from test_torch_lm_fusion import _ctc_log_probs

FIXDIR = os.path.dirname(os.path.abspath(__file__))
T_ = torch.from_numpy
LOSS_RTOL = 1e-5
LOGIT_TOL = 1e-5
GRAD_TOL = 1e-4

ELECTRA = dict(
    lm_type="electra", vocab_size=40, max_seq_len=24, mask_id=39, eos_id=2,
    gen_hidden_size=32, gen_embedding_size=16, gen_num_layers=2, gen_num_attention_heads=4,
    gen_intermediate_size=64, disc_hidden_size=32, disc_embedding_size=16, disc_num_layers=2,
    disc_num_attention_heads=4, disc_intermediate_size=64, electra_disc_weight=50,
)
P2W = dict(
    vocab_size=40, src_vocab_size=15, enc_hidden_size=32, enc_num_attention_heads=4, enc_num_layers=2,
    enc_intermediate_size=64, dec_hidden_size=32, dec_num_attention_heads=4, dec_num_layers=2,
    dec_intermediate_size=64, eos_id=2, mask_id=39, max_seq_len=24, blank_id=0,
    dropout_enc_rate=0.0, dropout_dec_rate=0.0, dropout_attn_rate=0.0,
)
PELECTRA = dict(P2W, lm_type="pelectra", disc_hidden_size=32, disc_embedding_size=16, disc_num_layers=2,
                disc_num_attention_heads=4, disc_intermediate_size=64, electra_disc_weight=50)


def redraw_params(shapes, seed: int):
    """Every leaf of a flax parameter tree redrawn from numpy: kernels ~
    N(0, 1/fan_in), embeddings ~ N(0, 1), biases ~ N(0, 0.1^2), norm scales
    ~ 1 + N(0, 0.1^2)."""
    rng = np.random.default_rng(seed)

    def redraw(path, x):
        name, shape = path[-1].key, np.shape(x)
        if name == "kernel":
            return (rng.normal(size=shape) / math.sqrt(shape[0])).astype(np.float32)
        if name == "embedding":
            return rng.normal(size=shape).astype(np.float32)
        if name == "scale":
            return (1.0 + 0.1 * rng.normal(size=shape)).astype(np.float32)
        return (0.1 * rng.normal(size=shape)).astype(np.float32)

    return jax.tree_util.tree_map_with_path(redraw, shapes)


def init_args(conf: dict, B=2, L=6, P=9):
    ys = jnp.full((B, L), 3, jnp.int32)
    ylens = jnp.full((B,), L, jnp.int32)
    labels = jnp.full((B, L), -100, jnp.int32).at[:, 0].set(3)
    if conf["lm_type"].startswith("electra"):
        return ys, ylens, labels
    return ys, ylens, labels, jnp.full((B, P), 3, jnp.int32), jnp.full((B,), P, jnp.int32)


def jax_lm_params(conf: dict, seed: int = 0) -> dict:
    """The JAX `LM` facade's params for `conf`, redrawn from `seed`."""
    rngs = {"params": jax.random.PRNGKey(0), "sample": jax.random.PRNGKey(1), "dropout": jax.random.PRNGKey(2)}
    shapes = jax.eval_shape(lambda: JaxLM(jax_config(conf)).init(rngs, *init_args(conf)))["params"]
    return redraw_params(shapes, seed)


def lm_pair(conf: dict, seed: int = 0):
    """(JAX `LM`, its variables, the port's `LM` on the CPU in eval mode) on
    the same weights."""
    params = jax_lm_params(conf, seed)
    cfg = config_from_dict(conf)
    port = LM(cfg)
    load_lm_state_dict(port, lm_state_dict(params, cfg))
    return JaxLM(jax_config(conf)), {"params": params}, port.eval()


def _close(a, b, tol=LOGIT_TOL):
    np.testing.assert_allclose(np.asarray(a, np.float32), np.asarray(b, np.float32), atol=tol, rtol=0)


def _grads_close(port_inner: torch.nn.Module, jgrads, cfg):
    """Every parameter's gradient within GRAD_TOL of the largest JAX
    gradient entry (the keys' biases, whose gradient is 0 but for
    rounding, included)."""
    want = lm_state_dict(jax.tree_util.tree_map(np.asarray, jgrads), cfg)
    named = dict(port_inner.named_parameters())
    assert set(named) <= set(want)
    scale = max(float(np.abs(want[n].numpy()).max()) for n in named)
    for n, p in named.items():
        ref = want[n].numpy()
        got = np.zeros_like(ref) if p.grad is None else p.grad.numpy()
        np.testing.assert_allclose(got, ref, atol=GRAD_TOL * scale, rtol=0, err_msg=n)


def _tokens(seed, B=3, L=10, V=40, P=14, S=15):
    rng = np.random.default_rng(seed)
    ys = rng.integers(3, V - 1, size=(B, L))
    ylens = np.sort(rng.integers(3, L + 1, size=B))[::-1].copy()
    ylens[0] = L
    ps = rng.integers(3, S, size=(B, P))
    plens = np.sort(rng.integers(4, P + 1, size=B))[::-1].copy()
    plens[0] = P
    labels = np.where(rng.random((B, L)) < 0.4, ys, -100)
    labels[:, 0] = ys[:, 0]  # every row has a masked position
    return ys, ylens, ps, plens, labels


def test_electra_matches_recorded_emoasr_outputs():
    fx = np.load(os.path.join(FIXDIR, "fixtures_lm_electra.npz"))
    sd = {k[4:]: T_(fx[k]) for k in fx.files if k.startswith("sd::")}
    model = LM(config_from_dict(ELECTRA))
    assert set(sd) == set(model.lm.state_dict())
    load_lm_state_dict(model, sd)
    model.eval()
    ys, ylens = T_(fx["ys"]), T_(fx["ylens"])
    with torch.no_grad():
        np.testing.assert_allclose(model.score(ys, ylens).numpy(), fx["scores"], rtol=1e-4)
        dloss, ld = model.forward_disc(ys, ylens, T_(fx["error_labels"]))
        dloss2, _ = model(ys, ylens, error_labels=T_(fx["error_labels"]))
    np.testing.assert_allclose(dloss.item(), float(fx["dloss"]), rtol=1e-4)
    assert set(ld) == {"loss_total"} and dloss2.item() == dloss.item()


def _generated(ys, labels, seed):
    """Replacements drawn once with numpy at the masked positions."""
    rng = np.random.default_rng(seed)
    return np.where(labels != -100, rng.integers(3, 39, size=ys.shape), ys)


@pytest.mark.parametrize("kind", ["electra", "pelectra"])
def test_joint_loss_and_gradients_match_jax_with_the_same_generated_ids(kind):
    """The generator, its MLM loss, the discriminator and its BCE on both
    sides around one `generated`: the joint loss, its terms, the counts,
    and the gradients of every parameter."""
    conf = ELECTRA if kind == "electra" else PELECTRA
    jm, jv, port = lm_pair(conf, seed=1)
    cfg = port.cfg
    ys, ylens, ps, plens, labels = _tokens(2)
    ys_in = np.where(labels != -100, conf["mask_id"], ys)
    gen = _generated(ys, labels, 3)
    # the first masked token of row 0 keeps its label: one replacement that is no replacement
    gen[0, 0] = ys[0, 0]
    Cls = JaxELECTRA if kind == "electra" else JaxPELECTRA
    j = dict(ys=jnp.asarray(ys_in), yl=jnp.asarray(ylens), lab=jnp.asarray(labels),
             ps=jnp.asarray(ps), pl=jnp.asarray(plens), gen=jnp.asarray(gen, jnp.int32))

    def jax_loss(params):
        inner = {"params": params["lm"]}
        if kind == "electra":
            glogits = Cls(jax_config(conf)).apply(inner, j["ys"], j["yl"], True, method=Cls._generator)
            gloss = jax_bert.mlm_loss(glogits, j["lab"])
        else:
            gloss, _, glogits = Cls(jax_config(conf)).apply(
                inner, j["ys"], j["yl"], j["lab"], j["ps"], j["pl"], True,
                method=lambda m, *a: m.gmodel(*a, return_logits=True))
        replaced = (j["gen"] != jnp.where(j["lab"] != -100, j["lab"], j["ys"])).astype(jnp.int32)
        dlogits = Cls(jax_config(conf)).apply(inner, j["gen"], j["yl"], True, method=Cls._discriminator)
        dloss = jax_bert.disc_bce_loss(dlogits, replaced, j["yl"])
        return gloss + conf["electra_disc_weight"] * dloss, (gloss, dloss, replaced.sum() / 3, glogits)

    (jl, (jg, jd, jrep, jlogits)), jgrads = jax.jit(jax.value_and_grad(jax_loss, has_aux=True))(jv["params"])
    t = dict(ys=T_(ys_in), yl=T_(ylens), lab=T_(labels), ps=T_(ps), pl=T_(plens))
    if kind == "electra":
        glogits = port.lm.generator_logits(t["ys"], t["yl"])
        gloss = mlm_loss(glogits, t["lab"])
    else:
        gloss, _, glogits = port.lm.gmodel(t["ys"], t["yl"], t["lab"], t["ps"], t["pl"], return_logits=True)
    loss, ld = port.lm.joint(gloss, t["ys"], t["yl"], t["lab"], T_(gen))
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(jl), rtol=LOSS_RTOL)
    np.testing.assert_allclose(ld["loss_gen"].item(), float(jg), rtol=LOSS_RTOL)
    np.testing.assert_allclose(ld["loss_disc"].item(), float(jd), rtol=LOSS_RTOL)
    assert ld["loss_total"] is loss
    np.testing.assert_allclose(ld["num_replaced"].item(), float(jrep), rtol=1e-7)
    assert ld["num_replaced"].item() < ld["num_masked"].item() == (labels != -100).sum() / 3
    _close(glogits.detach().numpy(), jlogits)
    _grads_close(port.lm, jgrads["lm"], cfg)


def test_sampler_draws_only_at_masked_positions_from_its_generator():
    """The replacements come from the generator the caller passes in (one
    seed, one draw) and only where a label is set; temp 0 is the argmax."""
    _, _, port = lm_pair(ELECTRA, seed=4)
    ys, ylens, _, _, labels = _tokens(5)
    t = dict(ys=T_(ys), yl=T_(ylens), lab=T_(labels))
    with torch.no_grad():
        glogits = port.lm.generator_logits(t["ys"], t["yl"])
        draws = []
        for _ in range(2):
            g = torch.Generator()
            g.manual_seed(7)
            draws.append(port.lm.sample_replacements(glogits, t["ys"], t["lab"], g))
        loss_a, _ = port(t["ys"], t["yl"], t["lab"], generator=torch.Generator().manual_seed(7))
        loss_b, _ = port(t["ys"], t["yl"], t["lab"], generator=torch.Generator().manual_seed(7))
    assert torch.equal(draws[0], draws[1]) and loss_a.item() == loss_b.item()
    unmasked = labels == -100
    assert (draws[0].numpy()[unmasked] == ys[unmasked]).all()
    assert torch.equal(sample_categorical(glogits, None, temp=0.0), glogits.argmax(-1))
    # the Gumbel-max draw follows softmax(logits): a near-certain logit wins
    peaked = torch.full((4000, 5), -20.0)
    peaked[:, 2] = 20.0
    assert (sample_categorical(peaked, torch.Generator().manual_seed(0)) == 2).all()
    two = torch.zeros(20000, 2)
    share = sample_categorical(two, torch.Generator().manual_seed(1)).float().mean().item()
    assert abs(share - 0.5) < 0.02


def test_electra_disc_score_and_predict_match_jax():
    jm, jv, port = lm_pair(dict(ELECTRA, lm_type="electra-disc"), seed=6)
    ys, ylens, _, _, _ = _tokens(7)
    err = (np.random.default_rng(8).random(ys.shape) < 0.3).astype(np.int64)
    jys, jyl = jnp.asarray(ys), jnp.asarray(ylens)
    jloss, _ = jm.apply(jv, jys, jyl, jnp.asarray(err), method=JaxLM.forward_disc)
    with torch.no_grad():
        loss, _ = port.forward_disc(T_(ys), T_(ylens), T_(err))
        np.testing.assert_allclose(loss.item(), float(jloss), rtol=LOSS_RTOL)
        _close(port.score(T_(ys), T_(ylens)).numpy(), jm.apply(jv, jys, jyl, method=JaxLM.score), 1e-4)
        lp, st = port.predict(T_(ys), T_(ylens))
    jlp, _ = jm.apply(jv, jys, jyl, method=JaxLM.predict)
    assert st is None
    _close(lp.numpy(), jlp)


def test_masked_lm_loss_matches_jax():
    rng = np.random.default_rng(9)
    logits = rng.normal(size=(3, 7, 40)).astype(np.float32) * 3
    labels = np.where(rng.random((3, 7)) < 0.5, rng.integers(0, 40, (3, 7)), -100)
    got = criteria.masked_lm_loss(T_(logits), T_(labels)).item()
    np.testing.assert_allclose(got, float(jax_criteria.masked_lm_loss(jnp.asarray(logits), jnp.asarray(labels))),
                               rtol=LOSS_RTOL)
    assert criteria.masked_lm_loss(T_(logits), torch.full((3, 7), -100)).item() == 0.0


@pytest.mark.parametrize("lm_type", ["ptransformer", "pbert", "pctc"])
def test_p2w_decoders_match_jax(lm_type):
    """test_lm.py::test_p2w_training's setup: the loss and its gradients,
    the logits without labels (CTC: its loss), and `predict`."""
    conf = dict(P2W, lm_type=lm_type)
    jm, jv, port = lm_pair(conf, seed=10)
    ys, ylens, ps, plens, labels = _tokens(11)
    if lm_type == "pbert":
        ys = np.where(labels != -100, conf["mask_id"], ys)
    if lm_type == "ptransformer":
        labels = np.where(np.arange(10)[None, :] < ylens[:, None], np.roll(ys, -1, 1), -100)
    j = [jnp.asarray(a) for a in (ys, ylens, labels, ps, plens)]
    t = [T_(a) for a in (ys, ylens, labels, ps, plens)]

    def jax_loss(params):
        loss, ld = jm.apply({"params": params}, *j)
        return loss, ld

    (jl, jld), jgrads = jax.jit(jax.value_and_grad(jax_loss, has_aux=True))(jv["params"])
    loss, ld = port(*t)
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(jl), rtol=LOSS_RTOL)
    assert set(ld) == set(jld)
    _grads_close(port.lm, jgrads["lm"], port.cfg)
    if lm_type == "pctc":
        with torch.no_grad():
            hyps, hyp_lens = port.lm.decode_greedy(t[3], t[4])
        jh, jhl = jm.apply(jv, j[3], j[4], method=lambda m, p, pl: m.lm.decode_greedy(p, pl))
        np.testing.assert_array_equal(hyp_lens.numpy(), np.asarray(jhl))
        for b in range(3):
            np.testing.assert_array_equal(hyps[b, : hyp_lens[b]].numpy(), np.asarray(jh)[b, : int(jhl[b])])
        return
    with torch.no_grad():
        logits = port(t[0], t[1], None, t[3], t[4])
        lp, _ = port.lm.predict(t[0], t[1], t[3], t[4])
    jlogits = jm.apply(jv, j[0], j[1], None, j[3], j[4])
    jlp, _ = jm.apply(jv, j[0], j[1], j[3], j[4], method=lambda m, *a: m.lm.predict(*a))
    _close(logits.numpy(), jlogits)
    _close(lp.numpy(), jlp)


@pytest.mark.parametrize("fused", [False, True], ids=["plain", "fused_attn"])
def test_embed_encoder_matches_jax(fused):
    conf = dict(P2W, input_layer="embed", enc_fused_attn=fused)
    jcfg = jax_config(conf)
    _, _, ps, plens, _ = _tokens(12, P=20)
    enc = JaxEncoder(jcfg)
    shapes = jax.eval_shape(lambda: enc.init(jax.random.PRNGKey(0), jnp.asarray(ps), jnp.asarray(plens)))
    params = redraw_params(shapes["params"], 13)
    port = TransformerEncoder(config_from_dict(conf))
    port.load_state_dict(transformer_encoder_state_dict(params, 2))
    port.eval()
    with torch.no_grad():
        eo, el, _ = port(T_(ps), T_(plens))
    jeo, jel, _ = enc.apply({"params": params}, jnp.asarray(ps), jnp.asarray(plens))
    np.testing.assert_array_equal(el.numpy(), np.asarray(jel))
    for b in range(3):  # the rows past a length differ only in what no one reads
        _close(eo[b, : plens[b]].numpy(), np.asarray(jeo)[b, : plens[b]], 2e-5)


@pytest.mark.parametrize("chunk_tokens", [10, 1 << 16])
def test_pbert_pseudo_log_likelihood_in_chunks_matches_jax(monkeypatch, chunk_tokens):
    """The phones encoded once an utterance, the masked copies in chunks of
    one and of all rows, against JAX's (B L, L) batch with the phones
    repeated L times."""
    monkeypatch.setattr(lm_mod, "PLL_CHUNK_TOKENS", chunk_tokens)
    conf = dict(P2W, lm_type="pbert")
    jm, jv, port = lm_pair(conf, seed=14)
    ys, ylens, ps, plens, _ = _tokens(15)
    jnll, jcnt = jax.jit(lambda p, *a: jax_masked_nll(jm, p, *a, conf["mask_id"]))(
        jv["params"], *(jnp.asarray(a) for a in (ys, ylens, ps, plens)))
    with torch.no_grad():
        lp = lm_mod.p2w_pseudo_log_likelihood(port.lm, T_(ys), T_(ylens), T_(ps), T_(plens), conf["mask_id"])
        nll, cnt = masked_nll(port, T_(ys), T_(ylens), conf["mask_id"], T_(ps), T_(plens))
    np.testing.assert_allclose(-lp.sum().item(), float(jnll), rtol=1e-6)
    np.testing.assert_allclose(nll.item(), float(jnll), rtol=1e-6)
    assert int(cnt) == int(jcnt) == int(ylens.sum())
    assert (lp.numpy()[np.arange(10)[None, :] >= ylens[:, None]] == 0).all()


def _flat(tree):
    return {jax.tree_util.keystr(p): np.asarray(v) for p, v in jax.tree_util.tree_leaves_with_path(tree)}


@pytest.mark.parametrize("lm_type", ["electra", "ptransformer", "pbert", "pctc", "pelectra"])
def test_lm_state_dict_round_trips_through_the_jax_importers(lm_type):
    conf = ELECTRA if lm_type == "electra" else dict(P2W, lm_type=lm_type) if lm_type != "pelectra" else PELECTRA
    params = jax_lm_params(conf, seed=16)["lm"]
    cfg = config_from_dict(conf)
    sd = lm_state_dict(params, cfg)
    assert set(sd) == set(LM(cfg).lm.state_dict())
    np_sd = {k: v.numpy() for k, v in sd.items()}

    def p2w_back(sd_, prefix, dt):
        enc, _ = ti.transformer_encoder(sd_, 2, False, f"{prefix}encoder.", "embed")
        dec = (ti.ctc_decoder(sd_, f"{prefix}decoder.") if dt == "pctc"
               else ti.transformer_decoder(sd_, 2, f"{prefix}decoder."))
        return {"encoder": enc, "decoder": dec}

    def disc_back(sd_):
        return {"dstack": ti.bert_stack_hf(sd_, 2, "dmodel.electra."),
                "dhead": {"dense": ti.dense(sd_, "dmodel.discriminator_predictions.dense"),
                          "dense_prediction": ti.dense(sd_, "dmodel.discriminator_predictions.dense_prediction")}}

    if lm_type == "electra":
        back = ti.electra_model(np_sd, 2, 2)
    elif lm_type == "pelectra":
        back = dict(disc_back(np_sd), gmodel=p2w_back(np_sd, "gmodel.", "pbert"))
    else:
        back = p2w_back(np_sd, "", lm_type)
    want, got = _flat(params), _flat(back)
    assert set(want) == set(got)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


def test_electra_fuses_by_the_stateless_route_in_the_ctc_beam():
    """The generator's log-probs at each prefix's last position, fused at
    0.5 into the CTC prefix beam, as the JAX adapter's stateless route does
    through the facade's `predict`; the phone-conditioned types are
    refused, naming the type."""
    jm, jv, port = lm_pair(ELECTRA, seed=17)
    lp = _ctc_log_probs(40, V=40)
    elens = np.array([12, 9, 6], np.int32)
    ref = jax_ctc_beam(jnp.asarray(lp), jnp.asarray(elens), 4, 0, 2, 0.5, lm=jax_make_lm_fusion(jm, jv, 0.5))
    fusion = make_lm_fusion(port, 0.5)
    assert fusion.init_states(3, 4) is None
    with torch.no_grad():
        got = ctc_beam_search(T_(lp), T_(elens).long(), 4, 0, 2, 0.5, lm=fusion)
    _same(got, ref, "ctc beam + ELECTRA")
    for lm_type in ("ptransformer", "pbert", "pctc", "pelectra"):
        conf = PELECTRA if lm_type == "pelectra" else dict(P2W, lm_type=lm_type)
        with pytest.raises(ValueError, match=lm_type):
            make_lm_fusion(LM(config_from_dict(conf)), 0.5)
