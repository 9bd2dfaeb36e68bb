"""The port's LAS decoder, its beam search and their wiring against the JAX
package and the emoASR outputs recorded in tests/fixtures_dec_las.npz, on
the CPU.

- `LASDecoder` (`attn_dim=20`) with the recorded `sd::` weights: the loss
  within rtol 1e-4, the logits of the valid positions within rtol 1e-3 /
  atol 1e-4 (what tests/test_decoders.py:64 holds the JAX decoder to).
- Against the JAX `LASDecoder` on the same weights (`flax_import`): the
  loss terms of the plain, distillation and auxiliary-CTC branches (rtol
  1e-5) and the gradients to every parameter and to the encoder outputs
  (1e-4 of each tensor's largest entry + 1e-6).
- The train CLI trains a LAS(Transformer) model (`--cpu`, per-epoch greedy
  validation) on a 16-utterance corpus until its loss halves; the port's
  and the JAX package's eval CLIs decode its `model.ep20` to the same TSV,
  greedily and with beam 3.
- On that model's encoder outputs: greedy decoding and the LAS beam at
  widths 1 and 3, `len_weight` 0 and 1, without an LM and with a
  Transformer LM (the port's ancestor-indirect route) and an RNN LM at
  0.5: hypotheses and lengths exact, scores within 1e-4 (sums of float32
  log-probabilities from two frameworks); at least half of the rows end
  at eos; width 1 agrees with greedy on every row it ends;
  `build_decode_fn` of the whole model against the JAX one, greedy and
  beam.

Sizes: the loss branches: decoder 2 LSTM cells of 24, embedding 16,
intermediate 28, attention 256 x 10 channels x 201 taps (the JAX
defaults), V = 40.  The trained model: 1 Transformer layer of 32, 1 cell of
32, V = 12, at most 8 labels.  The LMs: 2 layers of 32 (RNN 2 x 24).
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pandas as pd
import pytest
import torch
import yaml

from emoasr_tpu.config import config_from_dict as jax_config
from emoasr_tpu.eval import test_asr as jax_cli
from emoasr_tpu.eval.decode import build_decode_fn as jax_build_decode_fn
from emoasr_tpu.models.asr import ASR as JaxASR
from emoasr_tpu.models.decoders.las import LASDecoder as JaxLAS
from emoasr_tpu.search.common import make_lm_fusion as jax_make_lm_fusion
from emoasr_tpu.utils import torch_import as ti
from emoasr_tpu_torch.config import config_from_dict
from emoasr_tpu_torch.eval import test_asr as port_cli
from emoasr_tpu_torch.eval.decode import build_decode_fn
from emoasr_tpu_torch.models.asr import ASR
from emoasr_tpu_torch.models.decoders.las import LASDecoder
from emoasr_tpu_torch.ops import ctc_head, ctc_lattice, topk
from emoasr_tpu_torch.search.common import make_lm_fusion
from emoasr_tpu_torch.train import loop
from emoasr_tpu_torch.utils.flax_import import las_decoder_state_dict
from test_torch_attention_beam import _same
from test_torch_lm_types import lm_pair
from test_torch_rnnt import T_, _close_grads, random_rnnt_params

FIXDIR = os.path.dirname(os.path.abspath(__file__))
V = 40

LAS_SMALL = dict(
    encoder_type="transformer", input_layer="conv2d", feat_dim=20, enc_hidden_size=32, enc_num_attention_heads=4,
    enc_num_layers=1, enc_intermediate_size=64, decoder_type="las", dec_hidden_size=24, dec_num_layers=2,
    embedding_size=16, dec_intermediate_size=28, vocab_size=V, blank_id=0, eos_id=2, max_decode_ylen=10,
    lsm_prob=0.1, dropout_enc_rate=0.0, dropout_attn_rate=0.0, dropout_dec_rate=0.0, spec_augment=False,
)
TRF_LM = dict(lm_type="transformer", vocab_size=V, hidden_size=32, num_layers=2, num_attention_heads=4,
              intermediate_size=64, max_seq_len=24)
RNN_LM = dict(lm_type="rnn", vocab_size=V, embedding_size=16, hidden_size=24, num_layers=2, dropout_rate=0.0)


def _weights(conf, eos_bias, seed):
    """`random_rnnt_params`, with the LAS decoder's raw kernels ~ N(0,
    1/fan_in), its cells' weights and its output kernel ~ N(0, 9/fan_in), so
    that the hypotheses depend on the input."""
    params, stats = random_rnnt_params(conf, seed)
    dec = params["decoder"]
    rng = np.random.default_rng(seed + 100)
    for k, x in dec.items():
        if k.endswith("_kernel"):
            dec[k] = (rng.normal(size=x.shape) / np.sqrt(np.prod(x.shape[:-1]))).astype(np.float32)
        elif k.endswith(("_w_ih", "_w_hh")):
            dec[k] = (3 * rng.normal(size=x.shape) / np.sqrt(x.shape[1])).astype(np.float32)
    dec["output"]["kernel"] = 3 * dec["output"]["kernel"]
    dec["output"]["bias"][2] += eos_bias  # how readily a hypothesis ends
    return params, stats


@pytest.fixture(scope="module")
def las_weights():
    return _weights(dict(LAS_SMALL, mtl_ctc_weight=0.3), 1.5, seed=7)


def _enc_batch(seed, B=3, T=17, U=5):
    rng = np.random.default_rng(seed)
    ylens = np.array([U, 3, 1][:B], np.int32)
    ys = rng.integers(3, V, size=(B, U)).astype(np.int32)
    ys = np.where(np.arange(U)[None, :] < ylens[:, None], ys, 2).astype(np.int32)
    ys_in = np.concatenate([np.full((B, 1), 2, np.int32), ys], axis=1)
    ys_out = np.concatenate([ys, np.full((B, 1), 2, np.int32)], axis=1)
    ys_out[np.arange(B), ylens] = 2
    return dict(eouts=rng.normal(size=(B, T, 32)).astype(np.float32), elens=np.array([T, 12, 6][:B], np.int32),
                ys=ys, ylens=ylens, ys_in=ys_in, ys_out=ys_out)


def test_las_decoder_matches_recorded_emoasr_outputs():
    fx = np.load(os.path.join(FIXDIR, "fixtures_dec_las.npz"))
    cfg = config_from_dict(dict(decoder_type="las", vocab_size=30, dec_hidden_size=32, dec_num_layers=2,
                                dec_intermediate_size=64, lsm_prob=0.1, enc_hidden_size=32, embedding_size=24))
    dec = LASDecoder(cfg, attn_dim=20)
    dec.load_state_dict({k[4:]: torch.from_numpy(fx[k]) for k in fx.files if k.startswith("sd::")})
    t = {k: torch.from_numpy(fx[k]) for k in ("eouts", "elens", "ys", "ylens", "ys_in", "ys_out")}
    with torch.no_grad():
        loss, loss_dict, logits = dec(t["eouts"], t["elens"], None, t["ys"], t["ylens"], t["ys_in"], t["ys_out"])
    np.testing.assert_allclose(loss.item(), float(fx["loss"]), rtol=1e-4)
    assert set(loss_dict) == {"loss_att", "loss_total"}
    for b, n in enumerate(fx["ylens"] + 1):
        np.testing.assert_allclose(logits[b, :n].numpy(), fx["logits"][b, :n], rtol=1e-3, atol=1e-4)


@pytest.mark.parametrize("branch", ["plain", "kd", "aux_ctc"])
def test_las_loss_branches_and_gradients_match_jax(las_weights, branch):
    params, _ = las_weights
    conf = dict(LAS_SMALL, mtl_ctc_weight=0.3 if branch == "aux_ctc" else 0.0,
                kd_weight=0.5 if branch == "kd" else 0.0)
    dec_params = {k: v for k, v in params["decoder"].items() if branch == "aux_ctc" or k != "ctc"}
    b = _enc_batch(3)
    soft = None
    if branch == "kd":
        rng = np.random.default_rng(4)
        soft = rng.dirichlet(np.ones(V), size=(3, 6)).astype(np.float32)
    jdec = JaxLAS(jax_config(conf))
    keys = ("eouts", "elens", "ys", "ylens", "ys_in", "ys_out")

    def jloss(p, eouts):
        args = [eouts] + [jnp.asarray(b[k]) for k in keys[1:]]
        loss, ld, _ = jdec.apply({"params": p}, args[0], args[1], None, *args[2:],
                                 soft_labels=None if soft is None else jnp.asarray(soft))
        return loss, ld

    (jl, jdict), (jg, jge) = jax.jit(jax.value_and_grad(jloss, argnums=(0, 1), has_aux=True))(
        dec_params, jnp.asarray(b["eouts"]))
    dec = LASDecoder(config_from_dict(conf))
    dec.load_state_dict(las_decoder_state_dict(dec_params, 2))
    t = {k: T_(v) for k, v in b.items()}
    eouts = t["eouts"].clone().requires_grad_(True)
    loss, loss_dict, _ = dec(eouts, t["elens"], None, t["ys"], t["ylens"], t["ys_in"], t["ys_out"],
                             soft_labels=None if soft is None else T_(soft))
    assert set(loss_dict) == set(jdict)
    for k in jdict:
        np.testing.assert_allclose(loss_dict[k].item(), float(jdict[k]), rtol=1e-5, err_msg=k)
    names = [n for n, _ in dec.named_parameters()]
    grads = torch.autograd.grad(loss, list(dec.parameters()) + [eouts])
    _close_grads(dict(zip(names, grads[:-1])), las_decoder_state_dict(jax.tree_util.tree_map(np.asarray, jg), 2))
    np.testing.assert_allclose(grads[-1].numpy(), np.asarray(jge), rtol=0,
                               atol=1e-4 * np.abs(np.asarray(jge)).max() + 1e-6)
    assert ctc_head.KERNEL.launches == ctc_lattice.KERNEL.launches == 0


def write_corpus(root, n_utts=16, V_=12, F=16, seg=12, seed=0):
    """A learnable corpus: one active feature channel per label segment."""
    rng = np.random.default_rng(seed)
    os.makedirs(os.path.join(root, "feats"), exist_ok=True)
    rows = []
    for i in range(n_utts):
        toks = rng.integers(3, V_, size=int(rng.integers(2, 5)))
        x = np.zeros((len(toks) * seg, F), np.float32)
        for u, t in enumerate(toks):
            x[u * seg:(u + 1) * seg, t % F] = 2.0
        x += rng.normal(size=x.shape).astype(np.float32) * 0.05
        p = os.path.join(root, "feats", f"u{i}.npy")
        np.save(p, x)
        rows.append(dict(feat_path=p, utt_id=f"spk-u{i}-{i * 1000}-{i * 1000 + len(x) * 10}",
                         token_id=" ".join(map(str, toks)), text=" ".join(f"w{t}" for t in toks),
                         xlen=len(x), ylen=len(toks)))
    tsv = os.path.join(root, "train.tsv")
    pd.DataFrame(rows).to_csv(tsv, sep="\t", index=False)
    vocab = os.path.join(root, "vocab.txt")
    with open(vocab, "w", encoding="utf-8") as f:
        f.write("\n".join(["<blank> 0", "<unk> 1", "<eos> 2"] + [f"▁w{i} {i}" for i in range(3, V_)]) + "\n")
    return tsv, vocab


def corpus_batch(tsv: str):
    """The corpus's features as one padded batch (xs (N, T, F), xlens (N,))."""
    df = pd.read_table(tsv)
    feats = [np.load(p) for p in df["feat_path"]]
    xs = np.zeros((len(feats), max(len(f) for f in feats), feats[0].shape[1]), np.float32)
    for i, f in enumerate(feats):
        xs[i, :len(f)] = f
    return xs, np.array([len(f) for f in feats], np.int32)


def train_cli(root, conf: dict, name: str):
    """The port's train CLI (`--cpu`) on `conf` -> (yaml path, train log)."""
    conf_path = os.path.join(root, f"{name}.yaml")
    with open(conf_path, "w") as f:
        yaml.safe_dump(conf, f)
    state = loop.main(["-conf", conf_path, "--cpu"])
    assert state.skipped == 0 and state.step == conf["num_epochs"] * 2
    with open(os.path.join(root, name, "log", "train.log")) as f:
        return conf_path, f.read()


def eval_clis(conf_path: str, ep: int, beam: int):
    """The port's and the JAX package's eval CLIs on `model.ep{ep}` ->
    (port TSV, JAX TSV)."""
    argv = ["-conf", conf_path, "-ep", str(ep), "--beam_width", str(beam)]
    jax_cli.test_main(jax_cli.build_argparser().parse_args(argv + ["--save_dir", "jax"]))
    port_cli.main(argv + ["--cpu", "--save_dir", "torch"])
    res = os.path.join(conf_path[:-len(".yaml")], "results")
    f = f"result_test_beam{beam}_len0.0_ctc0.0_lm0.00_ep{ep}.tsv"
    return os.path.join(res, "torch", f), os.path.join(res, "jax", f)


LAS_TRAIN = dict(
    encoder_type="transformer", input_layer="linear", feat_dim=16, enc_hidden_size=32,
    enc_num_attention_heads=2, enc_num_layers=1, enc_intermediate_size=64, decoder_type="las",
    dec_hidden_size=32, dec_num_layers=1, embedding_size=16, dec_intermediate_size=32, lsm_prob=0.1,
    vocab_size=12, buckets=[[64, 8]], batch_size=8, max_xlens_batch=512, max_ylens_batch=64, num_epochs=20,
    learning_rate=1.0, lr_schedule_type="noam", num_warmup_steps=10, dropout_enc_rate=0.0, dropout_attn_rate=0.0,
    dropout_dec_rate=0.0, spec_augment=False, clip_grad_norm=5.0, log_step=2, save_step=20, seed=0,
    max_decode_ylen=8,
)


@pytest.fixture(scope="module")
def trained(tmp_path_factory):
    """LAS(Transformer) trained through the port's train CLI (label
    smoothing 0.1, greedy validation each epoch) on the 16-utterance corpus;
    -> (yaml path, config dict, train log, the port model, JAX params)."""
    root = str(tmp_path_factory.mktemp("las"))
    tsv, vocab = write_corpus(root)
    conf = dict(LAS_TRAIN, vocab_path=vocab, train_path=tsv, dev_path=tsv, test_path=tsv)
    conf_path, log = train_cli(root, conf, "las")
    sd = torch.load(os.path.join(root, "las", "checkpoints", "model.ep20"), map_location="cpu")
    model = ASR(config_from_dict(conf))
    model.load_state_dict(sd)
    params, _ = ti.asr_model({k: v.numpy() for k, v in sd.items()}, jax_config(conf))
    return conf_path, conf, log, model.eval(), params


@pytest.fixture(scope="module")
def lms():
    V_ = LAS_TRAIN["vocab_size"]
    return {"transformer": lm_pair(dict(TRF_LM, vocab_size=V_), seed=11),
            "rnn": lm_pair(dict(RNN_LM, vocab_size=V_), seed=12)}


@pytest.mark.parametrize("beam,len_w,lm_type", [
    (1, 0.0, None), (3, 0.0, None), (3, 1.0, None), (3, 0.0, "transformer"), (3, 1.0, "rnn")])
def test_las_greedy_and_beam_match_jax(trained, lms, beam, len_w, lm_type):
    """The trained decoder on its encoder's outputs for the corpus."""
    conf_path, conf, _, model, params = trained
    xs, xlens = corpus_batch(conf["train_path"])
    with torch.no_grad():
        eouts, elens, _ = model.encode(T_(xs), T_(xlens).long())
    jdec, jv, dec = JaxLAS(jax_config(conf)), {"params": params["decoder"]}, model.decoder
    e, el = jnp.asarray(eouts.numpy()), jnp.asarray(elens.numpy())
    jfusion = fusion = None
    if lm_type is not None:
        jm, jlv, port_lm = lms[lm_type]
        jfusion, fusion = jax_make_lm_fusion(jm, jlv, 0.5), make_lm_fusion(port_lm, 0.5)
        assert (fusion.indirect is not None) == (lm_type == "transformer")
    ref = jax.jit(lambda v, e, el: jdec.apply(v, e, el, beam, len_w, lm=jfusion, method=JaxLAS.decode_beam))(
        jv, e, el)
    before = topk.KERNEL.launches
    got = dec.decode_beam(eouts, elens, beam, len_w, lm=fusion)
    assert topk.KERNEL.launches == before  # CPU tensors: the plain top-k
    _same(got, ref, f"beam {beam} len {len_w} lm {lm_type}")
    ended = got[2][:, 0] > -1e29
    assert ended.float().mean() >= 0.5 and int(got[1][:, 0].max()) >= 5
    jhyps, jn = jax.jit(lambda v, e, el: jdec.apply(v, e, el, method=JaxLAS.decode_greedy))(jv, e, el)
    hyps, n = dec.decode_greedy(eouts, elens)
    np.testing.assert_array_equal(n.numpy(), np.asarray(jn))
    for r in range(len(n)):
        np.testing.assert_array_equal(hyps[r, :n[r]].numpy(), np.asarray(jhyps)[r, :int(jn[r])])
    if beam == 1 and lm_type is None:
        # width 1 is greedy: a row the beam ends holds greedy's labels between its framing eos
        for r in np.flatnonzero(ended.numpy()):
            L = int(got[1][r, 0])
            np.testing.assert_array_equal(got[0][r, 0, 1:L - 1].numpy(), hyps[r, :n[r]].numpy())


@pytest.mark.parametrize("beam", [0, 3])
def test_build_decode_fn_matches_jax(trained, beam):
    conf_path, conf, _, model, params = trained
    jcfg = jax_config(conf)
    jfn = jax_build_decode_fn(JaxASR(jcfg), {"params": params}, jcfg, beam, 1.0)
    fn = build_decode_fn(model, model.cfg, beam, 1.0, device="cpu")
    xs, xlens = corpus_batch(conf["train_path"])
    got, ref = fn(xs, xlens), jfn(jnp.asarray(xs), jnp.asarray(xlens))
    if beam:
        _same(got, ref, "build_decode_fn")
        assert bool((got[2][:, 0] > -1e29).all())
    else:
        for g, r in zip(got, ref):
            np.testing.assert_array_equal(g.numpy(), np.asarray(r))


def test_las_train_cli_then_eval_clis_agree(trained):
    """The loss of the training fell; both eval CLIs decode its checkpoint
    to the same TSV, greedily and with beam 3."""
    conf_path, conf, log, _, _ = trained
    losses = [float(x.split("loss_total: ")[1].split()[0]) for x in log.splitlines() if "loss_total" in x]
    assert len(losses) == 20 and losses[-1] < 0.5 * losses[0]
    assert log.count("dev WER (greedy)") == 20
    for beam in (1, 3):
        port_tsv, jax_tsv = eval_clis(conf_path, 20, beam)
        got, ref = pd.read_table(port_tsv, comment="#"), pd.read_table(jax_tsv, comment="#")
        assert len(got) == 16
        pd.testing.assert_frame_equal(got, ref)
        with open(port_tsv) as a, open(jax_tsv) as b:
            assert a.readline() == b.readline()
