"""The port's RNN encoder and a CTC(RNN) model against the JAX package and
the emoASR outputs recorded in tests/fixtures_enc_rnn.npz, on the CPU.

- `RNNEncoder` with the recorded `sd::` weights: elens exact, eouts within
  1e-4 on the valid frames (what tests/test_encoders.py:71 holds the JAX
  encoder to), zero past each length.
- `RNNEncoder` against the JAX `RNNEncoder` on a JAX-built checkpoint
  carried across by `flax_import.asr_state_dict`: directions summed and
  concatenated, the conv2d and the `none` input layer, the JAX recurrence
  by its scan and by its LSTM kernel
  (`USE_PALLAS`, interpret mode, as tests/test_lstm_pallas.py runs it);
  outputs within 1e-5, the gradients of a weighted sum within 1e-4 of each
  tensor's largest entry + 1e-6.
- A CTC(RNN) model: the loss and every gradient against
  `jax.value_and_grad`, and 4 micro-steps of the train step with
  `accum_grad: 2` (two optimizer updates) against the JAX
  `make_train_step`, with the tolerances of `test_torch_rnnt_train.py`.
- The train CLI trains a CTC(RNN) model (`--cpu`) until its loss halves;
  the port's and the JAX package's eval CLIs decode its `model.ep{N}` to
  the same TSV, greedily and with the prefix beam 4.

Sizes: conv2d to 32 (or the 20 features as they are), 2 biLSTM layers of
32 (16 a direction when concatenated), T' = 10 or 45 (the port's recurrence is the plain scan on the
CPU; the kernel's arithmetic is held in tests/test_torch_lstm_arith.py),
V = 29.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pandas as pd
import pytest
import torch

from emoasr_tpu.config import config_from_dict as jax_config
from emoasr_tpu.models.asr import ASR as JaxASR
from emoasr_tpu.models.encoders import RNNEncoder as JaxRNNEncoder
from emoasr_tpu.ops import lstm as jax_lstm
from emoasr_tpu.train import optim as joptim
from emoasr_tpu.train.step import init_train_state
from emoasr_tpu.train.step import make_train_step as jax_make_train_step
from emoasr_tpu_torch.config import config_from_dict
from emoasr_tpu_torch.models.encoders import RNNEncoder, build_encoder
from emoasr_tpu_torch.ops import ctc_head, ctc_lattice, lstm_scan
from emoasr_tpu_torch.train import optim
from emoasr_tpu_torch.train.step import TrainState, make_train_step
from emoasr_tpu_torch.utils.flax_import import asr_state_dict, rnn_encoder_state_dict
from test_torch_las import eval_clis, train_cli, write_corpus
from test_torch_rnnt import T_, _close_grads, port_model, random_rnnt_params

FIXDIR = os.path.dirname(os.path.abspath(__file__))
V = 29

ENC = dict(input_layer="conv2d", feat_dim=20, num_framestacks=1, enc_hidden_size=32, enc_num_layers=2,
           dropout_enc_rate=0.0, encoder_type="rnn")
CTC_RNN_SMALL = dict(
    ENC, decoder_type="ctc", vocab_size=V, blank_id=0, eos_id=2, spec_augment=False,
    lr_schedule_type="noam", learning_rate=2.0, num_warmup_steps=4, clip_grad_norm=5.0,
    weight_decay=1e-3, accum_grad=2,
)


def _batch(seed=0, B=3, Tn=45, U=5):
    rng = np.random.default_rng(seed)
    ylens = np.array([U, 3, 1][:B], np.int32)
    ys = rng.integers(3, V, size=(B, U)).astype(np.int32)
    ys = np.where(np.arange(U)[None, :] < ylens[:, None], ys, 2).astype(np.int32)
    return dict(xs=rng.normal(size=(B, Tn, 20)).astype(np.float32), xlens=np.array([45, 30, 17][:B], np.int32),
                ys=ys, ylens=ylens)


def test_rnn_encoder_matches_recorded_emoasr_outputs():
    fx = np.load(os.path.join(FIXDIR, "fixtures_enc_rnn.npz"))
    enc = build_encoder(config_from_dict(ENC))
    assert isinstance(enc, RNNEncoder)
    enc.load_state_dict({k[4:]: torch.from_numpy(fx[k]) for k in fx.files if k.startswith("sd::")})
    with torch.no_grad():
        eouts, elens, inter = enc.eval()(torch.from_numpy(fx["xs"]), torch.from_numpy(fx["xlens"]))
    assert inter is None
    np.testing.assert_array_equal(elens.numpy(), fx["elens"])
    for b, n in enumerate(fx["elens"]):
        np.testing.assert_allclose(eouts[b, :n].numpy(), fx["eouts"][b, :n], rtol=1e-4, atol=1e-4)
        assert not eouts[b, n:].any()


@pytest.mark.parametrize("use_pallas", [False, True])
@pytest.mark.parametrize("summed,input_layer", [(True, "conv2d"), (False, "conv2d"), (True, "none")])
def test_rnn_encoder_matches_jax(summed, input_layer, use_pallas, monkeypatch):
    conf = dict(ENC, enc_hidden_sum_fwd_bwd=summed, input_layer=input_layer)
    jcfg = jax_config(conf)
    b = _batch(4)
    jenc = JaxRNNEncoder(jcfg)
    variables = jax.eval_shape(lambda: jenc.init(jax.random.PRNGKey(0), jnp.asarray(b["xs"]),
                                                 jnp.asarray(b["xlens"])))
    rng = np.random.default_rng(5)
    params = jax.tree_util.tree_map(lambda x: (0.2 * rng.normal(size=x.shape)).astype(np.float32),
                                    variables["params"])
    monkeypatch.setattr(jax_lstm, "USE_PALLAS", use_pallas)
    T_out = 10 if input_layer == "conv2d" else 45
    wsum = np.random.default_rng(6).normal(size=(3, T_out, 32)).astype(np.float32)

    def jfn(p):
        eouts, elens, _ = jenc.apply({"params": p}, jnp.asarray(b["xs"]), jnp.asarray(b["xlens"]))
        return jnp.sum(eouts * wsum), (eouts, elens)

    (_, (jeouts, jelens)), jgrads = jax.jit(jax.value_and_grad(jfn, has_aux=True))(params)
    enc = RNNEncoder(config_from_dict(conf))
    enc.load_state_dict(rnn_encoder_state_dict(params, 2))
    eouts, elens, _ = enc.eval()(T_(b["xs"]), T_(b["xlens"]))
    np.testing.assert_array_equal(elens.numpy(), np.asarray(jelens))
    np.testing.assert_allclose(eouts.detach().numpy(), np.asarray(jeouts), rtol=0, atol=1e-5)
    for bi, n in enumerate(np.asarray(jelens)):
        assert not eouts[bi, n:].any()
    names = [n for n, _ in enc.named_parameters()]
    grads = dict(zip(names, torch.autograd.grad((eouts * T_(wsum)).sum(), list(enc.parameters()))))
    _close_grads(grads, rnn_encoder_state_dict(jax.tree_util.tree_map(np.asarray, jgrads), 2))
    assert lstm_scan.KERNEL.launches == 0


@pytest.fixture(scope="module")
def weights():
    return random_rnnt_params(CTC_RNN_SMALL, seed=2)


def test_ctc_rnn_loss_and_gradients_match_jax(weights):
    params, stats = weights
    b = _batch(1)
    jcfg = jax_config(CTC_RNN_SMALL)

    def jloss(p):
        return JaxASR(jcfg).apply({"params": p}, *(jnp.asarray(b[k]) for k in ("xs", "xlens", "ys", "ylens")),
                                  None, None, deterministic=True)

    (jl, jdict), jgrads = jax.jit(jax.value_and_grad(jloss, has_aux=True))(params)
    model = port_model(CTC_RNN_SMALL, params, stats).eval()
    t = {k: T_(v) for k, v in b.items()}
    loss, loss_dict = model(t["xs"], t["xlens"], t["ys"], t["ylens"])
    names = [n for n, _ in model.named_parameters()]
    grads = dict(zip(names, torch.autograd.grad(loss, list(model.parameters()))))
    np.testing.assert_allclose(loss.item(), float(jl), rtol=1e-5)
    for k in jdict:
        np.testing.assert_allclose(loss_dict[k].item(), float(jdict[k]), rtol=1e-5, err_msg=k)
    _close_grads(grads, asr_state_dict(jax.tree_util.tree_map(np.asarray, jgrads), config_from_dict(CTC_RNN_SMALL)))
    for k in (lstm_scan.KERNEL, ctc_head.KERNEL, ctc_lattice.KERNEL):
        assert k.launches == 0


def test_ctc_rnn_two_optimizer_updates_match_jax_train_step(weights):
    params, stats = weights
    batches = [_batch(10 + i) for i in range(4)]
    jcfg = jax_config(CTC_RNN_SMALL)
    tx = joptim.build_optimizer(jcfg)
    jstate = init_train_state(params, stats, tx)
    jstep = jax_make_train_step(JaxASR(jcfg), jcfg, tx)
    cfg = config_from_dict(CTC_RNN_SMALL)
    model = port_model(CTC_RNN_SMALL, params, stats)
    state = TrainState(model=model, optimizer=optim.build_optimizer(cfg, model.parameters()))
    step = make_train_step(cfg)
    lrs = []
    for i, b in enumerate(batches):
        jb = dict(b, ys_in=b["ys"], ys_out=b["ys"])
        jstate, m = jstep(jstate, {k: jnp.asarray(v) for k, v in jb.items()}, jax.random.PRNGKey(i))
        mt = step(state, {k: T_(v.copy()) for k, v in b.items()})
        np.testing.assert_allclose(mt["loss_total"].item(), float(m["loss_total"]), rtol=2e-4)
        np.testing.assert_allclose(mt["lr"], float(m["lr"]), rtol=2e-6)
        assert mt["grad_finite"] and bool(m["grad_finite"])
        lrs.append(mt["lr"])
    assert state.step == int(jstate.step) == 4 and state.skipped == 0
    lrs = [lrs[1], lrs[3]]
    ref = asr_state_dict(jax.tree_util.tree_map(np.asarray, jstate.params), cfg)
    start = asr_state_dict(params, cfg)
    for name, p in model.named_parameters():
        diff = np.abs(p.detach().numpy() - ref[name].numpy())
        assert diff.max() <= 1.01 * sum(lrs), name
        assert (diff > 0.02 * max(lrs)).mean() <= 0.01, (name, diff.max(), max(lrs))
        assert np.abs(ref[name].numpy() - start[name].numpy()).max() > 0.5 * max(lrs), name  # it moved


def test_ctc_rnn_train_cli_then_eval_clis_agree(tmp_path):
    tsv, vocab = write_corpus(str(tmp_path))
    conf = dict(
        ENC, feat_dim=16, decoder_type="ctc", vocab_size=12, vocab_path=vocab, train_path=tsv, dev_path=tsv,
        test_path=tsv, buckets=[[64, 8]], batch_size=8, max_xlens_batch=512, max_ylens_batch=64, num_epochs=24,
        learning_rate=3e-2, lr_schedule_type="epdecay", num_warmup_steps=1, spec_augment=False, clip_grad_norm=5.0,
        log_step=2, save_step=24, seed=0,
    )
    conf_path, log = train_cli(str(tmp_path), conf, "ctc_rnn")
    losses = [float(x.split("loss_total: ")[1].split()[0]) for x in log.splitlines() if "loss_total" in x]
    assert len(losses) == 24 and losses[-1] < 0.5 * losses[0]
    for beam in (1, 4):
        port_tsv, jax_tsv = eval_clis(conf_path, 24, beam)
        got, ref = pd.read_table(port_tsv, comment="#"), pd.read_table(jax_tsv, comment="#")
        assert len(got) == 16
        pd.testing.assert_frame_equal(got, ref)
        with open(port_tsv) as a, open(jax_tsv) as b:
            assert a.readline() == b.readline()
