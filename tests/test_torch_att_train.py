"""Training of the attention family (L3-style: Conformer encoder, Transformer
decoder, auxiliary CTC) in the port against the JAX package, on the CPU.

- `label_smoothing_loss` (closed-form smoothed target) against the JAX
  one-hot form, with `normalize_length` on and off, loss and gradient.
- The decoder's loss with MTL CTC 0.3, through the fused CTC head (K1/K2's
  plain versions) and the dense route, against the JAX decoder: loss terms
  and every gradient.
- `ASR.forward` loss and gradients of the whole model, `enc_fused_attn` on
  and off; two optimizer updates (4 micro-steps, `accum_grad: 2`) against
  the JAX `make_train_step`; one `compute_dtype: bfloat16` micro-step
  within the JAX bf16 step's own distance from its f32 step (measured over
  the model: see `test_bf16_micro_step_matches_jax`).
- `greedy_valid_wer` (a width-1 attention beam) against the JAX one.
- The train CLI on a tiny corpus, then the port's and the JAX package's
  eval CLIs on the port's `model.ep{N}`: the same TSV.

Sizes: 1 Conformer layer and 2 decoder layers (the JAX side's compile
time grows with depth), d = 32, 4 heads, FF 64, V = 50 (the CLI case 1 + 1
layers, V = 12).  Tolerances: losses rtol 1e-5
(label smoothing 1e-6); gradients within 1e-4 of each tensor's largest
entry + 1e-6, parameters after Adam as in `test_torch_train.py` (2 % of
the LR on all but 1 % of each tensor's entries, the sum of the LRs
everywhere); the WER and the TSV exactly.
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
from emoasr_tpu.data.asr_dataset import ASRDataset as JaxASRDataset
from emoasr_tpu.eval import test_asr as jax_cli
from emoasr_tpu.models.asr import ASR as JaxASR
from emoasr_tpu.models.criteria import label_smoothing_loss as jax_lsm_loss
from emoasr_tpu.models.decoders.transformer import TransformerDecoder as JaxDecoder
from emoasr_tpu.train import optim as joptim
from emoasr_tpu.train.loop import greedy_valid_wer as jax_greedy_valid_wer
from emoasr_tpu.train.step import init_train_state
from emoasr_tpu.train.step import make_train_step as jax_make_train_step
from emoasr_tpu_torch.config import config_from_dict
from emoasr_tpu_torch.data.asr_dataset import ASRDataset
from emoasr_tpu_torch.eval import test_asr as port_cli
from emoasr_tpu_torch.models.criteria import distill_loss, label_smoothing_loss
from emoasr_tpu_torch.models.decoders import ctc as ctc_dec
from emoasr_tpu_torch.ops import attention, ctc_head, ctc_lattice
from emoasr_tpu_torch.train import loop, optim
from emoasr_tpu_torch.train.step import TrainState, compute_loss, make_train_step
from emoasr_tpu_torch.utils.flax_import import asr_state_dict
from test_e2e_overfit import _make_corpus
from test_torch_conformer import L3_SMALL, port_model, random_l3_params
from test_torch_train import _assert_grads_close

T_ = torch.from_numpy
V = 50
L3_TRAIN = dict(L3_SMALL, enc_num_layers=1, dec_num_layers=2, lsm_prob=0.1, lr_schedule_type="noam",
                learning_rate=2.0, num_warmup_steps=4, clip_grad_norm=5.0, weight_decay=1e-3, accum_grad=2)


@pytest.fixture(scope="module")
def weights():
    return random_l3_params(L3_TRAIN, seed=21)


def l3_batch(seed=0, B=3, T=45, F=20, U=5):
    """An attention batch as `data/asr_dataset.py::collate` frames it:
    ys_in = eos + ys, ys_out = ys + eos, both padded with eos."""
    rng = np.random.default_rng(seed)
    ylens = np.array([5, 3, 2][:B], np.int32)
    ys = np.full((B, U), 2, np.int32)
    ys_in = np.full((B, U + 1), 2, np.int32)
    ys_out = np.full((B, U + 1), 2, np.int32)
    for b, n in enumerate(ylens):
        y = rng.integers(3, V, size=n)
        ys[b, :n], ys_in[b, 1:1 + n], ys_out[b, :n] = y, y, y
    return dict(xs=rng.normal(size=(B, T, F)).astype(np.float32), xlens=np.array([45, 30, 17][:B], np.int32),
                ys=ys, ylens=ylens, ys_in=ys_in, ys_out=ys_out)


def _grads(model, loss):
    names = [n for n, _ in model.named_parameters()]
    return dict(zip(names, torch.autograd.grad(loss, list(model.parameters()))))


@pytest.mark.parametrize("lsm_prob,normalize_length,normalize_batch", [
    (0.1, False, True), (0.1, True, True), (0.0, False, True), (0.2, True, False)])
def test_label_smoothing_matches_jax(lsm_prob, normalize_length, normalize_batch):
    """The closed form (1 - p) logp[y] + p / (V - 1) (sum logp - logp[y])
    against the JAX one-hot product: loss and gradient w.r.t. the logits,
    rtol 1e-6 (float32 sums in another order)."""
    rng = np.random.default_rng(3)
    logits = (3 * rng.normal(size=(4, 7, 11))).astype(np.float32)
    ys = rng.integers(0, 11, size=(4, 7)).astype(np.int32)
    ylens = np.array([7, 4, 1, 0], np.int32)
    kw = dict(lsm_prob=lsm_prob, normalize_length=normalize_length, normalize_batch=normalize_batch)
    jl, jg = jax.value_and_grad(lambda x: jax_lsm_loss(x, jnp.asarray(ys), jnp.asarray(ylens), **kw))(
        jnp.asarray(logits))
    x = T_(logits).requires_grad_()
    loss = label_smoothing_loss(x, T_(ys), T_(ylens), **kw)
    (g,) = torch.autograd.grad(loss, x)
    np.testing.assert_allclose(loss.item(), float(jl), rtol=1e-6)
    np.testing.assert_allclose(g.numpy(), np.asarray(jg), rtol=0, atol=1e-6 * np.abs(np.asarray(jg)).max())


@pytest.mark.parametrize("fused_head", [True, False])
def test_decoder_loss_matches_jax(weights, monkeypatch, fused_head):
    """The decoder's loss branch with MTL CTC 0.3 (loss_att, loss_ctc,
    loss_total) and the gradients of its parameters and of the encoder
    output, the CTC loss through the fused head (K1, K2) or the dense
    route."""
    monkeypatch.setattr(ctc_dec, "USE_FUSED_HEAD", fused_head)
    params, stats = weights
    b = l3_batch(1)
    rng = np.random.default_rng(5)
    eouts, elens = rng.normal(size=(3, 10, 32)).astype(np.float32), np.array([10, 7, 4], np.int32)
    jb = {k: jnp.asarray(v) for k, v in b.items()}

    def jloss(p, e):
        return JaxDecoder(jax_config(L3_TRAIN)).apply(
            {"params": p}, e, jnp.asarray(elens), None, jb["ys"], jb["ylens"], jb["ys_in"], jb["ys_out"])[:2]

    (jl, jdict), (jg, jge) = jax.jit(jax.value_and_grad(jloss, argnums=(0, 1), has_aux=True))(
        params["decoder"], jnp.asarray(eouts))
    dec = port_model(L3_TRAIN, params, stats).decoder
    e = T_(eouts).requires_grad_()
    t = {k: T_(v) for k, v in b.items()}
    loss, loss_dict, logits = dec(e, T_(elens), None, t["ys"], t["ylens"], t["ys_in"], t["ys_out"])
    assert logits.shape == (3, 6, V)
    assert set(loss_dict) == set(jdict) == {"loss_att", "loss_ctc", "loss_total"}
    for k in jdict:
        np.testing.assert_allclose(loss_dict[k].item(), float(jdict[k]), rtol=1e-5, err_msg=k)
    grads = torch.autograd.grad(loss, [e] + list(dec.parameters()))
    np.testing.assert_allclose(grads[0].numpy(), np.asarray(jge), rtol=0, atol=1e-4 * np.abs(np.asarray(jge)).max())
    ref = asr_state_dict({"encoder": params["encoder"], "decoder": jax.tree_util.tree_map(np.asarray, jg)},
                         config_from_dict(L3_TRAIN), stats)
    names = [f"decoder.{n}" for n, _ in dec.named_parameters()]
    _assert_grads_close(dict(zip(names, grads[1:])), ref)
    assert ctc_head.KERNEL.launches == ctc_lattice.KERNEL.launches == 0  # CPU tensors: the plain versions


@pytest.mark.parametrize("fused", [False, True])
def test_asr_loss_and_gradients_match_jax(weights, fused):
    conf = dict(L3_TRAIN, enc_fused_attn=fused)
    params, stats = weights
    b = l3_batch(2)
    jb = {k: jnp.asarray(v) for k, v in b.items()}

    def jloss(p):
        return JaxASR(jax_config(conf)).apply(
            {"params": p, "batch_stats": stats}, jb["xs"], jb["xlens"], jb["ys"], jb["ylens"], jb["ys_in"],
            jb["ys_out"], deterministic=True)

    (jl, jdict), jgrads = jax.jit(jax.value_and_grad(jloss, has_aux=True))(params)
    model = port_model(conf, params, stats)
    t = {k: T_(v) for k, v in b.items()}
    loss, loss_dict = model(t["xs"], t["xlens"], t["ys"], t["ylens"], t["ys_in"], t["ys_out"])
    np.testing.assert_allclose(loss.item(), float(jl), rtol=1e-5)
    assert set(loss_dict) == set(jdict)
    for k in jdict:
        np.testing.assert_allclose(loss_dict[k].item(), float(jdict[k]), rtol=1e-5, err_msg=k)
    grads = _grads(model, loss)
    ref = asr_state_dict(jax.tree_util.tree_map(np.asarray, jgrads), config_from_dict(conf))
    assert set(ref) == set(grads)
    _assert_grads_close(grads, ref)
    assert attention.KERNEL.launches == ctc_head.KERNEL.launches == 0


def test_two_optimizer_updates_match_jax_train_step(weights):
    params, stats = weights
    conf = dict(L3_TRAIN, enc_fused_attn=True)
    batches = [l3_batch(10 + i) for i in range(4)]
    jcfg = jax_config(conf)
    tx = joptim.build_optimizer(jcfg)
    jstate = init_train_state(params, stats, tx)
    jstep = jax_make_train_step(JaxASR(jcfg), jcfg, tx)
    cfg = config_from_dict(conf)
    model = port_model(conf, params, stats)
    state = TrainState(model=model, optimizer=optim.build_optimizer(cfg, model.parameters()))
    step = make_train_step(cfg)
    tm = []
    for i, b in enumerate(batches):
        jstate, m = jstep(jstate, {k: jnp.asarray(v) for k, v in b.items()}, jax.random.PRNGKey(i))
        mt = step(state, {k: T_(v.copy()) for k, v in b.items()})
        for k in ("loss_att", "loss_ctc", "loss_total"):
            np.testing.assert_allclose(mt[k].item(), float(m[k]), rtol=2e-4, err_msg=k)
        np.testing.assert_allclose(mt["lr"], float(m["lr"]), rtol=2e-6)
        tm.append(mt)
    assert state.step == int(jstate.step) == 4 and state.mini_step == 0 and state.skipped == 0
    lrs = [tm[1]["lr"], tm[3]["lr"]]
    ref = asr_state_dict(jax.tree_util.tree_map(np.asarray, jstate.params), cfg,
                         jax.tree_util.tree_map(np.asarray, jstate.batch_stats))
    start = asr_state_dict(params, cfg, stats)
    for name, p in model.named_parameters():
        diff = np.abs(p.detach().numpy() - ref[name].numpy())
        assert diff.max() <= 1.01 * sum(lrs), name
        assert (diff > 0.02 * max(lrs)).mean() <= 0.01, (name, diff.max(), max(lrs))
        assert np.abs(ref[name].numpy() - start[name].numpy()).max() > 0.5 * max(lrs), name  # it moved
    for name, buf in model.named_buffers():
        if "running" in name:
            np.testing.assert_allclose(buf.numpy(), ref[name].numpy(), rtol=0, atol=1e-5, err_msg=name)


def test_bf16_micro_step_matches_jax(weights):
    """`compute_dtype: bfloat16`, one micro-step from the same float32
    weights (K1 and K4 with its bias through their bf16 plain versions),
    held within the JAX bf16 step's own distance from its float32 step.

    The attention decoder's FF input weights take their gradient through
    relu'(h), which bf16 flips at entries near 0: over weight seeds the
    JAX bf16 step's own error on such a tensor ranges from 1 % to 24 % of
    its largest entry, so one tensor's JAX error is no yardstick for the
    same tensor in the port (`assert_bf16_micro_step_matches_jax`'s
    per-tensor rule, which the CTC family meets).  Here the yardsticks are
    the model's: the whole gradient's relative L2 distance from the JAX
    float32 gradient within 1.5 times the JAX bf16 step's, and every
    tensor within twice the JAX bf16 step's largest per-tensor error (of
    its largest entry; the key and depthwise biases, whose true gradient is
    zero, against the model's largest entry).  Loss rtol 5e-3; after one
    update of the step the masters, the Adam moments and the BatchNorm
    statistics are float32 (the bf16 update itself is held against JAX for
    the CTC family in `test_torch_train.py`)."""
    from test_torch_train import _jax_loss_and_grads, _port_state, _to_torch

    params, stats = weights
    conf16 = dict(L3_TRAIN, enc_fused_attn=True, compute_dtype="bfloat16", accum_grad=1)
    cfg = config_from_dict(conf16)
    batch = l3_batch(2)
    jl, jg = _jax_loss_and_grads(conf16, params, stats, batch, cfg)
    _, jg32 = _jax_loss_and_grads(dict(conf16, compute_dtype="float32"), params, stats, batch, cfg)
    _, state = _port_state(conf16, params, stats)
    state.model.train()
    loss, _ = compute_loss(state.model, cfg, _to_torch(batch))
    grads = {k: v.numpy() for k, v in _grads(state.model, loss).items()}
    np.testing.assert_allclose(loss.item(), jl, rtol=5e-3)
    ref32 = {k: v.numpy() for k, v in jg32.items()}
    top = max(np.abs(v).max() for v in ref32.values())

    def rel(got, name):
        scale = top if name.endswith(("linear_k.bias", "depthwise_conv.bias")) else np.abs(ref32[name]).max()
        return np.abs(got - ref32[name]).max() / scale

    def l2(g):
        return (sum(((g[k] - ref32[k]) ** 2).sum() for k in g) / sum((v ** 2).sum() for v in ref32.values())) ** 0.5

    jax_worst = max(rel(jg[k].numpy(), k) for k in grads)
    for k, g in grads.items():
        assert rel(g, k) <= 2 * jax_worst, (k, rel(g, k), jax_worst)
    assert l2(grads) <= 1.5 * l2({k: v.numpy() for k, v in jg.items()})

    # one update of the step: masters, Adam moments and BatchNorm statistics stay float32
    _, state = _port_state(conf16, params, stats)
    tm = make_train_step(cfg)(state, _to_torch(batch))
    np.testing.assert_allclose(tm["loss_total"].item(), jl, rtol=5e-3)
    assert tm["grad_finite"]
    assert all(p.dtype == torch.float32 for p in state.model.parameters())
    moments = [v for st in state.optimizer.state.values() for v in st.values() if torch.is_tensor(v) and v.dim()]
    assert moments and all(v.dtype == torch.float32 for v in moments)
    assert all(b.dtype == torch.float32 for n, b in state.model.named_buffers() if "running" in n)


def _l3_corpus(root, n=6, T=45, F=20, seed=4):
    rng = np.random.default_rng(seed)
    os.makedirs(os.path.join(root, "feats"), exist_ok=True)
    rows = []
    for i in range(n):
        U = int(rng.integers(1, 6))
        path = os.path.join(root, "feats", f"u{i}.npy")
        np.save(path, rng.normal(size=(T - 2 * i, F)).astype(np.float32))
        toks = rng.integers(3, V, size=U)
        rows.append(dict(feat_path=path, utt_id=f"spk-u{i}-{i * 1000}-{i * 1000 + 450}",
                         token_id=" ".join(map(str, toks)), text=" ".join(f"w{t}" for t in toks),
                         xlen=T - 2 * i, ylen=U))
    tsv = os.path.join(root, "dev.tsv")
    pd.DataFrame(rows).to_csv(tsv, sep="\t", index=False)
    return tsv


def test_greedy_valid_wer_matches_jax(weights, tmp_path):
    """The per-epoch validation of an attention model: a width-1 beam over
    the dev set, the same WER as the JAX `greedy_valid_wer`; the model is
    back in train mode afterwards."""
    params, stats = weights
    params = jax.tree_util.tree_map(np.array, params)
    params["decoder"]["output"]["bias"][2] += 2.0  # some hypotheses end before their cap
    conf = dict(L3_TRAIN, buckets=[[48, 8]], batch_size=4, max_xlens_batch=400, max_ylens_batch=64)
    tsv = _l3_corpus(str(tmp_path))

    class JState:
        pass

    js = JState()
    js.params, js.batch_stats = params, stats
    jcfg = jax_config(conf)
    want = jax_greedy_valid_wer(jcfg, JaxASR(jcfg), js, JaxASRDataset(jcfg, tsv, phase="valid"))
    cfg = config_from_dict(conf)
    model = port_model(conf, params, stats).train()
    got = loop.greedy_valid_wer(cfg, model, ASRDataset(cfg, tsv, phase="valid"))
    assert got == want and model.training
    assert 0 < got  # random weights


def test_train_cli_then_eval_clis_agree(tmp_path):
    """A tiny Conformer + Transformer-decoder model (label smoothing 0.1,
    aux CTC 0.3) through the port's train CLI (`--cpu`), with per-epoch
    validation by the width-1 beam; the loss falls; then the port's and
    the JAX package's eval CLIs decode its `model.ep{N}` with beam 2 and
    joint CTC 0.3 to the same TSV."""
    tsv, vocab = _make_corpus(tmp_path, n_utts=16)
    conf = dict(
        encoder_type="conformer", decoder_type="transformer", pos_encode_type="rel", input_layer="linear",
        feat_dim=16, enc_hidden_size=32, enc_num_attention_heads=2, enc_num_layers=1, enc_intermediate_size=64,
        conv_kernel_size=3, dec_hidden_size=32, dec_num_attention_heads=2, dec_num_layers=1,
        dec_intermediate_size=64, mtl_ctc_weight=0.3, lsm_prob=0.1, vocab_size=12, vocab_path=vocab,
        train_path=tsv, dev_path=tsv, test_path=tsv, buckets=[[32, 8]], batch_size=8, max_xlens_batch=512,
        max_ylens_batch=64, num_epochs=12, learning_rate=5.0, lr_schedule_type="noam", num_warmup_steps=12,
        dropout_enc_rate=0.0, dropout_attn_rate=0.0, dropout_dec_rate=0.0, spec_augment=False,
        clip_grad_norm=5.0, log_step=2, save_step=12, seed=0, max_decode_ylen=8,
    )
    conf_path = tmp_path / "l3.yaml"
    conf_path.write_text(yaml.safe_dump(conf))
    state = loop.main(["-conf", str(conf_path), "--cpu"])
    assert state.step == 24 and state.skipped == 0
    with open(tmp_path / "l3" / "log" / "train.log") as f:
        log = f.read()
    losses = [float(x.split("loss_total: ")[1].split()[0]) for x in log.splitlines() if "loss_total" in x]
    assert len(losses) == 12 and losses[-1] < 0.7 * losses[0]
    assert log.count("dev WER (greedy)") == 12
    argv = ["-conf", str(conf_path), "-ep", "12", "--beam_width", "2", "--decode_ctc_weight", "0.3"]
    jax_cli.test_main(jax_cli.build_argparser().parse_args(argv + ["--save_dir", "jax"]))
    port_cli.main(argv + ["--cpu", "--save_dir", "torch"])
    res = tmp_path / "l3" / "results"
    name = "result_test_beam2_len0.0_ctc0.3_lm0.00_ep12.tsv"
    got, ref = pd.read_table(res / "torch" / name, comment="#"), pd.read_table(res / "jax" / name, comment="#")
    assert len(got) == 16
    pd.testing.assert_frame_equal(got, ref)
    assert (res / "torch" / name).read_text().splitlines()[0] == (res / "jax" / name).read_text().splitlines()[0]


def test_distillation_branch_raises_and_names_its_slice(weights):
    params, stats = weights
    """Slice 7b ported the distillation branch: with soft labels the
    attention loss is `distill_loss` of the logits (its JAX parity is in
    test_torch_kd.py), without them the label-smoothed loss."""
    model = port_model(dict(L3_TRAIN, kd_weight=0.5), params, stats)
    t = {k: T_(v) for k, v in l3_batch(0).items()}
    soft = torch.softmax(torch.randn(3, 6, V, generator=torch.Generator().manual_seed(0)), -1)
    loss, loss_dict = model(t["xs"], t["xlens"], t["ys"], t["ylens"], t["ys_in"], t["ys_out"], soft_labels=soft)
    assert set(loss_dict) == {"loss_kd", "loss_att", "loss_ctc", "loss_total"}
    with torch.no_grad():
        eouts, elens, _ = model.encode(t["xs"], t["xlens"])
        logits = model.decoder(eouts, elens, None, t["ys"], t["ylens"], t["ys_in"])
        want = distill_loss(logits, t["ys_out"], soft, t["ylens"] + 1, 0.5, lsm_prob=0.1)
    for got, w in zip((loss - 0.3 * loss_dict["loss_ctc"], loss_dict["loss_kd"], loss_dict["loss_att"]), want):
        np.testing.assert_allclose(got.item(), w.item(), rtol=1e-6)
    _, plain = model(t["xs"], t["xlens"], t["ys"], t["ylens"], t["ys_in"], t["ys_out"])
    assert set(plain) == {"loss_att", "loss_ctc", "loss_total"}
