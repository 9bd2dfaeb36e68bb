"""LM training and perplexity in the port (`data/lm_dataset.py`,
`train/optim.py` AdamW, `train/train_lm.py`, `eval/test_ppl.py`) against the
JAX package, on the CPU.

- `LMDataset`: one seed gives the JAX package's batches bit for bit (order,
  buckets, the causal shift, BERT's masks and labels, IGNORE padding).
- AdamW with the no-decay group against optax's clip -> scale_by_adam ->
  add_decayed_weights(mask) -> -lr over two updates, for each LM type.
  The mask is the reference's (every name holding "bias", LayerNorm
  weights); for the RNN LM that includes the LSTM's `bias_ih` / `bias_hh`,
  which the JAX mask misses (ROADMAP.md §3), so optax gets the reference's
  mask there.
- The LM train step (RNN LM, dropout 0, `accum_grad: 2`, one non-finite
  micro-step) against the JAX `make_lm_train_step`: losses, LR, skips and
  the parameters after the updates.
- `train_lm` (`--cpu`) on a tiny corpus, then the port's `test_ppl` and the
  JAX `test_ppl` on the port's checkpoint: the same (pseudo-)PPL, far below
  uniform; `--resume` ends at the weights of an uninterrupted run.

Sizes: 1-2 layers x 32 (RNN 2 x 24), V = 30-40, max_seq_len 16.
Tolerances: batches exact; parameters after AdamW atol 1e-6 (the same f32
formula); step losses rtol 1e-5; parameters after the train step atol 1e-5
(gradients summed in two frameworks' orders); PPL rtol 1e-5.
"""

import argparse

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pandas as pd
import pytest
import torch
import yaml

from emoasr_tpu.config import config_from_dict as jax_config
from emoasr_tpu.data.lm_dataset import LMDataset as JaxLMDataset
from emoasr_tpu.eval import test_ppl as jax_ppl
from emoasr_tpu.models.lm.lm import LM as JaxLM
from emoasr_tpu.train import optim as joptim
from emoasr_tpu.train.step import init_train_state
from emoasr_tpu.train.train_lm import make_lm_train_step as jax_make_lm_train_step
from emoasr_tpu_torch.config import config_from_dict
from emoasr_tpu_torch.data.lm_dataset import LMDataset
from emoasr_tpu_torch.eval import test_ppl
from emoasr_tpu_torch.train import optim, train_lm
from emoasr_tpu_torch.train.checkpoint import load_state_dict
from emoasr_tpu_torch.train.step import TrainState
from emoasr_tpu_torch.utils.flax_import import lm_state_dict
from test_torch_lm_types import BERT_SMALL, lm_pair

T_ = torch.from_numpy
RNN = dict(lm_type="rnn", vocab_size=40, embedding_size=16, hidden_size=24, num_layers=2, dropout_rate=0.0)
TRANSFORMER = dict(BERT_SMALL, lm_type="transformer")
TYPES = {"transformer": TRANSFORMER, "bert": BERT_SMALL, "rnn": RNN}


def _corpus(path, n=40, V=30, seed=0, ragged=False):
    """Arithmetic token sequences (learnable), 12 tokens or, `ragged`,
    2-15."""
    rng = np.random.default_rng(seed)
    rows = []
    for i in range(n):
        L = int(rng.integers(2, 16)) if ragged else 12
        start = int(rng.integers(3, 10))
        toks = [(start + j) % (V - 4) + 3 for j in range(L)]
        rows.append(dict(utt_id=f"u{i}", token_id=" ".join(map(str, toks)), ylen=L))
    pd.DataFrame(rows).to_csv(path, sep="\t", index=False)
    return str(path)


@pytest.mark.parametrize("conf", [
    dict(lm_type="transformer"), dict(lm_type="rnn", add_sos_eos=True),
    dict(lm_type="bert", num_to_mask=3), dict(lm_type="bert", mask_proportion=0.3, random_num_to_mask=True),
], ids=["transformer", "rnn_sos_eos", "bert_count", "bert_proportion"])
def test_lm_dataset_matches_jax(tmp_path, conf):
    tsv = _corpus(tmp_path / "lm.tsv", n=50, ragged=True)
    conf = dict(conf, vocab_size=30, max_seq_len=16, batch_size=6, max_ylens_batch=40, eos_id=2, mask_id=29)
    for phase in ("test", "train"):
        got = list(LMDataset(config_from_dict(conf), tsv, phase=phase, seed=7).batches(seed=3))
        want = list(JaxLMDataset(jax_config(conf), tsv, phase=phase, seed=7).batches(seed=3))
        assert len(got) == len(want) > 3
        assert len({b["ys_in"].shape for b in got}) == 3 if phase == "train" else True  # every bucket
        for g, w in zip(got, want):
            assert set(g) == set(w) == ({"utt_ids", "ys_in", "ylens", "labels"} if phase == "train"
                                       else {"utt_ids", "ys_in", "ylens"})
            assert g["utt_ids"] == w["utt_ids"]
            for k in set(g) - {"utt_ids"}:
                np.testing.assert_array_equal(g[k], w[k], err_msg=k)
                assert g[k].dtype == w[k].dtype
    if conf["lm_type"] == "bert":  # the training batches are masked
        assert all((b["ys_in"] == 29).any() and (b["labels"] != -100).any() for b in got)


def _reference_mask(mask_tree, lm_type):
    """The JAX mask with, for the RNN LM, the LSTM biases exempt too (the
    reference's rule: every parameter whose name holds "bias")."""
    def fix(path, keep):
        return keep and not (lm_type == "rnn" and str(path[-1].key).startswith("bias"))
    return jax.tree_util.tree_map_with_path(fix, mask_tree)


@pytest.mark.parametrize("lm_type", ["transformer", "bert", "rnn"])
def test_adamw_and_nodecay_mask_match_optax(lm_type):
    conf = dict(TYPES[lm_type], weight_decay=0.1, clip_grad_norm=1.0)
    jm, jv, port = lm_pair(conf, seed=11)
    cfg = config_from_dict(conf)
    params = jv["params"]
    jmask = _reference_mask(joptim.nodecay_mask(params), lm_type)
    mask_sd = lm_state_dict(jax.tree_util.tree_map(lambda k: np.array(float(k)), jmask), cfg)
    got_mask = optim.nodecay_mask(port)
    assert got_mask == {f"lm.{n}": bool(mask_sd[n]) for n, _ in port.lm.named_parameters()}
    assert not got_mask["lm." + next(n for n, _ in port.lm.named_parameters() if "LayerNorm.weight" in n or
                                     n.startswith("rnns.bias"))]

    tx = optax.chain(optax.clip_by_global_norm(1.0), optax.scale_by_adam(b1=0.9, b2=0.999, eps=1e-8),
                     optax.add_decayed_weights(0.1, mask=lambda _: jmask), optax.scale(-1.0))
    opt_state = tx.init(params)
    opt = optim.build_optimizer(cfg, port, use_adamw=True)
    assert [g["weight_decay"] for g in opt.param_groups] == [0.1, 0.0]
    named = dict(port.lm.named_parameters())
    rng = np.random.default_rng(12)
    for lr in (3e-2, 1e-2):
        gtree = jax.tree_util.tree_map(lambda x: rng.normal(size=np.shape(x)).astype(np.float32), params)
        updates, opt_state = tx.update(gtree, opt_state, params)
        params = optax.apply_updates(params, joptim.scale_updates(updates, lr))
        gsd = lm_state_dict(gtree, cfg)
        grads = [T_(np.array(gsd[n])) for n in named]
        optim.clip_by_global_norm_(grads, 1.0)
        for p, g in zip(named.values(), grads):
            p.grad = g
        for group in opt.param_groups:
            group["lr"] = lr
        opt.step()
    want = lm_state_dict(jax.tree_util.tree_map(np.asarray, params), cfg)
    for n, p in named.items():
        np.testing.assert_allclose(p.detach().numpy(), want[n].numpy(), rtol=0, atol=1e-6, err_msg=n)


def test_lm_train_step_matches_jax(tmp_path):
    """4 micro-steps of the RNN LM (dropout 0, weight decay 0, so that the
    JAX mask's LSTM biases do not matter here) at `accum_grad: 2`, the
    third with an infinite embedding row in its batch: skipped on both
    sides, with no update and no moment change."""
    conf = dict(RNN, vocab_size=30, max_seq_len=16, batch_size=8, max_ylens_batch=128, eos_id=2,
                accum_grad=2, weight_decay=0.0, learning_rate=3e-3, lr_schedule_type="lindecay",
                warmup_proportion=0.25, train_size=32, num_epochs=1, clip_grad_norm=1.0)
    jm, jv, port = lm_pair(conf, seed=13)
    params = jax.tree_util.tree_map(np.array, jv["params"])
    params["lm"]["embed"]["embedding"][28] = np.inf  # token 28 appears only in the third batch
    port.lm.embed.weight.data[28] = float("inf")
    cfg, jcfg = config_from_dict(conf), jax_config(conf)
    tsv = _corpus(tmp_path / "lm.tsv", n=32, V=28)
    batches = list(LMDataset(cfg, tsv, phase="train", seed=1).batches(seed=1))
    assert len(batches) == 4 and all((b["ys_in"] != 28).all() for b in batches)
    batches[2]["ys_in"][1, 3] = 28
    n_total = train_lm.num_total_steps_of(cfg)
    tx = joptim.build_optimizer(jcfg, n_total, use_adamw=True)
    jstate = init_train_state(params, {}, tx)
    jstep = jax_make_lm_train_step(JaxLM(jcfg), jcfg, tx, n_total)
    state = TrainState(model=port, optimizer=optim.build_optimizer(cfg, port, use_adamw=True))
    step = train_lm.make_lm_train_step(cfg, n_total)
    for i, b in enumerate(batches):
        jstate, jmet = jstep(jstate, {k: jnp.asarray(v) for k, v in b.items() if k != "utt_ids"},
                             jax.random.PRNGKey(i))
        met = step(state, {k: T_(v) for k, v in b.items() if k != "utt_ids"})
        assert met["grad_finite"] == (i != 2)
        np.testing.assert_allclose(met["lr"], float(jmet["lr"]), rtol=1e-6)
        if i != 2:
            np.testing.assert_allclose(met["loss_total"].item(), float(jmet["loss_total"]), rtol=1e-5)
    assert state.step == int(jstate.step) == 4 and state.skipped == int(jstate.skipped) == 1
    assert state.mini_step == 1  # micro-steps 1 and 2 updated, 4 is open
    want = lm_state_dict(jax.tree_util.tree_map(np.asarray, jstate.params), cfg)
    for n, p in port.lm.named_parameters():
        got, ref = p.detach().numpy(), want[n].numpy()
        if n == "embed.weight":  # the infinite row: optax's decay term 0 * inf makes it NaN
            got, ref = np.delete(got, 28, 0), np.delete(ref, 28, 0)
        np.testing.assert_allclose(got, ref, rtol=0, atol=1e-5, err_msg=n)


def _write_conf(path, lm_type, tsv, **over):
    conf = dict(TYPES[lm_type], num_layers=1, vocab_size=30, mask_id=29, eos_id=2, max_seq_len=16,
                batch_size=8, max_ylens_batch=256, train_path=tsv, test_path=tsv, train_size=40,
                num_epochs=8, learning_rate=1e-2, lr_schedule_type="lindecay", warmup_proportion=0.1,
                weight_decay=0.01, log_step=5, save_step=8, num_to_mask=3)
    conf.update(over)
    path.write_text(yaml.safe_dump(conf))
    return str(path)


@pytest.mark.parametrize("lm_type", ["transformer", "bert", "rnn"])
def test_train_lm_then_test_ppl_match_jax_cli(tmp_path, lm_type):
    """`python -m emoasr_tpu_torch.train.train_lm -conf ... --cpu`, then
    the PPL CLIs of both packages on its `model.ep8`; a sharded train
    directory (two files, shuffled per epoch) for the causal LMs."""
    tsv = _corpus(tmp_path / "lm.tsv")
    train_path = tsv
    if lm_type != "bert":
        shards = tmp_path / "train_dir"
        shards.mkdir()
        rows = pd.read_table(tsv)
        rows[:16].to_csv(shards / "a.tsv", sep="\t", index=False)
        rows[16:].to_csv(shards / "b.tsv", sep="\t", index=False)
        train_path = str(shards)
    conf = _write_conf(tmp_path / f"{lm_type}.yaml", lm_type, tsv, train_path=train_path)
    state = train_lm.main(["-conf", conf, "--cpu"])
    assert state.step == 40  # 5 batches an epoch (2 + 3 from the shards)
    ckpt = tmp_path / lm_type / "checkpoints" / "model.ep8"
    assert ckpt.exists() and (tmp_path / lm_type / "checkpoints" / "optim.ep8").exists()
    assert all(v.dtype == torch.float32 for v in load_state_dict(str(ckpt)).values() if v.is_floating_point())
    cnt, ppl = test_ppl.main(["-conf", conf, "-ep", "8", "--cpu"])
    jcnt, jppl = jax_ppl.test_main(argparse.Namespace(conf=conf, ep="8", data=None))
    assert cnt == jcnt > 0
    np.testing.assert_allclose(ppl, jppl, rtol=1e-5)
    assert ppl < 0.5 * 26, ppl  # trained on a pattern: far below uniform over the 26 tokens used


def test_resume_continues_to_the_same_weights(tmp_path):
    """Two epochs, then `--resume` for a third, ends at the weights of three
    epochs in one run (noam: the LR does not depend on the epoch count)."""
    tsv = _corpus(tmp_path / "lm.tsv")
    over = dict(num_layers=2, lr_schedule_type="noam", num_warmup_steps=5, learning_rate=1.0, save_step=1,
                warmup_proportion=None, hidden_size=24, num_epochs=3)
    straight = _write_conf(tmp_path / "a.yaml", "rnn", tsv, **over)
    train_lm.main(["-conf", straight, "--cpu"])
    resumed = _write_conf(tmp_path / "b.yaml", "rnn", tsv, **dict(over, num_epochs=2))
    train_lm.main(["-conf", resumed, "--cpu"])
    _write_conf(tmp_path / "b.yaml", "rnn", tsv, **over)
    state = train_lm.main(["-conf", resumed, "--cpu", "--resume"])
    assert state.step == 15
    a = load_state_dict(str(tmp_path / "a" / "checkpoints" / "model.ep3"))
    b = load_state_dict(str(tmp_path / "b" / "checkpoints" / "model.ep3"))
    assert set(a) == set(b)
    for k in a:
        torch.testing.assert_close(b[k], a[k], rtol=0, atol=0)
