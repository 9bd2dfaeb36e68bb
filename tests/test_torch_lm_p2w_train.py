"""Training and perplexity of the port's ELECTRA, P-ELECTRA and
phone-to-word LMs (`data/lm_dataset.py`, `train/train_lm.py`,
`eval/test_ppl.py`) against the JAX package, on the CPU.

- `TextAugment`, the deletable-mask insertion and `P2WDataset` (and
  `LMDataset` for ELECTRA's masks and the `*-disc` error labels): one seed
  gives the JAX package's batches bit for bit.
- The LM train step of `electra`, `electra-disc`, `pelectra` and `pbert`
  (dropout 0 on both sides, the replacements drawn as the generator's
  argmax on both sides, so that they are the same ids) against the JAX
  `make_lm_train_step`: losses, LR, and the parameters after three updates.
- `train_lm --cpu` on a tiny P2W corpus for `pbert` (the phone encoder's
  attention by K4's plain version), then the port's `test_ppl` against the
  JAX `evaluate_ppl` on the port's checkpoint; `pelectra` and the `*-disc`
  types through the same CLI; `test_ppl` refuses the types the JAX
  `test_ppl` cannot score.

Sizes: 1-2 layers x 16-32, V = 40, 15 phones, max_seq_len 16.
Tolerances: batches exact; step losses rtol 1e-5; parameters after the
steps atol 1e-5 (gradients summed in two frameworks' orders); PPL rtol 1e-5.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pandas as pd
import pytest
import torch
import yaml

import emoasr_tpu.models.lm.lm as jax_lm_mod
from emoasr_tpu.config import config_from_dict as jax_config
from emoasr_tpu.data import lm_dataset as jax_data
from emoasr_tpu.eval.test_ppl import evaluate_ppl as jax_evaluate_ppl
from emoasr_tpu.models.lm.lm import LM as JaxLM
from emoasr_tpu.train import optim as joptim
from emoasr_tpu.train.step import init_train_state
from emoasr_tpu.train.train_lm import make_lm_train_step as jax_make_lm_train_step
from emoasr_tpu.utils import torch_import as ti
from emoasr_tpu_torch.config import config_from_dict
from emoasr_tpu_torch.data import lm_dataset
from emoasr_tpu_torch.eval import test_ppl
from emoasr_tpu_torch.models.lm import lm as lm_mod
from emoasr_tpu_torch.train import optim, train_lm
from emoasr_tpu_torch.train.checkpoint import load_state_dict
from emoasr_tpu_torch.train.step import TrainState
from emoasr_tpu_torch.utils.flax_import import lm_state_dict
from test_torch_lm_p2w import ELECTRA, P2W, PELECTRA, lm_pair

T_ = torch.from_numpy
SMALL = dict(max_seq_len=16, phone_eos_id=2, phone_mask_id=14, batch_size=4, max_ylens_batch=64,
             max_plens_batch=128, num_to_mask=2)


def _corpus(path, n=24, seed=0, V=40, S=15):
    """Word rows with phone rows (3-4 phones a word, a fixed spelling of each
    word, so that P2W can learn them) and error labels."""
    rng = np.random.default_rng(seed)
    spell = {w: rng.integers(3, S - 1, size=int(rng.integers(3, 5))) for w in range(3, V - 1)}
    rows = []
    for i in range(n):
        L = int(rng.integers(3, 8))
        words = rng.integers(3, V - 1, size=L)
        phones = np.concatenate([spell[int(w)] for w in words])
        rows.append(dict(utt_id=f"u{i}", token_id=" ".join(map(str, words)),
                         phone_token_id=" ".join(map(str, phones)),
                         error_label=" ".join(rng.choice(["C", "C", "S", "I"], L)), ylen=L, plen=len(phones)))
    pd.DataFrame(rows).to_csv(path, sep="\t", index=False)
    return str(path)


def test_text_augment_and_mask_insertion_match_jax():
    conf = dict(P2W, lm_type="pbert", textaug_max_mask_prob=0.5, textaug_max_replace_prob=0.3,
                phone_eos_id=2, phone_mask_id=14)
    x = np.random.default_rng(0).integers(2, 14, size=30).astype(np.int32)
    for seed in range(5):
        got = lm_dataset.TextAugment(config_from_dict(conf))(np.random.default_rng(seed), x)
        want = jax_data.TextAugment(jax_config(conf))(np.random.default_rng(seed), x)
        np.testing.assert_array_equal(got, want)
        y = np.random.default_rng(seed + 9).integers(3, 39, size=12).astype(np.int32)
        kw = dict(num_to_mask=-1, mask_proportion=0.3, random_num_to_mask=True, insert_poisson_lam=0.5, pad_id=0)
        gy, gl = lm_dataset.create_masked_lm_label_insert(np.random.default_rng(seed), y, 39, 2, **kw)
        wy, wl = jax_data.create_masked_lm_label_insert(np.random.default_rng(seed), y, 39, 2, **kw)
        np.testing.assert_array_equal(gy, wy)
        np.testing.assert_array_equal(gl, wl)
        assert len(gy) >= len(y)


@pytest.mark.parametrize("conf", [
    dict(lm_type="pbert", text_augment=True, textaug_max_mask_prob=0.4, mask_proportion=0.3,
         random_num_to_mask=True, mask_insert_poisson_lam=0.2, num_to_mask=-1),
    dict(lm_type="pelectra", text_augment=True, textaug_max_mask_prob=0.6, bucket_shuffle=False),
    dict(lm_type="ptransformer"), dict(lm_type="pctc"),
    dict(lm_type="electra"), dict(lm_type="electra-disc"),
], ids=["pbert_insert", "pelectra", "ptransformer", "pctc", "electra", "electra_disc"])
def test_datasets_match_jax(tmp_path, conf):
    tsv = _corpus(tmp_path / "p2w.tsv", n=40)
    conf = {**P2W, **SMALL, **conf}
    phones = conf["lm_type"] not in ("electra", "electra-disc")
    Port = lm_dataset.P2WDataset if phones else lm_dataset.LMDataset
    Jax = jax_data.P2WDataset if phones else jax_data.LMDataset
    for phase in ("test", "train"):
        got = list(Port(config_from_dict(conf), tsv, phase=phase, seed=7).batches(seed=3))
        want = list(Jax(jax_config(conf), tsv, phase=phase, seed=7).batches(seed=3))
        assert len(got) == len(want) > 3
        for g, w in zip(got, want):
            assert set(g) == set(w)
            assert g["utt_ids"] == w["utt_ids"]
            for k in set(g) - {"utt_ids"}:
                np.testing.assert_array_equal(g[k], w[k], err_msg=k)
                assert g[k].dtype == w[k].dtype
    if phase == "train" and conf["lm_type"] in ("pbert", "pelectra", "electra"):
        assert all((b["ys_in"] == conf["mask_id"]).any() for b in got)
    if conf["lm_type"] == "electra-disc":
        assert all("error_labels" in b and (b["error_labels"] == 1).any() for b in got)


LR = 3e-4


def _dropout_off(port):
    for m in port.modules():
        if isinstance(m, torch.nn.Dropout):
            m.p = 0.0


@pytest.mark.parametrize("lm_type", ["electra", "electra-disc", "pelectra", "pbert"])
def test_lm_train_step_matches_jax(tmp_path, monkeypatch, lm_type):
    """Three updates on both sides: dropout 0 (the BERT stacks' fixed 0.1
    set to 0 on both sides) and the replacements drawn as the generator's
    argmax on both sides."""
    monkeypatch.setattr(jax_lm_mod, "BertStack",
                        functools.partial(jax_lm_mod.BertStack, dropout_rate=0.0, attn_dropout_rate=0.0))
    monkeypatch.setattr(jax_lm_mod, "sample_categorical", lambda rng, logits, temp=1.0: jnp.argmax(logits, -1))
    monkeypatch.setattr(lm_mod, "sample_categorical", lambda logits, generator=None, temp=1.0: logits.argmax(-1))
    base = ELECTRA if lm_type.startswith("electra") else PELECTRA if lm_type == "pelectra" else dict(P2W)
    conf = dict({**base, **SMALL}, lm_type=lm_type, weight_decay=0.01, learning_rate=LR,
                lr_schedule_type="lindecay", warmup_proportion=0.25, train_size=12, num_epochs=1,
                clip_grad_norm=1.0, mask_proportion=0.3, num_to_mask=-1, text_augment=lm_type == "pbert",
                textaug_max_mask_prob=0.3, mask_insert_poisson_lam=0.3 if lm_type == "pbert" else 0.0,
                gen_num_layers=1, disc_num_layers=1, enc_num_layers=1, dec_num_layers=1)
    jm, jv, port = lm_pair(conf, seed=21)
    _dropout_off(port)
    cfg, jcfg = config_from_dict(conf), jax_config(conf)
    tsv = _corpus(tmp_path / "p2w.tsv", n=16)
    batches = list(train_lm.make_dataset(cfg, tsv, "train", seed=1).batches(seed=1))[:3]
    assert len(batches) == 3
    n_total = train_lm.num_total_steps_of(cfg)
    tx = joptim.build_optimizer(jcfg, n_total, use_adamw=True)
    jstate = init_train_state(jax.tree_util.tree_map(np.array, jv["params"]), {}, tx)
    jstep = jax_make_lm_train_step(JaxLM(jcfg), jcfg, tx, n_total)
    state = TrainState(model=port, optimizer=optim.build_optimizer(cfg, port, use_adamw=True))
    step = train_lm.make_lm_train_step(cfg, n_total)
    for i, b in enumerate(batches):
        jstate, jmet = jstep(jstate, {k: jnp.asarray(v) for k, v in b.items() if k != "utt_ids"},
                             jax.random.PRNGKey(i))
        met = step(state, {k: T_(v) for k, v in b.items() if k != "utt_ids"}, torch.Generator())
        assert met["grad_finite"]
        np.testing.assert_allclose(met["lr"], float(jmet["lr"]), rtol=1e-6)
        assert set(met) - {"lr", "grad_finite"} == set(jmet) - {"lr"}
        for k in set(jmet) - {"lr"}:
            np.testing.assert_allclose(met[k].item(), float(jmet[k]), rtol=1e-5, err_msg=k)
    want = lm_state_dict(jax.tree_util.tree_map(np.asarray, jstate.params), cfg)
    start = lm_state_dict(jv["params"], cfg)
    # Adam divides by the root of the second moment: where a gradient is 0
    # but for rounding (a key's bias shifts every score of a query alike; an
    # embedding row seen once at a near-saturated position), rounding turns
    # into a full step, and a small gradient's relative rounding error into
    # that share of a step (hence the small LR).  Entries whose root moment
    # is below 1e-4 of the largest are held to at most one LR a step; every
    # other entry to 1e-5 (a wrong gradient moves it by about one LR a step).
    named = dict(port.lm.named_parameters())
    root = {n: state.optimizer.state[p]["exp_avg_sq"].sqrt().numpy() for n, p in named.items()}
    floor = 1e-4 * max(float(r.max()) for r in root.values())
    moved = 0
    for n, p in named.items():
        got, ref, ill = p.detach().numpy(), want[n].numpy(), root[n] < floor
        assert np.abs(got - start[n].numpy())[ill].max(initial=0) <= 3 * LR * (1 + 1e-2), n
        np.testing.assert_allclose(got[~ill], ref[~ill], rtol=0, atol=1e-5, err_msg=n)
        moved += int(not np.array_equal(ref, start[n].numpy()))
    assert moved > 0


def _write_conf(path, lm_type, tsv, **over):
    base = ELECTRA if lm_type.startswith("electra") else PELECTRA if lm_type.startswith("pelectra") else P2W
    conf = dict({**base, **SMALL}, lm_type=lm_type, train_path=tsv, test_path=tsv, train_size=24, num_epochs=6,
                learning_rate=3e-3, lr_schedule_type="lindecay", warmup_proportion=0.1, weight_decay=0.01,
                log_step=3, save_step=6, mask_proportion=0.3, num_to_mask=-1)
    for k in ("enc_hidden_size", "dec_hidden_size", "gen_hidden_size", "disc_hidden_size"):
        if k in conf:
            conf[k] = 16
    for k in ("enc_num_layers", "dec_num_layers", "gen_num_layers", "disc_num_layers"):
        if k in conf:
            conf[k] = 1
    for k in ("enc_num_attention_heads", "dec_num_attention_heads", "gen_num_attention_heads",
              "disc_num_attention_heads"):
        if k in conf:
            conf[k] = 2
    conf.update(over)
    path.write_text(yaml.safe_dump(conf))
    return str(path)


def test_train_lm_pbert_then_test_ppl_matches_jax(tmp_path):
    """`python -m emoasr_tpu_torch.train.train_lm -conf ... --cpu` for a
    deletable PC-MLM with TextAugment and the fused phone-encoder attention,
    then the port's `test_ppl` and the JAX `evaluate_ppl` on its
    `model.ep6`: the same pseudo-PPL."""
    tsv = _corpus(tmp_path / "p2w.tsv")
    conf = _write_conf(tmp_path / "pbert.yaml", "pbert", tsv, enc_fused_attn=True, text_augment=True,
                       textaug_max_mask_prob=0.3, mask_insert_poisson_lam=0.2, dropout_enc_rate=0.1,
                       dropout_attn_rate=0.1)
    state = train_lm.main(["-conf", conf, "--cpu"])
    assert state.step > 0 and state.skipped == 0
    sd = {k: v.numpy() for k, v in load_state_dict(str(tmp_path / "pbert/checkpoints/model.ep6")).items()}
    cnt, ppl = test_ppl.main(["-conf", conf, "-ep", "6", "--cpu"])
    jcfg = jax_config(yaml.safe_load(open(conf)))
    prefix = "lm." if any(k.startswith("lm.") for k in sd) else ""
    enc, _ = ti.transformer_encoder(sd, 1, False, f"{prefix}encoder.", "embed")
    params = {"lm": {"encoder": enc, "decoder": ti.transformer_decoder(sd, 1, f"{prefix}decoder.")}}
    jcnt, jppl = jax_evaluate_ppl(jcfg, JaxLM(jcfg), {"params": params},
                                  jax_data.P2WDataset(jcfg, tsv, phase="test"))
    assert cnt == jcnt > 0
    np.testing.assert_allclose(ppl, jppl, rtol=1e-5)


@pytest.mark.parametrize("lm_type", ["pelectra", "electra-disc", "pelectra-disc", "pctc"])
def test_train_lm_cli_trains_the_other_types(tmp_path, lm_type):
    """The same CLI for P-ELECTRA (the fused phone encoder with dropout,
    replacements from the trainer's sampling generator), the
    discriminator-only types on error labels, and the P2W CTC decoder; the
    PPL CLI refuses the types the JAX `test_ppl` cannot score, before it
    reads a checkpoint."""
    tsv = _corpus(tmp_path / "p2w.tsv")
    conf = _write_conf(tmp_path / f"{lm_type}.yaml", lm_type, tsv, enc_fused_attn=True, dropout_enc_rate=0.1,
                       dropout_attn_rate=0.1, num_epochs=2, save_step=2, log_step=1)
    state = train_lm.main(["-conf", conf, "--cpu"])
    assert state.step > 0 and state.skipped == 0
    ckpt = tmp_path / lm_type / "checkpoints" / "model.ep2"
    assert set(load_state_dict(str(ckpt))) == {f"lm.{k}" for k in
                                               lm_mod.LM(config_from_dict(yaml.safe_load(open(conf)))).lm.state_dict()}
    log = (tmp_path / lm_type / "log" / "train.log").read_text()
    if lm_type == "pelectra":
        assert "loss_disc" in log and "num_replaced" in log
    with pytest.raises(ValueError, match=lm_type):
        test_ppl.main(["-conf", conf, "-ep", "2", "--cpu"])
