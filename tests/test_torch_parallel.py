"""The port's data and tensor parallelism (`emoasr_tpu_torch/parallel/`)
against the JAX mesh and against one process, on the CPU.

Ranks are processes of `emoasr_tpu_torch/parallel/ranks.py` over gloo,
meeting through a file store under `tmp_path` (no TCP port), one PyTorch
thread each; they import the port only.  Two launches, started before the
JAX references are computed (they run meanwhile): two ranks for the (2,)
and (1, 2) meshes, four for (2, 2).  The JAX side runs on the conftest's 8
virtual CPU devices.  The weights are the port's from seed 0, carried into
the JAX package by its own torch importer (`utils/torch_import.py`).

- `tp_plan` splits the matrices that JAX `_tp_spec` splits, along the same
  axes (through `flax_import`'s name map), the vocabulary tables and
  heads included, on the flagship, RNN-T, LAS and the three LM trees, apart
  from the Conformer's `pos_bias_u/v`, which it splits with their heads.
- `__graft_entry__._flagship_cfg(tiny=True)` (Conformer + Transformer
  decoder + CTC 0.3, label smoothing 0.1, BatchNorm), B = 8, T = 64, U = 8
  with the batch's halves holding different token counts, dropout and
  SpecAugment off, `accum_grad: 2`, 4 micro-steps: on (2,), (1, 2) and
  (2, 2) the loss terms, the first micro-gradient, the parameters and the
  BatchNorm statistics after both updates equal the JAX step on one device
  (and on its (2, 2) mesh), and the port's one process.
- The same with dropout, SpecAugment and the fused attention (K4's CPU
  path) on, port only: (2,) and (1, 2) equal the one-process run.
- An RNN-T model on such a batch: equal to one process.
- `accum_grad: 2` with a NaN in rank 1's rows of the middle micro-step:
  both ranks skip it, and the parameters equal the JAX step's on
  `test_parallel_accum_decode.py`'s configuration and batches.
- BERT on (1, 2): equal to the JAX step (dropout off on both sides, as
  `test_lm_bert_tp_matches_dp` compares its meshes) and, dropout on, to one
  process.
- A checkpoint written on (2, 2) loads into a one-process port model and
  into the JAX package (`eval/test_asr.py::load_asr_variables`, its torch
  importer) with the mesh's own eval loss; it reads back onto the mesh
  (weights and moments).  With the (2, 2) step and accumulation and a
  beam decode split over the four ranks, the twin of
  `__graft_entry__.dryrun_multichip`.

Tolerances.  Port mesh against one process (the same arithmetic, summed in
another order): loss terms rtol 1e-5; gradients within 1e-5 of each
tensor's largest entry (+1e-6); parameters and statistics atol 1e-6
(+ rtol 1e-5), but
for the biases whose true gradient is 0 (the attention key biases, the
convolution bias before a BatchNorm: `INERT`), whose rounding noise's sign
Adam's first steps turn into +-LR (the carve-out of
`test_lm_bert_tp_matches_dp`, its count pinned).
Against JAX, the JAX twins' (`test_parallel_tp.py`: losses rtol 2e-4;
`test_parallel_accum_decode.py`: parameters atol 2e-5, rtol 2e-4;
`test_lm_bert_tp_matches_dp`: parameters atol 2e-4, rtol 2e-3 without
the inert key biases); gradients within 1e-4 of each tensor's largest
entry (+1e-6, as `test_torch_train.py`).  Decoded hypotheses exactly,
scores 1e-5.
"""

import dataclasses
import os
from concurrent.futures import ThreadPoolExecutor
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import __graft_entry__ as graft
from emoasr_tpu.eval.test_asr import _import_lm_params, load_asr_variables
from emoasr_tpu.models.asr import ASR as JaxASR
from emoasr_tpu.models.lm.lm import LM as JaxLM
from emoasr_tpu.parallel.mesh import make_mesh as jax_make_mesh
from emoasr_tpu.parallel.mesh import param_partition_specs
from emoasr_tpu.parallel.mesh import shard_batch as jax_shard_batch
from emoasr_tpu.train.optim import build_optimizer as jax_build_optimizer
from emoasr_tpu.train.step import init_train_state
from emoasr_tpu.train.step import make_train_step as jax_make_train_step
from emoasr_tpu.train.train_lm import make_lm_train_step as jax_make_lm_train_step
from emoasr_tpu.utils import torch_import as ti
from emoasr_tpu_torch.config import config_from_dict
from emoasr_tpu_torch.models.asr import ASR
from emoasr_tpu_torch.models.lm.lm import LM
from emoasr_tpu_torch.parallel import ranks
from emoasr_tpu_torch.parallel.mesh import Mesh, resolve_shape, shard_batch
from emoasr_tpu_torch.parallel.tensor import tp_plan
from emoasr_tpu_torch.train.checkpoint import load_state_dict
from emoasr_tpu_torch.utils.flax_import import asr_state_dict, lm_state_dict
from test_parallel_accum_decode import _batch as twin_batch
from test_parallel_accum_decode import _cfg as twin_cfg

OFF = dict(spec_augment=False, dropout_enc_rate=0.0, dropout_attn_rate=0.0, dropout_dec_rate=0.0, accum_grad=2)
# the flagship with dropout, SpecAugment (two narrow masks) and K4 on
ON = dict(accum_grad=2, enc_fused_attn=True, max_mask_freq=10, max_mask_time=8)
BERT = dict(lm_type="bert", vocab_size=32, hidden_size=32, num_layers=2, num_attention_heads=2,
            intermediate_size=64, max_seq_len=16, eos_id=2, mask_id=31, learning_rate=3e-3,
            lr_schedule_type="lindecay", warmup_proportion=0.1, weight_decay=0.01, batch_size=8)
RNNT = dict(encoder_type="conformer", decoder_type="rnn_transducer", pos_encode_type="rel", input_layer="conv2d",
            feat_dim=20, enc_hidden_size=32, enc_num_attention_heads=4, enc_num_layers=1, enc_intermediate_size=64,
            conv_kernel_size=7, embedding_size=16, dec_hidden_size=24, dec_num_layers=1, joint_hidden_size=20,
            vocab_size=20, rnnt_joint_mode="pallas", mtl_ctc_weight=0.3, lr_schedule_type="noam",
            learning_rate=2.0, num_warmup_steps=25000, clip_grad_norm=5.0, accum_grad=2, dropout_emb_rate=0.1)


def _as_dict(cfg, **over) -> dict:
    conf = {f.name: getattr(cfg, f.name) for f in dataclasses.fields(cfg)}
    conf.update(over)
    return conf


def _asr_batch(V, F=80, B=8, T=64, U=8, seed=0, eos=2):
    """A batch whose first half holds U tokens a row and whose second half
    holds fewer (2..U-2), and lengths below T in that half."""
    rng = np.random.default_rng(seed)
    ylens = np.concatenate([np.full(B // 2, U), rng.integers(2, U - 1, B // 2)]).astype(np.int64)
    xlens = np.concatenate([np.full(B // 2, T), rng.integers(T // 2, T, B // 2)]).astype(np.int64)
    ys = np.where(np.arange(U)[None] < ylens[:, None], rng.integers(3, V, (B, U)), eos)
    ys_in = np.full((B, U + 1), eos)
    ys_in[:, 1:] = ys
    ys_out = np.full((B, U + 1), eos)
    for b in range(B):
        ys_out[b, :ylens[b]] = ys[b, :ylens[b]]
    return dict(xs=rng.normal(size=(B, T, F)).astype(np.float32), xlens=xlens, ys=ys, ylens=ylens,
                ys_in=ys_in, ys_out=ys_out)


def _torch(batch):
    return {k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in batch.items()}


def _bert_batch(seed):
    """`test_lm_bert_tp_matches_dp`'s batch: half the positions masked."""
    rng = np.random.default_rng(seed)
    B, L = 8, 12
    ys = rng.integers(3, 30, (B, L)).astype(np.int64)
    labels = np.full((B, L), -100, np.int64)
    labels[:, ::2] = ys[:, ::2]
    ys_masked = ys.copy()
    ys_masked[:, ::2] = 31
    return dict(ys_in=ys_masked, ylens=np.full((B,), L, np.int64), labels=labels)


class _Deterministic:
    """A flax module whose `apply` always runs without dropout (the JAX
    train step turns it on)."""

    def __init__(self, module):
        self.module = module

    def apply(self, *args, **kw):
        kw["deterministic"] = True
        return self.module.apply(*args, **kw)


def _jax_asr_steps(cfg, model, variables, batches, mesh=None):
    """Losses, the first micro-gradient (MultiSteps' accumulator), the
    params and statistics after every update."""
    tx = jax_build_optimizer(cfg)
    state = init_train_state(variables["params"], variables.get("batch_stats", {}), tx)
    step = jax_make_train_step(model, cfg, tx, mesh=mesh, params=state.params)
    out = {"metrics": [], "params": [], "grads": None}
    for i, b in enumerate(batches):
        state, m = step(state, b if mesh is None else jax_shard_batch(mesh, b), jax.random.PRNGKey(i))
        out["metrics"].append({k: float(v) for k, v in m.items()})
        inner = state.opt_state
        if i == 0 and hasattr(inner, "acc_grads"):
            out["grads"] = jax.device_get(inner.acc_grads)
        if int(getattr(inner, "mini_step", 0)) == 0:
            out["params"].append(jax.device_get((state.params, state.batch_stats)))
    out["skipped"] = int(state.skipped)
    return out


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Every rank launch and every reference, computed once."""
    work = tmp_path_factory.mktemp("ranks")
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield _compute(work)
    finally:
        torch.set_num_threads(threads)


def _port_init(conf, lm=False):
    """A port model's weights from seed 0 (the JAX side imports them)."""
    torch.manual_seed(0)
    cfg = config_from_dict(conf)
    return {k: v.clone() for k, v in (LM(cfg) if lm else ASR(cfg)).state_dict().items()}


def _jax_variables(sd, jcfg):
    params, stats = ti.asr_model({k: v.numpy() for k, v in sd.items()}, jcfg)
    variables = {"params": params}
    if stats:
        variables["batch_stats"] = stats
    return jax.tree_util.tree_map(jnp.asarray, variables)


def _compute(work):
    jcfg = graft._flagship_cfg(tiny=True).replace(**OFF)
    jmodel = JaxASR(jcfg)
    batches = [_asr_batch(jcfg.vocab_size, seed=s) for s in range(4)]
    conf = _as_dict(jcfg)
    sd = _port_init(conf)
    tb = [_torch(b) for b in batches]
    conf_on = _as_dict(graft._flagship_cfg(tiny=True), **ON)

    # the twin of test_accum_grad_dp_tp_and_full_batch_agree, a NaN in rank 1's rows in the middle
    acfg = twin_cfg(accum_grad=2)
    full = twin_batch(acfg, B=16)
    micro = [{k: v[:8] for k, v in full.items()}, {k: v[:8].copy() for k, v in full.items()},
             {k: v[8:] for k, v in full.items()}]
    micro[1]["xs"][5, 3, 2] = np.nan
    aconf = _as_dict(acfg)
    asd = _port_init(aconf)
    amicro = [{k: torch.from_numpy(v.astype(np.int64) if v.dtype == np.int32 else v) for k, v in m.items()}
              for m in micro]

    # BERT, the twin of test_lm_bert_tp_matches_dp
    bb = [_bert_batch(0), _bert_batch(1)]
    bsd = _port_init(BERT, lm=True)
    tbb = [_torch(b) for b in bb]

    rnnt_batches = [_torch(_asr_batch(RNNT["vocab_size"], F=20, T=40, U=6, seed=10 + s)) for s in range(2)]

    data, tp, both = ((2,), ("data",)), ((1, 2), ("data", "model")), ((2, 2), ("data", "model"))

    def job(program, mesh, **kw):
        return dict(program=program, mesh_shape=mesh[0], mesh_axes=mesh[1], device="cpu", **kw)

    flag = dict(conf=conf, batches=tb, state_dict=sd)
    drop = dict(conf=conf_on, batches=tb[:2], state_dict=sd)
    accum = dict(conf=aconf, batches=amicro, state_dict=asd)
    bert = dict(conf=BERT, batches=tbb, state_dict=bsd, lm=True, num_total_steps=100)
    bert_off = dict(bert, no_dropout=True)
    rnnt = dict(conf=RNNT, batches=rnnt_batches)
    save = str(work / "ckpt")
    flag4 = dict(flag, eval_batch=tb[0], save_dir=save)
    dec = dict(conf=conf, state_dict=sd, xs=tb[1]["xs"], xlens=tb[1]["xlens"], beam_width=3)
    two = ranks.Launch(2, str(work / "two"), [
        job("train_steps", data, **flag), job("train_steps", tp, **flag), job("train_steps", data, **drop),
        job("train_steps", tp, **drop), job("train_steps", data, **rnnt), job("train_steps", data, **accum),
        job("train_steps", tp, **bert_off), job("train_steps", tp, **bert)])
    four = ranks.Launch(4, str(work / "four"), [job("train_steps", both, **flag4), job("decode", both, **dec)])

    # the references, while the ranks run (XLA compiles the JAX programs two at a time)
    variables, avars = _jax_variables(sd, jcfg), _jax_variables(asd, acfg)
    jlm = JaxLM(_jax_config(BERT))
    bvars = {"params": {"lm": _import_lm_params({k: v.numpy() for k, v in bsd.items()}, _jax_config(BERT))}}
    with ThreadPoolExecutor(2) as pool:
        futures = [
            pool.submit(_jax_asr_steps, jcfg, jmodel, variables, batches,
                        jax_make_mesh((2, 2), ("data", "model"), jax.devices()[:4])),
            pool.submit(_jax_asr_steps, jcfg, jmodel, variables, batches),
            pool.submit(_jax_asr_steps, acfg, JaxASR(acfg), avars, micro),
            pool.submit(_jax_bert_steps, jlm, bvars, bb),
        ]
        jax_mesh, jax_one, jax_accum, jax_bert = (f.result() for f in futures)
    one = {name: ranks.train_steps(None, device="cpu", **kw) for name, kw in (
        ("flag", flag), ("drop", drop), ("accum", accum), ("bert_off", bert_off), ("bert", bert), ("rnnt", rnnt))}
    one_dec = ranks.decode(None, device="cpu", **dec)
    res2, res4 = two.wait(), four.wait()
    names2 = ["flag_data", "flag_tp", "drop_data", "drop_tp", "rnnt", "accum", "bert_off", "bert"]
    return dict(conf=conf, jcfg=jcfg, jmodel=jmodel, batches=batches, save=save, acfg=acfg, sd=sd,
                jax_one=jax_one, jax_mesh=jax_mesh, jax_accum=jax_accum, jax_bert=jax_bert, one=one,
                one_dec=one_dec, two=[dict(zip(names2, r)) for r in res2],
                four=[dict(zip(["flag", "dec"], r)) for r in res4])


def _jax_config(conf):
    from emoasr_tpu.config import config_from_dict as jax_config

    return jax_config(conf)


def _jax_bert_steps(jlm, bvars, bb):
    jcfg = _jax_config(BERT)
    tx = jax_build_optimizer(jcfg, 100, use_adamw=True)
    state = init_train_state(bvars["params"], {}, tx)
    step = jax_make_lm_train_step(_Deterministic(jlm), jcfg, tx, 100)
    losses = []
    for i, b in enumerate(bb):
        state, m = step(state, {k: jnp.asarray(v) for k, v in b.items()}, jax.random.PRNGKey(i))
        losses.append(float(m["loss_total"]))
    return losses, jax.device_get(state.params)


# ---------------------------------------------------------------------------- checks


def _grads_close(got, want, tol):
    assert set(got) == set(want)
    for k in want:
        ref = np.asarray(want[k], np.float32)
        np.testing.assert_allclose(np.asarray(got[k], np.float32), ref, rtol=0,
                                   atol=tol * np.abs(ref).max() + 1e-6, err_msg=k)


# biases whose true gradient is 0 (a constant on every key, or before a
# BatchNorm): rounding noise, whose sign Adam's first steps turn into +-LR
INERT = ("linear_k.bias", "attention.self.key.bias", "depthwise_conv.bias")


def _sd_close(got, want, atol, rtol=1e-5, skip=(), inert=False):
    skipped = 0
    for k in want:
        if k in skip or not want[k].is_floating_point() or (inert and k.endswith(INERT)):
            skipped += inert and k.endswith(INERT)
            continue
        np.testing.assert_allclose(got[k].numpy(), want[k].numpy(), atol=atol, rtol=rtol, err_msg=k)
    return skipped


def _losses_close(got, want, rtol):
    for a, b in zip(got, want):
        for k in b:
            if k.startswith("loss"):
                np.testing.assert_allclose(a[k], b[k], rtol=rtol, err_msg=k)


def test_mesh_shapes_and_batches_as_jax_takes_them():
    """`-1` filled from the world, the JAX message for a shape that needs
    more ranks (and a refusal for idle ones), and a batch the data axis
    does not divide refused by name, as the JAX loop's `device_put`
    refuses it (ValueError: "... should be divisible by 2, but it is equal
    to 3")."""
    assert resolve_shape((-1,), ("data",), 4) == (4,)
    assert resolve_shape((-1, 2), ("data", "model"), 4) == (2, 2)
    with pytest.raises(ValueError, match="needs 4 ranks, only 2 available"):
        resolve_shape((4,), ("data",), 2)
    with pytest.raises(ValueError, match="uses 1 of 2 ranks"):
        resolve_shape((1,), ("data",), 2)
    with pytest.raises(ValueError, match="the port's meshes"):
        resolve_shape((2,), ("model",), 2)
    mesh = Mesh(shape=(2,), axes=("data",), rank=1, world=2, data_size=2, data_rank=1, model_size=1,
                model_rank=0, data_group=None, model_group=None, backend="gloo", device=torch.device("cpu"))
    rows = shard_batch(mesh, {"xs": np.arange(8).reshape(4, 2), "utt_ids": ["a", "b", "c", "d"]})
    assert rows["xs"].tolist() == [[4, 5], [6, 7]] and rows["utt_ids"] == ["a", "b", "c", "d"]
    with pytest.raises(ValueError, match="a batch of 3 rows does not divide over the data axis of 2 ranks"):
        shard_batch(mesh, {"xs": np.zeros((3, 2))})


def _jax_split_dims(params, to_sd) -> dict:
    """{port name: the dimension JAX `param_partition_specs` splits over a
    model axis of 2}, through the port's name map `to_sd` (a marker leaf
    that varies along its split axis only)."""
    specs = param_partition_specs(params, jax_make_mesh((4, 2), ("data", "model")))

    def marker(x, s):
        axes = [i for i, a in enumerate(s.spec) if a == "model"]
        if not axes:
            return np.zeros(x.shape, np.float32)
        shape = [1] * len(x.shape)
        shape[axes[0]] = x.shape[axes[0]]
        return np.broadcast_to(np.arange(x.shape[axes[0]], dtype=np.float32).reshape(shape) + 1, x.shape).copy()

    want = {}
    for name, t in to_sd(jax.tree_util.tree_map(marker, params, specs)).items():
        varying = [d for d in range(t.dim()) if t.shape[d] > 1 and not torch.all(t == t.narrow(d, 0, 1))]
        if t.abs().sum() > 0:
            assert len(varying) == 1, name
            want[name] = varying[0]
    return want


def _asr_shapes(jcfg):
    b = graft._example_batch(jcfg, B=2, T=64, U=8)
    return jax.eval_shape(lambda: JaxASR(jcfg).init(jax.random.PRNGKey(0), b["xs"], b["xlens"], b["ys"],
                                                    b["ylens"], b["ys_in"], b["ys_out"]))["params"]


def test_tp_plan_splits_what_the_jax_specs_split():
    """Each split matrix of the flagship under a model axis of 2, by port
    name and dimension, against JAX `param_partition_specs` mapped through
    `asr_state_dict`, vocabulary tables and heads included; the
    Conformer's `pos_bias_u/v`, which the port splits with their heads,
    aside."""
    jcfg = graft._flagship_cfg(tiny=True)
    conf = _as_dict(jcfg)
    want = _jax_split_dims(_asr_shapes(jcfg), lambda t: asr_state_dict(t, config_from_dict(conf)))
    plan = tp_plan(ASR(config_from_dict(conf)), 2)
    heads = {"decoder.output.weight", "decoder.output.bias", "decoder.ctc.output.weight",
             "decoder.ctc.output.bias", "decoder.embed.weight"}
    pos_bias = {k for k in plan if k.endswith(("pos_bias_u", "pos_bias_v"))}
    assert heads <= set(want) and heads <= set(plan)
    assert len(pos_bias) == 2 * jcfg.enc_num_layers and not pos_bias & set(want)
    assert want == {k: v for k, v in plan.items() if k not in pos_bias}
    assert "encoder.transformers.0.feed_forward.w1.weight" in plan and not any("conv" in k for k in plan)


LAS = dict(RNNT, decoder_type="las", dec_hidden_size=24, dec_num_layers=1, dec_intermediate_size=28,
           embedding_size=16, max_decode_ylen=16, lsm_prob=0.1)
RNN_LM = dict(lm_type="rnn", vocab_size=30, hidden_size=24, num_layers=2, embedding_size=16, dropout_rate=0.0,
              batch_size=8, learning_rate=3e-3, lr_schedule_type="lindecay", warmup_proportion=0.1,
              weight_decay=0.01, accum_grad=2)
TRF_LM = dict(BERT, lm_type="transformer")
TREES = {"rnnt": (RNNT, False, ["decoder.embed.weight", "decoder.output.weight", "decoder.ctc.output.bias"]),
         "las": (LAS, False, ["decoder.embed.weight", "decoder.output.bias", "decoder.ctc.output.weight"]),
         "transformer_lm": (TRF_LM, True, ["lm.transformer.bert.embeddings.word_embeddings.weight",
                                          "lm.transformer.bert.embeddings.token_type_embeddings.weight"]),
         "bert": (BERT, True, ["lm.bert.bert.embeddings.position_embeddings.weight"]),
         "rnn_lm": (RNN_LM, True, ["lm.embed.weight", "lm.output.weight", "lm.output.bias"])}


@pytest.mark.parametrize("tree", list(TREES))
def test_tp_plan_equals_the_jax_specs_on_every_tree(tree):
    """The RNN-T, LAS and three LM trees: the port's plan at a model axis of
    2 is JAX `param_partition_specs`, name for name (the vocabulary tables
    and heads named here among them; the LM heads named `decoder` whole)."""
    conf, lm, split = TREES[tree]
    jcfg, cfg = _jax_config(conf), config_from_dict(conf)
    if lm:
        ys = jnp.zeros((2, 8), jnp.int32)
        shapes = jax.eval_shape(lambda: JaxLM(jcfg).init(jax.random.PRNGKey(0), ys, jnp.full((2,), 8, jnp.int32)))
        want = _jax_split_dims(shapes["params"], lambda t: {"lm." + k: v for k, v in lm_state_dict(t, cfg).items()})
        plan = tp_plan(LM(cfg), 2)
    else:
        want = _jax_split_dims(_asr_shapes(jcfg), lambda t: asr_state_dict(t, cfg))
        plan = tp_plan(ASR(cfg), 2)
    plan = {k: v for k, v in plan.items() if not k.endswith(("pos_bias_u", "pos_bias_v"))}
    assert set(split) <= set(plan) and not any(k.endswith("cls.predictions.decoder.weight") for k in plan)
    assert plan == want


@pytest.mark.parametrize("mesh", ["flag_data", "flag_tp", "flag"])
def test_flagship_steps_match_jax_and_one_process(runs, mesh):
    got = runs["four"][0][mesh] if mesh == "flag" else runs["two"][0][mesh]
    one, jone, jmesh = runs["one"]["flag"], runs["jax_one"], runs["jax_mesh"]
    cfg = config_from_dict(runs["conf"])
    assert len(got["params"]) == len(jone["params"]) == 2 and got["skipped"] == 0
    _losses_close(got["metrics"], one["metrics"], 1e-5)
    _losses_close(got["metrics"], jone["metrics"], 2e-4)
    _losses_close(got["metrics"], jmesh["metrics"], 2e-4)
    _grads_close(got["grads"], one["grads"], 1e-5)
    _grads_close(got["grads"], asr_state_dict(jone["grads"], cfg), 1e-4)
    # the clip's global norm: a tensor-parallel share's squares summed over the model group once
    np.testing.assert_allclose(got["grad_norm"], one["grad_norm"], rtol=1e-5)
    np.testing.assert_allclose(got["grad_norm"], np.sqrt(sum(float((g.double() ** 2).sum())
                                                              for g in one["grads"].values())), rtol=1e-5)
    for i in range(2):
        params, stats = jone["params"][i]
        _sd_close(got["params"][i], one["params"][i], 1e-6)
        _sd_close(got["params"][i], asr_state_dict(params, cfg, stats), 2e-5, 2e-4)
        _sd_close(got["params"][i], asr_state_dict(jmesh["params"][i][0], cfg, jmesh["params"][i][1]), 2e-5, 2e-4)
    # the BatchNorm statistics (compared above) moved with the global batch's
    stats = [k for k in runs["sd"] if k.endswith(("running_mean", "running_var"))]
    assert len(stats) == 2 * cfg.enc_num_layers
    assert all((got["params"][-1][k] - runs["sd"][k]).abs().max() > 1e-4 for k in stats)


def test_dropout_and_specaug_draw_what_one_process_draws(runs):
    """(2,) and (1, 2) with dropout, SpecAugment and K4's CPU path on: the
    one-process run's loss, micro-gradient, parameters and BatchNorm
    statistics (a rank keeps its rows and heads of the global draw)."""
    one = runs["one"]["drop"]
    for name in ("drop_data", "drop_tp"):
        got = runs["two"][0][name]
        _losses_close(got["metrics"], one["metrics"], 1e-5)
        _grads_close(got["grads"], one["grads"], 1e-5)
        assert _sd_close(got["params"][0], one["params"][0], 1e-6, inert=True) == 8
    assert one["metrics"][0]["loss_total"] != runs["one"]["flag"]["metrics"][0]["loss_total"]


def test_rnnt_and_uneven_token_counts_match_one_process(runs):
    got, one = runs["two"][0]["rnnt"], runs["one"]["rnnt"]
    assert {"loss_rnnt", "loss_ctc"} <= set(one["metrics"][0])
    _losses_close(got["metrics"], one["metrics"], 1e-5)
    _grads_close(got["grads"], one["grads"], 1e-5)
    assert _sd_close(got["params"][0], one["params"][0], 1e-6, inert=True) == 2


def test_nan_micro_step_is_skipped_on_every_rank(runs):
    cfg = config_from_dict(_as_dict(runs["acfg"]))
    jax_accum = runs["jax_accum"]
    assert jax_accum["skipped"] == 1
    for r in range(2):
        got = runs["two"][r]["accum"]
        assert got["skipped"] == 1 and [m["grad_finite"] for m in got["metrics"]] == [True, False, True]
    got = runs["two"][0]["accum"]
    assert len(got["params"]) == 1
    assert _sd_close(got["params"][0], runs["one"]["accum"]["params"][0], 1e-6, inert=True) == 2
    _sd_close(got["params"][0], asr_state_dict(jax_accum["params"][0][0], cfg), 2e-5, 2e-4)


def test_bert_tensor_parallel_matches_jax(runs):
    got, one = runs["two"][0]["bert_off"], runs["one"]["bert_off"]
    jlosses, jparams = runs["jax_bert"]
    np.testing.assert_allclose([m["loss_total"] for m in got["metrics"]], jlosses, rtol=2e-4)
    want = lm_state_dict(jparams, config_from_dict(BERT))
    got_sd = {k[len("lm."):]: v for k, v in got["params"][-1].items()}
    keys = [k for k in want if k.endswith("attention.self.key.bias")]
    assert len(keys) == BERT["num_layers"]
    _sd_close(got_sd, want, 2e-4, 2e-3, skip=keys)
    assert _sd_close(got["params"][-1], one["params"][-1], 1e-6, inert=True) == 2
    # dropout on: the heads' and rows' share of the one-process draw
    _losses_close(runs["two"][0]["bert"]["metrics"], runs["one"]["bert"]["metrics"], 1e-5)
    assert _sd_close(runs["two"][0]["bert"]["params"][-1], runs["one"]["bert"]["params"][-1], 1e-6, inert=True) == 2


def test_tp_checkpoint_loads_into_one_process_and_jax(runs):
    """The (2, 2) run's `model.ep1`: the same eval loss in the port's one
    process, in the JAX package and on the mesh; read back onto the mesh
    with its moments."""
    got = runs["four"][0]["flag"]
    assert got["roundtrip"] == 0.0
    path = os.path.join(runs["save"], "model.ep1")
    cfg = config_from_dict(runs["conf"])
    model = ASR(cfg)
    model.load_state_dict(load_state_dict(path))
    model.eval()
    b = _torch(runs["batches"][0])
    with torch.no_grad():
        loss, _ = model(b["xs"], b["xlens"], b["ys"], b["ylens"], b["ys_in"], b["ys_out"])
    variables = load_asr_variables(path, runs["jcfg"])
    jb = {k: jnp.asarray(v) for k, v in runs["batches"][0].items()}
    jloss, _ = jax.jit(partial(runs["jmodel"].apply, deterministic=True))(
        variables, jb["xs"], jb["xlens"], jb["ys"], jb["ylens"], jb["ys_in"], jb["ys_out"])
    np.testing.assert_allclose(loss.item(), got["eval_loss"]["loss_total"], rtol=1e-5)
    np.testing.assert_allclose(float(jloss), got["eval_loss"]["loss_total"], rtol=2e-4)
    _sd_close(load_state_dict(path), got["params"][-1], 0.0, 0.0)
    for r in range(1, 4):
        assert runs["four"][r]["flag"]["roundtrip"] == 0.0


def test_dryrun_twin_decodes_over_four_ranks(runs):
    (hyps, lens, scores), launches = runs["four"][0]["dec"]
    (h1, l1, s1), _ = runs["one_dec"]
    assert runs["four"][1]["dec"] is None and hyps.shape[0] == 8
    np.testing.assert_array_equal(lens, l1)
    for b in range(8):
        for w in range(hyps.shape[1]):
            np.testing.assert_array_equal(hyps[b, w, :lens[b, w]], h1[b, w, :l1[b, w]])
    np.testing.assert_allclose(scores, s1, atol=1e-5, rtol=1e-5)
    step = runs["four"][0]["flag"]
    assert step["step"] == 4 and len(step["params"]) == 2 and np.isfinite(step["metrics"][-1]["loss_total"])
