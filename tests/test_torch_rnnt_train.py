"""The RNN-T slice as a whole against the JAX package, on the CPU: a tiny
RNN-T(Conformer) model with the same weights (through `asr_state_dict`).

- The loss and every gradient of the whole model (`rnnt_joint_mode:
  pallas`, auxiliary CTC 0.3; the port's kernels on their plain versions,
  the JAX joint kernel in interpret mode) against `jax.value_and_grad`.
- 4 micro-steps of the train step with `accum_grad: 2` (two optimizer
  updates) against the JAX `make_train_step`: losses, LR, the moved
  BatchNorm statistics (1e-5) and the parameters.
- One `compute_dtype: bfloat16` micro-step against the JAX step (K7 and
  K8's bf16 plain versions on the port's side; tolerances in
  `test_torch_train.py::assert_bf16_micro_step_matches_jax`).

Sizes as in `test_torch_rnnt.py`.  Tolerances: loss rtol 1e-5 (2e-4 in the
train step, as `test_torch_train.py`); gradients 1e-4 of each tensor's
largest entry + 1e-6; parameters after Adam as in `test_torch_train.py`
(2 % of the LR on all but 1 % of each tensor's entries, the sum of the LRs
everywhere).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from emoasr_tpu.config import config_from_dict as jax_config
from emoasr_tpu.models.asr import ASR as JaxASR
from emoasr_tpu.train import optim as joptim
from emoasr_tpu.train.step import init_train_state
from emoasr_tpu.train.step import make_train_step as jax_make_train_step
from emoasr_tpu_torch.config import config_from_dict
from emoasr_tpu_torch.ops import ctc_head, ctc_lattice, lstm_scan, rnnt_joint
from emoasr_tpu_torch.train import optim
from emoasr_tpu_torch.train.step import TrainState, make_train_step
from emoasr_tpu_torch.utils.flax_import import asr_state_dict
from test_torch_rnnt import RNNT_SMALL, T_, _batch, _close_grads, port_model, random_rnnt_params
from test_torch_train import assert_bf16_micro_step_matches_jax


@pytest.fixture(scope="module")
def weights():
    return random_rnnt_params(dict(RNNT_SMALL, mtl_ctc_weight=0.3), seed=1)


def test_model_loss_and_gradients_match_jax(weights):
    params, stats = weights
    conf = dict(RNNT_SMALL, mtl_ctc_weight=0.3)
    b = _batch(2)
    jcfg = jax_config(conf)

    def jloss(p):
        return JaxASR(jcfg).apply({"params": p, "batch_stats": stats}, *(jnp.asarray(b[k]) for k in (
            "xs", "xlens", "ys", "ylens", "ys_in", "ys_out")), deterministic=True)

    (jl, jdict), jgrads = jax.jit(jax.value_and_grad(jloss, has_aux=True))(params)
    model = port_model(conf, params, stats).eval()
    t = {k: T_(v) for k, v in b.items()}
    loss, loss_dict = model(t["xs"], t["xlens"], t["ys"], t["ylens"], t["ys_in"], t["ys_out"])
    names = [n for n, _ in model.named_parameters()]
    grads = dict(zip(names, torch.autograd.grad(loss, list(model.parameters()))))
    np.testing.assert_allclose(loss.item(), float(jl), rtol=1e-5)
    assert set(loss_dict) == set(jdict) == {"loss_rnnt", "loss_ctc", "loss_total"}
    for k in jdict:
        np.testing.assert_allclose(loss_dict[k].item(), float(jdict[k]), rtol=1e-5, err_msg=k)
    _close_grads(grads, asr_state_dict(jax.tree_util.tree_map(np.asarray, jgrads), config_from_dict(conf)))
    for k in (rnnt_joint.KERNEL, lstm_scan.KERNEL, ctc_head.KERNEL, ctc_lattice.KERNEL):
        assert k.launches == 0


def test_two_optimizer_updates_match_jax_train_step(weights):
    params, stats = weights
    conf = dict(RNNT_SMALL, mtl_ctc_weight=0.3)
    batches = [_batch(10 + i) for i in range(4)]
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
        np.testing.assert_allclose(mt["loss_total"].item(), float(m["loss_total"]), rtol=2e-4)
        np.testing.assert_allclose(mt["lr"], float(m["lr"]), rtol=2e-6)
        assert mt["grad_finite"] and bool(m["grad_finite"])
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


@pytest.mark.parametrize("fused", [False, True])
def test_bf16_micro_step_matches_jax(weights, fused):
    """The tiny RNN-T(Conformer) with auxiliary CTC in bf16: loss,
    gradients, one update, float32 masters, moments and statistics."""
    params, stats = weights
    conf = dict(RNNT_SMALL, mtl_ctc_weight=0.3, enc_fused_attn=fused)
    assert_bf16_micro_step_matches_jax(conf, params, stats, _batch(2))


def test_bf16_eval_loss_matches_jax(weights):
    """The validation loss under `compute_dtype: bfloat16` (dropout off,
    BatchNorm on its float32 running statistics with bf16 weights) against
    the JAX `make_eval_loss_step`: rtol 5e-3, as the bf16 micro-step."""
    from emoasr_tpu.train.step import make_eval_loss_step as jax_eval_step
    from emoasr_tpu_torch.train.step import make_eval_loss_step

    params, stats = weights
    conf = dict(RNNT_SMALL, mtl_ctc_weight=0.3, enc_fused_attn=True, compute_dtype="bfloat16")
    b = _batch(4)
    jcfg = jax_config(conf)
    tx = joptim.build_optimizer(jcfg)
    want = jax_eval_step(JaxASR(jcfg), jcfg)(init_train_state(params, stats, tx),
                                             {k: jnp.asarray(v) for k, v in b.items()})
    cfg = config_from_dict(conf)
    model = port_model(conf, params, stats)
    state = TrainState(model=model, optimizer=optim.build_optimizer(cfg, model.parameters()))
    got = make_eval_loss_step(cfg)(state, {k: T_(v.copy()) for k, v in b.items()})
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(got[k].item(), float(want[k]), rtol=5e-3, err_msg=k)
    assert all(buf.dtype == torch.float32 for name, buf in model.named_buffers() if "running" in name)
