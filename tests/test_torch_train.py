"""The port's training pieces against the JAX package's, on the CPU.

- LR schedules, SpecAugment with shared (start, width) pairs, batch order.
- The slice as a whole: the same weights (through `asr_state_dict`), the
  same batch, dropout and SpecAugment off: loss and every gradient against
  `jax.value_and_grad` of the JAX model; then the parameters after 2
  optimizer updates with `accum_grad: 2` (4 micro-steps) against the JAX
  `make_train_step`, with `enc_fused_attn` on and off; a NaN micro-step is
  skipped the same way on both sides.

- `compute_dtype: bfloat16`: one micro-step's loss, gradients and the
  parameters after one update against the JAX step's, masters and moments
  float32 (`assert_bf16_micro_step_matches_jax` states its tolerances).

Sizes: 2 layers, d=32, 4 heads, F=20, V=37.  Tolerances: loss rtol 1e-5;
each gradient tensor within 1e-4 of its largest entry (+1e-6): float32 sums
in two frameworks' orders through 2 layers and the lattice.  Parameters
after Adam updates: Adam divides by sqrt(v) + 1e-8, so where a gradient is
rounding noise (about 1e-9 and below, e.g. the key bias, whose true gradient
is zero) its sign decides a step of up to the LR; the parameters are held to
2 % of the LR on all but 1 % of each tensor's entries, and to the sum of
the LRs applied everywhere.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from emoasr_tpu.config import config_from_dict as jax_config
from emoasr_tpu.data.batching import BucketBatcher as JaxBatcher
from emoasr_tpu.data.batching import derive_buckets as jax_derive_buckets
from emoasr_tpu.models.asr import ASR as JaxASR
from emoasr_tpu.ops import specaug as jsa
from emoasr_tpu.train import optim as joptim
from emoasr_tpu.train.step import init_train_state
from emoasr_tpu.train.step import make_train_step as jax_make_train_step
from emoasr_tpu.utils.precision import cast_batch_for_compute as jax_cast_batch
from emoasr_tpu.utils.precision import cast_params_for_compute as jax_cast_params
from emoasr_tpu_torch.config import config_from_dict
from emoasr_tpu_torch.data.batching import BucketBatcher, derive_buckets
from emoasr_tpu_torch.models.asr import ASR
from emoasr_tpu_torch.ops import attention, ctc_head, ctc_lattice, specaug
from emoasr_tpu_torch.train import optim
from emoasr_tpu_torch.train.step import TrainState, make_eval_loss_step, make_train_step
from emoasr_tpu_torch.train.step import compute_loss
from emoasr_tpu_torch.utils.flax_import import asr_state_dict
from test_torch_encoder import random_flax_params

T = torch.from_numpy


# ------------------------------------------------------------------ schedules


@pytest.mark.parametrize("sched,extra", [
    ("noam", dict(num_warmup_steps=50)),
    ("epdecay", dict(num_warmup_steps=50)),
    ("lindecay", dict(num_warmup_steps=50)),
    ("lindecay", dict(num_warmup_steps=None, warmup_proportion=0.1)),
])
def test_lr_schedules_match_jax(sched, extra):
    conf = dict(lr_schedule_type=sched, learning_rate=3.0, enc_hidden_size=64, **extra)
    total = 1000
    jf = joptim.make_lr_fn(jax_config(conf), total)
    tf = optim.make_lr_fn(config_from_dict(conf), total)
    warmup = optim.resolve_warmup(config_from_dict(conf), total)
    assert warmup == joptim.resolve_warmup(jax_config(conf), total)
    for step in (1, warmup, warmup + 1, 700, total, total + 5):
        for scale in (1.0, 0.25):
            want = float(jf(jnp.asarray(step), jnp.float32(scale)))
            # the JAX side computes in float32
            np.testing.assert_allclose(tf(step, scale), want, rtol=2e-6, atol=1e-12)


# ------------------------------------------------------------------ SpecAugment


def _draws(seed, B, F, xlens):
    """(start, width) pairs from numpy, some wider than their utterance."""
    rng = np.random.default_rng(seed)
    M = specaug.MAX_MASKS
    fw = rng.integers(0, 30, size=(B, M))
    fs = rng.integers(0, 2 ** 30, size=(B, M)) % np.maximum(F - fw, 1)
    tw = rng.integers(0, 40, size=(B, M))
    ts = rng.integers(0, 2 ** 30, size=(B, M)) % np.maximum(xlens[:, None] - tw, 1)
    return fs, fw, ts, tw


@pytest.mark.parametrize("replace_with_zero", [True, False])
def test_specaug_same_pairs_match_jax(replace_with_zero):
    B, Tn, F = 4, 90, 40
    rng = np.random.default_rng(0)
    xs = rng.normal(size=(B, Tn, F)).astype(np.float32) + 1.5
    xlens = np.array([90, 60, 12, 35], np.int32)  # 12 frames: wide time masks do not fit
    fs, fw, ts, tw = _draws(1, B, F, xlens)
    tw[2, 0] = 30
    nmf, nmt = np.full((B,), 2), np.array([2, 3, 2, 20])

    # the JAX function's own steps (ops/specaug.py:67-104) on these pairs
    jxs, jxl = jnp.asarray(xs), jnp.asarray(xlens)
    fmask = jsa._apply_masks(jxs, jnp.asarray(fs), jnp.asarray(fw), jnp.asarray(nmf), F, axis=2)
    fits = jnp.asarray(tw) < jxl[:, None]
    tmask = jsa._apply_masks(jxs, jnp.asarray(ts), jnp.asarray(tw), jnp.asarray(nmt), Tn, axis=1, valid=fits)
    if replace_with_zero:
        fill = 0.0
    else:
        valid = (jnp.arange(Tn)[None, :] < jxl[:, None])[:, :, None]
        fill = (jnp.sum(jnp.where(valid, jxs, 0.0), axis=(1, 2))
                / jnp.maximum(jnp.sum(valid, axis=(1, 2)) * F, 1))[:, None, None]
    want = np.asarray(jnp.where(fmask | tmask, fill, jxs))

    draws = specaug.MaskDraws(T(fs), T(fw), T(nmf), T(ts), T(tw), T(nmt))
    got = specaug.apply_masks(T(xs), T(xlens), draws, replace_with_zero).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)
    assert (got != xs).any()
    # the 30-wide mask on the 12-frame utterance was skipped
    assert not np.all(got[2, :12] == (0.0 if replace_with_zero else got[2, 0, 0]), axis=None)


def test_specaug_draws_are_valid():
    g = torch.Generator().manual_seed(0)
    xlens = torch.tensor([300, 41, 7, 120])
    d = specaug.draw_masks(g, xlens, 80, max_mask_freq=30, num_masks_freq=2,
                           max_mask_time=40, num_masks_time=2)
    assert (d.f_widths >= 0).all() and (d.f_widths < 30).all()
    assert (d.f_starts >= 0).all() and (d.f_starts + d.f_widths <= 80).all()
    assert (d.t_widths >= 0).all() and (d.t_widths < 40).all()
    fits = d.t_widths < xlens[:, None]
    assert ((d.t_starts + d.t_widths <= xlens[:, None]) | ~fits).all()  # never past xlens
    assert (d.t_starts < xlens[:, None]).all()
    assert d.f_count.tolist() == [2] * 4 and d.t_count.tolist() == [2] * 4
    # adaptive variant: caps of 20, counts from the lengths
    d2 = specaug.draw_masks(g, xlens, 80, max_mask_time_ratio=0.05, num_masks_time_ratio=0.02)
    assert d2.t_count.tolist() == [6, 1, 0, 2]
    assert (d2.t_widths[0] < 15).all() and (d2.t_widths[2] == 0).all()
    # two generators seeded alike draw alike; the masked batch keeps its shape
    xs = torch.randn(4, 300, 80, generator=torch.Generator().manual_seed(1))
    a = specaug.spec_augment(torch.Generator().manual_seed(5), xs, xlens)
    b = specaug.spec_augment(torch.Generator().manual_seed(5), xs, xlens)
    assert torch.equal(a, b) and a.shape == xs.shape and (a == 0).any()


# ------------------------------------------------------------------ batch order


@pytest.mark.parametrize("seed", [0, 7])
def test_batch_order_matches_jax(seed):
    rng = np.random.default_rng(3)
    xlens = np.sort(rng.integers(20, 400, size=157))
    ylens = rng.integers(1, 30, size=157)
    shapes, budget = [(100, 16), (200, 32), (400, 32)], (1600, 200, 12)
    jb = JaxBatcher(xlens, ylens, jax_derive_buckets(shapes, *budget), shuffle=True, seed=seed, drop_tail=True)
    tb = BucketBatcher(xlens, ylens, derive_buckets(shapes, *budget), shuffle=True, seed=seed, drop_tail=True)
    assert len(tb) == len(jb) > 5
    assert list(tb) == list(jb)
    assert list(tb) != tb.batches  # shuffled
    # decoding: manifest order, tails kept
    kept = BucketBatcher(xlens, ylens, derive_buckets(shapes, *budget))
    assert sum(len(i) for _, i in kept) == sum(
        len(i) for _, i in JaxBatcher(xlens, ylens, jax_derive_buckets(shapes, *budget), shuffle=False, drop_tail=False))
    assert len(kept) > len(tb)


# ------------------------------------------------------------------ the slice as a whole

CONF = dict(
    encoder_type="transformer", decoder_type="ctc", input_layer="conv2d",
    feat_dim=20, enc_hidden_size=32, enc_num_attention_heads=4,
    enc_num_layers=2, enc_intermediate_size=64, vocab_size=37,
    dropout_enc_rate=0.0, dropout_attn_rate=0.0, spec_augment=False,
    lr_schedule_type="noam", learning_rate=2.0, num_warmup_steps=4,
    clip_grad_norm=5.0, weight_decay=1e-3, accum_grad=2,
)


def _batches(n, seed=0, B=3, Tn=61, F=20, U=5, V=37):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        ys = rng.integers(3, V, size=(B, U)).astype(np.int32)
        ys[0, :3] = 5  # repeated labels
        ylens = np.array([5, 3, 0], np.int32)
        ys_pad = np.where(np.arange(U)[None, :] < ylens[:, None], ys, 2).astype(np.int32)
        out.append(dict(
            xs=rng.normal(size=(B, Tn, F)).astype(np.float32),
            xlens=np.array([61, 40, 29], np.int32), ys=ys_pad, ylens=ylens,
            ys_in=np.full((B, U + 1), 2, np.int32), ys_out=np.full((B, U + 1), 2, np.int32),
        ))
    return out


def _to_torch(batch):
    return {k: T(v.copy()) for k, v in batch.items()}


def _to_jax(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def _port_state(conf, params, stats=None):
    cfg = config_from_dict(conf)
    model = ASR(cfg)
    model.load_state_dict(asr_state_dict(params, cfg, stats) if stats else asr_state_dict(params, cfg))
    return cfg, TrainState(model=model, optimizer=optim.build_optimizer(cfg, model.parameters()))


def _assert_grads_close(named, ref_sd, tol=1e-4):
    for name, g in named.items():
        ref = ref_sd[name].numpy()
        np.testing.assert_allclose(g.numpy(), ref, rtol=0, atol=tol * np.abs(ref).max() + 1e-6, err_msg=name)


@pytest.mark.parametrize("fused", [False, True])
@pytest.mark.parametrize("mtl", [False, True])
def test_loss_and_gradients_match_jax(fused, mtl):
    conf = dict(CONF, enc_fused_attn=fused)
    if mtl:  # inter-CTC and hierarchical phone-CTC from the first layer
        conf.update(mtl_inter_ctc_weight=0.3, mtl_phone_ctc_weight=0.4, hie_mtl_phone=True,
                    inter_ctc_layer_id=1, phone_vocab_size=11)
    params = random_flax_params(conf, seed=1)
    batch = _batches(1)[0]
    if mtl:
        rng = np.random.default_rng(9)
        params["decoder"]["phone_output"] = {
            "kernel": (rng.normal(size=(32, 11)) / np.sqrt(32)).astype(np.float32),
            "bias": (0.1 * rng.normal(size=(11,))).astype(np.float32),
        }
        batch["ps"] = rng.integers(1, 11, size=(3, 8)).astype(np.int32)
        batch["plens"] = np.array([8, 4, 1], np.int32)
    jcfg = jax_config(conf)
    jb = _to_jax(batch)

    def jloss(p):
        return JaxASR(jcfg).apply(
            {"params": p}, jb["xs"], jb["xlens"], jb["ys"], jb["ylens"], jb["ys_in"], jb["ys_out"],
            None, jb.get("ps"), jb.get("plens"), deterministic=True)

    (jl, jdict), jgrads = jax.jit(jax.value_and_grad(jloss, has_aux=True))(params)

    cfg, state = _port_state(conf, params)
    tb = _to_torch(batch)
    state.model.train()  # dropout rates are 0
    loss, loss_dict = state.model(tb["xs"], tb["xlens"], tb["ys"], tb["ylens"], tb["ys_in"], tb["ys_out"],
                                  None, tb.get("ps"), tb.get("plens"))
    names = [n for n, _ in state.model.named_parameters()]
    grads = dict(zip(names, torch.autograd.grad(loss, list(state.model.parameters()))))

    np.testing.assert_allclose(loss.item(), float(jl), rtol=1e-5)
    assert set(loss_dict) == set(jdict)
    for k in jdict:
        np.testing.assert_allclose(loss_dict[k].item(), float(jdict[k]), rtol=1e-5, err_msg=k)
    ref = asr_state_dict(jax.tree_util.tree_map(np.asarray, jgrads), cfg)
    assert set(ref) == set(names)  # a gradient tree maps like the parameters
    _assert_grads_close(grads, ref)
    assert attention.KERNEL.launches == ctc_head.KERNEL.launches == ctc_lattice.KERNEL.launches == 0


def test_dense_route_when_asked(monkeypatch):
    """`USE_FUSED_HEAD = False` takes the dense route (logits, logsumexp,
    gather) to the same loss and gradients (rtol 1e-5; gradients 1e-5 of
    the largest entry: one framework, two orders of the same sums)."""
    from emoasr_tpu_torch.models.decoders import ctc as dec

    conf = dict(CONF, enc_fused_attn=True, mtl_inter_ctc_weight=0.3, inter_ctc_layer_id=1)
    params = random_flax_params(conf, seed=4)
    tb = _to_torch(_batches(1, seed=3)[0])
    res = []
    for fused in (True, False):
        monkeypatch.setattr(dec, "USE_FUSED_HEAD", fused)
        _, state = _port_state(conf, params)
        loss, _ = state.model(tb["xs"], tb["xlens"], tb["ys"], tb["ylens"])
        names = [n for n, _ in state.model.named_parameters()]
        res.append((loss.item(), dict(zip(names, torch.autograd.grad(loss, list(state.model.parameters()))))))
    np.testing.assert_allclose(res[0][0], res[1][0], rtol=1e-5)
    _assert_grads_close(res[0][1], res[1][1], tol=1e-5)


def _run_both(conf, batches):
    """4 micro-steps on both sides; returns per-step metrics and final states."""
    params = random_flax_params(conf, seed=2)
    jcfg = jax_config(conf)
    tx = joptim.build_optimizer(jcfg)
    jstate = init_train_state(params, {}, tx)
    jstep = jax_make_train_step(JaxASR(jcfg), jcfg, tx)
    cfg, state = _port_state(conf, params)
    step = make_train_step(cfg)
    jm, tm = [], []
    for i, batch in enumerate(batches):
        jstate, m = jstep(jstate, _to_jax(batch), jax.random.PRNGKey(i))
        jm.append({k: np.asarray(v) for k, v in m.items()})
        tm.append(step(state, _to_torch(batch)))
    return params, cfg, jstate, jm, state, tm


def _assert_params_close(state, jstate, cfg, lrs, start_params):
    ref = asr_state_dict(jax.tree_util.tree_map(np.asarray, jstate.params), cfg)
    start = asr_state_dict(start_params, cfg)
    total = sum(lrs)
    for name, p in state.model.named_parameters():
        diff = np.abs(p.detach().numpy() - ref[name].numpy())
        assert diff.max() <= 1.01 * total, name
        assert (diff > 0.02 * max(lrs)).mean() <= 0.01, (name, diff.max(), max(lrs))
        assert np.abs(ref[name].numpy() - start[name].numpy()).max() > 0.5 * max(lrs), name  # it moved


@pytest.mark.parametrize("fused", [False, True])
def test_two_optimizer_updates_match_jax_train_step(fused):
    conf = dict(CONF, enc_fused_attn=fused)
    start, cfg, jstate, jm, state, tm = _run_both(conf, _batches(4, seed=5))
    assert state.step == int(jstate.step) == 4 and state.skipped == int(jstate.skipped) == 0
    assert state.mini_step == 0
    for a, b in zip(tm, jm):
        np.testing.assert_allclose(a["lr"], float(b["lr"]), rtol=2e-6)
        np.testing.assert_allclose(a["loss_total"].item(), float(b["loss_total"]), rtol=2e-4)
        assert a["grad_finite"] and bool(b["grad_finite"])
    lr_fn = optim.make_lr_fn(cfg)
    assert tm[1]["lr"] == lr_fn(1) and tm[3]["lr"] == lr_fn(2)  # LR at (step + accum - 1) // accum
    _assert_params_close(state, jstate, cfg, [tm[1]["lr"], tm[3]["lr"]], start)
    # the eval loss step: dropout off, no gradient, the model back in train mode
    ld = make_eval_loss_step(cfg)(state, _to_torch(_batches(1, seed=8)[0]))
    assert np.isfinite(ld["loss_total"].item()) and state.model.training


def test_nan_micro_step_is_skipped_like_jax():
    conf = dict(CONF, enc_fused_attn=True)
    batches = _batches(4, seed=6)
    batches[1]["xs"][0, 3, 2] = np.nan
    start, cfg, jstate, jm, state, tm = _run_both(conf, batches)
    # the step counter advances on the skipped step; the accumulation does not
    assert state.step == int(jstate.step) == 4
    assert state.skipped == int(jstate.skipped) == 1
    assert [m["grad_finite"] for m in tm] == [bool(m["grad_finite"]) for m in jm] == [True, False, True, True]
    for a, b in zip(tm, jm):
        np.testing.assert_allclose(a["lr"], float(b["lr"]), rtol=2e-6)
    # one update so far (micro-steps 1 and 3), at the LR of optimizer step 2; micro-step 4 is open
    assert state.mini_step == 1 and int(jstate.opt_state.mini_step) == 1
    _assert_params_close(state, jstate, cfg, [tm[2]["lr"]], start)
    for p in state.model.parameters():
        assert torch.isfinite(p).all()


def test_finite_or_zero_and_clip_match_optax():
    import optax

    rng = np.random.default_rng(0)
    grads = [rng.normal(size=s).astype(np.float32) * 3 for s in ((4, 5), (7,), (2, 3, 2))]
    out, finite = optim.finite_or_zero([T(g) for g in grads])
    assert bool(finite) and all(np.array_equal(a.numpy(), g) for a, g in zip(out, grads))
    bad = [T(g.copy()) for g in grads]
    bad[1][3] = float("inf")
    out, finite = optim.finite_or_zero(bad)
    assert not bool(finite) and not any(a.any() for a in out)

    for max_norm in (5.0, 1e3):  # clipped, and left alone
        want, _ = optax.clip_by_global_norm(max_norm).update([jnp.asarray(g) for g in grads], optax.EmptyState())
        got = [T(g.copy()) for g in grads]
        norm = optim.clip_by_global_norm_(got, max_norm)
        np.testing.assert_allclose(norm.item(), float(optax.global_norm([jnp.asarray(g) for g in grads])), rtol=1e-6)
        for a, b in zip(got, want):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-6)


# ------------------------------------------------------------------ bf16


def _jax_loss_and_grads(conf, params, stats, batch, cfg):
    """The JAX step's loss and float32 gradients (`train/step.py:131-152`,
    jitted as the step is), by port parameter name."""
    jcfg = jax_config(conf)
    model = JaxASR(jcfg)
    jb = _to_jax(batch)

    def loss_fn(p):
        variables = {"params": jax_cast_params(jcfg, p)}
        if stats:
            variables["batch_stats"] = stats
        out = model.apply(variables, jax_cast_batch(jcfg, jb["xs"]), jb["xlens"], jb["ys"], jb["ylens"],
                          jb["ys_in"], jb["ys_out"], None, None, None, deterministic=False,
                          rngs={"dropout": jax.random.PRNGKey(0)}, mutable=["batch_stats"] if stats else False)
        return out[0][0] if stats else out[0]

    loss, grads = jax.jit(jax.value_and_grad(loss_fn))(params)
    return float(loss), asr_state_dict(jax.tree_util.tree_map(np.asarray, grads), cfg)


def assert_bf16_micro_step_matches_jax(conf, params, stats, batch):
    """One bf16 micro-step from the same float32 weights, port against JAX.

    - Loss: rtol 5e-3.
    - Gradients (float32, to the masters): bf16 rounds every activation, so
      the JAX bf16 step's gradients themselves lie some way from its float32
      step's (up to ~30 % of a tensor's largest entry for the first
      convolution's weight, whose sums run over every frame).  Each tensor
      is held within twice that distance of the JAX bf16 gradient, plus one
      bf16 step (2^-7) of its largest entry, plus 1e-4 of the model's
      largest entry (the key biases' true gradient is zero).
    - After one Adam update (accum_grad 1): Adam's first step moves each
      entry by about the LR times the sign of its gradient, so an entry
      whose gradient is within the bf16 noise of zero may move the other
      way: every entry within 2 LR of JAX's, and over the model at most 2 %
      of the entries more than 2 % of the LR apart.
    - Masters, Adam moments and BatchNorm statistics stay float32; the
      statistics within 1e-4 of JAX's."""
    conf16 = dict(conf, compute_dtype="bfloat16", accum_grad=1)
    cfg = config_from_dict(conf16)
    jl, jg = _jax_loss_and_grads(conf16, params, stats, batch, cfg)
    _, jg32 = _jax_loss_and_grads(dict(conf16, compute_dtype="float32"), params, stats, batch, cfg)

    _, state = _port_state(conf16, params, stats)
    state.model.train()
    loss, _ = compute_loss(state.model, cfg, _to_torch(batch))
    names = [n for n, _ in state.model.named_parameters()]
    grads = dict(zip(names, torch.autograd.grad(loss, list(state.model.parameters()))))
    np.testing.assert_allclose(loss.item(), jl, rtol=5e-3)
    floor = 1e-4 * max(np.abs(g.numpy()).max() for g in jg32.values())
    for name, g in grads.items():
        assert g.dtype == torch.float32, name
        ref, ref32 = jg[name].numpy(), jg32[name].numpy()
        noise = np.abs(ref - ref32).max()
        tol = 2 * noise + 2.0 ** -7 * np.abs(ref32).max() + floor
        np.testing.assert_allclose(g.numpy(), ref, rtol=0, atol=tol, err_msg=name)

    jcfg = jax_config(conf16)
    tx = joptim.build_optimizer(jcfg)
    jstate, jm = jax_make_train_step(JaxASR(jcfg), jcfg, tx)(
        init_train_state(params, stats or {}, tx), _to_jax(batch), jax.random.PRNGKey(0))
    _, state = _port_state(conf16, params, stats)
    tm = make_train_step(cfg)(state, _to_torch(batch))
    np.testing.assert_allclose(tm["loss_total"].item(), float(jm["loss_total"]), rtol=5e-3)
    lr = tm["lr"]
    ref = asr_state_dict(jax.tree_util.tree_map(np.asarray, jstate.params), cfg,
                         jax.tree_util.tree_map(np.asarray, jstate.batch_stats) if stats else None)
    far, total = 0, 0
    for name, p in state.model.named_parameters():
        assert p.dtype == torch.float32, name
        diff = np.abs(p.detach().numpy() - ref[name].numpy())
        assert diff.max() <= 2.01 * lr, (name, diff.max(), lr)
        far, total = far + int((diff > 0.02 * lr).sum()), total + diff.size
    assert far <= 0.02 * total, (far, total)
    moments = [v for st in state.optimizer.state.values() for v in st.values() if torch.is_tensor(v)]
    assert moments and all(v.dtype == torch.float32 for v in moments if v.is_floating_point())
    for name, buf in state.model.named_buffers():
        if "running" in name:
            assert buf.dtype == torch.float32, name
            np.testing.assert_allclose(buf.numpy(), ref[name].numpy(), rtol=0, atol=1e-4, err_msg=name)


@pytest.mark.parametrize("fused", [False, True])
def test_bf16_micro_step_matches_jax(fused):
    """`compute_dtype: bfloat16` training of the tiny CTC(Transformer): the
    port's micro-step against the JAX step on the same weights and batch
    (`enc_fused_attn` on: K1 and K4 forward and backward in bf16 on both
    sides, the JAX kernels in interpret mode)."""
    conf = dict(CONF, enc_fused_attn=fused)
    assert_bf16_micro_step_matches_jax(conf, random_flax_params(conf, seed=2), None, _batches(1, seed=5)[0])
