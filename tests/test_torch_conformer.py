"""The port's Conformer modules against the JAX package's flax modules, with
the same weights carried across by `utils/flax_import.py::asr_state_dict`,
and against the emoASR outputs recorded in tests/fixtures_enc_conformer.npz.

Sizes: 2 layers, d=32, 4 heads, FF 64, conv kernel 7, F=20, V=50.  Inputs and
weights come from numpy seeds.  Tolerances: f32 atol 2e-5 against JAX (the
same arithmetic in another summation order, through two layers with a
BatchNorm and five LayerNorms each); gradients atol 5e-5 at entries up to a
few units; rtol/atol 1e-4 against the recorded emoASR outputs (what
tests/test_encoders.py holds the JAX encoder to); the RelPE table, rel_shift
and the weight round trip are exact (table: 1e-6, sin/cos of two libraries).
The JAX side's fused attention runs in Pallas interpret mode; the port's
runs its plain version (CPU tensors)."""

import math
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from emoasr_tpu.config import config_from_dict as jax_config
from emoasr_tpu.models import layers as jl
from emoasr_tpu.models.decoders.transformer import TransformerDecoder as JaxDecoder
from emoasr_tpu.models.encoders import TransformerEncoder as JaxEncoder
from emoasr_tpu.ops.attention_pallas import fused_self_attention as jax_fused_attention
from emoasr_tpu.utils import torch_import as ti
from emoasr_tpu_torch.config import config_from_dict
from emoasr_tpu_torch.models import layers as pl_
from emoasr_tpu_torch.models.asr import ASR
from emoasr_tpu_torch.models.encoders import TransformerEncoder
from emoasr_tpu_torch.ops import attention
from emoasr_tpu_torch.utils.flax_import import asr_state_dict

FIXDIR = os.path.dirname(os.path.abspath(__file__))
TOL = 2e-5

L3_SMALL = dict(
    encoder_type="conformer", decoder_type="transformer", pos_encode_type="rel",
    input_layer="conv2d", feat_dim=20, enc_hidden_size=32, enc_num_attention_heads=4,
    enc_num_layers=2, enc_intermediate_size=64, conv_kernel_size=7,
    dec_hidden_size=32, dec_num_attention_heads=4, dec_num_layers=2,
    dec_intermediate_size=64, vocab_size=50, mtl_ctc_weight=0.3, max_decode_ylen=12,
    dropout_enc_rate=0.0, dropout_attn_rate=0.0, dropout_dec_rate=0.0,
)


def random_l3_params(conf: dict, seed: int = 0):
    """JAX ASR (params, batch_stats) for a Conformer or Transformer encoder
    with a Transformer decoder, every leaf redrawn from numpy: kernels ~
    N(0, 1/fan_in), embeddings ~ N(0, 1), biases and pos_bias_u/v ~
    N(0, 0.1^2), norm scales ~ 1 + N(0, 0.1^2), BatchNorm mean ~ N(0, 0.1^2),
    var ~ 1 + |N(0, 0.2^2)|."""
    cfg = jax_config(conf)
    xs, xl = jnp.zeros((1, 32, cfg.feat_dim)), jnp.array([32])
    enc = jax.eval_shape(
        lambda: JaxEncoder(cfg, is_conformer=cfg.encoder_type == "conformer").init(
            jax.random.PRNGKey(0), xs, xl)
    )
    eouts = jnp.zeros((1, 7, cfg.enc_hidden_size))
    ys, ys_io = jnp.ones((1, 2), jnp.int32), jnp.ones((1, 3), jnp.int32)
    dec = jax.eval_shape(  # the loss route, so that the aux CTC head is initialised too
        lambda: JaxDecoder(cfg).init(
            jax.random.PRNGKey(1), eouts, jnp.array([7]), ys=ys, ylens=jnp.array([2]),
            ys_in=ys_io, ys_out=ys_io)
    )["params"]
    rng = np.random.default_rng(seed)

    def redraw(path, x):
        name, shape = path[-1].key, np.shape(x)
        if name == "kernel":
            return (rng.normal(size=shape) / math.sqrt(int(np.prod(shape[:-1])))).astype(np.float32)
        if name == "embedding":
            return rng.normal(size=shape).astype(np.float32)
        if name == "scale":
            return (1.0 + 0.1 * rng.normal(size=shape)).astype(np.float32)
        if name == "var":
            return (1.0 + np.abs(0.2 * rng.normal(size=shape))).astype(np.float32)
        return (0.1 * rng.normal(size=shape)).astype(np.float32)

    params = jax.tree_util.tree_map_with_path(redraw, {"encoder": enc["params"], "decoder": dec})
    stats = {}
    if "batch_stats" in enc:
        stats = jax.tree_util.tree_map_with_path(redraw, {"encoder": enc["batch_stats"]})
    return params, stats


def port_model(conf: dict, params: dict, stats: dict) -> ASR:
    cfg = config_from_dict(conf)
    model = ASR(cfg)
    model.load_state_dict(asr_state_dict(params, cfg, stats))
    return model.eval()


@pytest.fixture(scope="module")
def weights():
    return random_l3_params(L3_SMALL)


def _batch(seed=0, B=3, T=45, F=20):
    rng = np.random.default_rng(seed)
    return rng.normal(size=(B, T, F)).astype(np.float32), np.array([45, 30, 17][:B], np.int32)


def _close(a, b, tol=TOL):
    np.testing.assert_allclose(np.asarray(a, np.float32), np.asarray(b, np.float32), atol=tol, rtol=0)


def test_rel_positional_encoder():
    x = np.random.default_rng(0).normal(size=(2, 11, 32)).astype(np.float32)
    jx, jpe = jl.RelPositionalEncoder(32, 0.0).apply({}, jnp.asarray(x))
    px, ppe = pl_.RelPositionalEncoder(32, 0.0).eval()(torch.from_numpy(x))
    assert ppe.shape == (1, 21, 32)
    _close(px.numpy(), jx, 1e-6)
    _close(ppe.numpy(), jpe, 1e-6)
    # positions T-1 .. -(T-1): the middle row is position 0
    np.testing.assert_allclose(ppe[0, 10, 0::2].numpy(), 0.0, atol=1e-7)
    np.testing.assert_allclose(ppe[0, 10, 1::2].numpy(), 1.0, atol=1e-7)


def test_rel_shift_is_exact():
    x = np.random.default_rng(1).normal(size=(2, 3, 7, 13)).astype(np.float32)
    ref = jl.RelMultiHeadAttention.rel_shift(jnp.asarray(x))
    got = pl_.RelMultiHeadAttention.rel_shift(torch.from_numpy(x))
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))


@pytest.mark.parametrize("train", [False, True])
def test_conv_module(weights, train):
    """Eval mode normalises with the running statistics, train mode with the
    batch's (over (B, T), padded frames included); train mode also moves the
    running mean and variance as the JAX package moves them (the variance
    by the batch's biased one)."""
    params, stats = weights
    p = params["encoder"]["layers_0"]["conv"]
    st = stats["encoder"]["layers_0"]["conv"]
    x = np.random.default_rng(2).normal(size=(3, 19, 32)).astype(np.float32)
    ref, mut = jl.ConvModule(32, 7).apply(
        {"params": p, "batch_stats": st}, jnp.asarray(x), not train, mutable=["batch_stats"]
    )
    mod = port_model(L3_SMALL, params, stats).encoder.transformers[0].conv
    mod.train(train)
    with torch.no_grad():
        out = mod(torch.from_numpy(x))
    _close(out.numpy(), ref)
    if train:
        _close(mod.batch_norm.running_mean.numpy(), mut["batch_stats"]["batch_norm"]["mean"], 1e-6)
        _close(mod.batch_norm.running_var.numpy(), mut["batch_stats"]["batch_norm"]["var"], 1e-6)


@pytest.mark.parametrize("fused", [False, True])
def test_rel_multi_head_attention(weights, fused):
    params, stats = weights
    rng = np.random.default_rng(3)
    B, T, D = 3, 11, 32
    h = rng.normal(size=(B, T, D)).astype(np.float32)
    lens = np.array([11, 6, 1], np.int32)
    mask = (np.arange(T)[None, :] < lens[:, None])[:, None, None, :]
    pos = np.asarray(jl.RelPositionalEncoder(D, 0.0).apply({}, jnp.asarray(h))[1])
    ref = jl.RelMultiHeadAttention(4, D, fused=fused).apply(
        {"params": params["encoder"]["layers_0"]["self_attn"]}, *(jnp.asarray(h),) * 3,
        jnp.asarray(pos), jnp.asarray(mask), lens=jnp.asarray(lens) if fused else None,
    )
    mha = port_model(dict(L3_SMALL, enc_fused_attn=fused), params, stats).encoder.transformers[0].self_attn
    ht = torch.from_numpy(h)
    with torch.no_grad():
        out = mha(ht, ht, ht, torch.from_numpy(pos), torch.from_numpy(mask),
                  lens=torch.from_numpy(lens) if fused else None)
    for b, n in enumerate(lens):  # the fused route leaves padded query rows to the mask
        _close(out[b, :n].numpy(), np.asarray(ref)[b, :n])
    assert attention.KERNEL.launches == 0


@pytest.mark.parametrize("pos_type", ["rel", "abs"])
def test_conformer_encoder_layer(weights, pos_type):
    params, stats = weights
    rng = np.random.default_rng(4)
    B, T, D = 2, 13, 32
    x = rng.normal(size=(B, T, D)).astype(np.float32)
    lens = np.array([13, 7], np.int32)
    mask = (np.arange(T)[None, :] < lens[:, None])[:, None, None, :]
    pos = np.asarray(jl.RelPositionalEncoder(D, 0.0).apply({}, jnp.asarray(x))[1])
    p = dict(params["encoder"]["layers_1"])
    if pos_type == "abs":  # plain MHSA: no position projection
        p["self_attn"] = {k: v for k, v in p["self_attn"].items() if k.startswith("linear_") and k != "linear_pos"}
    ref = jl.ConformerEncoderLayer(4, D, 64, 0.0, 0.0, pos_type, 7).apply(
        {"params": p, "batch_stats": stats["encoder"]["layers_1"]},
        jnp.asarray(x), jnp.asarray(mask), jnp.asarray(pos),
    )
    layer = pl_.ConformerEncoderLayer(4, D, 64, 0.0, 0.0, pos_type, 7).eval()
    sd = asr_state_dict(
        {"encoder": {"layers_0": p, "norm": params["encoder"]["norm"], "conv": params["encoder"]["conv"]},
         "decoder": params["decoder"]},
        config_from_dict(dict(L3_SMALL, enc_num_layers=1)),
        {"encoder": {"layers_0": stats["encoder"]["layers_1"]}},
    )
    layer.load_state_dict({k[len("encoder.transformers.0."):]: v for k, v in sd.items()
                           if k.startswith("encoder.transformers.0.")})
    with torch.no_grad():
        out = layer(torch.from_numpy(x), torch.from_numpy(mask), torch.from_numpy(pos))
    _close(out.numpy(), ref)


@pytest.mark.parametrize("fused", [False, True])
def test_conformer_encoder(weights, fused):
    params, stats = weights
    xs, xlens = _batch(5)
    conf = dict(L3_SMALL, enc_fused_attn=fused)
    ref, ref_lens, _ = JaxEncoder(jax_config(conf), is_conformer=True).apply(
        {"params": params["encoder"], "batch_stats": stats["encoder"]}, jnp.asarray(xs), jnp.asarray(xlens)
    )
    model = port_model(conf, params, stats)
    with torch.no_grad():
        eouts, elens, _ = model.encode(torch.from_numpy(xs), torch.from_numpy(xlens).long())
    np.testing.assert_array_equal(elens.numpy(), np.asarray(ref_lens))
    for b, n in enumerate(np.asarray(ref_lens)):
        _close(eouts[b, :n].numpy(), np.asarray(ref)[b, :n])
    assert attention.KERNEL.launches == 0


def test_conformer_matches_recorded_emoasr_outputs():
    fx = np.load(os.path.join(FIXDIR, "fixtures_enc_conformer.npz"))
    sd = {k[4:]: torch.from_numpy(fx[k]) for k in fx.files if k.startswith("sd::")}
    base = dict(encoder_type="conformer", pos_encode_type="rel", input_layer="conv2d", feat_dim=20,
                enc_hidden_size=32, enc_num_attention_heads=4, enc_num_layers=2,
                enc_intermediate_size=64, vocab_size=30)
    for fused in (False, True):
        enc = TransformerEncoder(config_from_dict(dict(base, enc_fused_attn=fused)), is_conformer=True)
        enc.load_state_dict(sd)
        with torch.no_grad():
            eouts, elens, _ = enc.eval()(torch.from_numpy(fx["xs"]), torch.from_numpy(fx["xlens"]))
        np.testing.assert_array_equal(elens.numpy(), fx["elens"])
        for b, n in enumerate(fx["elens"]):  # reference padding frames differ
            np.testing.assert_allclose(eouts[b, :n].numpy(), fx["eouts"][b, :n], rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("fused", [False, True])
def test_conformer_encoder_gradients(weights, fused):
    """d loss / d every encoder parameter, eval-mode BatchNorm, loss = a
    fixed weighting of the valid output frames.  With `enc_fused_attn` the
    JAX side differentiates its Pallas kernel (interpret mode) and the port
    its plain version under autograd."""
    params, stats = weights
    xs, xlens = _batch(6)
    conf = dict(L3_SMALL, enc_fused_attn=fused)
    jcfg = jax_config(conf)
    wgt = np.cos(np.arange(3 * 10 * 32, dtype=np.float32)).reshape(3, 10, 32)

    def loss_j(p):
        e, el, _ = JaxEncoder(jcfg, is_conformer=True).apply(
            {"params": p, "batch_stats": stats["encoder"]}, jnp.asarray(xs), jnp.asarray(xlens))
        vm = (jnp.arange(e.shape[1])[None, :] < el[:, None])[:, :, None]
        return (jnp.where(vm, e, 0.0) * wgt).sum()

    gj = jax.jit(jax.grad(loss_j))(params["encoder"])
    want = asr_state_dict({"encoder": gj, "decoder": params["decoder"]}, config_from_dict(conf))
    model = port_model(conf, params, stats)
    e, el, _ = model.encode(torch.from_numpy(xs), torch.from_numpy(xlens).long())
    vm = (torch.arange(e.shape[1])[None, :] < el[:, None])[:, :, None]
    (torch.where(vm, e, torch.zeros_like(e)) * torch.from_numpy(wgt)).sum().backward()
    n = 0
    for name, p in model.encoder.named_parameters():
        _close(p.grad.numpy(), want["encoder." + name].numpy(), 5e-5)
        n += 1
    assert n == len([k for k in want if k.startswith("encoder.")])


def test_attention_with_bias_matches_jax_kernel():
    """Forward and all four gradients against `fused_self_attention(...,
    bias=)` in interpret mode, as tests/test_attention_pallas.py::
    test_fused_bias_grads_match_dense compares them: over the valid region
    (the kernels never produce the dense path's gradients at padded slots).
    atol 3e-5, as there."""
    rng = np.random.default_rng(7)
    B, T, H, D = 2, 29, 2, 16
    q, k, v = (rng.normal(size=(B, T, H, D)).astype(np.float32) for _ in range(3))
    bias = rng.normal(size=(B, H, T, T)).astype(np.float32)
    lens = np.array([29, 18], np.int32)
    scale = 1.0 / math.sqrt(D)
    w = np.cos(np.arange(B * T * H * D, dtype=np.float32)).reshape(B, T, H, D)
    vm = (np.arange(T)[None, :] < lens[:, None])[:, :, None, None]

    def jfn(q, k, v, bias):
        o = jax_fused_attention(q, k, v, jnp.asarray(lens), jnp.zeros((), jnp.int32), scale=scale, bias=bias)
        return (jnp.where(vm, o, 0.0) * w).sum(), o

    (v1, o1), g1 = jax.jit(jax.value_and_grad(jfn, argnums=(0, 1, 2, 3), has_aux=True))(
        *(jnp.asarray(x) for x in (q, k, v, bias)))
    tq, tk, tv, tb = (torch.from_numpy(x).requires_grad_(True) for x in (q, k, v, bias))
    o0 = attention.fused_self_attention(tq, tk, tv, torch.from_numpy(lens), scale=scale, bias=tb)
    v0 = (torch.where(torch.from_numpy(vm), o0, torch.zeros_like(o0)) * torch.from_numpy(w)).sum()
    v0.backward()
    np.testing.assert_allclose(v0.item(), float(v1), rtol=1e-5)
    for bb in range(B):
        n = int(lens[bb])
        _close(o0[bb, :n].detach().numpy(), np.asarray(o1)[bb, :n], 1e-5)
        for t, g in zip((tq, tk, tv), g1[:3]):
            _close(t.grad[bb, :n].numpy(), np.asarray(g)[bb, :n], 3e-5)
        _close(tb.grad[bb, :, :n, :n].numpy(), np.asarray(g1[3])[bb, :, :n, :n], 3e-5)
    assert attention.KERNEL.launches == 0


def test_state_dict_round_trip(weights):
    """torch_import.asr_model(asr_state_dict(p, stats)) == (p, stats), leaf
    for leaf, and the names are those of the port's modules."""
    params, stats = weights
    sd = asr_state_dict(params, config_from_dict(L3_SMALL), stats)
    back, back_stats = ti.asr_model({k: v.numpy() for k, v in sd.items()}, jax_config(L3_SMALL))
    for tree_a, tree_b in ((params, back), (stats, back_stats)):
        flat_a = jax.tree_util.tree_leaves_with_path(tree_a)
        flat_b = dict(jax.tree_util.tree_leaves_with_path(tree_b))
        assert len(flat_a) == len(flat_b)
        for path, a in flat_a:
            np.testing.assert_array_equal(np.asarray(flat_b[path]), a)
    assert set(sd) == set(ASR(config_from_dict(L3_SMALL)).state_dict())


@pytest.mark.parametrize("fused", [False, True])
def test_ctc_conformer_train_mode_loss_and_gradients_match_jax(weights, fused):
    """A CTC(Conformer) model in train mode (BatchNorm on the batch's own
    statistics, dropout rates 0): the loss (rtol 1e-5), every parameter's
    gradient (1e-4 of the tensor's largest entry + 1e-6) and the moved
    running means and variances (1e-6) against the JAX package."""
    from emoasr_tpu.models.asr import ASR as JaxASR

    params, stats = weights
    rng = np.random.default_rng(12)
    conf = dict(L3_SMALL, decoder_type="ctc", enc_fused_attn=fused, mtl_ctc_weight=0.0)
    head = {"kernel": (rng.normal(size=(32, 50)) / np.sqrt(32)).astype(np.float32),
            "bias": (0.1 * rng.normal(size=(50,))).astype(np.float32)}
    p = {"encoder": params["encoder"], "decoder": {"output": head}}
    xs, xlens = _batch(8)
    ys = rng.integers(3, 50, size=(3, 4)).astype(np.int32)
    ylens = np.array([4, 3, 1], np.int32)
    pad = np.full((3, 5), 2, np.int32)
    jcfg = jax_config(conf)

    def jloss(q):
        (loss, _), mut = JaxASR(jcfg).apply(
            {"params": q, "batch_stats": stats}, jnp.asarray(xs), jnp.asarray(xlens), jnp.asarray(ys),
            jnp.asarray(ylens), jnp.asarray(pad), jnp.asarray(pad), deterministic=False,
            mutable=["batch_stats"], rngs={"dropout": jax.random.PRNGKey(0)})
        return loss, mut

    (jl, mut), jgrads = jax.jit(jax.value_and_grad(jloss, has_aux=True))(p)
    cfg = config_from_dict(conf)
    model = ASR(cfg)
    model.load_state_dict(asr_state_dict(p, cfg, stats))
    model.train()
    loss, _ = model(torch.from_numpy(xs), torch.from_numpy(xlens).long(), torch.from_numpy(ys).long(),
                    torch.from_numpy(ylens).long())
    names = [n for n, _ in model.named_parameters()]
    grads = dict(zip(names, torch.autograd.grad(loss, list(model.parameters()))))
    np.testing.assert_allclose(loss.item(), float(jl), rtol=1e-5)
    ref = asr_state_dict(jax.tree_util.tree_map(np.asarray, jgrads), cfg)
    assert set(ref) == set(names)
    for name, g in grads.items():
        r = ref[name].numpy()
        np.testing.assert_allclose(g.numpy(), r, rtol=0, atol=1e-4 * np.abs(r).max() + 1e-6, err_msg=name)
    for i in range(2):
        _close(model.encoder.transformers[i].conv.batch_norm.running_mean.numpy(),
               mut["batch_stats"]["encoder"][f"layers_{i}"]["conv"]["batch_norm"]["mean"], 1e-6)
        _close(model.encoder.transformers[i].conv.batch_norm.running_var.numpy(),
               mut["batch_stats"]["encoder"][f"layers_{i}"]["conv"]["batch_norm"]["var"], 1e-6)
    assert attention.KERNEL.launches == 0
