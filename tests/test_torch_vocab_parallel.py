"""The vocabulary split of the port's tensor parallelism
(`emoasr_tpu_torch/parallel/vocab.py`, `parallel/tensor.py`'s
`VocabParallelEmbedding` / `VocabParallelHead`, K1 and K7 on a rank's
columns) against the whole vocabulary, on the CPU.

Emulated shards (m = 2 and m = 4): threads of this process stand for the
model ranks, joined by `ThreadGroup` (an all-reduce that adds the ranks'
tensors in rank order), and each runs the port's own code on its block of
columns: the combination of the partial normalisers and of the owned
logits, K1's vocabulary-parallel wrapper (its plain path), K7's plain path
with the column offset and the chunked route, the embedding and the label
smoothing / cross-entropy / distillation losses, the CTC decoder's
alignment distillation, the RNN-T decoder's `full` joint and its word and
align distillation, and the Gumbel-max sampling of P-ELECTRA's generator.
Each is held against the whole tensors within 1e-6 (values and gradients,
the gradients of a rank's columns put side by side), with labels on the
shards' boundaries, repeated path labels and `ignore_id` rows; the combined
values are bit-identical across the ranks.  A vocabulary that does not
divide stays whole.
"""

import threading

import numpy as np
import pytest
import torch
from torch import nn

from emoasr_tpu_torch.models.criteria import distill_loss, label_smoothing_loss, masked_lm_loss
from emoasr_tpu_torch.ops.ctc_head import ctc_head_plain, fused_ctc_head_shard
from emoasr_tpu_torch.ops.rnnt_joint import fused_joint_gather, joint_gather_shard
from emoasr_tpu_torch.parallel.mesh import Mesh, model_logsumexp
from emoasr_tpu_torch.parallel.tensor import VocabParallelEmbedding, VocabParallelHead, prepare_model_, tp_plan
from emoasr_tpu_torch.parallel.vocab import VocabShard

TOL = 1e-6


class ThreadGroup:
    """A model group of `size` threads: `all_reduce` adds every thread's
    tensor in rank order (the calling thread's rank is `self.rank`)."""

    def __init__(self, size: int):
        self.size = size
        self._barrier = threading.Barrier(size)
        self._slots = [None] * size
        self._local = threading.local()

    @property
    def rank(self) -> int:
        return self._local.rank

    def all_reduce(self, t: torch.Tensor) -> None:
        self._slots[self.rank] = t.clone()
        self._barrier.wait()
        total = self._slots[0].clone()
        for s in self._slots[1:]:
            total = total + s
        self._barrier.wait()
        t.copy_(total)

    def run(self, fn):
        """fn(rank) on every rank's thread; their results in rank order."""
        out, errs = [None] * self.size, []

        def body(r):
            self._local.rank = r
            try:
                out[r] = fn(r)
            except BaseException as e:  # noqa: BLE001 - re-raised below
                errs.append(e)
                self._barrier.abort()

        threads = [threading.Thread(target=body, args=(r,)) for r in range(self.size)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        if errs:
            raise errs[0]
        return out


def _close(got, want, tol=TOL, msg=""):
    got, want = np.asarray(got.detach(), np.float64), np.asarray(want.detach(), np.float64)
    np.testing.assert_allclose(got, want, rtol=0, atol=tol * max(1.0, np.abs(want).max()), err_msg=msg)


def _same_bits(tensors):
    for t in tensors[1:]:
        assert torch.equal(t.detach(), tensors[0].detach())


def _leaf(x):
    return x.detach().clone().requires_grad_(True)


@pytest.mark.parametrize("m", [2, 4])
def test_partial_normalisers_combine_in_rank_order(m):
    rng = np.random.default_rng(0)
    logits = torch.from_numpy(rng.normal(scale=4.0, size=(3, 5, 8 * m)).astype(np.float32))
    g = torch.from_numpy(rng.normal(size=(3, 5)).astype(np.float32))
    whole = _leaf(logits)
    (torch.logsumexp(whole, -1) * g).sum().backward()
    group = ThreadGroup(m)

    def rank(r):
        part = _leaf(logits[..., 8 * r:8 * (r + 1)])
        lse = model_logsumexp(torch.logsumexp(part, -1), group, r, m)
        (lse * g).sum().backward()
        return lse, part.grad

    res = group.run(rank)
    _same_bits([r[0] for r in res])
    _close(res[0][0], torch.logsumexp(logits, -1))
    _close(torch.cat([r[1] for r in res], -1), whole.grad)


def _ctc_inputs(V, m, seed=1):
    rng = np.random.default_rng(seed)
    B, T, H, S = 3, 7, 12, 9
    e = torch.from_numpy(rng.normal(size=(B, T, H)).astype(np.float32))
    w = torch.from_numpy(rng.normal(scale=0.3, size=(H, V)).astype(np.float32))
    b = torch.from_numpy(rng.normal(scale=0.3, size=(V,)).astype(np.float32))
    per = V // m
    # blanks, labels on every shard's first and last column, repeats, one label past V
    z = np.zeros((B, S), np.int64)
    z[:, 1::2] = rng.integers(1, V, (B, S // 2))
    z[0, 1::2] = [per - 1, per, per, 2 * per - 1][:S // 2]
    z[1, 3] = V - 1
    z[2, 5] = z[2, 3]
    return e, w, b, torch.from_numpy(z)


@pytest.mark.parametrize("m", [2, 4])
def test_ctc_head_on_a_ranks_columns_matches_the_whole_head(m):
    V = 8 * m
    e, w, b, z = _ctc_inputs(V, m)
    rng = np.random.default_rng(2)
    g_lse = torch.from_numpy(rng.normal(size=e.shape[:2]).astype(np.float32))
    g_xs = torch.from_numpy(rng.normal(size=e.shape[:2] + z.shape[1:]).astype(np.float32))
    we, ww, wb = _leaf(e), _leaf(w), _leaf(b)
    lse, xs = ctc_head_plain(we, ww, wb, z)
    ((lse * g_lse).sum() + (xs * g_xs).sum()).backward()
    group, per = ThreadGroup(m), V // m

    def rank(r):
        shard = VocabShard(group, r, m, per)
        re, rw, rb = _leaf(e), _leaf(w[:, r * per:(r + 1) * per]), _leaf(b[r * per:(r + 1) * per])
        lse_r, xs_r = fused_ctc_head_shard(re, rw, rb, z, shard)
        ((lse_r * g_lse).sum() + (xs_r * g_xs).sum()).backward()
        return lse_r, xs_r, re.grad, rw.grad, rb.grad

    res = group.run(rank)
    _same_bits([r[0] for r in res])
    _same_bits([r[1] for r in res])
    _same_bits([r[2] for r in res])  # the encoder output's gradient, summed over the group
    _close(res[0][0], lse, msg="lse")
    _close(res[0][1], xs, msg="xs")
    _close(res[0][2], we.grad, msg="d e")
    _close(torch.cat([r[3] for r in res], 1), ww.grad, msg="d w")
    _close(torch.cat([r[4] for r in res]), wb.grad, msg="d b")


def _joint_inputs(V, seed=3):
    rng = np.random.default_rng(seed)
    B, T, U, J = 2, 6, 4, 10
    he = torch.from_numpy(rng.normal(scale=0.5, size=(B, T, J)).astype(np.float32))
    hd = torch.from_numpy(rng.normal(scale=0.5, size=(B, U + 1, J)).astype(np.float32))
    w = torch.from_numpy(rng.normal(scale=0.4, size=(J, V)).astype(np.float32))
    b = torch.from_numpy(rng.normal(scale=0.2, size=(V,)).astype(np.float32))
    labels = torch.from_numpy(rng.integers(1, V, (B, U)))
    labels[0] = torch.tensor([V // 2 - 1, V // 2, V - 1, V // 2])
    return he, hd, w, b, labels


@pytest.mark.parametrize("route", ["pallas", "chunked"])
@pytest.mark.parametrize("m", [2, 4])
def test_rnnt_joint_on_a_ranks_columns_matches_the_whole_joint(m, route):
    V = 6 * m
    he, hd, w, b, labels = _joint_inputs(V)
    rng = np.random.default_rng(4)
    g_b = torch.from_numpy(rng.normal(size=(2, 6, 5)).astype(np.float32))
    g_l = torch.from_numpy(rng.normal(size=(2, 6, 4)).astype(np.float32))
    xe, xd, xw, xb = (_leaf(t) for t in (he, hd, w, b))
    lpb, lpl = fused_joint_gather(xe, xd, xw, xb, labels)
    ((lpb * g_b).sum() + (lpl * g_l).sum()).backward()
    group, per = ThreadGroup(m), V // m

    def rank(r):
        shard = VocabShard(group, r, m, per)
        re, rd = _leaf(he), _leaf(hd)
        rw, rb = _leaf(w[:, r * per:(r + 1) * per]), _leaf(b[r * per:(r + 1) * per])
        pb, pl = joint_gather_shard(re, rd, rw, rb, labels, 0, shard, route)
        ((pb * g_b).sum() + (pl * g_l).sum()).backward()
        return pb, pl, re.grad, rd.grad, rw.grad, rb.grad

    res = group.run(rank)
    _same_bits([r[0] for r in res])
    _same_bits([r[1] for r in res])
    _close(res[0][0], lpb, msg="lp_blank")
    _close(res[0][1], lpl, msg="lp_label")
    # h_enc's and h_dec's gradients: each rank's share, summed over the group by the caller
    _close(sum(r[2] for r in res), xe.grad, msg="d h_enc")
    _close(sum(r[3] for r in res), xd.grad, msg="d h_dec")
    _close(torch.cat([r[4] for r in res], 1), xw.grad, msg="d w")
    _close(torch.cat([r[5] for r in res]), xb.grad, msg="d b")


class _Tiny(nn.Module):
    """An embedding table and a vocabulary head, as the decoders hold them."""

    def __init__(self, V, D=6):
        super().__init__()
        self.embed = nn.Embedding(V, D)
        self.output = nn.Linear(D, V)

    def forward(self, ys):
        return self.output(torch.tanh(self.embed(ys)))


def _fake_mesh(group, r, m):
    return Mesh(shape=(1, m), axes=("data", "model"), rank=r, world=m, data_size=1, data_rank=0, model_size=m,
                model_rank=r, data_group=None, model_group=group, backend="gloo", device=torch.device("cpu"))


@pytest.mark.parametrize("m", [2, 4])
def test_embedding_head_and_losses_on_split_columns(m):
    V, B, L = 5 * m, 4, 6
    rng = np.random.default_rng(5)
    ys = torch.from_numpy(rng.integers(0, V, (B, L)))
    ys[0, :4] = torch.tensor([0, V // m - 1, V // m, V - 1])  # the shards' edges
    ys_out = ys.roll(1, 1)
    ylens = torch.tensor([L, 3, 5, 1])
    labels = torch.where(torch.from_numpy(rng.random((B, L)) < 0.4), ys_out, torch.full_like(ys_out, -100))
    labels[3] = -100  # a row with no label
    soft = torch.softmax(torch.from_numpy(rng.normal(size=(B, L, V)).astype(np.float32)), -1)

    def losses(model, shard):
        logits = model(ys)
        return [label_smoothing_loss(logits, ys_out, ylens, 0.1, shard=shard),
                label_smoothing_loss(logits, ys_out, ylens, 0.0, normalize_length=True, shard=shard),
                masked_lm_loss(logits, labels, shard=shard),
                *distill_loss(logits, ys_out, soft, ylens, 0.3, lsm_prob=0.1, shard=shard)]

    torch.manual_seed(0)
    whole = _Tiny(V)
    want = losses(whole, None)
    want_grads = [torch.autograd.grad(x, list(whole.parameters()), retain_graph=True) for x in want]
    sd = {k: v.clone() for k, v in whole.state_dict().items()}
    group = ThreadGroup(m)

    def rank(r):
        model = _Tiny(V)
        model.load_state_dict(sd)
        plan = prepare_model_(model, _fake_mesh(group, r, m))
        assert plan == {"embed.weight": 0, "output.weight": 0, "output.bias": 0}
        assert type(model.embed) is VocabParallelEmbedding and type(model.output) is VocabParallelHead
        got = losses(model, model.output.vocab_shard)
        return got, [torch.autograd.grad(x, list(model.parameters()), retain_graph=True) for x in got]

    res = group.run(rank)
    for i, w in enumerate(want):
        _same_bits([r[0][i] for r in res])
        _close(res[0][0][i], w, msg=f"loss {i}")
        for j, wg in enumerate(want_grads[i]):
            _close(torch.cat([r[1][i][j] for r in res]), wg, msg=f"loss {i} grad {j}")


CTC_KD = dict(encoder_type="transformer", decoder_type="ctc", feat_dim=20, enc_hidden_size=16, enc_num_layers=1,
              enc_num_attention_heads=2, enc_intermediate_size=32, vocab_size=36, mtl_inter_ctc_weight=0.3,
              inter_ctc_layer_id=1, kd_weight=0.4, inter_kd_weight=0.6, lsm_prob=0.1, kd_ctc_position="mid",
              kd_ctc_soft_label_weight=0.7, dropout_enc_rate=0.0, dropout_attn_rate=0.0)
RNNT_KD = dict(encoder_type="transformer", decoder_type="rnn_transducer", feat_dim=20, enc_hidden_size=16,
               enc_num_layers=1, enc_num_attention_heads=2, enc_intermediate_size=32, embedding_size=8,
               dec_hidden_size=12, dec_num_layers=1, joint_hidden_size=10, vocab_size=28, mtl_ctc_weight=0.3,
               dropout_dec_rate=0.0, dropout_emb_rate=0.0)


def _decoder_on_split_columns(make, m, run):
    """`run(decoder)` -> (loss dict, tensors to differentiate, inputs) on
    the whole decoder and on each of m threads' vocabulary-split copies:
    the loss terms bit-identical across the ranks and within 1e-6 of the
    whole decoder's, the gradients of the loss too (a split parameter's
    columns put side by side; an input's and a whole parameter's the
    same on every rank)."""
    torch.manual_seed(0)
    whole = make()
    sd = {k: v.clone() for k, v in whole.state_dict().items()}
    want, ins = run(whole)
    names = [n for n, _ in whole.named_parameters()]
    want_g = torch.autograd.grad(want["loss_total"], ins + list(whole.parameters()))
    group = ThreadGroup(m)

    def rank(r):
        dec = make()
        dec.load_state_dict(sd)
        plan = prepare_model_(dec, _fake_mesh(group, r, m))
        got, gins = run(dec)
        return plan, got, torch.autograd.grad(got["loss_total"], gins + list(dec.parameters()))

    res = group.run(rank)
    plan = res[0][0]
    assert plan and all(k.endswith(("embed.weight", "output.weight", "output.bias")) for k in plan)
    for k, w in want.items():
        _same_bits([r[1][k] for r in res])
        _close(res[0][1][k], w, msg=k)
    for i, w in enumerate(want_g):
        name = names[i - len(ins)] if i >= len(ins) else f"input {i}"
        got = torch.cat([r[2][i] for r in res], plan[name]) if name in plan else res[0][2][i]
        _close(got, w, msg=name)


def _soft(rng, *shape):
    return torch.softmax(torch.from_numpy(rng.normal(size=shape).astype(np.float32)), -1)


@pytest.mark.parametrize("m", [2, 4])
def test_ctc_alignment_distillation_on_split_columns(m):
    from emoasr_tpu_torch.config import config_from_dict
    from emoasr_tpu_torch.models.decoders.ctc import CTCDecoder

    rng = np.random.default_rng(7)
    B, T, U, V = 3, 14, 4, 36
    e, ei = (torch.from_numpy(x) for x in rng.normal(size=(2, B, T, 16)).astype(np.float32))
    elens, ylens = torch.tensor([14, 9, 6]), torch.tensor([4, 2, 1])
    ys = torch.from_numpy(rng.integers(1, V, (B, U)))
    ys[0] = torch.tensor([V // m - 1, V // m, V - 1, 1])
    soft = _soft(rng, B, U, V)

    def run(dec):
        xe, xi = _leaf(e), _leaf(ei)
        _, d, _ = dec(xe, elens, xi, ys, ylens, soft_labels=soft)
        assert {"loss_kd", "loss_inter_kd"} < set(d)
        return d, [xe, xi]

    _decoder_on_split_columns(lambda: CTCDecoder(config_from_dict(CTC_KD)), m, run)


@pytest.mark.parametrize("mode", ["full", "word", "align"])
@pytest.mark.parametrize("m", [2, 4])
def test_rnnt_full_joint_and_distillation_on_split_columns(m, mode):
    from emoasr_tpu_torch.config import config_from_dict
    from emoasr_tpu_torch.models.decoders.rnnt import RNNTDecoder

    conf = dict(RNNT_KD, rnnt_joint_mode="full") if mode == "full" else dict(RNNT_KD, kd_weight=0.3, kd_type=mode)
    rng = np.random.default_rng(8)
    B, T, U, V = 3, 9, 5, 28
    e = torch.from_numpy(rng.normal(size=(B, T, 16)).astype(np.float32))
    elens, ylens = torch.tensor([9, 6, 1]), torch.tensor([5, 3, 0])
    ys = torch.from_numpy(rng.integers(1, V, (B, U)))
    ys[0, :3] = torch.tensor([V // m - 1, V // m, V - 1])
    ys_in = torch.cat([torch.full((B, 1), 2), ys], 1)
    soft = _soft(rng, B, U, V)

    def run(dec):
        xe = _leaf(e)
        _, d, _ = dec(xe, elens, None, ys, ylens, ys_in, None, soft if mode != "full" else None)
        assert ("loss_kd" in d) == (mode != "full")
        return d, [xe]

    _decoder_on_split_columns(lambda: RNNTDecoder(config_from_dict(conf)), m, run)


@pytest.mark.parametrize("temp", [0.0, 1.0])
@pytest.mark.parametrize("m", [2, 4])
def test_sampling_from_split_logits_draws_what_the_whole_logits_draw(m, temp):
    from emoasr_tpu_torch.models.lm.lm import sample_categorical

    logits = torch.from_numpy(np.random.default_rng(9).normal(size=(4, 7, 6 * m)).astype(np.float32))
    logits[0, 0] = 1.0  # ties: the first column wins the argmax, on every side
    want = sample_categorical(logits, torch.Generator().manual_seed(3), temp)
    group, per = ThreadGroup(m), 6

    def rank(r):
        shard = VocabShard(group, r, m, per)
        return sample_categorical(logits[..., r * per:(r + 1) * per], torch.Generator().manual_seed(3), temp,
                                  shard=shard)

    res = group.run(rank)
    _same_bits(res)
    assert torch.equal(res[0], want) and (temp > 0 or int(want[0, 0]) == 0)


ATT = dict(encoder_type="conformer", decoder_type="transformer", pos_encode_type="rel", feat_dim=20,
           enc_hidden_size=16, enc_num_layers=1, enc_num_attention_heads=2, enc_intermediate_size=32,
           dec_hidden_size=16, dec_num_layers=1, dec_num_attention_heads=2, dec_intermediate_size=32,
           vocab_size=38, mtl_ctc_weight=0.3, lsm_prob=0.1, dropout_enc_rate=0.0, dropout_attn_rate=0.0,
           dropout_dec_rate=0.0, spec_augment=False)


def test_a_split_step_holds_no_whole_vocabulary_tensor():
    """A training step of a vocabulary-split attention model (Conformer,
    Transformer decoder, aux CTC) on two emulated ranks: no tensor that
    autograd keeps for the backward, and no parameter, has a dimension of
    the whole vocabulary's 38 (the rank's 19, and the batch's own sizes,
    only); the (B, U + 1, V) logits never exist on a rank."""
    from emoasr_tpu_torch.config import config_from_dict
    from emoasr_tpu_torch.models.asr import ASR

    rng = np.random.default_rng(10)
    B, T, U, V = 2, 40, 5, 38
    xs = torch.from_numpy(rng.normal(size=(B, T, 20)).astype(np.float32))
    ys = torch.from_numpy(rng.integers(3, V, (B, U)))
    ys_in = torch.cat([torch.full((B, 1), 2), ys], 1)
    ys_out = torch.cat([ys, torch.full((B, 1), 2)], 1)
    lens = (torch.tensor([T, T - 7]), torch.tensor([U, U - 2]))
    torch.manual_seed(0)
    sd = ASR(config_from_dict(ATT)).state_dict()
    group = ThreadGroup(2)

    def rank(r):
        model = ASR(config_from_dict(ATT))
        model.load_state_dict(sd)
        prepare_model_(model, _fake_mesh(group, r, 2))
        shapes = []

        def pack(t):
            shapes.append(tuple(t.shape))
            return t

        with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
            loss, _ = model(xs, lens[0], ys, lens[1], ys_in, ys_out)
        loss.backward()
        return shapes, [tuple(p.shape) for p in model.parameters()]

    for shapes, params in group.run(rank):
        assert shapes and not any(V in s for s in shapes + params)
        assert any(V // 2 in s for s in shapes) and any(s[:1] == (V // 2,) for s in params)


def test_a_vocabulary_that_does_not_divide_stays_whole():
    assert tp_plan(_Tiny(10), 4) == {}
    assert tp_plan(_Tiny(10), 2) == {"embed.weight": 0, "output.weight": 0, "output.bias": 0}


# ---------------------------------------------------------------------------- rank processes over gloo
#
# RNN-T (K7's plain path with the offset), LAS and the RNN LM on (1, 2) over
# gloo, each rank process holding half of every vocabulary table and head:
# against the port's one process and the JAX step on one device, at the
# tolerances of tests/test_torch_parallel.py (port: loss terms rtol 1e-5,
# gradients 1e-5 of each tensor's largest entry, parameters after the
# update atol 1e-6; JAX: losses rtol 2e-4, gradients 1e-4 (or the one
# process's own distance from JAX, `_grads_close_or_as_one`), and for the
# RNN LM the parameters atol 2e-5 rtol 2e-4).
# The RNN-T run writes `model.ep1` on the mesh, which the JAX eval CLI's
# importer loads with the mesh's eval loss.

import os  # noqa: E402
from concurrent.futures import ThreadPoolExecutor  # noqa: E402
from functools import partial  # noqa: E402

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from emoasr_tpu.eval.test_asr import _import_lm_params, load_asr_variables  # noqa: E402
from emoasr_tpu.models.asr import ASR as JaxASR  # noqa: E402
from emoasr_tpu.models.lm.lm import LM as JaxLM  # noqa: E402
from emoasr_tpu.train.optim import build_optimizer as jax_build_optimizer  # noqa: E402
from emoasr_tpu.train.step import init_train_state  # noqa: E402
from emoasr_tpu.train.train_lm import make_lm_train_step as jax_make_lm_train_step  # noqa: E402
from emoasr_tpu_torch.config import config_from_dict  # noqa: E402
from emoasr_tpu_torch.parallel import ranks  # noqa: E402
from emoasr_tpu_torch.utils.flax_import import asr_state_dict, lm_state_dict  # noqa: E402
from test_torch_parallel import (  # noqa: E402
    LAS,
    RNN_LM,
    RNNT,
    _asr_batch,
    _Deterministic,
    _grads_close,
    _jax_asr_steps,
    _jax_config,
    _jax_variables,
    _losses_close,
    _port_init,
    _sd_close,
    _torch,
)

OFF = dict(spec_augment=False, dropout_enc_rate=0.0, dropout_attn_rate=0.0, dropout_dec_rate=0.0,
           dropout_emb_rate=0.0)
ASR_CONFS = {"rnnt": dict(RNNT, **OFF), "las": dict(LAS, **OFF)}
SPLIT = {"rnnt": ("decoder.embed.weight", "decoder.output.weight", "decoder.ctc.output.weight"),
         "las": ("decoder.embed.weight", "decoder.output.weight", "decoder.ctc.output.bias"),
         "rnn_lm": ("lm.embed.weight", "lm.output.weight", "lm.output.bias")}


def _lm_batch(seed, V=30, B=8, L=10):
    rng = np.random.default_rng(seed)
    ylens = rng.integers(4, L + 1, B).astype(np.int64)
    ys = rng.integers(3, V, (B, L)).astype(np.int64)
    labels = np.where(np.arange(L)[None] < ylens[:, None] - 1, np.roll(ys, -1, 1), -100)
    return dict(ys_in=ys, ylens=ylens, labels=labels)


def _jax_lm_steps(conf, sd, batches):
    jcfg = _jax_config(conf)
    jlm = JaxLM(jcfg)
    params = {"lm": _import_lm_params({k: v.numpy() for k, v in sd.items()}, jcfg)}
    tx = jax_build_optimizer(jcfg, 100, use_adamw=True)
    state = init_train_state(params, {}, tx)
    step = jax_make_lm_train_step(_Deterministic(jlm), jcfg, tx, 100)
    losses = []
    for i, b in enumerate(batches):
        state, m = step(state, {k: jnp.asarray(v) for k, v in b.items()}, jax.random.PRNGKey(i))
        losses.append(float(m["loss_total"]))
    return losses, jax.device_get(state.params)


@pytest.fixture(scope="module")
def mesh_runs(tmp_path_factory):
    work = tmp_path_factory.mktemp("vocab_ranks")
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        asr = {}
        for name, conf in ASR_CONFS.items():
            batches = [_asr_batch(conf["vocab_size"], F=20, T=40, U=6, seed=20 + s) for s in range(2)]
            asr[name] = dict(conf=conf, np=batches, batches=[_torch(b) for b in batches], state_dict=_port_init(conf))
        lm_np = [_lm_batch(s) for s in range(2)]
        lm = dict(conf=RNN_LM, batches=[_torch(b) for b in lm_np], state_dict=_port_init(RNN_LM, lm=True), lm=True,
                  num_total_steps=100)
        save = str(work / "ckpt")
        tp = dict(mesh_shape=(1, 2), mesh_axes=("data", "model"), device="cpu", program="train_steps")
        rnnt_job = {k: v for k, v in asr["rnnt"].items() if k != "np"}
        las_job = {k: v for k, v in asr["las"].items() if k != "np"}
        launch = ranks.Launch(2, str(work / "two"), [
            dict(tp, **rnnt_job, eval_batch=asr["rnnt"]["batches"][0], save_dir=save), dict(tp, **las_job),
            dict(tp, **lm)])
        with ThreadPoolExecutor(2) as pool:
            futures = {name: pool.submit(_jax_asr_steps, _jax_config(a["conf"]), JaxASR(_jax_config(a["conf"])),
                                         _jax_variables(a["state_dict"], _jax_config(a["conf"])), a["np"])
                       for name, a in asr.items()}
            futures["rnn_lm"] = pool.submit(_jax_lm_steps, RNN_LM, lm["state_dict"], lm_np)
            jax_res = {k: f.result() for k, f in futures.items()}
        one = {"rnnt": ranks.train_steps(None, **rnnt_job, eval_batch=asr["rnnt"]["batches"][0], device="cpu"),
               "las": ranks.train_steps(None, **las_job, device="cpu"),
               "rnn_lm": ranks.train_steps(None, **lm, device="cpu")}
        two = [dict(zip(["rnnt", "las", "rnn_lm"], r)) for r in launch.wait()]
        yield dict(asr=asr, save=save, jax=jax_res, one=one, two=two)
    finally:
        torch.set_num_threads(threads)


def _grads_close_or_as_one(got, one, jax_grads, tol=1e-4):
    """`got` within `tol` of each JAX tensor's largest entry, or, where the
    port's one process is itself farther from JAX than that, within the one
    process's distance plus 1e-5: the split adds nothing to it.  (Under
    train-mode BatchNorm the Conformer's depthwise-convolution weight
    gradient of the RNN-T tree is 2.4e-4 of its largest entry from JAX's in
    one process already.)"""
    assert set(got) == set(jax_grads)
    for k, ref in jax_grads.items():
        ref = np.asarray(ref, np.float32)
        scale = np.abs(ref).max()
        own = np.abs(np.asarray(one[k], np.float32) - ref).max()
        np.testing.assert_allclose(np.asarray(got[k], np.float32), ref, rtol=0,
                                   atol=max(tol * scale, own) + 1e-5 * scale + 1e-6, err_msg=k)


def _assert_split(res, name):
    """Both ranks hold half of each vocabulary table and head, no more."""
    for r in range(2):
        shapes = res["two"][r][name]["shapes"]
        for k in SPLIT[name]:
            assert shapes[k][0] * 2 == res["one"][name]["shapes"][k][0], (r, k)


@pytest.mark.parametrize("name", ["rnnt", "las"])
def test_split_vocabulary_asr_steps_match_one_process_and_jax(mesh_runs, name):
    got, one, jone = mesh_runs["two"][0][name], mesh_runs["one"][name], mesh_runs["jax"][name]
    cfg = config_from_dict(mesh_runs["asr"][name]["conf"])
    _assert_split(mesh_runs, name)
    assert {"loss_ctc"} < set(one["metrics"][0]) and len(got["params"]) == 1 and got["skipped"] == 0
    _losses_close(got["metrics"], one["metrics"], 1e-5)
    _losses_close(got["metrics"], jone["metrics"], 2e-4)
    _grads_close(got["grads"], one["grads"], 1e-5)
    _grads_close_or_as_one(got["grads"], one["grads"], asr_state_dict(jone["grads"], cfg))
    np.testing.assert_allclose(got["grad_norm"], one["grad_norm"], rtol=1e-5)
    _sd_close(got["params"][0], one["params"][0], 1e-6, inert=True)
    # the combined values every rank runs on: the same bits, so the same update
    for k, v in mesh_runs["two"][1][name]["params"][0].items():
        assert torch.equal(v, got["params"][0][k]), k
    assert [m["loss_total"] for m in mesh_runs["two"][1][name]["metrics"]] == [m["loss_total"] for m in got["metrics"]]


def test_split_vocabulary_rnn_lm_step_matches_one_process_and_jax(mesh_runs):
    got, one = mesh_runs["two"][0]["rnn_lm"], mesh_runs["one"]["rnn_lm"]
    jlosses, jparams = mesh_runs["jax"]["rnn_lm"]
    _assert_split(mesh_runs, "rnn_lm")
    np.testing.assert_allclose([m["loss_total"] for m in got["metrics"]], jlosses, rtol=2e-4)
    _losses_close(got["metrics"], one["metrics"], 1e-5)
    _grads_close(got["grads"], one["grads"], 1e-5)
    _sd_close(got["params"][-1], one["params"][-1], 1e-6)
    want = {"lm." + k: v for k, v in lm_state_dict(jparams, config_from_dict(RNN_LM)).items()}
    _sd_close(got["params"][-1], want, 2e-5, 2e-4)


def test_split_vocabulary_checkpoint_loads_into_jax(mesh_runs):
    """The RNN-T (1, 2) run's `model.ep1`, gathered from the split tables
    and heads: the JAX eval CLI's importer loads it with the mesh's eval
    loss, and it reads back onto the mesh (weights and moments)."""
    got = mesh_runs["two"][0]["rnnt"]
    assert got["roundtrip"] == 0.0 and mesh_runs["two"][1]["rnnt"]["roundtrip"] == 0.0
    path = os.path.join(mesh_runs["save"], "model.ep1")
    conf = mesh_runs["asr"]["rnnt"]["conf"]
    jcfg = _jax_config(conf)
    b = {k: jnp.asarray(v) for k, v in mesh_runs["asr"]["rnnt"]["np"][0].items()}
    jloss, _ = jax.jit(partial(JaxASR(jcfg).apply, deterministic=True))(
        load_asr_variables(path, jcfg), b["xs"], b["xlens"], b["ys"], b["ylens"], b["ys_in"], b["ys_out"])
    np.testing.assert_allclose(got["eval_loss"]["loss_total"], mesh_runs["one"]["rnnt"]["eval_loss"]["loss_total"],
                               rtol=1e-5)
    np.testing.assert_allclose(float(jloss), got["eval_loss"]["loss_total"], rtol=2e-4)
