"""Training cells: the inner loop of `emoasr_tpu_torch/train/loop.py::train`
driven from a seeded pool, epoch after epoch, for a fixed window.

Set-up: the pool, `build_train_state` (the trainers' own set-up) with the
benchmark's weights copied in, `ASRDataset` over the pool, one
`prefetch_to_device` over the epochs' batches (each epoch's
`BucketBatcher` shuffled with seed + epoch, as the train CLI does), the
step of `make_train_step`.  The first `updates * accum_grad` micro-steps
of that feed are the check's: their losses, the gradient that Adam takes
in the first update (read from its first moment) and each parameter's
change after them are kept.  Then one micro-step of every bucket shape
that the check did not meet, and the window: micro-step after micro-step
until `seconds` have passed.  Each micro-step ends in the step's own
read-back of its gradient's finiteness; a micro-step's wall time runs
from the end of the one before to its own end (the Adam launches queued
after an update's read-back land in the next one's), the last one up to a
final synchronisation.  After the window the program's state is freed and
the plain reference follows the check's micro-steps from the same
weights, batches and random streams."""

from __future__ import annotations

import itertools
import statistics
import time
from dataclasses import dataclass
from typing import Dict, List

import numpy as np
import torch

from harness import stats, traffic, weights
from harness.common import Check, Result, Run, device_info, free_device, program_config, relative_gap, seeds
from harness.trace import Profiler

TRACE_LEAD_S = 1.0  # the traced stretch starts this far into the window
TRACE_S = 11.0  # a traced run profiles this long after its first second, then ends
MOVING = 1e-3  # a leaf moves when its reference gradient is at least this share of the median leaf's


@dataclass
class Fed:
    """One batch as the feed gave it: pool indices and the bucket."""

    index: np.ndarray
    T: int
    U: int


def _bucket(buckets, frames: int, tokens: int):
    for T, U in sorted(buckets):
        if frames <= T and tokens <= U:
            return T, U
    raise ValueError("no bucket holds the utterance")


def run(r: Run) -> Result:
    from emoasr_tpu_torch.data.asr_dataset import ASRDataset
    from emoasr_tpu_torch.train.loop import build_train_state, prefetch_to_device
    from emoasr_tpu_torch.train.step import make_train_step

    res = Result()
    mix = r.cell.traffic
    raw0 = r.cell.config["config"]
    buckets = [tuple(b) for b in raw0["buckets"]]
    marks = {"start": time.perf_counter() - r.t0}
    pool = traffic.make_pool(mix, raw0["vocab_size"], buckets, r.seed, raw0["feat_dim"])
    manifest = traffic.write_pool(pool, r.seed, raw0["vocab_size"], r.work_dir)
    marks["pool"] = time.perf_counter() - r.t0
    res.notes["pool"] = {"utterances": len(pool.utt_ids), "audio_s": float(pool.seconds.sum()),
                         "skipped_share": pool.skipped_share}
    cfg, raw = program_config(r, {"train_path": manifest, "dev_path": "", "test_path": "",
                                  "vocab_path": manifest.replace("pool.tsv", "vocab.txt")})
    harness = r.cell.config["harness"]
    accum = int(cfg.accum_grad)
    updates = int(r.updates or harness["check_updates"])
    n_check = updates * accum

    state, sa_gen = build_train_state(cfg, r.device)
    model = state.model
    shapes = [(n, tuple(p.shape)) for n, p in model.named_parameters()]
    wseed = seeds(r)["weights"]

    def init_weights():
        return weights.make_weights(shapes, wseed, r.device, cfg.blank_id, float(harness.get("blank_bias", 0.0)))

    weights.load_into(model, init_weights())
    marks["state"] = time.perf_counter() - r.t0
    torch.manual_seed(cfg.seed)  # PyTorch's dropout stream, which the reference draws again
    step = make_train_step(cfg)
    if r.fault:
        step = _planted(r.fault, step, state, cfg)
    dataset = ASRDataset(cfg, manifest, phase="train")
    fed: List[Fed] = []

    def host_batches():
        for epoch in itertools.count():
            for batch in dataset.batches(dataset.make_batcher(seed=cfg.seed + epoch)):
                idx = np.array([int(u[1:]) for u in batch["utt_ids"]])
                fed.append(Fed(idx, *_bucket(buckets, int(pool.frames[idx].max()),
                                             max(len(pool.labels[i]) for i in idx))))
                yield batch

    feed = prefetch_to_device(host_batches(), r.device)
    params = dict(model.named_parameters())
    tracing = {"prof": None}
    adam = state.optimizer.step

    def timed_adam(*a, **k):  # the update's host span, for the trace
        t = time.perf_counter()
        out = adam(*a, **k)
        if tracing["prof"] is not None:
            tracing["prof"].span("adam.step", t, time.perf_counter())
        return out

    state.optimizer.step = timed_adam

    # ---- the check's micro-steps (the first of the feed)
    losses, first_moment = [], {}
    for i in range(n_check):
        m = step(state, next(feed), sa_gen)
        losses.append(float(m["loss_total"]))
        if not m["grad_finite"]:
            res.sound = False
            res.problems.append(f"check micro-step {i + 1}: gradient not finite")
        if i + 1 == accum:
            first_moment = {n: float((state.optimizer.state[p]["exp_avg"] / 0.1).norm())
                            for n, p in params.items() if "exp_avg" in state.optimizer.state.get(p, {})}
    marks["check"] = time.perf_counter() - r.t0
    w0 = init_weights()
    change = {n: float((p.detach() - w0[n]).norm()) for n, p in params.items()}
    del w0

    # ---- one micro-step of every bucket shape the check did not meet
    seen = {(f.T, f.U) for f in fed[:n_check]}
    batcher = dataset.make_batcher(seed=cfg.seed)
    extra = []
    for bi, idxs in batcher.batches:
        b = batcher.buckets[bi]
        if (b.max_xlen, b.max_ylen) not in seen:
            seen.add((b.max_xlen, b.max_ylen))
            extra.append(dataset.collate(idxs, b.max_xlen, b.max_ylen, pad_to_batch=b.batch_size))
    for batch in prefetch_to_device(iter(extra), r.device):
        step(state, batch, sa_gen)
    if r.device.type == "cuda":
        torch.cuda.synchronize(r.device)
        torch.cuda.reset_peak_memory_stats(r.device)
    setup_s = time.perf_counter() - r.t0
    res.notes["setup_marks_s"] = {**marks, "warm": setup_s, "warm_steps": len(extra)}

    # ---- the window
    times, waits, audio, attempted, failed = [], [], 0.0, 0, 0
    prof, trace, traced, counts0 = None, None, [], None
    k_counts = _kernel_counters()
    n = n_check
    t_start = t_prev = time.perf_counter()
    while True:
        if r.trace and prof is None and trace is None and t_prev - t_start >= TRACE_LEAD_S:
            prof = tracing["prof"] = Profiler()
            counts0 = {k: dict(v.counts) for k, v in k_counts.items()}
            prof.start()
            trace_first, t_trace = len(times), time.perf_counter()
        t0 = time.perf_counter()
        batch = next(feed)
        t1 = time.perf_counter()
        m = step(state, batch, sa_gen)
        t2 = time.perf_counter()
        if prof is not None:
            prof.span("next_batch", t0, t1)
            prof.span("train_step", t1, t2)
        waits.append(t1 - t0)
        times.append(t2 - t_prev)
        t_prev = t2
        f = fed[n]
        n += 1
        attempted += 1
        failed += 0 if m["grad_finite"] else 1
        audio += float(pool.frames[f.index].sum()) / pool.frames_per_s
        if prof is not None and t2 - t_trace >= TRACE_S:
            trace = prof.stop()
            traced = fed[n_check + trace_first:n]
            res.notes["launches"] = {k: {l: c - counts0[k][l] for l, c in v.counts.items()}
                                     for k, v in k_counts.items()}
            prof = tracing["prof"] = None
        if trace is not None or (not r.trace and t2 - t_start >= r.seconds):
            break
    if prof is not None:
        trace = prof.stop()
        tracing["prof"] = None
        traced = fed[n_check + trace_first:n]
        res.notes["launches"] = {k: {l: c - counts0[k][l] for l, c in v.counts.items()} for k, v in k_counts.items()}
    if r.device.type == "cuda":
        torch.cuda.synchronize(r.device)
    t_end = time.perf_counter()
    times[-1] += t_end - t_prev
    window = t_end - t_start
    res.attempted, res.failed = attempted, failed
    res.device = device_info(r)
    res.metrics = {
        "train_audio_s_per_s": {"value": stats.rate(audio, window), "unit": "audio_s/s"},
        "train_step_p90_ms": {"value": 1e3 * stats.percentile(times, 90), "unit": "ms"},
        "setup_s": {"value": setup_s, "unit": "s"},
    }
    res.notes["window"] = {"seconds": window, "micro_steps": attempted, "step_median_ms": 1e3 * statistics.median(times),
                           "input_wait_mean_ms": 1e3 * statistics.mean(waits), "audio_s": audio}
    ctx = {"phase": "train", "cfg": raw, "trace": trace, "steps": traced, "pool": pool, "waits": waits,
           "launches": res.notes.get("launches", {}), "train": True}

    feed.close()
    del state, model, params, step, feed, sa_gen, m, batch
    free_device(r.device)

    # ---- the reference follows the check's micro-steps
    t_ref = time.perf_counter()
    ref = _reference(r, raw, pool, fed[:n_check], init_weights, updates)
    res.notes["reference_s"] = time.perf_counter() - t_ref
    _compare(res, r, losses, first_moment, change, ref, init_weights)
    return res, ctx


def _kernel_counters() -> Dict[str, object]:
    from emoasr_tpu_torch.ops import attention, ctc_head, rnnt_joint

    return {"k4": attention.KERNEL, "k1": ctc_head.KERNEL, "k7": rnnt_joint.KERNEL}


def ref_batches(raw: dict, pool, fed: List[Fed], work_dir: str, device) -> List[dict]:
    """The check's batches as the reference builds them from the raw
    feature files: zero-padded to the bucket's frames, labels padded with
    eos to its tokens."""
    out = []
    for f in fed:
        xs = np.zeros((len(f.index), f.T, raw["feat_dim"]), np.float32)
        ys = np.full((len(f.index), f.U), raw["eos_id"], np.int64)
        for b, i in enumerate(f.index):
            x = traffic.load_features(pool, work_dir, int(i))
            xs[b, : len(x)] = x
            ys[b, : len(pool.labels[i])] = pool.labels[i]
        out.append({
            "xs": torch.from_numpy(xs).to(device),
            "xlens": torch.from_numpy(pool.frames[f.index].astype(np.int64)).to(device),
            "ys": torch.from_numpy(ys).to(device),
            "ylens": torch.tensor([len(pool.labels[i]) for i in f.index], dtype=torch.int64, device=device),
        })
    return out


def _reference(r: Run, raw: dict, pool, fed: List[Fed], init_weights, updates: int) -> dict:
    from reference import common
    import importlib

    common.no_tf32()
    rm = importlib.import_module("reference." + r.cell.config["harness"]["reference"])
    ref_cfg = dict(raw)
    ref_cfg["compute_dtype"] = "float32"
    model = rm.Model(ref_cfg).to(r.device)
    w = init_weights()
    names = {n for n, _ in model.named_parameters()}
    if names != set(w):
        raise KeyError(f"reference and program parameters differ: {sorted(names ^ set(w))[:6]}")
    weights.load_into(model, w)
    batches = ref_batches(raw, pool, fed, r.work_dir, r.device)
    s = int(r.seed)
    out = common.train_reference(model, rm.train_loss, batches, ref_cfg,
                                 {"dropout": s, "specaug": s, "attention": s}, updates)
    out["first_grad"] = {n: float(g.norm()) for n, g in out["first_grad"].items()}
    out["change"] = {n: float((p - w[n]).norm()) for n, p in out["params"].items()}
    del out["params"], model, batches, w
    free_device(r.device)
    return out


def _compare(res: Result, r: Run, losses, first_moment, change, ref, init_weights) -> None:
    limits = r.cell.config["limits"]["train"]
    loss_gap = max(relative_gap(a, b, 1e-30) for a, b in zip(losses, ref["losses"]))
    g_ref = ref["first_grad"]
    med_g = statistics.median(g_ref.values())
    grad_gap = max(relative_gap(first_moment.get(n, 0.0), g, med_g) for n, g in g_ref.items())
    moving = [n for n, g in g_ref.items() if g >= MOVING * med_g]
    med_c = statistics.median(ref["change"][n] for n in moving)
    change_gap = max(relative_gap(change[n], ref["change"][n], med_c) for n in moving)
    worst_g = max(g_ref, key=lambda n: relative_gap(first_moment.get(n, 0.0), g_ref[n], med_g))
    worst_c = max(moving, key=lambda n: relative_gap(change[n], ref["change"][n], med_c))
    res.notes["check"] = {"losses": losses, "ref_losses": ref["losses"], "leaves": len(g_ref),
                          "leaves_left_out": len(g_ref) - len(moving),
                          "worst_grad_leaf": [worst_g, first_moment.get(worst_g, 0.0), g_ref[worst_g], med_g],
                          "worst_change_leaf": [worst_c, change[worst_c], ref["change"][worst_c], med_c]}
    res.checks = [Check("loss_gap", loss_gap, limits["loss_gap"]),
                  Check("grad_gap", grad_gap, limits["grad_gap"]),
                  Check("change_gap", change_gap, limits["change_gap"])]


def _planted(fault: str, step, state, cfg):
    """The step with a fault planted underneath (controls and tests)."""
    if fault == "unchanged":
        state.optimizer.step = lambda *a, **k: None
        return step
    if fault == "half_batch":
        def half(s, batch, gen=None):
            n = batch["xs"].shape[0] // 2
            return step(s, {k: v[:n] for k, v in batch.items()}, gen)
        return half
    if fault == "token":
        def token(s, batch, gen=None):
            batch = dict(batch)
            ys = batch["ys"].clone()
            ys[0, 0] = 3 + (ys[0, 0] - 2) % (cfg.vocab_size - 3)
            batch["ys"] = ys
            if "ys_in" in batch:
                ys_in = batch["ys_in"].clone()
                ys_in[0, 1] = ys[0, 0]
                batch["ys_in"] = ys_in
            return step(s, batch, gen)
        return token
    raise ValueError(f"no fault {fault!r} in training")
