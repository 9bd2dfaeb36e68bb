"""Decoding cells: the eval CLI's `decode_dataset` with the decode function
of `build_decode_fn` (the configuration's `beam_width`; 0 is greedy), pass
after pass over a seeded pool, for a fixed window.

Set-up: the pool, the model built as the eval CLI builds it
(`ASR(cfg)` with the benchmark's weights), the decode function, one pass
over one batch of every bucket shape.  The window runs whole passes until
`seconds` have passed and rates every utterance decoded in them.  After
it, a sample of the decoded utterances drawn from the seed (the longest
among them, some hundreds of served tokens) is judged against the plain
reference: the reference's
logits, the program's hypothesis aligned to them by CTC's best path
(Viterbi) and, at each frame of that path, how far the hypothesis' token
lies below the reference's best logit; the widest gap is compared."""

from __future__ import annotations

import importlib
import statistics
import time
from typing import Dict, List

import numpy as np
import torch

from harness import stats, traffic, weights
from harness.common import Check, Result, Run, device_info, free_device, program_config, seeds
from harness.trace import Profiler

TRACE_LEAD_S = 1.0
TRACE_S = 11.0  # a traced run profiles this long after its first second, then ends


def run(r: Run):
    from emoasr_tpu_torch.data.asr_dataset import ASRDataset
    from emoasr_tpu_torch.eval.decode import build_decode_fn
    from emoasr_tpu_torch.eval.test_asr import decode_dataset
    from emoasr_tpu_torch.models.asr import ASR
    from emoasr_tpu_torch.utils.device import set_matmul_precision
    from emoasr_tpu_torch.utils.vocab import Vocab

    res = Result()
    mix = r.cell.traffic
    raw0 = r.cell.config["config"]
    buckets = [tuple(b) for b in raw0["buckets"]]
    pool = traffic.make_pool(mix, raw0["vocab_size"], buckets, r.seed, raw0["feat_dim"])
    manifest = traffic.write_pool(pool, r.seed, raw0["vocab_size"], r.work_dir)
    res.notes["pool"] = {"utterances": len(pool.utt_ids), "audio_s": float(pool.seconds.sum()),
                         "skipped_share": pool.skipped_share}
    vocab_path = manifest.replace("pool.tsv", "vocab.txt")
    cfg, raw = program_config(r, {"train_path": "", "dev_path": "", "test_path": manifest, "vocab_path": vocab_path})
    harness = r.cell.config["harness"]
    set_matmul_precision(cfg.compute_dtype)
    model = ASR(cfg)
    shapes = [(n, tuple(p.shape)) for n, p in model.named_parameters()]
    wseed = seeds(r)["weights"]

    def init_weights():
        return weights.make_weights(shapes, wseed, r.device, cfg.blank_id, float(harness.get("blank_bias", 0.0)))

    model = model.to(r.device)
    weights.load_into(model, init_weights())
    decode_fn = build_decode_fn(model, cfg, beam_width=cfg.beam_width, device=r.device)
    vocab = Vocab(vocab_path)
    dataset = ASRDataset(cfg, manifest, phase="test")

    # one batch of every bucket shape, through the same function
    warm = _one_per_bucket(dataset)
    decode_dataset(cfg, warm, decode_fn, vocab)
    if r.device.type == "cuda":
        torch.cuda.synchronize(r.device)
        torch.cuda.reset_peak_memory_stats(r.device)
    setup_s = time.perf_counter() - r.t0

    secs = dict(zip(pool.utt_ids, pool.seconds))
    rows: Dict[str, str] = {}
    audio, attempted, passes = 0.0, 0, 0
    prof, trace, traced_batches, counts0 = None, None, [], None
    k4 = importlib.import_module("emoasr_tpu_torch.ops.attention").KERNEL
    pass_times = []
    pass_batches = [list(idxs) for _, idxs in dataset.make_batcher().batches]  # decode_dataset's grouping
    t_start = t_prev = time.perf_counter()
    while True:
        if r.trace and prof is None and trace is None and t_prev - t_start >= TRACE_LEAD_S:
            prof, counts0 = Profiler(), dict(k4.counts)
            prof.start()
            t_trace = time.perf_counter()
        t1 = time.perf_counter()
        out = _planted(r.fault, decode_dataset(cfg, dataset, decode_fn, vocab))
        t2 = time.perf_counter()
        if prof is not None:
            prof.span("decode_pass", t1, t2)
        pass_times.append(t2 - t_prev)
        t_prev = t2
        passes += 1
        for row in out:
            rows[row[0]] = row[1]
            audio += secs[row[0]]
        attempted += len(out)
        if prof is not None:
            traced_batches.extend(pass_batches)
            if t2 - t_trace >= TRACE_S:
                trace, prof = prof.stop(), None
                res.notes["launches"] = {"k4": {l: c - counts0[l] for l, c in k4.counts.items()}}
        if trace is not None or (not r.trace and t2 - t_start >= r.seconds):
            break
    if prof is not None:
        trace = prof.stop()
        res.notes["launches"] = {"k4": {l: c - counts0[l] for l, c in k4.counts.items()}}
    if r.device.type == "cuda":
        torch.cuda.synchronize(r.device)
    window = time.perf_counter() - t_start
    res.attempted = attempted
    res.failed = sum(1 for u in pool.utt_ids if u not in rows)
    res.device = device_info(r)
    res.metrics = {
        "decode_audio_s_per_s": {"value": stats.rate(audio, window), "unit": "audio_s/s"},
        "setup_s": {"value": setup_s, "unit": "s"},
    }
    res.notes["window"] = {"seconds": window, "passes": passes, "utterances": attempted, "audio_s": audio,
                           "pass_median_s": statistics.median(pass_times)}
    ctx = {"phase": "decode", "cfg": raw, "trace": trace, "decoded_batches": traced_batches, "pool": pool,
           "launches": res.notes.get("launches", {}), "train": False}

    del model, decode_fn
    free_device(r.device)
    t_ref = time.perf_counter()
    sample = _sample(r, pool, harness, rows)
    gap, tokens = _judge(r, raw, pool, sample, rows, init_weights)
    res.notes["reference_s"] = time.perf_counter() - t_ref
    res.notes["check"] = {"sampled": len(sample), "tokens": tokens}
    res.checks = [Check("logit_gap", gap, r.cell.config["limits"]["decode"]["logit_gap"])]
    return res, ctx


def _one_per_bucket(dataset):
    """A view of `dataset` whose batches are one of each bucket shape."""
    batcher = dataset.make_batcher()
    picked, seen = [], set()
    for bi, idxs in batcher.batches:
        if bi not in seen:
            seen.add(bi)
            picked.append((bi, idxs))

    class One:
        def batches(self):
            for bi, idxs in picked:
                b = batcher.buckets[bi]
                yield dataset.collate(idxs, b.max_xlen, b.max_ylen, pad_to_batch=b.batch_size)

    return One()


def _sample(r: Run, pool, harness: dict, rows: Dict[str, str]) -> List[int]:
    """The decoded utterances that the check judges: the longest, then others
    in an order drawn from the seed, until they hold `check_tokens` served
    tokens or `check_utterances` utterances (a seed's weights may emit few)."""
    rng = np.random.default_rng(np.random.SeedSequence([int(r.seed), 3]))
    longest = int(np.argmax(pool.frames))
    order = [longest] + [int(i) for i in rng.permutation(len(pool.utt_ids)) if i != longest]
    out, tokens = [], 0
    for i in order[: int(harness["check_utterances"])]:
        out.append(i)
        tokens += len(rows.get(pool.utt_ids[i], "").split())
        if tokens >= int(harness["check_tokens"]):
            break
    return out


def _planted(fault, rows):
    if fault is None:
        return rows
    if fault == "token":  # the middle token of every hypothesis replaced where it is produced
        rows = [list(x) for x in rows]
        for row in rows:
            ids = row[1].split()
            if ids:
                ids[len(ids) // 2] = str(3 + (int(ids[len(ids) // 2]) - 2) % 997)
            row[1] = " ".join(ids)
        return rows
    raise ValueError(f"no fault {fault!r} in decoding")


@torch.no_grad()
def _judge(r: Run, raw: dict, pool, sample: List[int], rows: Dict[str, str], init_weights):
    """(widest gap, tokens judged) of the sample's hypotheses under the
    reference's logits; a missing or unalignable hypothesis reads inf."""
    from reference import common

    common.no_tf32()
    rm = importlib.import_module("reference." + r.cell.config["harness"]["reference"])
    ref_cfg = dict(raw)
    model = rm.Model(ref_cfg).to(r.device).eval()
    weights.load_into(model, init_weights())
    buckets = sorted(tuple(b) for b in raw["buckets"])
    worst, tokens = 0.0, 0
    for i in sample:
        uid = pool.utt_ids[i]
        if uid not in rows:
            return float("inf"), tokens
        x = traffic.load_features(pool, r.work_dir, i)
        T = next(t for t, _ in buckets if len(x) <= t)
        xs = torch.zeros((1, T, raw["feat_dim"]), device=r.device)
        xs[0, : len(x)] = torch.from_numpy(x).to(r.device)
        logits, elens = model.logits(xs, torch.tensor([len(x)], device=r.device))
        hyp = [int(t) for t in rows[uid].split()]
        tokens += len(hyp)
        worst = max(worst, best_path_gap(logits[0, : int(elens[0])].double(), hyp, raw["blank_id"], raw["eos_id"]))
    del model
    free_device(r.device)
    return worst, tokens


def best_path_gap(logits: torch.Tensor, hyp: List[int], blank: int, eos: int) -> float:
    """The CTC path that collapses to `hyp` with the highest logit sum
    (Viterbi over blank-interleaved labels), and on it the widest gap
    max_v logit(t, v) - logit(t, path_t); inf where no path collapses to
    `hyp` in these frames.  The eval CLI drops <eos> from a collapsed
    greedy path, so a frame of <eos> serves as a blank does: a blank
    state takes the larger of the two logits."""
    T = logits.shape[0]
    ext = [blank]
    for y in hyp:
        ext += [y, blank]
    S = len(ext)
    if T == 0 or (hyp and T < len(hyp) + sum(1 for a, b in zip(hyp, hyp[1:]) if a == b)):
        return float("inf")
    dev = logits.device
    e = torch.tensor(ext, device=dev)
    emit = logits[:, e]  # (T, S)
    is_blank = e == blank
    emit = torch.where(is_blank[None], torch.maximum(logits[:, blank], logits[:, eos])[:, None], emit)
    skip = torch.zeros(S, dtype=torch.bool, device=dev)
    if S > 2:
        skip[2:] = (e[2:] != blank) & (e[2:] != e[:-2])
    neg = torch.tensor(float("-inf"), dtype=logits.dtype, device=dev)
    score = torch.full((S,), float("-inf"), dtype=logits.dtype, device=dev)
    score[0] = emit[0, 0]
    if S > 1:
        score[1] = emit[0, 1]
    back = torch.zeros((T, S), dtype=torch.int64, device=dev)
    idx = torch.arange(S, device=dev)
    for t in range(1, T):
        s1 = torch.cat([neg[None], score])[:S]
        s2 = torch.where(skip, torch.cat([neg[None].expand(2), score])[:S], neg)
        cand = torch.stack([score, s1, s2])
        best, arg = cand.max(dim=0)
        back[t] = idx - arg
        score = best + emit[t]
    ends = [S - 1, S - 2] if S > 1 else [0]
    end = max(ends, key=lambda s: float(score[s]))
    if not torch.isfinite(score[end]):
        return float("inf")
    back = back.cpu()
    path = [end]
    for t in range(T - 1, 0, -1):
        path.append(int(back[t, path[-1]]))
    path.reverse()
    chosen = emit[torch.arange(T, device=dev), torch.tensor(path, device=dev)]
    return float((logits.max(dim=1).values - chosen).max())
