"""The traffic generator: deterministic per seed, the same sizes for every
seed, fitted to the published totals."""

import numpy as np
import pytest

from harness import spec, traffic

MIXES = {"libri960": 12.3, "test_clean": 7.4}
BUCKETS = [(1600, 128), (1200, 112), (800, 96), (400, 64), (200, 48)]


def _mix(name):
    return spec.load_json(spec.all_names("traffic")[name])


@pytest.mark.parametrize("name", sorted(MIXES))
def test_durations_fit_the_published_mean(name):
    mix = dict(_mix(name))
    mix.pop("durations")
    mix["durations"] = dict(_mix(name)["durations"])
    mix["durations"].pop("cap_s", None)  # the cap comes after the fit
    mix["pool_utterances"] = 20000
    d = traffic.draw_durations(mix)
    assert d.mean() == pytest.approx(MIXES[name], rel=0.03)
    assert d.min() >= mix["durations"]["min_s"] and d.max() <= mix["durations"]["max_s"]


@pytest.mark.parametrize("name", sorted(MIXES))
def test_pool_is_deterministic_per_seed_and_sizes_shared(name):
    mix = _mix(name)
    a = traffic.make_pool(mix, 1000, BUCKETS, 2 ** 31 + 11, 80)
    b = traffic.make_pool(mix, 1000, BUCKETS, 2 ** 31 + 11, 80)
    c = traffic.make_pool(mix, 1000, BUCKETS, 7, 80)
    assert np.array_equal(a.frames, b.frames) and all(np.array_equal(x, y) for x, y in zip(a.labels, b.labels))
    assert not np.array_equal(a.frames, c.frames)  # another order
    assert sorted(a.frames.tolist()) == sorted(c.frames.tolist())  # the same set of sizes
    assert a.frames.max() <= 1600
    assert all(1 <= len(y) <= 128 for y in a.labels)


def test_test_clean_is_capped_and_nothing_skipped():
    pool = traffic.make_pool(_mix("test_clean"), 10000, BUCKETS, 5, 80)
    assert pool.skipped_share == 0.0
    assert pool.frames.max() == 1600


def test_train_skips_what_no_bucket_holds():
    pool = traffic.make_pool(_mix("libri960"), 10000, BUCKETS, 5, 80)
    assert 0.0 < pool.skipped_share < 0.2
    assert len(pool.utt_ids) == round(320 * (1 - pool.skipped_share))


def test_written_pool_reads_back(tmp_path):
    mix = dict(_mix("test_clean"))
    mix.update(pool_utterances=5, tokens_per_s={"50": 3.0})
    pool = traffic.make_pool(mix, 50, BUCKETS, 3, 8)
    manifest = traffic.write_pool(pool, 3, 50, str(tmp_path))
    lines = open(manifest).read().splitlines()
    assert lines[0].split("\t") == ["feat_path", "utt_id", "token_id", "text", "xlen", "ylen"]
    x = traffic.load_features(pool, str(tmp_path), 2)
    assert x.shape == (pool.frames[2], 8) and x.dtype == np.float32
    assert traffic.load_features(pool, str(tmp_path), 2).tobytes() == x.tobytes()
    vocab = open(tmp_path / "vocab.txt", encoding="utf-8").read().splitlines()
    assert vocab[3] == "▁w3 3" and len(vocab) == 50
