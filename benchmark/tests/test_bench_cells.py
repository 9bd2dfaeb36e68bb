"""Each cell's run at a size the CPU holds (depth 2, width 32, a 50-token
vocabulary, short buckets, 40 utterances), skipping only the look for a
chip: the program against the plain reference comes out correct; with the
control (bfloat16) or a fault planted under the timed path it does not."""

import copy
import time

import pytest
import torch

from harness import driver, spec

TRAIN = ["l1_train.libri960", "l4_train.libri960"]
DECODE = ["l1_greedy.test_clean"]


def tiny(name: str) -> spec.Cell:
    cell = spec.load_cell(name)
    c = copy.deepcopy(cell.config)
    c["config"].update(enc_num_layers=2, enc_hidden_size=32, enc_intermediate_size=64, vocab_size=50,
                       buckets=[[160, 40], [120, 30], [80, 24]], max_xlens_batch=480, max_ylens_batch=200,
                       batch_size=4, feat_dim=16, num_warmup_steps=10, max_mask_freq=4, max_mask_time=8)
    if "joint_hidden_size" in c["config"]:
        c["config"].update(joint_hidden_size=24, dec_hidden_size=24, embedding_size=16)
    c["harness"].update(check_utterances=40, check_tokens=10 ** 6, blank_bias=1.0)  # every utterance of the tiny pool
    if "decode" in c["limits"]:
        # set at this size as at the cell's: sound runs read 0.0, the bfloat16 control 0.013-0.023
        c["limits"]["decode"]["logit_gap"] = 0.005
    cell.config = c
    t = copy.deepcopy(cell.traffic)
    t.update(pool_utterances=40, frames_per_s=10, tokens_per_s={"50": 1.0})
    cell.traffic = t
    return cell


def run(name, tmp_path, **kw):
    line = driver.run_cell(tiny(name), 2 ** 31 + 977, 1.0, False, torch.device("cpu"), str(tmp_path),
                           time.perf_counter(), updates=2, **kw)
    assert line is not None
    return line


@pytest.mark.parametrize("name", TRAIN + DECODE)
def test_cell_is_correct(name, tmp_path):
    line = run(name, tmp_path)
    assert line["correct"], line["checks"]
    assert line["attempted"] > 0 and line["failed"] == 0
    assert set(line["metrics"]) == {m["name"] for m in spec.load_cell(name).end_to_end}
    assert list(line)[-1] == "checks"


@pytest.mark.parametrize("name", TRAIN + DECODE)
def test_control_in_bfloat16_is_not_correct(name, tmp_path):
    assert not run(name, tmp_path, dtype="bfloat16")["correct"]


@pytest.mark.parametrize("name,fault", [(n, f) for n in TRAIN for f in ("unchanged", "half_batch", "token")]
                         + [(n, "token") for n in DECODE])
def test_planted_fault_is_not_correct(name, fault, tmp_path):
    assert not run(name, tmp_path, fault=fault)["correct"]


@pytest.mark.chip
def test_attention_keep_mask_is_the_kernels(cuda):
    from emoasr_tpu_torch.ops.attention import dropout_keep_mask
    from reference.common import attention_keep_mask

    for seed, (B, H, T) in [(12345, (2, 4, 37)), (2 ** 61 + 99, (3, 2, 130))]:
        ref = attention_keep_mask(seed, B, H, T, 0.1, cuda)
        assert torch.equal(ref, dropout_keep_mask(B, T, H, 0.1, seed, cuda))
