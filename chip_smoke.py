#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (`emoasr_tpu_torch`) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases (any failed check raises, so the script exits non-zero):

1. Device: require CUDA, print the card's name and power limit, set the
   port's TF32 switch for float32 and say what it found.
2. Build: compile every CUDA kernel from `emoasr_tpu_torch/csrc/`, one nvcc
   per source, all at once (and K2's latency-floor variant); beside them
   the sources once more with `-Xptxas -v`, for each kernel's registers,
   spills, shared memory and count of tensor-core (HMMA / HGMMA)
   instructions.
3. Kernels against their plain PyTorch versions on the card, forward and
   backward, each with its stated tolerance (top-k exact, every case twice
   and bit-identical, at the main paths' shapes, ties, -inf rows, rows
   whose top entries crowd a few threads, and V = MAX_V; the CTC lattice
   also at S = 1025 and S = MAX_S; attention forward
   f32 1e-5, bf16 2e-2, with and without the score bias; attention backward,
   CTC head, CTC lattice, the decoder layer step, direct and indirect, the
   LM layer step, the RNN-T joint and the LSTM recurrence: see the
   constants beside their checks); the tensor-core kernels at the shapes
   their tiling makes risky, each launched twice with bit-identical
   outputs: the attention forward and backward in both dtypes at
   `k4_edge_cases` (T = 1 to 399, lens 0 and 1, D = 8, 40, 128; in f32
   also D = 1, 3, 20 and a q at a storage offset of one element), with no
   bias, an f32 and a bf16 bias, dropout 0, 0.1 and 0.3, the f32 and bf16
   dropout maps of one seed equal, and the CTC head over V in (37, 1000,
   10000, 10872) x H in (144, 256, 512, 600) in both dtypes; then the bf16
   parts: the CTC head in bf16 (H = 256, 512, 600) and in f32 at H = 512,
   the attention backward in bf16 with and without the bias (and the bf16
   launchers' own dropout bits), the RNN-T joint and the LSTM in bf16
   (one bf16 step of each entry, see `BF16_STEP`); the decoder layer step
   (direct and indirect) and the LM layer step in bf16; the RNN-T joint at
   J = 1024, 1500 and 2048 and the LSTM at H = 640 and 1024, in f32 and
   bf16.  Every LSTM case (T up to 256, B = 1 to 50) runs twice,
   bit-identical; the beam steps also at W = 17 and 33, and rows 0-15 of a
   W = 20 launch equal a W = 16 launch bit for bit, in both dtypes; K8 at
   the RNN LM's three bucket shapes (`LSTM_RNNLM_CASES`) and the RNN
   encoder's (`LSTM_RNN_ENCODER_CASES`), K3 at the LAS beam's classes.
   The vocabulary split (`check_vocab_shards`): K1 on each rank's half of
   L1's head (18, 399, 256) x (256, 5000 of 10000) with the path labels
   shifted (about half outside the block: xs exactly 0 there), forward and
   both gradients, twice bit-identical; K7's vocabulary-split launcher
   with the column offset at (18, 399, 129), J = 512, on ranks 0 and 1 of
   V = 1000, f32 and bf16, against its plain version (0 exactly where
   another rank owns the column), twice bit-identical, the two ranks
   combined against the whole launch; K7 without the offset bit-identical
   to the source before it (K7_WHOLE_SHA256).
4. Training at the full width of the L1 CTC(Transformer) model (12 x 256,
   4 heads, FF 2048, V = 10000, SpecAugment and dropout on,
   `enc_fused_attn: true`, random initial weights from `--seed`): one epoch
   of 13 micro-steps over the five L1 buckets through the port's train CLI
   with `--profile` (its trace of batches 8-12 names K1's, K2's and K4's
   kernels).
   Finite losses, no skipped step, the noam LR, changed weights, and the
   launch counts of every training kernel are checked; then one micro-step's
   loss and gradients on the card are held against the CPU's plain path,
   and one micro-step's phases are timed.
5. Learning on the card: a small corpus is overfitted through the train CLI
   and decoded by the eval CLI (WER < 15).
6. Decoding: a synthetic test corpus over the L1 buckets is decoded with the
   `model.ep1` the trainer wrote, through the port's eval CLI with
   `--beam_width 8`, then greedily; the launch counts prove that the path
   went through the kernels; one batch's encoder output on the card is held
   against the CPU's plain path.
7. The L2 CTC(Conformer) model at full width: two micro-steps (the smallest
   and the largest bucket) through the train CLI with `enc_fused_attn: true`,
   which sends the attention through the kernel with its score bias, forward
   and backward.
8. The L3-1 model (Conformer encoder 12 x 256, Transformer decoder 6 x 256,
   FF 2048, V = 10000, `enc_fused_attn: true`, weights from `--seed`): the
   decode corpus through the eval CLI with beam 10, joint CTC 0.3, once with
   `dec_step_mode: fused_indirect` and once with `fused`, then once more
   in `fused_indirect` with `--beam_width 17` (two row groups an
   utterance); launch counts of the top-k, attention and decoder-step
   kernels; the count of hypotheses
   force-finalized at their step budget (seed weights seldom emit eos); one
   batch on the card against the CPU's plain path (encoder output, one
   decoder step's logits, top-1 hypotheses); where one large batch's time
   goes.
9. The L3-3 model (L3-1's, `dec_step_mode: fused_indirect`, with the
   Transformer LM of `configs/lm/libri_transformer.yaml` fused at 0.5: 4 x
   512, 8 heads, FF 2048, V = 10000; both models' weights from `--seed`,
   written as `state_dict`s): the decode corpus through the eval CLI with
   the LM's layer step by K6 (`FUSED_INDIRECT_STEP = True`) and then by the
   dense route, then again in the other order; K6 launches = 4 x beam
   steps in the K6 runs and 0 in the others, the two routes' hypotheses
   agree on 95%; one batch on the card against the CPU (one step's fused
   scores, top-1 hypotheses); where one large batch's time goes without
   the LM and with either route, and the device's busy share of it; one
   CTC beam-8 decode of the L1 `model.ep1` with the LM in `cached` mode.
10. The L4 RNN-T(Conformer) model at full width (12 x 256 Conformer,
   embedding 128, 1 x 512 LSTM prediction network, joint 512, V = 1000,
   `rnnt_joint_mode: pallas`, `enc_fused_attn: true`, SpecAugment and
   dropout on, weights from `--seed`): one epoch of 10 micro-steps over the
   five L4 buckets through the train CLI, with K7 = K8 forward = K8
   backward launches = micro-steps; one micro-step against the CPU; where
   one largest-bucket micro-step's time goes; then the trainer's
   `model.ep1` through the eval CLI over the 40-utterance corpus, greedy and
   with the ALSD beam at width 10 (K8 launched no time: the prediction
   network steps one token at a time), and one batch's greedy and top-1
   beam hypotheses equal on the card and the CPU.
11. L1 trained with `compute_dtype: bfloat16` through the train CLI (5
   micro-steps, one per bucket): K1 and K4 through their bf16 launchers,
   float32 masters, Adam moments and checkpoint; one micro-step of the
   trainer's checkpoint in bf16 against float32 on the same batch (loss
   within 2 %, gradient cosine >= 0.99); the largest bucket's phases in
   bf16; a greedy bf16 decode of its `model.ep1` through the eval CLI.
12. The same for L4 (K4 with its bias, K7 and K8 through their bf16
   launchers).
13. bf16 beam decoding of the 40-utterance corpus at full width: L1 beam 8,
   L3-1 beam 10 with joint CTC 0.3 (`dec_step_mode: fused_indirect`, then
   `fused`: K5's bf16 launches = 6 x beam steps; then the dense `indirect`
   route) and L4 ALSD beam 10 through the eval CLI on bf16 copies of the
   earlier yamls and checkpoints; L3-3 through `build_decode_fn` +
   `decode_dataset` with the LM cast to bf16, its layer step by K6 (bf16
   launches = 4 x beam steps) and then by the dense route (0); top-1
   agreement with the float32 decodes and between the routes; one step of
   one L3-1 and one L3-3 batch on the card against the CPU's plain bf16
   path (within twice the CPU's own bf16-vs-f32 distance, plus one bf16
   step of the largest score).
14. L3-1 training (slice 3c): `configs/libri/l3_1_ctc_joint.yaml` at full
   width (label smoothing 0.1, aux CTC 0.3, SpecAugment and dropout on,
   `enc_fused_attn: true`; a copy with a warm-up of UPDATE_WARMUP steps, so
   that its one update shows) through the train CLI, 5 micro-steps up to
   the (18, 1600) bucket, each launching K1 and K2 once and K4 with its
   bias once a Conformer layer; one micro-step (loss_att, loss_ctc,
   loss_total, every gradient) against the CPU within STEP_TOL; one update
   of its `model.ep1` card against CPU (`updates_close`); its `model.ep1` through
   the eval CLI (beam 10, joint CTC 0.3, `fused_indirect`: K3, K4, K5);
   two bf16 micro-steps, one held against f32 (loss within 2 %, gradient
   cosine >= 0.99).
15. LM training (slice 6a): `configs/lm/libri_{rnn,transformer,bert}.yaml`
   at full width through `train_lm` over a sharded synthetic corpus that
   fills the (11, 256), (23, 128) and (46, 64) buckets (6 steps each); the
   RNN LM's steps launch K8 forward and backward in both layers (counted
   by shape); one RNN LM step against the CPU.
16. PPL: the PPL CLI on the three checkpoints, each equal to the CPU's on
   the same batches (PPL_RTOL; BERT's equal to `evaluate_ppl` on the card,
   which is held to the CPU's over the rows below the (11, 256) bucket);
   BERT's chunked pseudo-PPL at the (11, 256) bucket within PLL_PEAK_BYTES
   of device memory.
17. RNN-LM shallow fusion at 0.5: the L1 CTC beam 8 and the trained L3-1
   attention beam 10 through the eval CLI (`--lm_conf`, `--lm_path`), the
   L4 ALSD beam 10 in Python (an RNN LM over L4's 1000 tokens from the
   seed, token ALSD_LM_TOKEN's bias raised by GRID_LM_BIAS, on a copy of
   L4's checkpoint whose logit of that token is raised until it beats
   blank at every frame: no top-1 hypothesis empty); one short batch's
   top-1 hypotheses card against CPU each.
18. ELECTRA (slice 6b): `configs/lm/ted2_electra.yaml` at full width
   (generator and discriminator 12 x 256, V = 9798) through `train_lm`, 6
   steps over a sharded corpus that fills its three buckets, then
   `electra-disc` on error labels, 6 steps; one step of each against the
   CPU (ELECTRA's on one `generated` drawn on the card).  No kernel.
19. P-ELECTRA (`ted2_pelectra.yaml`) and the deletable PC-MLM
   (`del_pc_mlm.yaml`, TextAugment, Poisson mask insertion) at full width
   with `enc_fused_attn: true`, 4 steps each: every step launches K4
   forward and backward (dropout 0.1) once a phone-encoder layer; one step
   of each against the CPU; the PC-MLM's pseudo-PPL through the PPL CLI at
   the phone encoder's largest bucket (39, 512) within PLL_PEAK_BYTES, and
   against the CPU on three rows; one `pctc` step (K1, K2, K4).
20. Error correction (slice 7a): `configs/csj/asr_hie_phone.yaml` through
   the train CLI (2 micro-steps: K1 and K2 for the word and the phone
   head, K4), its phone hypotheses through `test_asr --decode_phone`, and
   `correct` with the PC-MLM checkpoint (mask_th 0.9, lm_weight 0.5) over
   20 utterances on the card and the CPU: the corrected TSVs equal row for
   row; the RTF.
21. N-best rescoring (slice 7a): the L1 beam-8 n-best through the
   rescoring CLI with the Transformer, BERT and ELECTRA LMs; `score_lm`
   against the CPU (SCORE_RTOL) and the same best hypotheses.
22. Soft labels (slice 7b): the trained libri Transformer LM (causal, every
   position) and BERT (a pre-masked row a position) over a distillation
   corpus of L1's buckets through `make_label make` (K3 once a chunk of 128
   rows, at (N, 10000) k = 8), each pickle held to the CPU's (KD_PROB_TOL;
   ids where the CPU's k / k + 1 gap exceeds the measured logit error),
   K3 exactly against its plain version on the chunks' logits, `make_label
   eval`; a seed Transformer LM at libri widths with V = 1000 labels L4's.
23. Distillation micro-steps through the train step (`ASRDataset(
   kd_label_path=...)`, dropout and SpecAugment on), copies of the shipped
   yamls with `kd_weight: 0.5`: L1 alignment KD (all, then mid; K2, K4;
   up to (18, 1600)), L3 soft labels with <eos> (K1, K2, K4 with its bias),
   L4 word and align KD over the full (18, 399, 129, 1000) joint (K8, K4;
   peak device memory under KD_PEAK_BYTES); one micro-step of each (L4's
   in both kd_types) against the CPU within STEP_TOL, `loss_kd` finite
   and nonzero.
24. RNN-T forced alignment of a batch through `ASR.forced_align` on the L4
   `model.ep1`, card against CPU: the walks equal wherever the CPU's
   margin exceeds the measured alpha + beta error.
25. `analysis ctc_prob` (card against CPU, ANALYSIS_PROB_TOL), the fusion
   grid (2 x 2) on L1's CTC beam 8 with the Transformer LM, each point's
   TSV equal to the eval CLI's and the best pair the lowest WER's, and
   `align_hyps` on the n-best.
26. LAS(Transformer) (slice 5; no shipped yaml builds it: the decoder keys
   the JAX package benchmarked, `tools/bench_decode.py:112-119`, on L1's
   encoder, `enc_fused_attn: true`): two micro-steps through the train CLI
   up to the (18, 1600) bucket (K4 with dropout, forward and backward), one
   against the CPU within STEP_TOL; the same widths overfitted on phase 5's
   labels (80-dim features) through the train CLI, then its checkpoint
   through the eval CLI greedily, with beam 4 and `len_weight` 1.0 (K3 on
   the (B, 4, 10000) pre-selection and the (B, 16) pool) and with phase
   15's libri Transformer LM at 0.5 (K6); at least half of the hypotheses
   end at <eos> before the 64-step cap; one batch of each mode card against
   CPU; width 1 equal to greedy on the card.
27. CTC(RNN) (slice 5): L1 with `encoder_type: rnn` (12 biLSTM layers of
   256, directions summed): two micro-steps through the train CLI (K8 at
   (46, 99, 256) and (18, 399, 256), 24 launches each way a micro-step, K1,
   K2), one against the CPU; the checkpoint over phase 6's corpus through
   the eval CLI, greedy and CTC beam 8 (K8 forward, K3); one short batch
   of each card against CPU.
28. The front end, prep and native paths (slice 8a): 40 synthetic wavs of
   1-16 s through the prep CLI (`wav_to_feats` on the card, `norm_feats`,
   `prep_tsv`, `sort_bylen`), each feature file within FBANK_TOL of the
   CPU's fbank; the manifest through the eval CLI with phase 5's model; the
   native WER equal to the Python path's, native-collated batches
   bit-equal to the `np.load` path's.
29. Data and tensor parallelism (slice 8b, `emoasr_tpu_torch/parallel/`),
   the L1 train CLI on a copy with a warm-up of UPDATE_WARMUP steps (one
   update, accum_grad 2, over two batches of the (18, 1600) bucket, dropout
   and SpecAugment on, then rank 0's greedy validation on phase 6's
   corpus): (a) `torchrun --standalone --nproc_per_node 1` (NCCL, a world
   of one) equal bit for bit to a plain `python -m` run (losses, LRs, dev
   WER, `model.ep1` but the conv2d subsampler's tensors, CUDNN_NONDET,
   held by `updates_close`); (b) `torchrun --nproc_per_node 2` over gloo on the
   one card (asked for by name), mesh `(2,)` (9 + 9 rows a rank): the
   logged losses (STEP_TOL), the LRs and the dev WER equal to the plain
   run's, its `model.ep1` held to it by `updates_close` (PAR_PARAM_TOL);
   the first micro-step through the rank programs (`parallel/ranks.py`):
   the loss (STEP_TOL) and the summed micro-gradient (PAR_GRAD_TOL)
   against one process on the card, each rank launching K1 and K2 once and
   K4 once a layer, and K4's keep mask of a rank's rows (and heads) equal
   to its block of the one-process mask (`dropout_keep_mask` with offsets;
   offsets (0, 0, H) draw the old bits); (c) the same on `(1, 2)`: 2 heads
   and FF 1024 a rank, rank 0 validating a gathered whole copy; (d) the
   eval CLI with `--dp` on two ranks (gloo) over phase 6's corpus with beam
   8: its rows against phase 6's TSV (at least HYP_SHARE equal) and one
   batch's encoder output split over the ranks against one process
   (PAR_ENC_TOL).  Then the vocabulary split (slice 8c), at the shipped
   configs' full width on `(1, 2)` over gloo through the rank programs,
   each against the same job on one rank (a world of one): one micro-step
   of L3-1 (label smoothing, the aux CTC: K1 on 5000 columns a rank;
   it writes `model.ep1` on the mesh, which a one-process port model loads
   with the one-rank run's eval loss) and of L4 (K7's split launcher once a
   rank), one step of the RNN LM and of BERT: the loss (STEP_TOL), the
   summed micro-gradient (PAR_GRAD_TOL), the same loss terms on both ranks,
   half of every vocabulary table and head a rank, and each rank's peak
   device memory beside the one-rank run's; and the eval CLI with
   `--profile` over phase 6's corpus (its trace names K3's and K4's
   kernels).
30. Every kernel timed at the largest bucket beside its plain version and
   one library call (for K5 and K6 the dense route), the bf16 launchers in
   bf16 (bounds at the bf16 rate, library calls in bf16; an f32 launcher
   that splits its operands into bf16 terms held to that many tensor-core
   products; K8 in both storage types as three or two), K4's forward also
   with dropout (training's), K7 at J = 1024 and K8 at H = 1024 beside the
   chunked route and cuDNN, K5 and K6 at W = 33, K3 at every shape class
   the beams launch (with its launches by class over the main paths) and
   K2 beside its latency floor (`tools/k2_parts.py`'s `chain_only`), K8
   at the RNN LM's three bucket shapes beside cuDNN, K4 at the phone
   encoder's largest bucket in both dtypes beside SDPA, K3 at make_label's
   class beside torch.topk (its own row), K8 at the RNN encoder's largest
   bucket beside cuDNN's one-direction `nn.LSTM(256, 256)`, K7's
   vocabulary-split launcher on a rank's 500 of L4's 1000 columns beside
   the chunked route on the same block (its own row), K1 at V = 5000; one
   JSON line describing each kernel, the `nvidia-smi` line, and last the
   `{"ok": true, "device": ...}` line.

Scratch files go to `build/chip_smoke/` and are removed at the end.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import shutil
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

REPO = os.path.dirname(os.path.abspath(__file__))
L1_CONF = os.path.join(REPO, "configs", "libri", "l1_ctc_transformer.yaml")
L2_CONF = os.path.join(REPO, "configs", "libri", "l2_ctc_conformer.yaml")
L3_1_CONF = os.path.join(REPO, "configs", "libri", "l3_1_ctc_joint.yaml")
L3_3_CONF = os.path.join(REPO, "configs", "libri", "l3_transformer_conformer.yaml")
LM_CONF = os.path.join(REPO, "configs", "lm", "libri_transformer.yaml")
L4_CONF = os.path.join(REPO, "configs", "libri", "l4_rnnt_conformer.yaml")

# published peaks of one H100 SXM (NVIDIA data sheet; dense, 700 W)
PEAK_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {torch.float32: 67e12, torch.bfloat16: 989e12}

ATTN_TOL = {torch.float32: 1e-5, torch.bfloat16: 2e-2}
ENC_TOL = 1e-3


class CheckFailed(RuntimeError):
    pass


def require(cond: bool, msg: str) -> None:
    if not cond:
        raise CheckFailed(msg)


def nvidia_smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


_HEAD_START = {}


def cuda_time_ms(fn, iters: int = 50, warmup: int = 5) -> float:
    """Mean time of one call on the device, by CUDA events around `iters`
    calls.  A matrix product of some 20 ms is queued first, so that the
    host is `iters` calls ahead when the card reaches the first event: the
    events then bracket the device's work, not the host's pace of issuing it
    (for a call of many small launches that outlasts the head start, the
    host's pace still shows)."""
    for _ in range(warmup):
        fn()
    dev = torch.cuda.current_device()
    if dev not in _HEAD_START:
        _HEAD_START[dev] = torch.randn(8192, 8192, device=f"cuda:{dev}")
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.mm(_HEAD_START[dev], _HEAD_START[dev])
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


# ---------------------------------------------------------------- kernels

# the kernels' sources with their defines (K5's source builds its indirect
# variant here, the main path's): their registers, spills and shared memory
# (`nvcc -Xptxas -v`) and their count of tensor-core instructions
# (`cuobjdump -sass`; none in K2 and K3) are reported in phase 2
RESOURCE_SOURCES = (("attention.cu", ()), ("ctc_head.cu", ()), ("rnnt_joint.cu", ()), ("lstm_scan.cu", ()),
                    ("decoder_step.cu", ("EMO_DECODER_STEP_INDIRECT=1",)), ("lm_step.cu", ()), ("topk.cu", ()),
                    ("ctc_lattice.cu", ()))


def start_resource_builds(out_dir: str) -> dict:
    """One `nvcc -Xptxas -v` per source of RESOURCE_SOURCES, started (not
    awaited) beside the kernels' own build."""
    from emoasr_tpu_torch.ops.cuda_lib import CSRC_DIR, NVCC_FLAGS, find_nvcc

    os.makedirs(out_dir, exist_ok=True)
    jobs = {}
    for src, defines in RESOURCE_SOURCES:
        lib = os.path.join(out_dir, src + ".so")
        cmd = [find_nvcc(), *NVCC_FLAGS, *(f"-D{d}" for d in defines), "-Xptxas", "-v", "-o", lib,
               os.path.join(CSRC_DIR, src)]
        jobs[src] = (subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True), lib)
    return jobs


def _template_args(mangled: str) -> list:
    """The template arguments (`f32`, `bf16`, `u32`, `u64`, integers, class
    names) of a mangled argument list `I...E`."""
    import re

    args, i = [], 1
    while i < len(mangled) and mangled[i] != "E":
        if mangled[i] in "fjm":
            args.append({"f": "f32", "j": "u32", "m": "u64"}[mangled[i]])
            i += 1
        elif mangled.startswith("13__nv_bfloat16", i):
            args.append("bf16")
            i += len("13__nv_bfloat16")
        elif mangled[i] == "L":  # a literal, L<type><value>E
            j = mangled.index("E", i)
            args.append(mangled[i + 2:j])
            i = j + 1
        elif mangled[i] == "N":  # a nested name, N<substitutions and <length><name>s>E: its last name
            i, name = i + 1, None
            while i < len(mangled) and mangled[i] != "E":
                m = re.match(r"S[0-9A-Z]*_|(\d+)", mangled[i:])
                if not m:
                    return args
                if m.group(1):
                    n = int(m.group(1))
                    name = mangled[i + m.end():i + m.end() + n]
                    i += m.end() + n
                else:
                    i += m.end()
            args.append(name)
            i += 1
        else:
            break
    return args


def _short_kernel_name(mangled: str) -> str:
    """`ctc_head_grad_e_kernel<bf16>`, `tc::bwd_dq_kernel<8>`,
    `rnnt_joint_kernel<f32, 64>`, ... from a mangled name."""
    end = mangled.find("_kernel") + len("_kernel")
    name = mangled[:40]
    for j in range(end - len("_kernel") - 1, 0, -1):  # the length-prefixed identifier ending there
        digits = len(mangled[:j]) - len(mangled[:j].rstrip("0123456789"))
        if digits and mangled[:j].endswith(str(end - j)):
            name = mangled[j:end]
            break
    name = ("tc::" if "2tc" in mangled else "") + name
    args = _template_args(mangled[end:]) if mangled[end:end + 1] == "I" else []
    return f"{name}<{', '.join(args)}>" if args else name


CALLEES = ("5dense", "16cached_attention", "15cross_attention")  # K5's and K6's device functions, not inlined


def _callee(mangled: str):
    """(name, template arguments) of a device function the kernels call
    (`CALLEES`), else None."""
    for c in CALLEES:
        i = mangled.find(c + "I")
        if i >= 0:
            return (c.lstrip("0123456789"), tuple(_template_args(mangled[i + len(c):])))
    return None


def _calls(kernel_args: list, callee_args: tuple) -> bool:
    """Whether a kernel of these template arguments calls the callee of
    these: the same element type (the last argument) and, where the callee
    has a row group (`dense<WP, E>`), the same one (the first)."""
    return (bool(kernel_args) and bool(callee_args) and kernel_args[-1] == callee_args[-1]
            and (len(callee_args) < 2 or callee_args[0] in ("0", "1") or kernel_args[0] == callee_args[0]))


def kernel_resources(jobs: dict) -> dict:
    """Registers, spill stores and loads (bytes), static shared memory and
    HMMA / HGMMA instructions of every kernel of the sources of `jobs`; a
    kernel's spills and HMMA include those of the device functions it calls
    that are not inlined (`CALLEES`, matched by `_calls`)."""
    import re

    from emoasr_tpu_torch.ops.cuda_lib import find_nvcc

    res = {}
    for src, (proc, lib) in jobs.items():
        log, _ = proc.communicate()
        require(proc.returncode == 0, f"nvcc -Xptxas -v {src} failed:\n{log[-3000:]}")
        cur, props, callees = None, None, {}
        for line in log.splitlines():
            m = re.search(r"Compiling entry function '(\S+)'", line)
            if m:
                cur = _short_kernel_name(m.group(1))
                res[cur] = {"source": src, "registers": 0, "spill_stores": 0, "spill_loads": 0, "smem": 0,
                            "mma_instructions": 0}
                continue
            m = re.search(r"Function properties for (\S+)", line)
            if m:
                props = _callee(m.group(1)) or cur
                continue
            m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
            if m and props is not None:
                entry = callees.setdefault(props, {"spill_stores": 0, "spill_loads": 0, "mma_instructions": 0}) \
                    if isinstance(props, tuple) else res[props]
                entry["spill_stores"], entry["spill_loads"] = int(m.group(1)), int(m.group(2))
            m = re.search(r"Used (\d+) registers", line)
            if m and cur is not None:
                res[cur]["registers"] = int(m.group(1))
                sm = re.search(r"(\d+) bytes smem", line)
                res[cur]["smem"] = int(sm.group(1)) if sm else 0
        cuobjdump = os.path.join(os.path.dirname(find_nvcc()), "cuobjdump")
        sass = subprocess.run([cuobjdump, "-sass", lib], capture_output=True, text=True, timeout=300).stdout
        cur = None
        for line in sass.splitlines():
            if "Function :" in line:
                mangled = line.split("Function :")[1].strip()
                cur = _callee(mangled) or _short_kernel_name(mangled)
                if isinstance(cur, tuple):
                    callees.setdefault(cur, {"spill_stores": 0, "spill_loads": 0, "mma_instructions": 0})
            elif re.search(r"\bH(G)?MMA\b", line):
                entry = callees.get(cur) if isinstance(cur, tuple) else res.get(cur)
                if entry is not None:
                    entry["mma_instructions"] += 1
        for (_, cargs), c in callees.items():  # into the kernels of this source that call them
            for name, r in res.items():
                args = name[name.find("<") + 1:-1].split(", ") if "<" in name else []
                if r["source"] == src and _calls(args, cargs):
                    for k in ("spill_stores", "spill_loads", "mma_instructions"):
                        r[k] += c[k]
    return res


def topk_cases(dev, gen):
    """(name, x, k) inputs: random rows, ties, rows of -inf, the main paths'
    shapes (the CTC beam's (B, V) k = 8, the attention pre-selection's
    (B, W, V) k = 15 at V = 10000 and CSJ's 10872, the ALSD expansion's
    (B, W, V - 1) k = 10, the W = 17 pool's (B, W^2) k = 17, the LAS
    beam's (B, 4, V) and (B, 16) k = 4, make_label's (N, V) logits k = 8
    at V = 10000 and 1000), rows whose top
    entries crowd the fewest threads (each thread's entries share one value
    band: the most entries pass the kernel's threshold), and V = MAX_V."""
    from emoasr_tpu_torch.ops.topk import MAX_V

    def randn(*shape, dtype=torch.float32):
        return torch.randn(*shape, generator=gen, device=dev).to(dtype)

    def log_probs(*shape, dtype=torch.float32):
        return torch.log_softmax(randn(*shape), -1).to(dtype)

    ties = torch.randint(-3, 3, (64, 10000), generator=gen, device=dev).float()
    inf = torch.full((6, 10000), float("-inf"), device=dev)
    inf[1, 7777] = 1.0
    inf[2, 5000:] = randn(5000)
    inf[3, ::97] = 0.5
    i = torch.arange(10000, device=dev, dtype=torch.float32)
    crowded = ((i % 1024) // 4 + i * 1e-6).expand(4, -1).contiguous()  # thread t of a block owns band t
    return [
        ("f32 (128,10000) k=8", randn(128, 10000), 8),
        ("f32 (7,1000) k=10", randn(7, 1000), 10),
        ("bf16 (3,10,10000) k=15", randn(3, 10, 10000, dtype=torch.bfloat16), 15),
        # the attention beam's pre-selection: (B, W, V) float32 scores, k = 1.5 W
        ("f32 (18,10,10000) k=15", torch.log_softmax(randn(18, 10, 10000), -1), 15),
        ("f32 (640,512) k=32", randn(640, 512), 32),
        ("f32 ties (64,10000) k=16", ties, 16),
        ("bf16 ties (64,10000) k=8", ties.to(torch.bfloat16), 8),
        ("f32 -inf rows (6,10000) k=12", inf, 12),
        ("f32 (18,10000) k=8", log_probs(18, 10000), 8),
        ("bf16 (18,10000) k=8", log_probs(18, 10000, dtype=torch.bfloat16), 8),
        ("f32 (18,10,10872) k=15", log_probs(18, 10, 10872), 15),
        ("f32 (18,10,999) k=10", log_probs(18, 10, 999), 10),
        ("bf16 (18,10,999) k=10", log_probs(18, 10, 999, dtype=torch.bfloat16), 10),
        ("f32 (18,289) k=17", randn(18, 289), 17),
        # the LAS beam: the (B, W, V) pre-selection and the (B, W W) pool at W = 4,
        # the pool of the first step all DEAD but its first W entries
        ("f32 (18,4,10000) k=4", log_probs(18, 4, 10000), 4),
        ("f32 (18,16) k=4", randn(18, 16), 4),
        ("f32 DEAD pool (18,16) k=4", torch.cat([randn(18, 4), torch.full((18, 12), -1e30, device=dev)], 1), 4),
        ("f32 crowded (4,10000) k=32", crowded, 32),
        ("f32 crowded (4,10000) k=1", crowded, 1),
        (f"f32 (3,{MAX_V}) k=32", randn(3, MAX_V), 32),
        (f"bf16 (2,{MAX_V}) k=15", randn(2, MAX_V, dtype=torch.bfloat16), 15),
        # make_label: (N, V) LM logits, N a chunk's labelled positions, k = 8
        ("f32 make_label (1423,10000) k=8", 3 * randn(1423, 10000), 8),
        ("f32 make_label (128,10000) k=8", 3 * randn(128, 10000), 8),
        ("f32 make_label (1390,1000) k=8", 3 * randn(1390, 1000), 8),
        ("f32 (1,256) k=32", randn(1, 256), 32),
        ("bf16 (5,257) k=1", randn(5, 257, dtype=torch.bfloat16), 1),
    ]


def check_topk(dev, gen) -> float:
    """Kernel == plain version, values and indices, on every case; each
    case launched twice, bit-identical."""
    from emoasr_tpu_torch.ops.topk import launch_geometry, topk_lastdim_kernel, topk_plain

    for name, x, k in topk_cases(dev, gen):
        v1, i1 = topk_lastdim_kernel(x, k)
        v2, i2 = topk_lastdim_kernel(x, k)
        v0, i0 = topk_plain(x, k)
        torch.cuda.synchronize()
        require(v1.dtype == x.dtype and i1.dtype == torch.int32, f"topk {name}: dtypes {v1.dtype} {i1.dtype}")
        require(torch.equal(i1, i0), f"topk {name}: indices differ from the plain version")
        require(torch.equal(v1, v0), f"topk {name}: values differ from the plain version")
        require(torch.equal(i1, i2) and torch.equal(v1, v2), f"topk {name}: two launches differ")
        geo = launch_geometry(x.numel() // x.shape[-1], x.shape[-1], k, x.dtype)
        print(f"  top-k {name}: exact, twice bit-identical ({geo['parts']} blocks a row, {geo['keys']} keys a thread)")
    return 0.0


def attention_cases(dev, gen):
    def qkv(B, T, H, D, dtype):
        return [torch.randn(B, T, H, D, generator=gen, device=dev).to(dtype) for _ in range(3)]

    lens32 = torch.randint(1, 400, (32,), generator=gen, device=dev)
    lens32[0], lens32[1], lens32[2] = 1, 399, 200
    out = []
    for dtype in (torch.float32, torch.bfloat16):
        out.append((f"{dtype} (32,399,4,64)", *qkv(32, 399, 4, 64, dtype), lens32))
        out.append((f"{dtype} (5,37,4,64)", *qkv(5, 37, 4, 64, dtype),
                    torch.tensor([37, 1, 0, 20, 36], device=dev)))
    out.append(("f32 (3,50,2,128)", *qkv(3, 50, 2, 128, torch.float32),
                torch.tensor([50, 17, 3], device=dev)))
    out.append(("f32 (2,70,3,40)", *qkv(2, 70, 3, 40, torch.float32),
                torch.tensor([70, 33], device=dev)))
    return out


def k4_edge_cases(dev, dtype=torch.bfloat16):
    """(name, (B, T, H, D), lens) where the launchers' tiles of 64 and
    16-byte rows are likely to break: T = 1, 17, 63, 64, 65, 399; lens 0 and
    1; D = 40 (zero-padded to 48) and 8; rows H D 2 bytes apart that are a
    multiple of 16 and not of 128 (16, 240, 400).  In float32 also D = 1, 3
    and 20 (rows that move by 4-byte copies) and a q at a storage offset of
    one element (`K4_OFFSET_CASE`, see `k4_edge_inputs`)."""
    t = lambda *x: torch.tensor(x, device=dev)
    cases = [
        ("T=1", (2, 1, 4, 64), t(1, 0)),
        ("T=17 H=3 D=40", (3, 17, 3, 40), t(17, 1, 0)),
        ("T=63", (2, 63, 4, 64), t(63, 1)),
        ("T=64 H=1 D=8", (2, 64, 1, 8), t(64, 33)),
        ("T=65 D=128", (2, 65, 2, 128), t(65, 64)),
        ("T=399", (3, 399, 4, 64), t(399, 0, 1)),
        ("T=399 H=5 D=40", (2, 399, 5, 40), t(399, 200)),
    ]
    if dtype == torch.float32:
        cases += [
            ("T=33 H=2 D=1", (2, 33, 2, 1), t(33, 5)),
            ("T=50 H=3 D=3", (2, 50, 3, 3), t(50, 0)),
            ("T=70 H=3 D=20", (2, 70, 3, 20), t(70, 33)),
            (K4_OFFSET_CASE, (2, 70, 3, 40), t(70, 33)),
        ]
    return cases


K4_OFFSET_CASE = "T=70 H=3 D=40, q at a storage offset of one element"


def k4_edge_inputs(name: str, shape: tuple, dtype, gen, dev, n: int = 3) -> list:
    """n standard normal tensors of `shape` in `dtype` (q, k, v, d_out);
    for `K4_OFFSET_CASE` the first (q) lies one element into its storage,
    so its rows have no 16-byte alignment."""
    xs = [torch.randn(*shape, generator=gen, device=dev).to(dtype) for _ in range(n)]
    if name == K4_OFFSET_CASE:
        buf = torch.empty(xs[0].numel() + 1, dtype=dtype, device=dev)
        buf[1:] = xs[0].reshape(-1)
        xs[0] = buf[1:].view(shape)
    return xs


def _twice(fn):
    """fn() run twice; the two results (a tensor or a tuple of them) must be
    bit-identical.  Returns the first."""
    a, b = fn(), fn()
    a_, b_ = (a, b) if isinstance(a, (tuple, list)) else ((a,), (b,))
    torch.cuda.synchronize()
    require(all(torch.equal(x, y) for x, y in zip(a_, b_)), "two launches on the same inputs differ")
    return a


def check_attention(dev, gen) -> dict:
    """Kernel against the plain version within the dtype's tolerance, and
    both dtypes' launchers at `k4_edge_cases`, launched twice
    (bit-identical); returns the largest error by dtype."""
    from emoasr_tpu_torch.ops.attention import attention_plain, fused_self_attention

    worst = {torch.float32: 0.0, torch.bfloat16: 0.0}
    for name, q, k, v, lens in attention_cases(dev, gen):
        scale = 1.0 / (q.shape[-1] ** 0.5)
        o1 = fused_self_attention(q, k, v, lens, scale=scale)
        o0 = attention_plain(q, k, v, lens, scale)
        torch.cuda.synchronize()
        require(o1.dtype == v.dtype and o1.shape == v.shape, f"attention {name}: {o1.dtype} {o1.shape}")
        err = (o1.float() - o0.float()).abs().max().item()
        tol = ATTN_TOL[v.dtype]
        require(err <= tol, f"attention {name}: max |kernel - plain| = {err} > {tol}")
        worst[v.dtype] = max(worst[v.dtype], err)
        print(f"  attention {name}: max abs err {err:.3e} (tol {tol})")
    for dtype in (torch.float32, torch.bfloat16):
        tol = ATTN_TOL[dtype]
        for name, (B, T, H, D), lens in k4_edge_cases(dev, dtype):
            q, k, v = k4_edge_inputs(name, (B, T, H, D), dtype, gen, dev)
            scale = 1.0 / D ** 0.5
            o1 = _twice(lambda: fused_self_attention(q, k, v, lens, scale=scale))
            err = _max_err(o1, attention_plain(q, k, v, lens, scale))
            require(o1.dtype == dtype and bool(torch.isfinite(o1).all()) and err <= tol,
                    f"attention {dtype} {name}: max |kernel - plain| = {err} > {tol}")
            require(not o1[lens == 0].any(), f"attention {dtype} {name}: rows of an utterance with lens 0 are not 0")
            worst[dtype] = max(worst[dtype], err)
            print(f"  attention {dtype} {name}: max abs err {err:.3e} (tol {tol}); two launches bit-identical")
    return {"attention_fwd": worst[torch.float32], "attention_fwd_bf16": worst[torch.bfloat16]}


# K3's shape classes on the main paths, (shape, k): the attention beam's
# pre-selection (B, W, V) k = 1.5 W (first: the `kernels` line's own row),
# the CTC beam's (B, V) k = 8, CSJ's vocabulary, the ALSD expansion's
# (B, W, V - 1) k = W, the W = 17 pool's (B, W^2) k = W and the W = 17
# pre-selection
TOPK_SHAPES = (((18, 10, 10000), 15), ((18, 10000), 8), ((18, 10, 10872), 15), ((18, 10, 999), 10),
               ((18, 289), 17), ((18, 17, 10000), 25), ((18, 4, 10000), 4), ((18, 16), 4))


def time_topk(dev, gen, shape: tuple, k: int, dtype=torch.float32) -> dict:
    """K3 over the last axis of log-probabilities of `shape` in `dtype`."""
    from emoasr_tpu_torch.ops.topk import topk_lastdim_kernel, topk_plain

    x = torch.log_softmax(torch.randn(*shape, generator=gen, device=dev), -1).to(dtype)
    esize, V = x.element_size(), shape[-1]
    rows = x.numel() // V
    bytes_moved = rows * V * esize + rows * k * (esize + 4)
    ops = rows * V  # one compare an entry: the least a selection does
    t_bytes, t_ops = bytes_moved / PEAK_BYTES_PER_S, ops / PEAK_FLOPS[torch.float32]
    return {
        "shape": f"({','.join(map(str, shape))}) k={k} {str(x.dtype).replace('torch.', '')}",
        "ms": cuda_time_ms(lambda: topk_lastdim_kernel(x, k)),
        "plain_ms": cuda_time_ms(lambda: topk_plain(x, k)),
        "library_ms": cuda_time_ms(lambda: torch.topk(x, k, dim=-1)),
        "bound_ms": max(t_bytes, t_ops) * 1e3,
        "bound_by": "bytes" if t_bytes >= t_ops else "operations",
    }


def time_attention(dev, gen, B: int, T: int, H: int, D: int, lens: torch.Tensor, dtype=torch.float32) -> dict:
    """K4's forward as decoding runs it (no dropout) and, beside it, as
    training does (dropout 0.1, `dropout_ms`), with the plain version and
    SDPA's call of each."""
    import torch.nn.functional as F

    from emoasr_tpu_torch.ops.attention import attention_plain, dropout_keep_mask, fused_self_attention

    q, k, v = (torch.randn(B, T, H, D, generator=gen, device=dev).to(dtype) for _ in range(3))
    scale = 1.0 / D ** 0.5
    qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))  # (B, H, T, D) views
    key_mask = (torch.arange(T, device=dev)[None, :] < lens[:, None])[:, None, None, :]
    mask = dropout_keep_mask(B, T, H, DROPOUT_RATE, 99, dev, dtype)
    row = {
        "shape": f"({B},{T},{H},{D}) {q.dtype}",
        "ms": cuda_time_ms(lambda: fused_self_attention(q, k, v, lens, scale=scale)),
        "plain_ms": cuda_time_ms(lambda: attention_plain(q, k, v, lens, scale)),
        "library_ms": cuda_time_ms(
            lambda: F.scaled_dot_product_attention(qt, kt, vt, attn_mask=key_mask, scale=scale)
        ),
        "dropout_ms": cuda_time_ms(lambda: fused_self_attention(q, k, v, lens, scale=scale, dropout_rate=DROPOUT_RATE,
                                                                deterministic=False, seed=99)),
        "plain_dropout_ms": cuda_time_ms(lambda: attention_plain(q, k, v, lens, scale, DROPOUT_RATE, dropout_mask=mask)),
        "library_dropout_ms": cuda_time_ms(
            lambda: F.scaled_dot_product_attention(qt, kt, vt, attn_mask=key_mask, dropout_p=DROPOUT_RATE, scale=scale)
        ),
    }
    # q, k, v read and the output written once, lens; Q K^T and P V over valid keys
    row.update(_bound(4 * B * T * H * D * q.element_size() + B * 4,
                      4.0 * H * T * D * int(lens.clamp(max=T).sum().item()), dtype, _split_products(dtype)))
    return row


def _split_products(dtype) -> int:
    """bf16 tensor-core products per f32 product of K4's f32 launchers (the
    leading cross products of TERMS bf16 terms a side), 0 in bf16."""
    from emoasr_tpu_torch.ops.attention import TERMS

    return TERMS * (TERMS + 1) // 2 if dtype == torch.float32 else 0


def _bound(bytes_moved: float, ops: float, dtype=torch.float32, split_products: int = 0) -> dict:
    """The least time of the work: bytes over the memory rate or operations
    over the peak of `dtype`, the larger.  A float32 kernel that splits its
    operands into bf16 terms runs `split_products` bf16 products on the
    tensor cores for each float32 one (K1, K4: 6, K7: 3): its operations take
    the lower of the CUDA cores' time and that many times the tensor cores'.
    `ops_at` says which peak the operations were held to."""
    t_bytes = bytes_moved / PEAK_BYTES_PER_S
    t_ops, at = ops / PEAK_FLOPS[dtype], "bf16 tensor cores" if dtype == torch.bfloat16 else "f32 CUDA cores"
    if split_products and split_products * ops / PEAK_FLOPS[torch.bfloat16] < t_ops:
        t_ops, at = split_products * ops / PEAK_FLOPS[torch.bfloat16], f"{split_products} bf16 products, tensor cores"
    return {"bound_ms": max(t_bytes, t_ops) * 1e3,
            "bound_by": "bytes" if t_bytes >= t_ops else "operations", "ops_at": at}


def _max_err(a: torch.Tensor, b: torch.Tensor) -> float:
    return (a.double() - b.double()).abs().max().item()


def _require_close(name: str, got: torch.Tensor, want: torch.Tensor, atol: float, rtol: float) -> float:
    """max |got - want| <= atol + rtol max |want|; returns the largest error."""
    require(got.shape == want.shape, f"{name}: shape {tuple(got.shape)} != {tuple(want.shape)}")
    require(bool(torch.isfinite(got).all()), f"{name}: non-finite values")
    err, tol = _max_err(got, want), atol + rtol * want.abs().max().item()
    require(err <= tol, f"{name}: max |kernel - plain| = {err} > {tol} (atol {atol} + rtol {rtol} of the largest)")
    return err


def _require_close_by_column(name: str, got: torch.Tensor, want: torch.Tensor, dim: int, atol: float,
                             rtol: float) -> tuple:
    """Every index v along `dim` on its own: max |got[v] - want[v]| <= atol +
    rtol max |want[v]|.  A gradient to the output layer has a few vocabulary
    columns (blank, eos, the labels) thousands of times larger than the rest:
    a tolerance scaled by the largest entry of the whole tensor would not see
    the rest at all.  Returns the largest error and the largest error as a
    share of its own column's largest entry."""
    require(got.shape == want.shape, f"{name}: shape {tuple(got.shape)} != {tuple(want.shape)}")
    require(bool(torch.isfinite(got).all()), f"{name}: non-finite values")
    other = [d for d in range(want.dim()) if d != dim % want.dim()]
    err = (got.double() - want.double()).abs().amax(other)
    scale = want.double().abs().amax(other)
    over = err - (atol + rtol * scale)
    v = int(over.argmax())
    require(over[v].item() <= 0, f"{name}: column {v}: max |kernel - plain| = {err[v].item()} > atol {atol} + "
            f"rtol {rtol} of the column's largest entry {scale[v].item()}")
    return err.max().item(), (err / scale.clamp_min(1e-30)).max().item()


def _require_close_by_group(name: str, got: torch.Tensor, want: torch.Tensor, groups: dict, atol: float,
                            rtol: float) -> float:
    """A vector over the vocabulary, held group by group (entries on a CTC
    path, entries on none): each group to atol + rtol of its own largest
    entry.  Single entries can cancel to nothing, so they carry no scale of
    their own.  Returns the largest error as a share of its group's scale."""
    worst = 0.0
    for gname, idx in groups.items():
        if idx.numel():
            _require_close(f"{name} ({gname})", got[idx], want[idx], atol, rtol)
            worst = max(worst, _max_err(got[idx], want[idx]) / max(want[idx].abs().max().item(), 1e-30))
    return worst


def _vocab_groups(V: int, on_path: torch.Tensor) -> dict:
    """Vocabulary entries that lie on some CTC path of the batch, and the rest."""
    is_path = torch.zeros(V, dtype=torch.bool, device=on_path.device)
    is_path[on_path.reshape(-1).long()] = True
    return {"path columns": is_path.nonzero()[:, 0], "other columns": (~is_path).nonzero()[:, 0]}


# K2: the CTC lattice, held against its plain version run in float64.  ll
# is a sum of up to T log-probabilities (magnitudes in the thousands): atol
# 1e-3 + rtol 1e-5 of the largest feasible |ll|.  The gradient is
# g exp(alpha + beta - ll): alpha, beta and ll are each rounded to f32 at a
# magnitude of about |ll|, so with |ll| near 1650 (T = 399) the exponent
# carries an error of some 1e-3 and so does the posterior: atol 1e-4 + rtol
# 3e-3 of the largest |gradient|.  (The plain version's autograd, a chain of
# local softmax derivatives, is some 20 times closer to float64.)
LATTICE_TOL = {"ll": (1e-3, 1e-5), "grad": (1e-4, 3e-3)}


def lattice_case(dev, gen, B: int, T: int, U: int, V: int):
    """Path emissions from random log-probabilities: ragged xlens, repeated
    labels, one utterance without labels and one without a feasible path."""
    from emoasr_tpu_torch.ops.ctc import _path_masks

    lp = torch.log_softmax(torch.randn(B, T, V, generator=gen, device=dev), -1)
    labels = torch.randint(1, V, (B, U), generator=gen, device=dev)
    labels[:, 1::3] = labels[:, 0::3][:, : labels[:, 1::3].shape[1]]  # repeats
    ylens = torch.randint(1, U + 1, (B,), generator=gen, device=dev)
    xlens = torch.randint(2 * U + 1, T + 1, (B,), generator=gen, device=dev) if T > 2 * U else \
        torch.full((B,), T, device=dev)
    xlens[0], ylens[0] = T, U
    ylens[1] = 0                      # no labels: blank all the way
    xlens[2], ylens[2] = max(U // 2, 1), U  # too short for its labels: infeasible
    z, allow2f, initf, finalf = _path_masks(labels, ylens, 0)
    lp_path = torch.gather(lp, 2, z[:, None, :].expand(-1, T, -1)).transpose(0, 1)
    return lp_path, allow2f, initf, finalf, xlens


def lattice_cases() -> tuple:
    """(name, (B, T, U, V)) of `check_ctc_lattice`: L1's largest bucket, two
    narrow lattices, one of several warps a chain and the widest the kernels
    take (S = MAX_S: 2 U + 1 states and one dead state after them)."""
    from emoasr_tpu_torch.ops.ctc_lattice import MAX_S

    U_max = (MAX_S - 1) // 2
    return (("(399,18,257)", (18, 399, 128, 64)), ("(50,5,21)", (5, 50, 10, 7)), ("(9,4,1)", (4, 9, 0, 5)),
            ("(1100,5,1025)", (5, 1100, 512, 64)), (f"({2 * U_max + 80},3,{MAX_S})", (3, 2 * U_max + 80, U_max, 64)))


def check_ctc_lattice(dev, gen) -> dict:
    from emoasr_tpu_torch.ops.common import LOG_0
    from emoasr_tpu_torch.ops.ctc_lattice import MAX_S, ctc_ll_from_path, ctc_ll_plain, launch_geometry

    worst = {"ll": 0.0, "grad": 0.0}
    for name, (B, T, U, V) in lattice_cases():
        lp_path, allow2f, initf, finalf, xlens = lattice_case(dev, gen, B, T, max(U, 1), V)
        if U == 0:  # S = 1: blank only
            lp_path, allow2f, initf, finalf = (x[..., :1].contiguous() for x in (lp_path, allow2f, initf, finalf))
            finalf.fill_(1.0)
        if 2 * U + 1 == MAX_S - 1:  # one dead state more: neither initial, final nor a skip target
            lp_path = torch.cat([lp_path, lp_path[..., -1:]], -1).transpose(0, 1).contiguous().transpose(0, 1)
            allow2f, initf, finalf = (torch.cat([m, torch.zeros_like(m[:, :1])], 1) for m in (allow2f, initf, finalf))
        g = torch.randn(B, generator=gen, device=dev)
        outs = []
        for fn, x in ((ctc_ll_from_path, lp_path), (ctc_ll_from_path, lp_path), (ctc_ll_plain, lp_path.clone()),
                      (ctc_ll_plain, lp_path.double())):
            x = x.detach().requires_grad_(True)
            ll = fn(x, allow2f, initf, finalf, xlens)
            (grad,) = torch.autograd.grad(ll, x, g.to(ll.dtype))
            outs.append((ll.detach(), grad))
        torch.cuda.synchronize()
        (ll1, g1), (ll2, g2), (ll32, g32), (ll0, g0) = outs
        require(torch.equal(ll1, ll2) and torch.equal(g1, g2), f"lattice {name}: two launches differ")
        ok = ll0 > LOG_0 / 2  # rows with a feasible alignment
        require(torch.equal(ok, ll1 > LOG_0 / 2), f"lattice {name}: feasible rows differ from the plain version's")
        if U > 0:
            require(not ok[2], f"lattice {name}: the infeasible row has ll {ll1[2].item()}")
            require(not g1[:, 2].any(), f"lattice {name}: gradient of the infeasible row is not exactly 0")
        past = torch.arange(T, device=dev)[:, None] >= xlens[None, :]
        require(not g1[past].any(), f"lattice {name}: gradient past xlens is not exactly 0")
        e_ll = _require_close(f"lattice {name} ll", ll1[ok], ll0[ok], *LATTICE_TOL["ll"])
        e_g = _require_close(f"lattice {name} grad", g1, g0, *LATTICE_TOL["grad"])
        worst = {"ll": max(worst["ll"], e_ll), "grad": max(worst["grad"], e_g)}
        geo = launch_geometry(lp_path.shape[2])
        print(f"  ctc lattice {name}: ll err {e_ll:.3e}, grad err {e_g:.3e} against the float64 plain version "
              f"(its float32 run: {_max_err(ll32[ok], ll0[ok]):.3e}, {_max_err(g32, g0):.3e}); twice bit-identical; "
              f"{int(ok.sum())} of {B} rows feasible; {geo['warps']} warps x {geo['spl']} states a thread")
    return worst


# K1: the fused head.  Sums of H = 256 products of O(1) values in another
# order than cuBLAS: lse, xs and d e within atol 1e-4 + rtol 1e-4 of the
# largest entry.  The gradients to w and the bias add up B T = 7182 rows, and
# their columns differ by orders of magnitude: with independent cotangents
# the path columns (blank at every even s, eos padding) reach thousands while
# the other ~9900 columns hold only the softmax term g_lse p, about 0.01.  So
# d w is held vocabulary column by column, each to rtol 1e-4 of its own
# largest entry + atol 1e-6, and d b in two groups (path columns, others).
# A second cotangent, g_lse = -sum_s g_xs, is what the CTC loss sends: there
# the two terms of d logits cancel in the sum over the vocabulary.
HEAD_TOL = (1e-4, 1e-4)
HEAD_COLUMN_TOL = (1e-6, 1e-4)


def head_case(dev, gen, B: int, T: int, H: int, V: int, U: int):
    from emoasr_tpu_torch.ops.ctc import _extend_with_blanks

    e = torch.randn(B, T, H, generator=gen, device=dev)
    weight = torch.randn(V, H, generator=gen, device=dev) / H ** 0.5  # a linear layer's (V, H)
    bias = 0.1 * torch.randn(V, generator=gen, device=dev)
    labels = torch.randint(1, V, (B, U), generator=gen, device=dev)
    labels[:, U // 2:] = 2  # eos padding: one label many times over
    labels[:, 1::4] = labels[:, 0::4][:, : labels[:, 1::4].shape[1]]
    z = _extend_with_blanks(labels, 0)
    elens = torch.randint(T // 2, T + 1, (B,), generator=gen, device=dev)
    elens[0] = T
    valid = (torch.arange(T, device=dev)[None, :] < elens[:, None]).float()
    g_lse = torch.randn(B, T, generator=gen, device=dev) * valid
    g_xs = torch.randn(B, T, z.shape[1], generator=gen, device=dev) * valid[:, :, None]
    return e, weight, bias, z, g_lse, g_xs, valid


# the widths the tensor-core tiling of K1 makes risky: V ragged against the
# 64-column tile (37, 10872) or not (1000, 10000); H below one chunk (144),
# one bf16 chunk (256), two (512), and ragged against both chunks (600)
HEAD_SWEEP_V = (37, 1000, 10000, 10872)
HEAD_SWEEP_H = (144, 256, 512, 600)


def check_head_case(dev, gen, name: str, shape: tuple, dtype, transposed: bool = True, block=None) -> dict:
    """K1 against `ctc_head_plain` at one shape (B, T, H, V, U) in `dtype`,
    both cotangents, w as a linear layer's `.t()` (`transposed`) or as a
    contiguous (H, V); the kernels run twice and must give bit-identical
    outputs.  `block=(r, m)`: rank r's V / m columns of a model axis of m,
    with the whole vocabulary's path labels shifted by the block's first
    column, as `fused_ctc_head_shard` launches it (a label outside the block
    selects nothing: its xs is exactly 0).  Largest errors by kernel."""
    from emoasr_tpu_torch.ops.ctc_head import ctc_head_plain, fused_ctc_head

    e, weight, bias, z, g_lse, g_xs, valid = head_case(dev, gen, *shape)
    e, weight, bias = e.to(dtype), weight.to(dtype), bias.to(dtype)
    V = shape[3]
    if block is not None:
        per = V // block[1]
        v0 = block[0] * per
        weight, bias, z, V = weight[v0:v0 + per], bias[v0:v0 + per], z - v0, per
    outside = (z < 0) | (z >= V)
    groups = _vocab_groups(V, z[~outside])
    worst = {"fwd": 0.0, "grad_e": 0.0, "grad_w": 0.0, "grad_w_rel": 0.0}
    col = 0 if transposed else 1
    for cot, g_lse_ in (("independent cotangents", g_lse), ("g_lse = -sum g_xs", -g_xs.sum(-1))):
        res = []
        for fn in (fused_ctc_head, fused_ctc_head, ctc_head_plain):
            e_, b_ = e.clone().requires_grad_(True), bias.clone().requires_grad_(True)
            w_ = (weight.clone() if transposed else weight.t().contiguous()).requires_grad_(True)
            lse, xs = fn(e_, w_.t() if transposed else w_, b_, z)
            grads = torch.autograd.grad((lse, xs), (e_, w_, b_), (g_lse_, g_xs))
            res.append((lse.detach(), xs.detach(), *grads))
        torch.cuda.synchronize()
        tag = f"ctc head {name}, {cot},"
        require(all(torch.equal(a, c) for a, c in zip(res[0], res[1])),
                f"{tag} two launches on the same inputs differ")
        require(res[0][0].dtype == res[0][1].dtype == torch.float32, f"{tag} lse / xs are not float32")
        require(not res[0][1].masked_select(outside[:, None, :].expand_as(res[0][1])).any(),
                f"{tag} xs of a label outside the columns is not exactly 0")
        fwd = [_require_close(f"{tag} {what}", a, c, *HEAD_TOL) for what, a, c in zip(("lse", "xs"), res[0], res[2])]
        if dtype == torch.float32:
            e_e = _require_close(f"{tag} d e", res[0][2], res[2][2], *HEAD_TOL)
            e_w, rel_w = _require_close_by_column(f"{tag} d w", res[0][3], res[2][3], col, *HEAD_COLUMN_TOL)
            rel_b = _require_close_by_group(f"{tag} d b", res[0][4], res[2][4], groups, *HEAD_COLUMN_TOL)
            e_b = _max_err(res[0][4], res[2][4])
            what = (f"d w by column {rel_w:.2e} of the column's largest entry, d b by group {rel_b:.2e} "
                    f"(tol {HEAD_COLUMN_TOL[1]})")
        else:
            e_e = _require_close_bf16(f"{tag} d e", res[0][2], res[2][2], floor=HEAD_TOL[1])
            e_w = _require_close_bf16(f"{tag} d w", res[0][3], res[2][3], floor=HEAD_COLUMN_TOL[1], col_dim=col)
            e_b = max(_require_close_bf16(f"{tag} d b ({g})", res[0][4][idx], res[2][4][idx],
                                          floor=HEAD_COLUMN_TOL[1]) for g, idx in groups.items() if idx.numel())
            rel_w = rel_b = 0.0
            what = "each within one bf16 step of its entry + the floor"
        require(not res[0][2][valid == 0].any(), f"{tag} d e past the lengths is not exactly 0")
        worst = {"fwd": max(worst["fwd"], *fwd), "grad_e": max(worst["grad_e"], e_e),
                 "grad_w": max(worst["grad_w"], e_w, e_b), "grad_w_rel": max(worst["grad_w_rel"], rel_w, rel_b)}
        print(f"  {tag} max |kernel - plain|: lse {fwd[0]:.2e} xs {fwd[1]:.2e} d e {e_e:.2e} d w {e_w:.2e} "
              f"d b {e_b:.2e}; {what}; two launches bit-identical")
    return worst


def _merge_worst(worst: dict, new: dict) -> dict:
    return {k: max(worst.get(k, 0.0), v) for k, v in new.items()}


def check_ctc_head(dev, gen) -> dict:
    """Largest errors by kernel, f32: forward (lse, xs), grad-e (d e),
    grad-w (d w, d b); at the L1 shape with w in both layouts, at small
    ragged shapes, and over `HEAD_SWEEP_V` x `HEAD_SWEEP_H`."""
    worst = {}
    for name, shape, transposed in (
        ("(18,399,256)x(256,10000) S=257, w as weight.t()", (18, 399, 256, 10000, 128), True),
        ("(18,399,256)x(256,10000) S=257, w contiguous", (18, 399, 256, 10000, 128), False),
        ("(3,70,96)x(96,37) S=9", (3, 70, 96, 37, 4), True),
        ("(2,65,40)x(40,129) S=3", (2, 65, 40, 129, 1), False),
    ):
        worst = _merge_worst(worst, check_head_case(dev, gen, name, shape, torch.float32, transposed))
    for V in HEAD_SWEEP_V:
        for H in HEAD_SWEEP_H:
            worst = _merge_worst(worst, check_head_case(dev, gen, f"(3,70,{H})x({H},{V}) S=17 f32",
                                                        (3, 70, H, V, 8), torch.float32))
    return worst


# K4 backward: sums over up to 399 keys (dQ) or queries (dK, dV) of O(1)
# terms in f32, in another order than the plain version: atol 1e-4.
ATTN_BWD_TOL = 1e-4
DROPOUT_RATE = 0.1
K4_EDGE_RATES = (0.0, 0.1, 0.3)


def check_attention_backward(dev, gen) -> float:
    """Forward with dropout and backward, kernel against the plain version
    under autograd, the plain version taking the kernel's own keep mask;
    the f32 launchers at `k4_edge_cases`, launched twice (bit-identical)."""
    from emoasr_tpu_torch.ops.attention import (attention_bwd_plain, attention_plain, dropout_keep_mask,
                                                fused_self_attention)

    worst = 0.0
    lens18 = torch.randint(1, 400, (18,), generator=gen, device=dev)
    lens18[0], lens18[1], lens18[2] = 399, 0, 1
    for name, (B, T, H, D), lens, rate in (
        ("(18,399,4,64) no dropout", (18, 399, 4, 64), lens18, 0.0),
        ("(18,399,4,64) dropout 0.1", (18, 399, 4, 64), lens18, DROPOUT_RATE),
        ("(5,37,4,64) dropout 0.3", (5, 37, 4, 64), torch.tensor([37, 1, 0, 20, 36], device=dev), 0.3),
        ("(3,50,2,128) dropout 0.1", (3, 50, 2, 128), torch.tensor([50, 17, 3], device=dev), DROPOUT_RATE),
        ("(2,70,3,40) no dropout", (2, 70, 3, 40), torch.tensor([70, 33], device=dev), 0.0),
    ):
        q, k, v, d_out = (torch.randn(B, T, H, D, generator=gen, device=dev) for _ in range(4))
        scale, seed = 1.0 / D ** 0.5, 1234567 + T
        mask = dropout_keep_mask(B, T, H, rate, seed, dev) if rate > 0 else None
        res = []
        for kernel in (True, False):
            q_, k_, v_ = (x.clone().requires_grad_(True) for x in (q, k, v))
            if kernel:
                out = fused_self_attention(q_, k_, v_, lens, scale=scale, dropout_rate=rate,
                                           deterministic=False, seed=seed)
            else:
                out = attention_plain(q_, k_, v_, lens, scale, rate, dropout_mask=mask)
            res.append((out.detach(), *torch.autograd.grad(out, (q_, k_, v_), d_out)))
        torch.cuda.synchronize()
        errs = []
        for what, a, b in zip(("out", "dq", "dk", "dv"), res[0], res[1]):
            err = _max_err(a, b)
            require(bool(torch.isfinite(a).all()) and err <= ATTN_BWD_TOL,
                    f"attention {name} {what}: max |kernel - plain| = {err} > {ATTN_BWD_TOL}")
            errs.append(err)
        past = torch.arange(T, device=dev)[None, :] >= lens[:, None]
        require(not res[0][2][past].any() and not res[0][3][past].any(),
                f"attention {name}: dk/dv at masked keys are not exactly 0")
        worst = max(worst, *errs)
        print(f"  attention fwd+bwd {name}: out {errs[0]:.2e} dq {errs[1]:.2e} dk {errs[2]:.2e} "
              f"dv {errs[3]:.2e} (tol {ATTN_BWD_TOL})")
    # `k4_edge_cases` in f32, dropout 0, 0.1 and 0.3: forward and backward
    # launched twice (bit-identical), the forward within its own tolerance
    f32 = torch.float32
    for name, (B, T, H, D), lens in k4_edge_cases(dev, f32):
        q, k, v, d_out = k4_edge_inputs(name, (B, T, H, D), f32, gen, dev, 4)
        scale = 1.0 / D ** 0.5
        for rate in K4_EDGE_RATES:
            seed = 5678901 + T
            mask = dropout_keep_mask(B, T, H, rate, seed, dev) if rate > 0 else None
            got = _twice(lambda: _attention_grads(q, k, v, d_out, lens, scale, rate, seed))
            want = (attention_plain(q, k, v, lens, scale, rate, dropout_mask=mask),
                    *attention_bwd_plain(q, k, v, d_out, lens, scale, rate, None, mask)[:3])
            tag = f"attention fwd+bwd f32 {name} dropout {rate}"
            errs = _hold_attention_grads(tag, got, want, lens)
            worst = max(worst, *errs[1:])
        print(f"  attention fwd+bwd f32 {name}, dropout {K4_EDGE_RATES}: out within {ATTN_TOL[f32]}, dq dk dv within "
              f"{ATTN_BWD_TOL} (worst so far {worst:.2e}); two launches bit-identical")
    # the dropout bits: kept share, dependence on the seed, and one map for
    # both dtypes
    m1 = dropout_keep_mask(18, 399, 4, DROPOUT_RATE, 1, dev)
    m2 = dropout_keep_mask(18, 399, 4, DROPOUT_RATE, 2, dev)
    share = m1.float().mean().item()
    require(abs(share - (1 - DROPOUT_RATE)) < 1e-3, f"dropout keeps {share}, want {1 - DROPOUT_RATE}")
    differ = (m1 != m2).float().mean().item()
    require(abs(differ - 2 * DROPOUT_RATE * (1 - DROPOUT_RATE)) < 2e-3,
            f"two seeds differ at a share of {differ} of the elements")
    require(torch.equal(m1, dropout_keep_mask(18, 399, 4, DROPOUT_RATE, 1, dev, torch.bfloat16)),
            "the f32 and bf16 dropout maps of one seed differ")
    print(f"  dropout bits: kept share {share:.5f} at rate {DROPOUT_RATE}; two seeds differ at {differ:.4f}; "
          "the f32 and bf16 maps of one seed are equal")
    return worst


def _attention_grads(q, k, v, d_out, lens, scale, rate, seed, bias=None):
    """(out, dq, dk, dv[, d bias]) of the kernel under autograd; the inputs
    are detached in place, so that a q at a storage offset keeps it."""
    from emoasr_tpu_torch.ops.attention import fused_self_attention

    ins = [x.detach().requires_grad_(True) for x in (q, k, v) + (() if bias is None else (bias,))]
    out = fused_self_attention(*ins[:3], lens, scale=scale, dropout_rate=rate, deterministic=rate == 0.0,
                               seed=seed, bias=None if bias is None else ins[3])
    return (out.detach(), *torch.autograd.grad(out, ins, d_out))


def _hold_attention_grads(tag: str, got: tuple, want: tuple, lens) -> list:
    """The f32 launchers' (out, dq, dk, dv[, d bias]) against the plain
    version's: out within ATTN_TOL, the gradients within ATTN_BWD_TOL (a
    bf16 d bias: one bf16 step of each entry more, as the f32 dS is rounded
    once on each side); dK, dV and d bias exactly 0 at masked keys.
    Returns the largest errors."""
    errs = []
    for what, a, b in zip(("out", "dq", "dk", "dv", "dbias"), got, want):
        tol = ATTN_TOL[torch.float32] if what == "out" else ATTN_BWD_TOL
        require(a.shape == b.shape and a.dtype == b.dtype and bool(torch.isfinite(a).all()),
                f"{tag} {what}: {a.dtype} {tuple(a.shape)} against {b.dtype} {tuple(b.shape)}")
        err = (a.double() - b.double()).abs()
        over = err - (tol + (BF16_STEP * b.double().abs() if a.dtype == torch.bfloat16 else 0.0))
        require(over.max().item() <= 0, f"{tag} {what}: max |kernel - plain| = {err.max().item()} > {tol}")
        errs.append(err.max().item())
    T = got[0].shape[1]
    past = torch.arange(T, device=lens.device)[None, :] >= lens[:, None]
    require(not got[2][past].any() and not got[3][past].any(), f"{tag}: dk/dv at masked keys are not exactly 0")
    if len(got) > 4:
        require(not got[4][past[:, None, None, :].expand_as(got[4])].any(),
                f"{tag}: d bias at masked keys is not exactly 0")
    return errs


# K4 with the score bias: the tolerances of the checks without it (forward
# f32 1e-5, bf16 2e-2; backward 1e-4, d bias included: it is the dS tile the
# first backward pass already holds).  The bias is scaled so that it weighs
# as much as q k^T in the score.
def check_attention_bias(dev, gen) -> dict:
    """Forward (f32, bf16) and backward (f32; out, dQ, dK, dV, d bias; with
    and without dropout, the plain version taking the kernel's keep mask),
    ragged lens, T not a multiple of any tile; then the f32 launchers
    forward and backward and the bf16 forward at `k4_edge_cases`, each
    launched twice (bit-identical)."""
    from emoasr_tpu_torch.ops.attention import (attention_bwd_plain, attention_plain, dropout_keep_mask,
                                                fused_self_attention)

    worst = {"fwd": 0.0, "bwd": 0.0, "fwd_bf16": 0.0}
    lens18 = torch.randint(1, 400, (18,), generator=gen, device=dev)
    lens18[0], lens18[1], lens18[2] = 399, 0, 1
    cases = (
        ("(18,399,4,64)", (18, 399, 4, 64), lens18),
        ("(5,37,4,64)", (5, 37, 4, 64), torch.tensor([37, 1, 0, 20, 36], device=dev)),
        ("(2,70,3,40)", (2, 70, 3, 40), torch.tensor([70, 33], device=dev)),
    )
    for name, (B, T, H, D), lens in cases:
        q, k, v, d_out = (torch.randn(B, T, H, D, generator=gen, device=dev) for _ in range(4))
        bias = torch.randn(B, H, T, T, generator=gen, device=dev) * D ** 0.5
        scale = 1.0 / D ** 0.5
        for dtype in (torch.float32, torch.bfloat16):
            args = [x.to(dtype) for x in (q, k, v)]
            o1 = fused_self_attention(*args, lens, scale=scale, bias=bias.to(dtype))
            o0 = attention_plain(*args, lens, scale, bias=bias.to(dtype))
            torch.cuda.synchronize()
            err, tol = _max_err(o1, o0), ATTN_TOL[dtype]
            require(o1.dtype == dtype and bool(torch.isfinite(o1).all()) and err <= tol,
                    f"attention+bias {name} {dtype}: max |kernel - plain| = {err} > {tol}")
            key = "fwd" if dtype == torch.float32 else "fwd_bf16"
            worst[key] = max(worst[key], err)
            print(f"  attention+bias fwd {name} {dtype}: max abs err {err:.3e} (tol {tol})")
        for rate in (0.0, DROPOUT_RATE):
            seed = 7654321 + T
            mask = dropout_keep_mask(B, T, H, rate, seed, dev) if rate > 0 else None
            res = []
            for kernel in (True, False):
                q_, k_, v_, b_ = (x.clone().requires_grad_(True) for x in (q, k, v, bias))
                if kernel:
                    out = fused_self_attention(q_, k_, v_, lens, scale=scale, dropout_rate=rate,
                                               deterministic=rate == 0.0, seed=seed, bias=b_)
                else:
                    out = attention_plain(q_, k_, v_, lens, scale, rate, bias=b_, dropout_mask=mask)
                res.append((out.detach(), *torch.autograd.grad(out, (q_, k_, v_, b_), d_out)))
            torch.cuda.synchronize()
            errs = []
            for what, a, b in zip(("out", "dq", "dk", "dv", "dbias"), res[0], res[1]):
                err = _max_err(a, b)
                require(a.shape == b.shape and bool(torch.isfinite(a).all()) and err <= ATTN_BWD_TOL,
                        f"attention+bias {name} dropout {rate} {what}: max |kernel - plain| = {err} > {ATTN_BWD_TOL}")
                errs.append(err)
            past = (torch.arange(T, device=dev)[None, :] >= lens[:, None])[:, None, None, :].expand(B, H, T, T)
            require(not res[0][4][past].any(), f"attention+bias {name}: d bias at masked keys is not exactly 0")
            worst["bwd"] = max(worst["bwd"], *errs)
            print(f"  attention+bias fwd+bwd {name} dropout {rate}: out {errs[0]:.2e} dq {errs[1]:.2e} "
                  f"dk {errs[2]:.2e} dv {errs[3]:.2e} dbias {errs[4]:.2e} (tol {ATTN_BWD_TOL})")
    # the f32 launchers at `k4_edge_cases`, the bias in f32 and in bf16,
    # dropout 0, 0.1 and 0.3: forward and backward launched twice
    # (bit-identical)
    f32 = torch.float32
    for name, (B, T, H, D), lens in k4_edge_cases(dev, f32):
        q, k, v, d_out = k4_edge_inputs(name, (B, T, H, D), f32, gen, dev, 4)
        bias32 = torch.randn(B, H, T, T, generator=gen, device=dev) * D ** 0.5
        scale = 1.0 / D ** 0.5
        for bias in (bias32, bias32.to(torch.bfloat16)):
            for rate in K4_EDGE_RATES:
                seed = 6789012 + T
                mask = dropout_keep_mask(B, T, H, rate, seed, dev) if rate > 0 else None
                got = _twice(lambda: _attention_grads(q, k, v, d_out, lens, scale, rate, seed, bias))
                want = (attention_plain(q, k, v, lens, scale, rate, bias=bias, dropout_mask=mask),
                        *attention_bwd_plain(q, k, v, d_out, lens, scale, rate, bias, mask))
                errs = _hold_attention_grads(f"attention+bias f32 {name} bias {bias.dtype} dropout {rate}", got, want,
                                             lens)
                worst["fwd"] = max(worst["fwd"], errs[0])
                worst["bwd"] = max(worst["bwd"], *errs[1:4], *errs[4:] if bias.dtype == f32 else ())
        print(f"  attention+bias fwd+bwd f32 {name}, bias f32 and bf16, dropout {K4_EDGE_RATES}: out within "
              f"{ATTN_TOL[f32]}, gradients within {ATTN_BWD_TOL} (a bf16 d bias one bf16 step more); two launches "
              "bit-identical")
    # the bf16 forward at `k4_edge_cases`, the bias in f32 and in bf16, dropout
    # 0, 0.1 and 0.3 (the plain version taking the launchers' keep mask)
    bf, tol = torch.bfloat16, ATTN_TOL[torch.bfloat16]
    for name, (B, T, H, D), lens in k4_edge_cases(dev):
        q, k, v = (torch.randn(B, T, H, D, generator=gen, device=dev).to(bf) for _ in range(3))
        bias = torch.randn(B, H, T, T, generator=gen, device=dev) * D ** 0.5
        scale = 1.0 / D ** 0.5
        for bdt in (torch.float32, bf):
            for rate in K4_EDGE_RATES:
                seed = 3456789 + T
                mask = dropout_keep_mask(B, T, H, rate, seed, dev, bf) if rate > 0 else None
                o1 = _twice(lambda: fused_self_attention(q, k, v, lens, scale=scale, dropout_rate=rate,
                                                         deterministic=rate == 0.0, seed=seed, bias=bias.to(bdt)))
                o0 = attention_plain(q, k, v, lens, scale, rate, bias=bias.to(bdt), dropout_mask=mask)
                err = _max_err(o1, o0)
                require(o1.dtype == bf and bool(torch.isfinite(o1).all()) and err <= tol,
                        f"attention+bias bf16 {name} bias {bdt} dropout {rate}: max |kernel - plain| = {err} > {tol}")
                worst["fwd_bf16"] = max(worst["fwd_bf16"], err)
        print(f"  attention+bias fwd bf16 {name}, bias f32 and bf16, dropout {K4_EDGE_RATES}: max abs err "
              f"{worst['fwd_bf16']:.3e} so far (tol {tol}); two launches bit-identical")
    return worst


# K5: a layer step is some twenty sums of 256 to 2048 f32 products of O(1)
# values, taken in another order than cuBLAS takes them: atol 1e-4 at
# outputs of magnitude O(1) to O(10).
DEC_STEP_TOL = 1e-4
# (name, (Bu, W, L, T, H, D, F)): the L3 decode bucket, one beam, narrow
# widths, many utterances, and beams wider than a row group of 16 (W = 17:
# groups of 16 and 1; W = 33: three groups), among them W = 17 at the
# largest and the smallest L3 bucket (Bu 18 and 50: on 132 SMs clusters of
# 2 and 1 blocks a row group, as the beam-17 decode runs them), and an
# encoder output longer than the cross-attention's window of frames (512 in
# float32, 1024 in bf16: three windows and two)
DEC_STEP_CASES = (
    ("Bu=18 W=10 L=258 T=399 D=256 F=2048", (18, 10, 258, 399, 4, 256, 2048)),
    ("Bu=18 W=17 L=258 T=399 D=256 F=2048", (18, 17, 258, 399, 4, 256, 2048)),
    ("Bu=50 W=17 L=258 T=49 D=256 F=2048", (50, 17, 258, 49, 4, 256, 2048)),
    ("Bu=5 W=1 L=20 T=37 D=256 F=2048", (5, 1, 20, 37, 4, 256, 2048)),
    ("Bu=3 W=10 L=9 T=50 D=64 F=96 H=2", (3, 10, 9, 50, 2, 64, 96)),
    ("Bu=140 W=3 L=16 T=21 D=128 F=256 H=8", (140, 3, 16, 21, 8, 128, 256)),
    ("Bu=4 W=17 L=20 T=37 D=256 F=2048", (4, 17, 20, 37, 4, 256, 2048)),
    ("Bu=2 W=33 L=12 T=30 D=256 F=2048", (2, 33, 12, 30, 4, 256, 2048)),
    ("Bu=2 W=10 L=20 T=1100 D=256 F=2048", (2, 10, 20, 1100, 4, 256, 2048)),
)
# float32 only (bf16 takes widths of multiples of 8): D, d_k and F 4 past a
# multiple of 8, in clusters of 8 blocks, so that a block's output columns
# end halfway through a 16-byte word of the planes it copies to the others
DEC_STEP_CASES_F32 = (
    ("Bu=3 W=5 L=9 T=30 D=100 F=100 H=5", (3, 5, 9, 30, 5, 100, 100)),
)


def dec_step_cases(dtype) -> tuple:
    """The K5 cases `check_decoder_step` runs in `dtype`."""
    return DEC_STEP_CASES + (DEC_STEP_CASES_F32 if dtype == torch.float32 else ())


def decoder_step_case(dev, gen, Bu: int, W: int, L: int, T: int, H: int = 4, D: int = 256, F: int = 2048,
                      pos=None):
    """Random layer weights and one step's inputs: `pos` from 0 to L - 1
    mixed within the batch, ragged `elens`, and an ancestor table composed
    from L random beam selections as the search composes it."""
    dk, N = D // H, Bu * W

    def randn(*shape):
        return torch.randn(*shape, generator=gen, device=dev)

    lin = {"wq": (D, D), "wk": (D, D), "wv": (D, D), "wo": (D, D), "cwq": (D, D), "cwo": (D, D),
           "w1": (F, D), "w2": (D, F)}
    wt = {}
    for n, (o, i) in lin.items():
        wt[n] = (randn(o, i) / i ** 0.5).t()  # an nn.Linear weight's (in, out) view
        wt["b" + n[1:] if n[0] == "w" else "cb" + n[2:]] = 0.1 * randn(o)
    for n in ("ln1", "ln2", "ln3"):
        wt[n + "_s"], wt[n + "_b"] = 1.0 + 0.1 * randn(D), 0.1 * randn(D)
    if pos is None:
        pos = torch.randint(0, L, (Bu, W), generator=gen, device=dev)
        pos.view(-1)[0], pos.view(-1)[-1] = 0, L - 1
    else:
        pos = torch.full((Bu, W), pos, device=dev)
    elens = torch.randint(1, T + 1, (Bu,), generator=gen, device=dev)
    elens[0] = T
    if Bu > 2:
        elens[1], elens[2] = 1, 0
    anc = torch.arange(W, device=dev)[None, :, None].repeat(Bu, 1, L)
    for step in range(1, L):
        parent = torch.randint(0, W, (Bu, W), generator=gen, device=dev)
        anc[:, :, :step] = torch.gather(anc[:, :, :step], 1, parent[:, :, None].expand(-1, -1, step))
    return dict(h=randn(N, D), cache_k=randn(Bu, W, L, H, dk), cache_v=randn(Bu, W, L, H, dk), pos=pos,
                anc=anc, cross_k=randn(Bu, T, H, dk), cross_v=randn(Bu, T, H, dk), elens=elens, weights=wt)


def _row_groups(kernel, kind: str, Bu: int, W: int, D: int, F: int, H: int, L: int, T: int, dtype, dev) -> str:
    """How a launch of `kernel` (K5 or K5 indirect, `kind` "decoder"; K6,
    "lm") lays out its rows: the row group, the groups and the blocks a
    group's cluster on this card."""
    from emoasr_tpu_torch.ops.decoder_step import device_geometry

    g = device_geometry(kernel, kind, Bu, W, D, F, H, L, T, dtype, dev, kind)
    return f"{g['groups']} row groups of up to {g['group']}, clusters of {g['cluster']}"


def _step_close(name: str, got: torch.Tensor, want: torch.Tensor, tol: float) -> float:
    """The f32 tolerance `tol`, or, for bf16 outputs, one bf16 step of each
    entry plus one of the tensor's largest (see BF16_STEP)."""
    if got.dtype == torch.bfloat16:
        return _require_close_bf16(name, got, want)
    return _require_close(name, got, want, tol, 0.0)


def check_decoder_step(dev, gen, dtype=torch.float32) -> dict:
    """K5 and K5 indirect against their plain versions (y, k_new, v_new),
    each launched twice (bit-identical), and K5 indirect against K5 on
    caches gathered by `anc`, in `dtype`.  In
    bf16 each output entry is a float32 sum of exact products rounded once,
    as in the plain version, but upstream of it a dense product or a
    softmax may have rounded the other way: one bf16 step of each entry
    plus one of the largest, as the CPU tests hold the plain versions to
    the JAX kernels."""
    from emoasr_tpu_torch.ops import decoder_step as ds

    sfx = "" if dtype == torch.float32 else "_bf16"
    worst = {"direct": 0.0, "indirect": 0.0, "direct wide": 0.0, "indirect wide": 0.0}
    for name, (Bu, W, L, T, H, D, F) in dec_step_cases(dtype):
        c = _cast_case(decoder_step_case(dev, gen, Bu, W, L, T, H, D, F), dtype)
        dk = D // H
        flat = lambda x: x.reshape(Bu * W, L, H, dk)
        idx = c["anc"][:, :, :, None, None].expand(Bu, W, L, H, dk)
        gk, gv = torch.gather(c["cache_k"], 1, idx), torch.gather(c["cache_v"], 1, idx)
        tail = (c["cross_k"], c["cross_v"], c["elens"], c["weights"])
        out = {
            "direct": _twice(lambda: ds.fused_decoder_layer_step(c["h"], flat(c["cache_k"]), flat(c["cache_v"]),
                                                                 c["pos"].reshape(-1), *tail, beam_width=W)),
            "direct plain": ds.decoder_layer_step_plain(c["h"], flat(c["cache_k"]), flat(c["cache_v"]),
                                                        c["pos"].reshape(-1), *tail, W),
            "indirect": _twice(lambda: ds.fused_decoder_layer_step_indirect(
                c["h"], c["cache_k"], c["cache_v"], c["pos"], c["anc"], *tail, beam_width=W)),
            "indirect plain": ds.decoder_layer_step_indirect_plain(c["h"], c["cache_k"], c["cache_v"],
                                                                   c["pos"], c["anc"], *tail, W),
            "direct on gathered caches": ds.fused_decoder_layer_step(
                c["h"], flat(gk).contiguous(), flat(gv).contiguous(), c["pos"].reshape(-1), *tail, beam_width=W),
        }
        torch.cuda.synchronize()
        layout = {kind: _row_groups(kernel, "decoder", Bu, W, D, F, H, L, T, dtype, dev)
                  for kind, kernel in (("direct", ds.KERNEL), ("indirect", ds.KERNEL_INDIRECT))}
        for kind, other in (("direct", "direct plain"), ("indirect", "indirect plain"),
                            ("indirect", "direct on gathered caches")):
            errs = [_step_close(f"decoder step {dtype} {name} {kind} vs {other}: {what}", a, b, DEC_STEP_TOL)
                    for what, a, b in zip(("y", "k_new", "v_new"), out[kind], out[other])]
            key = kind + (" wide" if W > 16 else "")
            worst[key] = max(worst[key], *errs)
            print(f"  decoder step {dtype} {name} ({layout[kind]}): {kind} vs {other}: y {errs[0]:.2e} k_new {errs[1]:.2e} "
                  f"v_new {errs[2]:.2e} (tol {DEC_STEP_TOL if dtype == torch.float32 else 'one bf16 step + one of the largest'})")
    return {"decoder_step" + sfx: worst["direct"], "decoder_step_indirect" + sfx: worst["indirect"],
            "decoder_step_wide" + sfx: worst["direct wide"],
            "decoder_step_indirect_wide" + sfx: worst["indirect wide"]}


def check_beam_groups(dev, gen, dtype=torch.float32) -> None:
    """Beams wider than a row group: K5, K5 indirect and K6 at W = 20 (two
    row groups of 16 and 4) and at W = 16 (one group) on the same inputs
    for beams 0-15 (ancestor slots below 16), in `dtype`: rows 0-15 of the
    W = 20 launch equal the W = 16 launch bit for bit, so a row's result does
    not depend on the group it lands in."""
    from emoasr_tpu_torch.ops import decoder_step as ds
    from emoasr_tpu_torch.ops import lm_step

    Bu, W, L, T, H, D, F = 3, 20, 12, 30, 4, 256, 2048
    c = _cast_case(decoder_step_case(dev, gen, Bu, W, L, T, H, D, F), dtype)
    c["anc"] = c["anc"] % 16
    dk = D // H
    tail = (c["cross_k"], c["cross_v"], c["elens"], c["weights"])
    narrow = lambda x: x[:, :16].contiguous()
    rows = lambda x: x.reshape(Bu, -1, *x.shape[1:])
    flat = lambda x, w: x.reshape(Bu * w, *x.shape[2:])
    wide = {
        "direct": ds.fused_decoder_layer_step(c["h"], flat(c["cache_k"], W), flat(c["cache_v"], W),
                                              c["pos"].reshape(-1), *tail, beam_width=W),
        "indirect": ds.fused_decoder_layer_step_indirect(c["h"], c["cache_k"], c["cache_v"], c["pos"], c["anc"],
                                                         *tail, beam_width=W),
    }
    h16 = flat(narrow(rows(c["h"])), 16)
    ck16, cv16, pos16, anc16 = (narrow(c[k]) for k in ("cache_k", "cache_v", "pos", "anc"))
    sixteen = {
        "direct": ds.fused_decoder_layer_step(h16, flat(ck16, 16), flat(cv16, 16), pos16.reshape(-1), *tail,
                                              beam_width=16),
        "indirect": ds.fused_decoder_layer_step_indirect(h16, ck16, cv16, pos16, anc16, *tail, beam_width=16),
    }
    for kind in ("direct", "indirect"):
        for what, a, b in zip(("y", "k_new", "v_new"), wide[kind], sixteen[kind]):
            require(torch.equal(narrow(rows(a)), rows(b)),
                    f"decoder step {kind} {dtype}: {what} of beams 0-15 differs between W = 20 and W = 16")
    lc = _cast_case(lm_step_case(dev, gen, Bu, W, L, H, D, F), dtype)
    lc["anc"] = lc["anc"] % 16
    got = lm_step.fused_bert_layer_step_indirect(lc["h"], lc["cache_k"], lc["cache_v"], lc["pos"], lc["anc"],
                                                lc["weights"])
    want = lm_step.fused_bert_layer_step_indirect(*(narrow(lc[k]) for k in ("h", "cache_k", "cache_v", "pos", "anc")),
                                                 lc["weights"])
    for what, a, b in zip(("y", "k_new", "v_new"), got, want):
        require(torch.equal(narrow(a), b), f"LM step {dtype}: {what} of beams 0-15 differs between W = 20 and W = 16")
    print(f"  decoder step (direct, indirect) and LM step {dtype}: beams 0-15 of W = 20 (groups of 16 and 4) "
          "equal W = 16 bit for bit")


def time_attention_bias(dev, gen, B: int, T: int, H: int, D: int, lens: torch.Tensor,
                        dtype=torch.float32) -> dict:
    """K4 with its bias, forward and backward (dropout 0.1), beside the
    plain version and SDPA with the bias folded into its additive mask; in
    `dtype` (rows named `..._bf16` for bf16, bound at that dtype's rate)."""
    import torch.nn.functional as F

    from emoasr_tpu_torch.ops.attention import (attention_bwd_plain, attention_plain, dropout_keep_mask,
                                                fused_self_attention)

    q, k, v, d_out = (torch.randn(B, T, H, D, generator=gen, device=dev).to(dtype) for _ in range(4))
    bias = (torch.randn(B, H, T, T, generator=gen, device=dev) * D ** 0.5).to(dtype)
    scale, seed = 1.0 / D ** 0.5, 99
    key_mask = (torch.arange(T, device=dev)[None, :] < lens[:, None])[:, None, None, :]
    valid = int(lens.clamp(max=T).sum().item())
    qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
    es = q.element_size()

    # SDPA adds its mask after the scale, so the bias goes in scaled, with the
    # key mask folded in; it is built once here, outside what is timed
    add_mask = (bias * scale).masked_fill(~key_mask, float("-inf"))

    live_bias = es * H * T * valid  # bias bytes at the keys a row can see
    fwd = {
        "ms": cuda_time_ms(lambda: fused_self_attention(q, k, v, lens, scale=scale, bias=bias)),
        "plain_ms": cuda_time_ms(lambda: attention_plain(q, k, v, lens, scale, bias=bias)),
        "library_ms": cuda_time_ms(lambda: F.scaled_dot_product_attention(
            qt, kt, vt, attn_mask=add_mask, scale=scale)),
        "shape": f"({B},{T},{H},{D}) {dtype}, bias ({B},{H},{T},{T})",
    }
    fwd.update(_bound(es * 4 * B * T * H * D + live_bias + B * 4, 4.0 * H * T * D * valid, dtype,
                      _split_products(dtype)))

    mask = dropout_keep_mask(B, T, H, DROPOUT_RATE, seed, dev, dtype)
    q_, k_, v_, b_ = (x.clone().requires_grad_(True) for x in (q, k, v, bias))
    qt, kt, vt = (x.transpose(1, 2) for x in (q_, k_, v_))
    # SDPA's backward is taken to its additive mask as a leaf (d bias / scale),
    # so that no pass over the bias outside the call is timed with it
    m_ = add_mask.clone().requires_grad_(True)
    graphs = {
        "ms": fused_self_attention(q_, k_, v_, lens, scale=scale, dropout_rate=DROPOUT_RATE,
                                   deterministic=False, seed=seed, bias=b_),
        "library_ms": F.scaled_dot_product_attention(
            qt, kt, vt, attn_mask=m_, dropout_p=DROPOUT_RATE, scale=scale).transpose(1, 2),
    }
    if dtype == torch.float32:
        graphs["plain_ms"] = attention_plain(q_, k_, v_, lens, scale, DROPOUT_RATE, bias=b_, dropout_mask=mask)
    bwd = {key: cuda_time_ms(_grad_timer(out, (q_, k_, v_, m_ if key == "library_ms" else b_), d_out),
                             iters=20, warmup=2)
           for key, out in graphs.items()}
    if dtype != torch.float32:  # the plain backward with the kernel's rounding, not autograd's
        bwd["plain_ms"] = cuda_time_ms(lambda: attention_bwd_plain(q, k, v, d_out, lens, scale, DROPOUT_RATE,
                                                                   bias, mask), iters=20, warmup=2)
    # inputs read once (q, k, v, o, dO, lse, the live bias), outputs written
    # once (dQ, dK, dV and all of d bias, zeros included)
    bwd.update(_bound(es * 8 * B * T * H * D + 4 * (B * H * T + B) + live_bias + es * B * H * T * T,
                      10.0 * H * D * T * valid, dtype, _split_products(dtype)))
    bwd["shape"] = f"({B},{T},{H},{D}) {dtype}, bias ({B},{H},{T},{T}), dropout {DROPOUT_RATE}"
    suffix = "" if dtype == torch.float32 else "_bf16"
    return {"attention_bias_fwd" + suffix: fwd, "attention_bias_bwd" + suffix: bwd}


def time_decoder_step(dev, gen, Bu: int, W: int, L: int, T: int, pos: int, lens: torch.Tensor,
                      dtype=torch.float32) -> dict:
    """K5 and K5 indirect at the decode shapes beside their plain versions
    and the port's dense route of the same step (`decode_step`,
    `decode_step_indirect`: some twenty-five PyTorch calls; no single
    PyTorch call computes the step, so `library_ms` is null); in `dtype`
    (rows named `..._bf16` for bf16, the bytes at its element size)."""
    from emoasr_tpu_torch.models.layers import TransformerDecoderLayer, make_pad_mask
    from emoasr_tpu_torch.ops import decoder_step as ds

    H, D, F = 4, 256, 2048
    dk, N = D // H, Bu * W
    c = _cast_case(decoder_step_case(dev, gen, Bu, W, L, T, H, D, F, pos=pos), dtype)
    c["elens"] = lens.to(dev)
    layer = TransformerDecoderLayer(H, D, F).to(dev, dtype).eval()
    pack = layer._packed_step_weights()  # as the decoder's steps pass them: checked and laid out once
    flat = lambda x: x.reshape(N, L, H, dk)
    tail = (c["cross_k"], c["cross_v"], c["elens"], pack)
    plain_tail = (c["cross_k"], c["cross_v"], c["elens"], pack.source)
    h3 = c["h"][:, None]
    memory_mask = make_pad_mask(c["elens"], T)[:, None, None, :]
    flat_pos = c["pos"].reshape(-1)
    self_mask = (torch.arange(L, device=dev)[None, :] <= flat_pos[:, None])[:, None, None, :]
    cross_kv = (c["cross_k"], c["cross_v"])
    ck, cv = flat(c["cache_k"]).clone(), flat(c["cache_v"]).clone()
    ick, icv = c["cache_k"].clone(), c["cache_v"].clone()
    with torch.no_grad():
        direct = {
            "ms": cuda_time_ms(lambda: ds.fused_decoder_layer_step(c["h"], ck, cv, flat_pos, *tail, beam_width=W)),
            "plain_ms": cuda_time_ms(lambda: ds.decoder_layer_step_plain(c["h"], ck, cv, flat_pos, *plain_tail, W)),
            "dense_route_ms": cuda_time_ms(lambda: layer.decode_step(
                h3, ck, cv, flat_pos, self_mask, memory_mask, cross_kv, beam_width=W)),
        }
        indirect = {
            "ms": cuda_time_ms(lambda: ds.fused_decoder_layer_step_indirect(
                c["h"], ick, icv, c["pos"], c["anc"], *tail, beam_width=W)),
            "plain_ms": cuda_time_ms(lambda: ds.decoder_layer_step_indirect_plain(
                c["h"], ick, icv, c["pos"], c["anc"], *plain_tail, W)),
            "dense_route_ms": cuda_time_ms(lambda: layer.decode_step_indirect(
                h3, ick, icv, c["pos"], c["anc"], memory_mask, cross_kv, W)),
        }
    frames, past = int(c["elens"].sum().item()), int(flat_pos.sum().item())
    n_weights = 6 * D * D + 2 * D * F + 9 * D + F
    es = c["h"].element_size()
    # weights, h in, y / k_new / v_new out, the live encoder K/V and cache
    # columns in the storage dtype; pos and elens (and anc) int32
    io = es * (n_weights + 4 * N * D + 2 * frames * D + 2 * past * D) + 4 * (N + Bu)
    ops = 2.0 * N * (6 * D * D + 2 * D * F) + 4.0 * D * (past + N) + 4.0 * W * D * frames
    for row, extra in ((direct, 0), (indirect, 4 * past)):
        row.update(_bound(io + extra, ops, dtype, _beam_step_products(dtype)))
        row["library_ms"] = None
        row["shape"] = (f"h ({N},{D}), caches ({Bu},{W},{L},{H},{dk}) at pos {pos}, encoder K/V "
                        f"({Bu},{T},{H},{dk}), F {F}, {dtype}")
    sfx = "" if dtype == torch.float32 else "_bf16"
    return {"decoder_step" + sfx: direct, "decoder_step_indirect" + sfx: indirect}


def _beam_step_products(dtype) -> int:
    """bf16 tensor-core products per f32 product of K5's and K6's float32
    launchers (two terms a side, three products), 0 in bf16."""
    return 3 if dtype == torch.float32 else 0


def _cast_case(c: dict, dtype) -> dict:
    """A step case's floating tensors and weights in `dtype` (integers as they are)."""
    cast = lambda v: v.to(dtype) if v.is_floating_point() else v
    return {k: ({n: cast(w) for n, w in v.items()} if k == "weights" else cast(v)) for k, v in c.items()}


# K6: a layer step is some ten sums of 64 to 2048 f32 products of O(1)
# values, in another order than cuBLAS takes them, and two LayerNorms that
# bring the outputs back to O(1): atol 1e-4.  Against the same kernel on
# caches gathered by `anc` (identity table): the same numbers in the same
# order, so 0; LM_GATHER_TOL allows for a different reduction order.
LM_STEP_TOL = 1e-4
LM_GATHER_TOL = 1e-5
# (name, (Bu, W, L, H, D, F)): the L3-3 bucket, narrow shapes, and beams
# wider than a row group of 16 (W = 17 and 33; W = 17 at Bu 18 and 50, as in
# DEC_STEP_CASES)
LM_STEP_CASES = (
    ("Bu=18 W=10 L=256 D=512 F=2048 H=8", (18, 10, 256, 8, 512, 2048)),
    ("Bu=18 W=17 L=256 D=512 F=2048 H=8", (18, 17, 256, 8, 512, 2048)),
    ("Bu=50 W=17 L=256 D=512 F=2048 H=8", (50, 17, 256, 8, 512, 2048)),
    ("Bu=5 W=3 L=20 D=512 F=2048 H=8", (5, 3, 20, 8, 512, 2048)),
    ("Bu=3 W=1 L=7 D=512 F=2048 H=8", (3, 1, 7, 8, 512, 2048)),
    ("Bu=7 W=16 L=9 D=64 F=96 H=2", (7, 16, 9, 2, 64, 96)),
    ("Bu=3 W=17 L=20 D=512 F=2048 H=8", (3, 17, 20, 8, 512, 2048)),
    ("Bu=2 W=33 L=12 D=512 F=2048 H=8", (2, 33, 12, 8, 512, 2048)),
)
# float32 only, as DEC_STEP_CASES_F32
LM_STEP_CASES_F32 = (
    ("Bu=3 W=5 L=9 D=100 F=100 H=5", (3, 5, 9, 5, 100, 100)),
)


def lm_step_cases(dtype) -> tuple:
    """The K6 cases `check_lm_step` runs in `dtype`."""
    return LM_STEP_CASES + (LM_STEP_CASES_F32 if dtype == torch.float32 else ())


def lm_step_case(dev, gen, Bu: int, W: int, L: int, H: int = 8, D: int = 512, F: int = 2048, pos=None):
    """Random post-norm layer weights and one step's inputs: `pos` per row
    from 0 to L - 1 with a 0 and an L - 1 (or `pos` everywhere), and an
    ancestor table composed from random beam selections, with
    anc[u, w, pos] = w as the search sets it before the step."""
    dk = D // H

    def randn(*shape):
        return torch.randn(*shape, generator=gen, device=dev)

    lin = {"wq": (D, D), "wk": (D, D), "wv": (D, D), "wo": (D, D), "wi": (F, D), "wo2": (D, F)}
    wt = {}
    for n, (o, i) in lin.items():
        wt[n] = (randn(o, i) / i ** 0.5).t()  # an nn.Linear weight's (in, out) view
        wt["b" + n[1:]] = 0.1 * randn(o)
    for n in ("ln1", "ln2"):
        wt[n + "_s"], wt[n + "_b"] = 1.0 + 0.1 * randn(D), 0.1 * randn(D)
    if pos is None:
        pos = torch.randint(0, L, (Bu, W), generator=gen, device=dev)
        pos.view(-1)[0], pos.view(-1)[-1] = 0, L - 1
    else:
        pos = torch.full((Bu, W), pos, device=dev)
    anc = torch.arange(W, device=dev)[None, :, None].repeat(Bu, 1, L)
    for step in range(1, L):
        parent = torch.randint(0, W, (Bu, W), generator=gen, device=dev)
        anc[:, :, :step] = torch.gather(anc[:, :, :step], 1, parent[:, :, None].expand(-1, -1, step))
    anc.scatter_(2, pos[:, :, None], torch.arange(W, device=dev)[None, :, None].expand(Bu, W, 1))
    return dict(h=randn(Bu, W, D), cache_k=randn(Bu, W, L, H, dk), cache_v=randn(Bu, W, L, H, dk),
                pos=pos, anc=anc, weights=wt)


def check_lm_step(dev, gen, dtype=torch.float32) -> dict:
    """K6 against its plain version (y, k_new, v_new), launched twice
    (bit-identical), and against itself on
    caches gathered by `anc` under the identity table, in `dtype` (bf16 held
    as `check_decoder_step` holds it): the largest errors at W <= 16 and at
    W > 16."""
    from emoasr_tpu_torch.ops import lm_step

    worst = {"narrow": 0.0, "wide": 0.0}
    for name, (Bu, W, L, H, D, F) in lm_step_cases(dtype):
        c = _cast_case(lm_step_case(dev, gen, Bu, W, L, H, D, F), dtype)
        dk = D // H
        idx = c["anc"][:, :, :, None, None].expand(Bu, W, L, H, dk)
        gk, gv = torch.gather(c["cache_k"], 1, idx), torch.gather(c["cache_v"], 1, idx)
        ident = torch.arange(W, device=dev)[None, :, None].expand(Bu, W, L).contiguous()
        args = (c["h"], c["cache_k"], c["cache_v"], c["pos"], c["anc"], c["weights"])
        out = {
            "kernel": _twice(lambda: lm_step.fused_bert_layer_step_indirect(*args)),
            "plain": lm_step.bert_layer_step_indirect_plain(*args),
            "kernel on gathered caches": lm_step.fused_bert_layer_step_indirect(
                c["h"], gk.contiguous(), gv.contiguous(), c["pos"], ident, c["weights"]),
        }
        torch.cuda.synchronize()
        layout = _row_groups(lm_step.KERNEL, "lm", Bu, W, D, F, H, L, 1, dtype, dev)
        for other, tol in (("plain", LM_STEP_TOL), ("kernel on gathered caches", LM_GATHER_TOL)):
            errs = [_step_close(f"LM step {dtype} {name} kernel vs {other}: {what}", a, b, tol)
                    for what, a, b in zip(("y", "k_new", "v_new"), out["kernel"], out[other])]
            if other == "plain":
                key = "wide" if W > 16 else "narrow"
                worst[key] = max(worst[key], *errs)
            print(f"  LM step {dtype} {name} ({layout}): kernel vs {other}: y {errs[0]:.2e} k_new {errs[1]:.2e} "
                  f"v_new {errs[2]:.2e} (tol {tol if dtype == torch.float32 else 'one bf16 step + one of the largest'})")
    sfx = "" if dtype == torch.float32 else "_bf16"
    return {"lm_step_indirect" + sfx: worst["narrow"], "lm_step_indirect_wide" + sfx: worst["wide"]}


def time_lm_step(dev, gen, Bu: int, W: int, L: int, pos: int, dtype=torch.float32) -> dict:
    """K6 at the L3-3 shapes beside its plain version and the port's dense
    route of the same step (`BertLayer.step_indirect(fused=False)`: some
    twenty PyTorch calls and the two cache writes; no single PyTorch call
    computes the step, so `library_ms` is null); in `dtype`."""
    from emoasr_tpu_torch.models.lm.bert import BertLayer
    from emoasr_tpu_torch.ops import lm_step

    H, D, F = 8, 512, 2048
    dk, N = D // H, Bu * W
    c = _cast_case(lm_step_case(dev, gen, Bu, W, L, H, D, F, pos=pos), dtype)
    layer = BertLayer(H, D, F).to(dev, dtype).eval()
    pack = layer._packed_step_weights()
    ck, cv = c["cache_k"].clone(), c["cache_v"].clone()
    pos32 = c["pos"].to(torch.int32)
    with torch.no_grad():
        row = {
            "ms": cuda_time_ms(lambda: lm_step.fused_bert_layer_step_indirect(c["h"], ck, cv, pos32, c["anc"], pack)),
            "plain_ms": cuda_time_ms(lambda: lm_step.bert_layer_step_indirect_plain(
                c["h"], ck, cv, pos32, c["anc"], pack)),
            "dense_route_ms": cuda_time_ms(lambda: layer.step_indirect(
                c["h"], ck, cv, c["pos"], c["anc"], fused=False)),
        }
    past = int(c["pos"].sum().item())  # live cache columns over all rows
    n_weights = 4 * D * D + 2 * D * F + 9 * D + F
    es = c["h"].element_size()
    # weights, each row's live K and V columns, h in, y / k_new / v_new out
    # in the storage dtype; pos and its anc row int32
    io = es * (n_weights + 2 * past * D + 4 * N * D) + 4 * (N + past)
    ops = 2.0 * N * (4 * D * D + 2 * D * F) + 4.0 * D * (past + N)
    row.update(_bound(io, ops, dtype, _beam_step_products(dtype)))
    row["library_ms"] = None
    row["shape"] = f"h ({Bu},{W},{D}), caches ({Bu},{W},{L},{H},{dk}) at pos {pos}, F {F}, {dtype}"
    return {"lm_step_indirect" + ("" if dtype == torch.float32 else "_bf16"): row}


# K7: log-probabilities (magnitudes about log V ~ 7-8) from float32 sums of
# J = 512 products in another order than the plain version's matrix
# product, in float32 of operands split into two bf16 terms each (~2^-17 of
# each product; tests/test_torch_kernel_arith.py): atol 1e-4.
RNNT_JOINT_TOL = 1e-4


def rnnt_joint_case(dev, gen, B: int, T: int, U1: int, J: int, V: int):
    """Joint activations, an output layer in `nn.Linear`'s (V, J) layout and
    labels with eos padding (a valid id, as the trainer pads)."""
    h_enc = torch.randn(B, T, J, generator=gen, device=dev)
    h_dec = torch.randn(B, U1, J, generator=gen, device=dev)
    weight = torch.randn(V, J, generator=gen, device=dev) / J ** 0.5
    bias = 0.1 * torch.randn(V, generator=gen, device=dev)
    labels = torch.randint(1, V, (B, U1 - 1), generator=gen, device=dev)
    labels[:, (U1 - 1) // 2:] = 2
    return h_enc, h_dec, weight, bias, labels


def _check_joint(tag: str, args: tuple, want: tuple, blank: int = 0) -> float:
    """K7 launched twice on `args` (h_enc, h_dec, w, bias, labels): the two
    launches bit-identical, float32 outputs within RNNT_JOINT_TOL of `want`."""
    from emoasr_tpu_torch.ops.rnnt_joint import fused_joint_gather

    with torch.no_grad():
        got = fused_joint_gather(*args, blank)
        again = fused_joint_gather(*args, blank)
    torch.cuda.synchronize()
    require(got[0].dtype == got[1].dtype == torch.float32, f"{tag}: outputs are not float32")
    require(all(torch.equal(a, b) for a, b in zip(got, again)), f"{tag}: two launches differ")
    require(got[1].shape == want[1].shape, f"{tag} lp_label: shape {tuple(got[1].shape)} != {tuple(want[1].shape)}")
    errs = [_require_close(f"{tag} {what}", a, b, RNNT_JOINT_TOL, 0.0) if b.numel() else 0.0  # U = 0: no labels
            for what, a, b in zip(("lp_blank", "lp_label"), got, want)]
    print(f"  {tag}: lp_blank {errs[0]:.2e}, lp_label {errs[1]:.2e} (tol {RNNT_JOINT_TOL}), twice, bit-identical")
    return max(errs)


def check_rnnt_joint(dev, gen) -> dict:
    """K7 forward against its plain version (the chunked dense product):
    the largest L4 bucket at V = 1000 and CSJ's V = 4000, U+1 not a
    multiple of anything, B not a multiple of anything, T below the plain
    version's chunk, the weight read in place as `weight.t()` and
    contiguous; each shape launched twice, bit-identical."""
    from emoasr_tpu_torch.ops.rnnt import joint_gather_plain

    worst = {"rnnt_joint": 0.0, "rnnt_joint_v4000": 0.0}
    for shape, transposed in (((18, 399, 129, 512, 1000), True), ((18, 399, 129, 512, 4000), True),
                              ((5, 23, 37, 512, 4000), True), ((3, 41, 13, 512, 1000), False),
                              ((7, 9, 2, 96, 257), True)):
        h_enc, h_dec, weight, bias, labels = rnnt_joint_case(dev, gen, *shape)
        w = weight.t() if transposed else weight.t().contiguous()
        with torch.no_grad():
            want = joint_gather_plain(h_enc, h_dec, w, bias, labels, 0)
        err = _check_joint(f"rnnt joint {shape}{' weight.t()' if transposed else ''}",
                           (h_enc, h_dec, w, bias, labels), want)
        for key in ("rnnt_joint", "rnnt_joint_v4000") if shape[4] == 4000 else ("rnnt_joint",):
            worst[key] = max(worst[key], err)
    return worst


# K8: the forward's outputs are O(1) after up to 129 steps of float32 dot
# products of 512 terms in another order: atol 1e-5.  The backward carries
# d h through the same steps back and sums d w_hh over B T terms: each
# gradient within 1e-5 + 1e-4 of its largest entry.
LSTM_FWD_TOL = 1e-5
LSTM_BWD_TOL = (1e-5, 1e-4)


def lstm_case(dev, gen, B: int, T: int, H: int, zero_state: bool = False):
    x_proj = 0.5 * torch.randn(B, T, 4 * H, generator=gen, device=dev)
    w_hh = torch.randn(4 * H, H, generator=gen, device=dev) / H ** 0.5
    h0 = torch.zeros(B, H, device=dev) if zero_state else 0.5 * torch.randn(B, H, generator=gen, device=dev)
    c0 = torch.zeros(B, H, device=dev) if zero_state else 0.5 * torch.randn(B, H, generator=gen, device=dev)
    cots = (torch.randn(B, T, H, generator=gen, device=dev), torch.randn(B, H, generator=gen, device=dev),
            torch.randn(B, H, generator=gen, device=dev))
    return x_proj, w_hh, h0, c0, cots


def lstm_twice(tag: str, ins: list, cots) -> tuple:
    """K8 forward and backward of `ins` (x_proj, w_hh, h0, c0) with the
    cotangents `cots`, launched twice: the second run must equal the first
    bit for bit.  Returns ((ys, h_T, c_T), (d x_proj, d w_hh, d h0, d c0))."""
    from emoasr_tpu_torch.ops.lstm_scan import lstm_scan_fused

    runs = []
    for _ in range(2):
        leaves = [t.detach().clone().requires_grad_(True) for t in ins]
        ys, (hT, cT) = lstm_scan_fused(*leaves)
        runs.append(((ys, hT, cT), torch.autograd.grad((ys, hT, cT), leaves, cots)))
    torch.cuda.synchronize()
    require(all(torch.equal(a, b) for a, b in zip((*runs[0][0], *runs[0][1]), (*runs[1][0], *runs[1][1]))),
            f"{tag}: two launches differ")
    return runs[0]


# the K8 shapes checked, (B, T, H) and a zero initial state: the prediction
# network's largest bucket, a batch in two tiles (B = 50), H not a multiple
# of 128, T = 8 (the threshold), the RNN LM's length (T = 256) and B = 1
LSTM_CASES = (((18, 129, 512), True), ((5, 9, 512), False), ((50, 49, 512), True), ((3, 20, 136), False),
              ((7, 8, 40), False), ((18, 256, 512), True), ((1, 129, 512), False))
LSTM_BF16_CASES = (((18, 129, 512), True), ((50, 49, 512), True), ((3, 20, 136), False),
                   ((18, 256, 512), True), ((1, 129, 512), False))
LSTM_WIDE_CASES = (((18, 129, 1024), True), ((50, 20, 640), False), ((1, 256, 1024), False))


def check_lstm(dev, gen) -> dict:
    """K8 forward (ys, h_T, c_T) and backward (d x_proj, d w_hh, d h0, d c0)
    against the plain versions at `LSTM_CASES`, each launched twice
    (bit-identical)."""
    from emoasr_tpu_torch.ops.lstm_scan import lstm_bwd_plain, lstm_fwd_plain

    worst = {"fwd": 0.0, "bwd": 0.0}
    for shape, zero in LSTM_CASES:
        x_proj, w_hh, h0, c0, (g_ys, g_h, g_c) = lstm_case(dev, gen, *shape, zero_state=zero)
        tag = f"lstm {shape}{' zero state' if zero else ''}"
        (ys, hT, cT), grads = lstm_twice(tag, [x_proj, w_hh, h0, c0], (g_ys, g_h, g_c))
        with torch.no_grad():
            p_ys, p_h, p_c, gates, hcprev = lstm_fwd_plain(x_proj, w_hh, h0, c0)
            p_grads = lstm_bwd_plain(gates, hcprev, g_ys, g_h, g_c, w_hh)
        torch.cuda.synchronize()
        fwd = [_require_close(f"{tag} {what}", a, b, LSTM_FWD_TOL, 0.0)
               for what, a, b in zip(("ys", "h_T", "c_T"), (ys, hT, cT), (p_ys, p_h, p_c))]
        bwd = [_require_close(f"{tag} {what}", a, b, *LSTM_BWD_TOL)
               for what, a, b in zip(("d x_proj", "d w_hh", "d h0", "d c0"), grads, p_grads)]
        worst = {"fwd": max(worst["fwd"], *fwd), "bwd": max(worst["bwd"], *bwd)}
        print(f"  {tag}: ys {fwd[0]:.2e} h_T {fwd[1]:.2e} c_T {fwd[2]:.2e}; d x_proj {bwd[0]:.2e} d w_hh "
              f"{bwd[1]:.2e} d h0 {bwd[2]:.2e} d c0 {bwd[3]:.2e}; twice, bit-identical")
    return worst


def check_lstm_cases(dev, gen, cases, what: str) -> dict:
    """K8 forward and backward at `cases` ((B, T, H), zero initial state),
    against the plain versions, each launched twice (bit-identical)."""
    from emoasr_tpu_torch.ops.lstm_scan import lstm_bwd_plain, lstm_fwd_plain

    worst = {"fwd": 0.0, "bwd": 0.0}
    for shape, zero in cases:
        x_proj, w_hh, h0, c0, cots = lstm_case(dev, gen, *shape, zero_state=zero)
        tag = f"lstm ({what}) {shape}"
        (ys, hT, cT), grads = lstm_twice(tag, [x_proj, w_hh, h0, c0], cots)
        with torch.no_grad():
            p_ys, p_h, p_c, gates, hcprev = lstm_fwd_plain(x_proj, w_hh, h0, c0)
            p_grads = lstm_bwd_plain(gates, hcprev, *cots, w_hh)
        torch.cuda.synchronize()
        fwd = [_require_close(f"{tag} {w}", a, b, LSTM_FWD_TOL, 0.0)
               for w, a, b in zip(("ys", "h_T", "c_T"), (ys, hT, cT), (p_ys, p_h, p_c))]
        bwd = [_require_close(f"{tag} {w}", a, b, *LSTM_BWD_TOL)
               for w, a, b in zip(("d x_proj", "d w_hh", "d h0", "d c0"), grads, p_grads)]
        worst = {"fwd": max(worst["fwd"], *fwd), "bwd": max(worst["bwd"], *bwd)}
        print(f"  {tag}: forward {max(fwd):.2e}, backward {max(bwd):.2e}; twice, bit-identical")
    return worst



# ---------------------------------------------------------------- bf16 parts
#
# A bf16 output of a kernel and of its plain version is one float32 sum of
# the same exact products (bf16 values multiply exactly in f32) in two
# orders, rounded once: where the two sums straddle a rounding boundary they
# differ by one bf16 step, 2^-7 of the entry at most.  An entry whose inputs
# went through such a step upstream (a rounded dS or Pd in K4, a rounded
# gate in K8) differs by that step times its weight in the sum: a floor of
# one step of the tensor's largest entry (of the column's, for
# vocabulary-sized gradients, compared by column as in f32).  float32
# outputs of bf16 products (K1's lse and xs, K7's log-probabilities) keep
# their f32 tolerances.
BF16_STEP = 2.0 ** -7


def _require_close_bf16(name: str, got: torch.Tensor, want: torch.Tensor, floor: float = BF16_STEP,
                        col_dim=None) -> float:
    """|got - want| <= 2^-7 |want| + floor * (the largest |want|, or the
    largest of its column along `col_dim`) entry by entry; returns the
    largest |got - want|."""
    require(got.shape == want.shape, f"{name}: shape {tuple(got.shape)} != {tuple(want.shape)}")
    require(got.dtype == want.dtype, f"{name}: dtype {got.dtype} != {want.dtype}")
    require(bool(torch.isfinite(got).all()), f"{name}: non-finite values")
    g, w = got.double(), want.double()
    if col_dim is None:
        scale = w.abs().max().expand_as(w)
    else:
        other = [d for d in range(w.dim()) if d != col_dim % w.dim()]
        scale = w.abs().amax(other, keepdim=True).expand_as(w)
    err = (g - w).abs()
    over = err - (BF16_STEP * w.abs() + floor * scale)
    i = int(over.argmax())
    require(over.reshape(-1)[i].item() <= 0,
            f"{name}: |kernel - plain| = {err.reshape(-1)[i].item()} at {w.reshape(-1)[i].item()} exceeds one bf16 "
            f"step + {floor} of its scale {scale.reshape(-1)[i].item()}")
    return err.max().item()


def check_ctc_head_bf16(dev, gen) -> dict:
    """K1 in bf16 at the L1 width (H = 256) and wider (H = 512, 600: the
    kernels stream H in chunks of 256), in f32 at H = 512, and in bf16 over
    `HEAD_SWEEP_V` x `HEAD_SWEEP_H`; both cotangents of `check_ctc_head`.
    Largest errors by kernel, bf16 only."""
    bf = torch.bfloat16
    worst = {}
    for name, shape, dtype in (
        ("(18,399,256)x(256,10000) S=257 bf16", (18, 399, 256, 10000, 128), bf),
        ("(18,399,512)x(512,10000) S=257 bf16", (18, 399, 512, 10000, 128), bf),
        ("(18,399,512)x(512,10000) S=257 f32", (18, 399, 512, 10000, 128), torch.float32),
        ("(3,70,600)x(600,37) S=9 bf16", (3, 70, 600, 37, 4), bf),
    ):
        w = check_head_case(dev, gen, name, shape, dtype)
        if dtype == bf:
            worst = _merge_worst(worst, w)
    for V in HEAD_SWEEP_V:
        for H in HEAD_SWEEP_H:
            worst = _merge_worst(worst, check_head_case(dev, gen, f"(3,70,{H})x({H},{V}) S=17 bf16",
                                                        (3, 70, H, V, 8), bf))
    return {"ctc_head_fwd_bf16": worst["fwd"], "ctc_head_grad_e_bf16": worst["grad_e"],
            "ctc_head_grad_w_bf16": worst["grad_w"]}


def check_attention_backward_bf16(dev, gen) -> dict:
    """K4's backward in bf16, with and without the score bias, dropout on
    and off, against `attention_bwd_plain` with the kernel's keep mask: the
    forward's output (the bf16 forward's tolerance) and dQ, dK, dV, d bias."""
    from emoasr_tpu_torch.ops.attention import (attention_bwd_plain, attention_plain, dropout_keep_mask,
                                                fused_self_attention)

    worst = {"attention_bwd_bf16": 0.0, "attention_bias_bwd_bf16": 0.0}
    lens18 = torch.randint(1, 400, (18,), generator=gen, device=dev)
    lens18[0], lens18[1], lens18[2] = 399, 0, 1
    bf = torch.bfloat16
    for name, (B, T, H, D), lens, rate, with_bias in (
        ("(18,399,4,64) dropout 0.1", (18, 399, 4, 64), lens18, DROPOUT_RATE, False),
        ("(18,399,4,64) dropout 0.1, bias", (18, 399, 4, 64), lens18, DROPOUT_RATE, True),
        ("(5,37,4,64) no dropout, bias", (5, 37, 4, 64), torch.tensor([37, 1, 0, 20, 36], device=dev), 0.0, True),
        ("(2,70,3,40) dropout 0.3", (2, 70, 3, 40), torch.tensor([70, 33], device=dev), 0.3, False),
    ):
        q, k, v, d_out = (torch.randn(B, T, H, D, generator=gen, device=dev).to(bf) for _ in range(4))
        bias = (torch.randn(B, H, T, T, generator=gen, device=dev) * D ** 0.5).to(bf) if with_bias else None
        scale, seed = 1.0 / D ** 0.5, 2345678 + T
        mask = dropout_keep_mask(B, T, H, rate, seed, dev, bf) if rate > 0 else None
        ins = [x.clone().requires_grad_(True) for x in (q, k, v)] + ([bias.clone().requires_grad_(True)]
                                                                      if with_bias else [])
        out = fused_self_attention(*ins[:3], lens, scale=scale, dropout_rate=rate, deterministic=rate == 0.0,
                                   seed=seed, bias=ins[3] if with_bias else None)
        got = torch.autograd.grad(out, ins, d_out)
        with torch.no_grad():
            want = attention_bwd_plain(q, k, v, d_out, lens, scale, rate, bias, mask)
        torch.cuda.synchronize()
        tag = f"attention bwd bf16 {name}"
        require(out.dtype == bf and all(g.dtype == bf for g in got), f"{tag}: the gradients are not bf16")
        errs = [_require_close_bf16(f"{tag} {what}", a, b)
                for what, a, b in zip(("dq", "dk", "dv", "dbias"), got, want)]
        past = torch.arange(T, device=dev)[None, :] >= lens[:, None]
        require(not got[1][past].any() and not got[2][past].any(), f"{tag}: dk/dv at masked keys are not exactly 0")
        key = "attention_bias_bwd_bf16" if with_bias else "attention_bwd_bf16"
        worst[key] = max(worst[key], *errs)
        print(f"  {tag}: max |kernel - plain| " + ", ".join(f"{w} {e:.2e}" for w, e in zip(("dq", "dk", "dv", "dbias"), errs))
              + " (tol one bf16 step of the entry + one of the largest)")
    # the bf16 launchers' dropout bits: kept share and dependence on the
    # seed (the map is the f32 launchers', `check_attention_backward`)
    m1 = dropout_keep_mask(18, 399, 4, DROPOUT_RATE, 1, dev, bf)
    share = m1.float().mean().item()
    require(abs(share - (1 - DROPOUT_RATE)) < 1e-3, f"bf16 dropout keeps {share}, want {1 - DROPOUT_RATE}")
    differ = (m1 != dropout_keep_mask(18, 399, 4, DROPOUT_RATE, 2, dev, bf)).float().mean().item()
    require(abs(differ - 2 * DROPOUT_RATE * (1 - DROPOUT_RATE)) < 2e-3,
            f"bf16 dropout: two seeds differ at a share of {differ} of the elements")
    print(f"  bf16 dropout bits: kept share {share:.5f} at rate {DROPOUT_RATE}; two seeds differ at {differ:.4f}")
    # `k4_edge_cases`: no bias, a bias in f32 and one in bf16, dropout 0, 0.1
    # and 0.3; forward and backward launched twice (bit-identical)
    for name, (B, T, H, D), lens in k4_edge_cases(dev):
        q, k, v, d_out = (torch.randn(B, T, H, D, generator=gen, device=dev).to(bf) for _ in range(4))
        bias32 = torch.randn(B, H, T, T, generator=gen, device=dev) * D ** 0.5
        scale = 1.0 / D ** 0.5
        for bias in (None, bias32, bias32.to(bf)):
            for rate in K4_EDGE_RATES:
                seed = 4567890 + T
                mask = dropout_keep_mask(B, T, H, rate, seed, dev, bf) if rate > 0 else None

                def run():
                    ins = [x.clone().requires_grad_(True) for x in (q, k, v)] + (
                        [] if bias is None else [bias.clone().requires_grad_(True)])
                    out = fused_self_attention(*ins[:3], lens, scale=scale, dropout_rate=rate,
                                               deterministic=rate == 0.0, seed=seed,
                                               bias=None if bias is None else ins[3])
                    return (out.detach(), *torch.autograd.grad(out, ins, d_out))

                got = _twice(run)
                with torch.no_grad():
                    want = attention_bwd_plain(q, k, v, d_out, lens, scale, rate, bias, mask)
                    out0 = attention_plain(q, k, v, lens, scale, rate, bias=bias, dropout_mask=mask)
                tag = (f"attention bwd bf16 {name}, bias {None if bias is None else bias.dtype}, "
                       f"dropout {rate}")
                err_o = _max_err(got[0], out0)
                require(err_o <= ATTN_TOL[bf], f"{tag}: out max |kernel - plain| = {err_o} > {ATTN_TOL[bf]}")
                require(all(g.dtype == x.dtype for g, x in zip(got[1:], (q, k, v, bias) if bias is not None
                                                                   else (q, k, v))),
                        f"{tag}: gradients in another dtype than their inputs")
                errs = [_require_close_bf16(f"{tag} {what}", a, b)
                        for what, a, b in zip(("dq", "dk", "dv"), got[1:4], want[:3])]
                if bias is not None:
                    errs.append(_require_close_bf16(f"{tag} dbias", got[4].to(bias.dtype), want[3]))
                past = torch.arange(T, device=dev)[None, :] >= lens[:, None]
                require(not got[2][past].any() and not got[3][past].any(),
                        f"{tag}: dk/dv at masked keys are not exactly 0")
                key = "attention_bias_bwd_bf16" if bias is not None else "attention_bwd_bf16"
                worst[key] = max(worst[key], *errs)
        print(f"  attention bwd bf16 {name}, no bias / f32 / bf16 bias, dropout {K4_EDGE_RATES}: within one bf16 "
              f"step of each entry + one of the largest, out within {ATTN_TOL[bf]}; two launches bit-identical")
    return worst


# K7 in bf16: z is rounded to bf16 on both sides from the same f32 sum and
# tanh, so the log-probabilities differ by the order of J products: the f32
# tolerance, 1e-4.
def check_rnnt_joint_bf16(dev, gen) -> dict:
    """K7 in bf16 against `rnnt_joint_plain` (z in bf16, f32 logits):
    the shapes of `check_rnnt_joint` with the weight read in place."""
    from emoasr_tpu_torch.ops.rnnt_joint import rnnt_joint_plain

    worst = {"rnnt_joint_bf16": 0.0, "rnnt_joint_v4000_bf16": 0.0}
    for shape in ((18, 399, 129, 512, 1000), (18, 399, 129, 512, 4000), (5, 23, 37, 512, 4000),
                  (7, 9, 2, 96, 257)):
        h_enc, h_dec, weight, bias, labels = (x.bfloat16() if x.is_floating_point() else x
                                              for x in rnnt_joint_case(dev, gen, *shape))
        with torch.no_grad():
            want = rnnt_joint_plain(h_enc, h_dec, weight.t(), bias, labels, 0)
        err = _check_joint(f"rnnt joint bf16 {shape}", (h_enc, h_dec, weight.t(), bias, labels), want)
        for key in ("rnnt_joint_bf16", "rnnt_joint_v4000_bf16") if shape[4] == 4000 else ("rnnt_joint_bf16",):
            worst[key] = max(worst[key], err)
    return worst


def check_lstm_bf16(dev, gen) -> dict:
    """K8 in bf16 (x_proj, the states and what is stored bf16; the carry
    f32) against `lstm_fwd_plain` / `lstm_bwd_plain` at `LSTM_BF16_CASES`,
    w_hh the model's bf16 weight (one bf16 term on the tensor cores), each
    launched twice (bit-identical): ys, h_T, c_T and d x_proj, d h0, d c0 in
    bf16; d w_hh, of w_hh's dtype, is a sum over B T terms each taken from
    stored residuals that may sit one bf16 step apart on the two sides (each
    side's forward rounds its own f32 carry), so it is held like the bf16
    outputs, with a floor of a quarter step of its largest entry."""
    from emoasr_tpu_torch.ops.lstm_scan import lstm_bwd_plain, lstm_fwd_plain

    worst = {"lstm_fwd_bf16": 0.0, "lstm_bwd_bf16": 0.0}
    bf = torch.bfloat16
    for shape, zero in LSTM_BF16_CASES:
        x_proj, w_hh, h0, c0, cots = lstm_case(dev, gen, *shape, zero_state=zero)
        x_proj, w_hh, h0, c0 = x_proj.to(bf), w_hh.to(bf), h0.to(bf), c0.to(bf)
        cots = [c.to(bf) for c in cots]
        tag = f"lstm bf16 {shape}{' zero state' if zero else ''}"
        (ys, hT, cT), grads = lstm_twice(tag, [x_proj, w_hh, h0, c0], cots)
        with torch.no_grad():
            p_ys, p_h, p_c, gates, hcprev = lstm_fwd_plain(x_proj, w_hh, h0, c0)
            p_grads = lstm_bwd_plain(gates, hcprev, *cots, w_hh)
        torch.cuda.synchronize()
        fwd = [_require_close_bf16(f"{tag} {what}", a, b)
               for what, a, b in zip(("ys", "h_T", "c_T"), (ys, hT, cT), (p_ys, p_h, p_c))]
        bwd = [_require_close_bf16(f"{tag} {what}", a, b)
               for what, a, b in zip(("d x_proj", "d h0", "d c0"), (grads[0], grads[2], grads[3]),
                                     (p_grads[0], p_grads[2], p_grads[3]))]
        e_w = _require_close_bf16(f"{tag} d w_hh", grads[1], p_grads[1].to(bf), floor=BF16_STEP / 4)
        worst = {"lstm_fwd_bf16": max(worst["lstm_fwd_bf16"], *fwd),
                 "lstm_bwd_bf16": max(worst["lstm_bwd_bf16"], *bwd, e_w)}
        print(f"  {tag}: max |kernel - plain| ys {fwd[0]:.2e} h_T {fwd[1]:.2e} c_T {fwd[2]:.2e}; d x_proj {bwd[0]:.2e} "
              f"d h0 {bwd[1]:.2e} d c0 {bwd[2]:.2e}, d w_hh {e_w:.2e} (tol one bf16 step of the entry + the floor); "
              "twice, bit-identical")
    return worst


def check_rnnt_joint_wide(dev, gen) -> dict:
    """K7 above the width of 128 cells' z tile: J = 1024 (64 cells a block
    in bf16, 32 in f32), 1500 (16 in f32) and 2048 (32 in bf16, 16 in
    f32), float32 against `joint_gather_plain` and bf16 against
    `rnnt_joint_plain`, both within RNNT_JOINT_TOL (the outputs are float32
    sums of J products in two orders); each launched twice, bit-identical."""
    from emoasr_tpu_torch.ops.rnnt import joint_gather_plain
    from emoasr_tpu_torch.ops.rnnt_joint import rnnt_joint_plain

    worst = {"rnnt_joint_j1024": 0.0, "rnnt_joint_j1024_bf16": 0.0}
    for shape, transposed, dtypes in (((18, 399, 129, 1024, 1000), True, (torch.float32, torch.bfloat16)),
                                      ((3, 41, 13, 1500, 257), False, (torch.float32,)),
                                      ((2, 9, 5, 2048, 100), True, (torch.float32, torch.bfloat16))):
        case = rnnt_joint_case(dev, gen, *shape)
        for dtype in dtypes:
            h_enc, h_dec, weight, bias, labels = (x.to(dtype) if x.is_floating_point() else x for x in case)
            w = weight.t() if transposed else weight.t().contiguous()
            with torch.no_grad():
                want = (joint_gather_plain if dtype == torch.float32 else rnnt_joint_plain)(
                    h_enc, h_dec, w, bias, labels, 0)
            key = "rnnt_joint_j1024" + ("" if dtype == torch.float32 else "_bf16")
            worst[key] = max(worst[key], _check_joint(f"rnnt joint {shape} {dtype}{' weight.t()' if transposed else ''}",
                                                      (h_enc, h_dec, w, bias, labels), want))
    return worst


def rnnt_joint_edges() -> list:
    """(J, dtype) on both sides of each width at which K7's cells a block
    change (`launch_geometry`): bf16 128 | 64 | 32, f32 128 | 64 | 32 | 16."""
    from emoasr_tpu_torch.ops.rnnt_joint import MAX_J, launch_geometry

    out = []
    for dtype in (torch.float32, torch.bfloat16):
        prev = launch_geometry(1, 1, 1, 1, 1, dtype)["cells"]
        for J in range(2, MAX_J + 1):
            cells = launch_geometry(1, 1, 1, J, 1, dtype)["cells"]
            if cells != prev:
                out += [(J - 1, dtype), (J, dtype)]
                prev = cells
    return out


def check_rnnt_joint_edges(dev, gen) -> dict:
    """K7 at the edges of its tiling, each launched twice, bit-identical,
    against the plain version of its dtype within RNNT_JOINT_TOL: both
    sides of every change of cells a block (V = 4000 below, 257 above: a
    ragged last V tile), 143 cells of an utterance (ragged at every cell
    count); then a blank at V - 1 with labels outside [0, V), V = 40 (the
    second warp column sees no valid column), one cell (T = U+1 = 1, no
    labels), h_enc off a 16-byte boundary, J = 100 (not a multiple of 8)
    and a contiguous (J, V) weight in bf16 (both through the copy of w)."""
    from emoasr_tpu_torch.ops.rnnt import joint_gather_plain
    from emoasr_tpu_torch.ops.rnnt_joint import rnnt_joint_plain

    def one(tag, shape, dtype, blank=0, transposed=True, labels_edit=None, offset=False):
        h_enc, h_dec, weight, bias, labels = (x.to(dtype) if x.is_floating_point() else x
                                              for x in rnnt_joint_case(dev, gen, *shape))
        if labels_edit is not None:
            labels_edit(labels, shape[4])
        if offset:  # the same values one element into a fresh buffer: no longer 16-byte aligned
            buf = torch.empty(h_enc.numel() + 1, dtype=dtype, device=dev)
            buf[1:] = h_enc.reshape(-1)
            h_enc = buf[1:].view(h_enc.shape)
        w = weight.t() if transposed else weight.t().contiguous()
        with torch.no_grad():
            want = (joint_gather_plain if dtype == torch.float32 else rnnt_joint_plain)(
                h_enc, h_dec, w, bias, labels, blank)
        return _check_joint(f"rnnt joint edge {tag} {shape} {dtype}", (h_enc, h_dec, w, bias, labels), want, blank)

    def out_of_range(labels, V):
        labels[0, 0], labels[-1, 1] = -3, V + 5

    worst = {torch.float32: 0.0, torch.bfloat16: 0.0}
    for i, (J, dtype) in enumerate(rnnt_joint_edges()):
        worst[dtype] = max(worst[dtype], one(f"J={J}", (2, 13, 11, J, 4000 if i % 2 == 0 else 257), dtype))
    for dtype in (torch.float32, torch.bfloat16):
        for tag, shape, kw in (("blank V-1, labels out of range", (3, 17, 9, 512, 300),
                                {"blank": 299, "labels_edit": out_of_range}),
                               ("V=40", (2, 11, 7, 512, 40), {}), ("one cell", (2, 1, 1, 512, 300), {}),
                               ("h_enc misaligned", (2, 7, 5, 512, 300), {"offset": True}),
                               ("J % 8 = 4", (2, 7, 5, 100, 300), {}),
                               ("w (J, V) contiguous", (2, 7, 5, 512, 300), {"transposed": False})):
            worst[dtype] = max(worst[dtype], one(tag, shape, dtype, **kw))
    # every cells a block at one width where all fit: the same outputs, bit for bit
    from emoasr_tpu_torch.ops.rnnt_joint import CELLS, _launch, launch_geometry

    for dtype in (torch.float32, torch.bfloat16):
        h_enc, h_dec, weight, bias, labels = (x.to(dtype) if x.is_floating_point() else x
                                              for x in rnnt_joint_case(dev, gen, 3, 29, 17, 200, 1000))
        labels = labels.int()
        outs = {}
        for cells in CELLS[dtype]:
            geo = {**launch_geometry(3, 29, 17, 200, 1000, dtype), "cells": cells, "stages": 2}
            with torch.no_grad():
                outs[cells] = _launch(h_enc, h_dec, weight.t(), bias, labels, 0, geo)
        torch.cuda.synchronize()
        ref = outs[CELLS[dtype][0]]
        require(all(torch.equal(a, b) for o in outs.values() for a, b in zip(o, ref)),
                f"rnnt joint {dtype}: the outputs depend on the cells a block")
        print(f"  rnnt joint {dtype} (3, 29, 17, 200, 1000) at {', '.join(map(str, outs))} cells a block: "
              "bit-identical")
    return {"rnnt_joint_edges": worst[torch.float32], "rnnt_joint_edges_bf16": worst[torch.bfloat16]}


def check_lstm_wide(dev, gen) -> dict:
    """K8 above H = 512 (eight units a block forward): `LSTM_WIDE_CASES`,
    H = 1024 at the prediction network's largest bucket and at B = 1, T =
    256, and H = 640 with B = 50 (the batch in two tiles), each launched
    twice (bit-identical), float32 with the tolerances of `check_lstm` and
    bf16 with those of `check_lstm_bf16`; w_hh float32 of bf16 values in
    the bf16 runs (two terms, the second zero)."""
    from emoasr_tpu_torch.ops.lstm_scan import lstm_bwd_plain, lstm_fwd_plain

    worst = {"lstm_fwd_h1024": 0.0, "lstm_bwd_h1024": 0.0, "lstm_fwd_h1024_bf16": 0.0, "lstm_bwd_h1024_bf16": 0.0}
    for shape, zero in LSTM_WIDE_CASES:
        case = lstm_case(dev, gen, *shape, zero_state=zero)
        for dtype in (torch.float32, torch.bfloat16):
            x_proj, w_hh, h0, c0 = (t.to(dtype) for t in case[:4])
            w_hh = w_hh.float()  # a float32 weight (of bf16 values in the bf16 runs)
            cots = [c.to(dtype) for c in case[4]]
            tag = f"lstm {shape} {dtype}{' zero state' if zero else ''}"
            (ys, hT, cT), grads = lstm_twice(tag, [x_proj, w_hh, h0, c0], cots)
            with torch.no_grad():
                p_ys, p_h, p_c, gates, hcprev = lstm_fwd_plain(x_proj, w_hh, h0, c0)
                p_grads = lstm_bwd_plain(gates, hcprev, *cots, w_hh)
            torch.cuda.synchronize()
            sfx = "" if dtype == torch.float32 else "_bf16"
            if dtype == torch.float32:
                fwd = [_require_close(f"{tag} {what}", a, b, LSTM_FWD_TOL, 0.0)
                       for what, a, b in zip(("ys", "h_T", "c_T"), (ys, hT, cT), (p_ys, p_h, p_c))]
                bwd = [_require_close(f"{tag} {what}", a, b, *LSTM_BWD_TOL)
                       for what, a, b in zip(("d x_proj", "d w_hh", "d h0", "d c0"), grads, p_grads)]
            else:
                fwd = [_require_close_bf16(f"{tag} {what}", a, b)
                       for what, a, b in zip(("ys", "h_T", "c_T"), (ys, hT, cT), (p_ys, p_h, p_c))]
                bwd = [_require_close_bf16(f"{tag} {what}", a, b)
                       for what, a, b in zip(("d x_proj", "d h0", "d c0"), (grads[0], grads[2], grads[3]),
                                             (p_grads[0], p_grads[2], p_grads[3]))]
                bwd.append(_require_close_bf16(f"{tag} d w_hh", grads[1], p_grads[1], floor=BF16_STEP / 4))
            worst["lstm_fwd_h1024" + sfx] = max(worst["lstm_fwd_h1024" + sfx], *fwd)
            worst["lstm_bwd_h1024" + sfx] = max(worst["lstm_bwd_h1024" + sfx], *bwd)
            print(f"  {tag}: max |kernel - plain| forward {max(fwd):.2e}, backward {max(bwd):.2e} "
                  f"(tol as {'check_lstm' if dtype == torch.float32 else 'check_lstm_bf16'}); twice, bit-identical")
    return worst


def time_rnnt_joint(dev, gen, B: int, T: int, U1: int, J: int, V: int, dtype=torch.float32) -> dict:
    """K7 forward at the largest training bucket beside its plain version;
    the library route is the chunked mode's forward (`rnnt_gathered_from_
    joint`, 32-frame chunks of cuBLAS products, in `dtype`): no single call
    computes it."""
    from emoasr_tpu_torch.ops.rnnt import rnnt_gathered_from_joint
    from emoasr_tpu_torch.ops.rnnt_joint import fused_joint_gather, rnnt_joint_plain

    h_enc, h_dec, weight, bias, labels = (x.to(dtype) if x.is_floating_point() else x
                                          for x in rnnt_joint_case(dev, gen, B, T, U1, J, V))
    w = weight.t()
    row = {}
    with torch.no_grad():
        for key, fn, iters in (("ms", fused_joint_gather, 10), ("plain_ms", rnnt_joint_plain, 3),
                               ("library_ms", rnnt_gathered_from_joint, 3)):
            row[key] = cuda_time_ms(lambda: fn(h_enc, h_dec, w, bias, labels, 0), iters=iters, warmup=1)
    U, es = U1 - 1, h_enc.element_size()
    row.update(_bound(es * (B * T * J + B * U1 * J + J * V + V) + 4 * (B * U + B * T * U1 + B * T * U),
                      2.0 * B * T * U1 * J * V, dtype, 3 if dtype == torch.float32 else 0))
    row["shape"] = f"h_enc ({B},{T},{J}), h_dec ({B},{U1},{J}), w ({J},{V}), {dtype}"
    return {"rnnt_joint" + ("" if dtype == torch.float32 else "_bf16"): row}


def time_lstm(dev, gen, B: int, T: int, H: int, I: int, dtype=torch.float32) -> dict:
    """K8 forward and backward at the prediction network's largest bucket
    beside the plain versions; the library route is cuDNN's `nn.LSTM` of the
    same layer (input size I, in `dtype`), its input projection included.
    w_hh is of `dtype`, as the training step hands it over (in bf16 one
    bf16 term on the tensor cores).  The bound holds the operations to the
    arithmetic K8 runs in both storage types: float32 products (the carried
    h and d pre are float32) as `split_products` bf16 tensor-core products
    each (`_k8_products`), or the CUDA cores' f32 peak if that is lower."""
    from emoasr_tpu_torch.ops.lstm_scan import lstm_bwd_plain, lstm_fwd_plain, lstm_scan_fused

    x_proj, w_hh, h0, c0, cots = lstm_case(dev, gen, B, T, H)
    x_proj, w_hh, h0, c0 = x_proj.to(dtype), w_hh.to(dtype), h0.to(dtype), c0.to(dtype)
    cots = [c.to(dtype) for c in cots]
    cudnn = torch.nn.LSTM(I, H, batch_first=True).to(dev, dtype)
    x = torch.randn(B, T, I, generator=gen, device=dev).to(dtype)
    sfx = "" if dtype == torch.float32 else "_bf16"
    fwd, bwd = {}, {}
    with torch.no_grad():
        fwd["ms"] = cuda_time_ms(lambda: lstm_scan_fused(x_proj, w_hh, h0, c0), iters=20, warmup=2)
        fwd["plain_ms"] = cuda_time_ms(lambda: lstm_fwd_plain(x_proj, w_hh, h0, c0), iters=5, warmup=1)
        fwd["library_ms"] = cuda_time_ms(lambda: cudnn(x, (h0[None], c0[None])), iters=20, warmup=2)
        _, _, _, gates, hcprev = lstm_fwd_plain(x_proj, w_hh, h0, c0)
    ins = [t.clone().requires_grad_(True) for t in (x_proj, w_hh, h0, c0)]
    ys, (hT, cT) = lstm_scan_fused(*ins)
    bwd["ms"] = cuda_time_ms(_grad_timer((ys, hT, cT), ins, cots), iters=20, warmup=2)
    with torch.no_grad():
        bwd["plain_ms"] = cuda_time_ms(lambda: lstm_bwd_plain(gates, hcprev, *cots, w_hh), iters=5, warmup=1)
    x_ = x.clone().requires_grad_(True)
    out, (hn, cn) = cudnn(x_, (h0[None], c0[None]))
    lib_in = [x_, *cudnn.parameters()]
    bwd["library_ms"] = cuda_time_ms(
        _grad_timer((out, hn, cn), lib_in, (cots[0], cots[1][None], cots[2][None])), iters=20, warmup=2)
    H4, es = 4 * H, x_proj.element_size()
    # stored tensors, w_hh and d w_hh in `dtype`
    fwd_io = es * (B * T * H4 + 2 * B * H + B * T * H + T * B * H4 + T * B * 2 * H + 2 * B * H + H4 * H)
    bwd_io = es * (T * B * H4 + T * B * 2 * H + B * T * H + 2 * B * H + B * T * H4 + 2 * B * H + 2 * H4 * H)
    n = _k8_products(dtype)
    fwd.update(_bound(fwd_io, 2.0 * B * T * H4 * H + 10.0 * B * T * H, torch.float32, n))
    bwd.update(_bound(bwd_io, 4.0 * B * T * H4 * H + 20.0 * B * T * H, torch.float32, n))
    for r in (fwd, bwd):
        r["shape"] = f"x_proj ({B},{T},{H4}) {dtype}, w_hh ({H4},{H}) {w_hh.dtype}, {T} dependent steps"
    return {"lstm_fwd" + sfx: fwd, "lstm_bwd" + sfx: bwd}


def _k8_products(dtype) -> int:
    """bf16 tensor-core products K8 runs per float32 product: the f32
    operand (h_{t-1}, d pre) in two bf16 terms times w_hh (and h_{t-1} in
    d w_hh) in two terms in float32 (the three leading cross products), in
    one in bf16 (two products)."""
    from emoasr_tpu_torch.ops.lstm_scan import launch_geometry

    return 3 if launch_geometry(1, 1, 1, dtype)["w_terms"] == 2 else 2


def _grad_timer(outs, inputs, cots):
    """A closure that runs the backward from `outs` to `inputs` once."""
    return lambda: torch.autograd.grad(outs, inputs, cots, retain_graph=True)


def time_ctc_head(dev, gen, B: int, T: int, H: int, V: int, U: int, dtype=torch.float32) -> dict:
    """The three head kernels at the training shapes, beside the plain
    version and the library route (F.linear + logsumexp + gather), with e,
    w and b in `dtype`."""
    import torch.nn.functional as F

    from emoasr_tpu_torch.ops.ctc_head import ctc_head_plain, fused_ctc_head

    e, weight, bias, z, g_lse, g_xs, _ = head_case(dev, gen, B, T, H, V, U)
    e, weight, bias = e.to(dtype), weight.to(dtype), bias.to(dtype)
    S, N = z.shape[1], B * T
    idx = z.long()[:, None, :].expand(-1, T, -1)

    def library(e_, w_, b_):
        logits = F.linear(e_, w_, b_)
        return torch.logsumexp(logits, -1), torch.gather(logits, 2, idx)

    routes = {"ms": lambda e_, w_, b_: fused_ctc_head(e_, w_.t(), b_, z),
              "plain_ms": lambda e_, w_, b_: ctc_head_plain(e_, w_.t(), b_, z),
              "library_ms": library}
    sfx = "" if dtype == torch.float32 else "_bf16"
    rows = {f"ctc_head_fwd{sfx}": {}, f"ctc_head_grad_e{sfx}": {}, f"ctc_head_grad_w{sfx}": {}}
    fwd, ge, gw = rows.values()
    for key, fn in routes.items():
        with torch.no_grad():
            fwd[key] = cuda_time_ms(lambda: fn(e, weight, bias), iters=10, warmup=2)
        # a graph in which only e needs a gradient runs grad-e alone, and
        # one in which only the weights do runs grad-w alone
        e_ = e.clone().requires_grad_(True)
        outs = fn(e_, weight, bias)
        cots = tuple(g.to(o.dtype) for g, o in zip((g_lse, g_xs), outs))
        ge[key] = cuda_time_ms(_grad_timer(outs, (e_,), cots), iters=10, warmup=2)
        w_, b_ = weight.clone().requires_grad_(True), bias.clone().requires_grad_(True)
        gw[key] = cuda_time_ms(_grad_timer(fn(e, w_, b_), (w_, b_), cots), iters=10, warmup=2)
    es = e.element_size()
    io = es * (N * H + H * V + V) + 4 * B * S  # e, w, bias, z
    product, path = 2.0 * N * H * V, 2.0 * N * H * S
    split = 6 if dtype == torch.float32 else 0  # the six leading products of three bf16 terms
    fwd.update(_bound(io + 4 * (N + N * S), product + path, dtype, split))
    ge.update(_bound(io + 4 * (2 * N + N * S) + es * N * H, 2 * product + path, dtype, split))
    gw.update(_bound(io + 4 * (2 * N + N * S) + es * (H * V + V), 2 * product + path, dtype, split))
    for r in rows.values():
        r["shape"] = f"({B},{T},{H})x({H},{V}) S={S} {dtype}"
    return rows


def lattice_floor_kernel():
    """K2's `chain_only` variant (`tools/k2_parts.py`): each step's
    dependence alone, the latency floor of the shipped geometry; built from
    this tree's source beside the kernels."""
    import importlib.util

    from emoasr_tpu_torch.ops import ctc_lattice, cuda_lib

    spec = importlib.util.spec_from_file_location("k2_parts", os.path.join(REPO, "tools", "k2_parts.py"))
    k2_parts = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(k2_parts)
    with open(os.path.join(cuda_lib.CSRC_DIR, "ctc_lattice.cu")) as f:
        text = k2_parts.variant_sources(f.read())["chain_only"]
    out_dir = os.path.join(REPO, "build", "chip_smoke_floor")
    os.makedirs(out_dir, exist_ok=True)
    path = os.path.join(out_dir, "ctc_lattice_chain_only.cu")
    with open(path, "w") as f:
        f.write(text)
    return cuda_lib.CudaKernel(os.path.relpath(path, cuda_lib.CSRC_DIR), ctc_lattice.KERNEL.signatures,
                               name="ctc_lattice_chain_only")


def time_ctc_lattice(dev, gen, B: int, T: int, U: int, V: int, floor_kernel=None) -> dict:
    """alpha and beta kernels at the training shapes, beside the plain loop
    and `F.ctc_loss` (which takes dense (T, B, V) log-probabilities: another
    interface, timed as a yardstick only), and beside `floor_kernel`'s
    launches of the same shapes (`floor_ms`): the chain's latency floor."""
    import torch.nn.functional as F

    from emoasr_tpu_torch.ops import ctc_lattice
    from emoasr_tpu_torch.ops.ctc_lattice import ctc_ll_from_path, ctc_ll_plain

    lp = torch.log_softmax(torch.randn(T, B, V, generator=gen, device=dev), -1)
    labels = torch.randint(1, V, (B, U), generator=gen, device=dev)
    ylens = torch.randint(U // 4, U + 1, (B,), generator=gen, device=dev)
    xlens = torch.randint(2 * U + 1, T + 1, (B,), generator=gen, device=dev)
    xlens[0] = T
    from emoasr_tpu_torch.ops.ctc import _path_masks
    z, allow2f, initf, finalf = _path_masks(labels, ylens, 0)
    S = z.shape[1]
    lp_path = torch.gather(lp, 2, z[None].expand(T, -1, -1)).contiguous()
    g = torch.ones(B, device=dev)

    def library(x):
        return F.ctc_loss(x, labels, xlens, ylens, blank=0, reduction="none", zero_infinity=True)

    rows = {"ctc_alpha": {}, "ctc_beta_grad": {}}
    for key, fn, x in (("ms", lambda x: ctc_ll_from_path(x, allow2f, initf, finalf, xlens), lp_path),
                       ("plain_ms", lambda x: ctc_ll_plain(x, allow2f, initf, finalf, xlens), lp_path),
                       ("library_ms", library, lp)):
        iters = 3 if key == "plain_ms" else 20
        with torch.no_grad():
            rows["ctc_alpha"][key] = cuda_time_ms(lambda: fn(x), iters=iters, warmup=1)
        x_ = x.clone().requires_grad_(True)
        rows["ctc_beta_grad"][key] = cuda_time_ms(_grad_timer(fn(x_), (x_,), g), iters=iters, warmup=1)
    steps = int(xlens.sum().item())  # live (t, b) pairs: the loops end at xlens
    rows["ctc_alpha"].update(_bound(4 * (2 * steps * S + 3 * B * S + 2 * B), 12.0 * steps * S))
    rows["ctc_beta_grad"].update(_bound(4 * (2 * steps * S + T * B * S + 2 * B * S + 3 * B), 14.0 * steps * S))
    geo = ctc_lattice.launch_geometry(S)
    if floor_kernel is not None:
        masks = [m.float().contiguous() for m in (allow2f, initf, finalf)]
        xl = xlens.int().contiguous()
        alpha, grad = torch.empty(T, B, S, device=dev, dtype=torch.float64), torch.empty_like(lp_path)
        ll, ll64 = torch.empty(B, device=dev), torch.empty(B, device=dev, dtype=torch.float64)
        stream = torch.cuda.current_stream().cuda_stream
        st = (lp_path.stride(0), lp_path.stride(1), geo["spl"], geo["warps"], stream)
        fwd = (lp_path.data_ptr(), *(m.data_ptr() for m in masks), xl.data_ptr(), alpha.data_ptr(), ll.data_ptr(),
               ll64.data_ptr(), T, B, S, *st)
        rows["ctc_alpha"]["floor_ms"] = cuda_time_ms(lambda: floor_kernel.launch("emo_ctc_alpha_f32", *fwd),
                                                     iters=20, warmup=1)
        # the shipped forward's alpha and ll, so that the floor's backward has the same live rows
        ctc_lattice.KERNEL.launch("emo_ctc_alpha_f32", *fwd)
        rows["ctc_beta_grad"]["floor_ms"] = cuda_time_ms(lambda: floor_kernel.launch(
            "emo_ctc_beta_grad_f32", lp_path.data_ptr(), masks[0].data_ptr(), masks[2].data_ptr(), xl.data_ptr(),
            alpha.data_ptr(), ll64.data_ptr(), g.data_ptr(), grad.data_ptr(), T, B, S, *st),
            iters=20, warmup=1)
    for r in rows.values():
        r["shape"] = f"({T},{B},{S}) float32, {T - 1} dependent steps, {geo['warps']} warps x {geo['spl']} states"
    return rows


def time_attention_backward(dev, gen, B: int, T: int, H: int, D: int, lens: torch.Tensor,
                            dtype=torch.float32) -> dict:
    """Both backward passes with dropout 0.1, beside the plain version and
    SDPA's backward under autograd, in `dtype` (the bf16 plain version is
    `attention_bwd_plain`, the kernel's rounding)."""
    import torch.nn.functional as F

    from emoasr_tpu_torch.ops.attention import (attention_bwd_plain, attention_plain, dropout_keep_mask,
                                                fused_self_attention)

    q, k, v, d_out = (torch.randn(B, T, H, D, generator=gen, device=dev).to(dtype) for _ in range(4))
    scale, seed = 1.0 / D ** 0.5, 99
    mask = dropout_keep_mask(B, T, H, DROPOUT_RATE, seed, dev, dtype)
    key_mask = (torch.arange(T, device=dev)[None, :] < lens[:, None])[:, None, None, :]
    q_, k_, v_ = (x.clone().requires_grad_(True) for x in (q, k, v))
    qt, kt, vt = (x.transpose(1, 2) for x in (q_, k_, v_))
    graphs = {
        "ms": fused_self_attention(q_, k_, v_, lens, scale=scale, dropout_rate=DROPOUT_RATE,
                                   deterministic=False, seed=seed),
        "library_ms": F.scaled_dot_product_attention(
            qt, kt, vt, attn_mask=key_mask, dropout_p=DROPOUT_RATE, scale=scale).transpose(1, 2),
    }
    if dtype == torch.float32:
        graphs["plain_ms"] = attention_plain(q_, k_, v_, lens, scale, DROPOUT_RATE, dropout_mask=mask)
    row = {key: cuda_time_ms(_grad_timer(out, (q_, k_, v_), d_out), iters=20, warmup=2)
           for key, out in graphs.items()}
    if dtype != torch.float32:
        row["plain_ms"] = cuda_time_ms(lambda: attention_bwd_plain(q, k, v, d_out, lens, scale, DROPOUT_RATE,
                                                                   None, mask), iters=20, warmup=2)
    pairs = T * int(lens.clamp(max=T).sum().item())  # (query, valid key) pairs per head
    row.update(_bound(q.element_size() * 8 * B * T * H * D + 4 * (B * H * T + B), 10.0 * H * D * pairs, dtype,
                      _split_products(dtype)))
    row["shape"] = f"({B},{T},{H},{D}) {dtype}, dropout {DROPOUT_RATE}"
    return row


# ---------------------------------------------------------------- main paths

class Launches(dict):
    """Launch counts by launcher; `topk_shapes`: K3's launches by shape
    class, (V, k, dtype)."""

    def __init__(self, counts: dict, topk_shapes: dict):
        super().__init__(counts)
        self.topk_shapes = topk_shapes


# the kernels' launchers, by the name each has on the `kernels` line
def launch_counts() -> dict:
    from emoasr_tpu_torch.ops import (attention, ctc_head, ctc_lattice, decoder_step, lm_step, lstm_scan,
                                      rnnt_joint, topk)

    counts = {
        "rnnt_joint": rnnt_joint.KERNEL.counts["emo_rnnt_joint_f32"],
        "lstm_fwd": lstm_scan.KERNEL.counts["emo_lstm_fwd_f32"],
        "lstm_bwd": lstm_scan.KERNEL.counts["emo_lstm_bwd_f32"],
        "lm_step_indirect": lm_step.KERNEL.counts["emo_lm_step_indirect_f32"],
        "attention_bias_fwd": attention.KERNEL.counts["bias_fwd"],
        "attention_bias_bwd": attention.KERNEL.counts["bias_bwd"],
        "decoder_step": decoder_step.KERNEL.counts["emo_decoder_step_f32"],
        "decoder_step_indirect": decoder_step.KERNEL_INDIRECT.counts["emo_decoder_step_indirect_f32"],
        "topk": topk.KERNEL.launches,
        "attention_fwd": attention.KERNEL.counts["emo_attention_fwd_f32"],
        "attention_bwd": attention.KERNEL.counts["emo_attention_bwd_f32"],
        "ctc_head_fwd": ctc_head.KERNEL.counts["emo_ctc_head_fwd_f32"],
        "ctc_head_grad_e": ctc_head.KERNEL.counts["emo_ctc_head_grad_e_f32"],
        "ctc_head_grad_w": ctc_head.KERNEL.counts["emo_ctc_head_grad_w_f32"],
        "ctc_alpha": ctc_lattice.KERNEL.counts["emo_ctc_alpha_f32"],
        "ctc_beta_grad": ctc_lattice.KERNEL.counts["emo_ctc_beta_grad_f32"],
        # the bf16 launchers
        "attention_fwd_bf16": attention.KERNEL.counts["emo_attention_fwd_bf16"],
        "attention_bwd_bf16": attention.KERNEL.counts["emo_attention_bwd_bf16"],
        "attention_bias_fwd_bf16": attention.KERNEL.counts["bias_fwd_bf16"],
        "attention_bias_bwd_bf16": attention.KERNEL.counts["bias_bwd_bf16"],
        "ctc_head_fwd_bf16": ctc_head.KERNEL.counts["emo_ctc_head_fwd_bf16"],
        "ctc_head_grad_e_bf16": ctc_head.KERNEL.counts["emo_ctc_head_grad_e_bf16"],
        "ctc_head_grad_w_bf16": ctc_head.KERNEL.counts["emo_ctc_head_grad_w_bf16"],
        "rnnt_joint_bf16": rnnt_joint.KERNEL.counts["emo_rnnt_joint_bf16"],
        "lstm_fwd_bf16": lstm_scan.KERNEL.counts["emo_lstm_fwd_bf16"],
        "lstm_bwd_bf16": lstm_scan.KERNEL.counts["emo_lstm_bwd_bf16"],
        "decoder_step_bf16": decoder_step.KERNEL.counts["emo_decoder_step_bf16"],
        "decoder_step_indirect_bf16": decoder_step.KERNEL_INDIRECT.counts["emo_decoder_step_indirect_bf16"],
        "lm_step_indirect_bf16": lm_step.KERNEL.counts["emo_lm_step_indirect_bf16"],
        # the vocabulary split: K7's launcher with the column offset; K1 at V = 5000 is its usual
        # launcher, counted on phase 29's (1, 2) rank programs (`vocab_phase_finish`)
        "rnnt_joint_shard": rnnt_joint.KERNEL.counts["emo_rnnt_joint_shard_f32"],
        "rnnt_joint_shard_bf16": rnnt_joint.KERNEL.counts["emo_rnnt_joint_shard_bf16"],
        "ctc_head_fwd_v5000": 0, "ctc_head_grad_e_v5000": 0, "ctc_head_grad_w_v5000": 0,
    }
    return Launches(counts, topk_shapes=dict(topk.SHAPE_LAUNCHES))


BF16_KEYS = ("attention_fwd_bf16", "attention_bwd_bf16", "attention_bias_fwd_bf16", "attention_bias_bwd_bf16",
             "ctc_head_fwd_bf16", "ctc_head_grad_e_bf16", "ctc_head_grad_w_bf16", "rnnt_joint_bf16",
             "lstm_fwd_bf16", "lstm_bwd_bf16", "decoder_step_bf16", "decoder_step_indirect_bf16",
             "lm_step_indirect_bf16")


def all_kernels() -> list:
    from emoasr_tpu_torch.ops import (attention, ctc_head, ctc_lattice, decoder_step, lm_step, lstm_scan,
                                      rnnt_joint, topk)

    return [topk.KERNEL, attention.KERNEL, ctc_head.KERNEL, ctc_lattice.KERNEL,
            decoder_step.KERNEL, decoder_step.KERNEL_INDIRECT, lm_step.KERNEL, rnnt_joint.KERNEL,
            lstm_scan.KERNEL]


def reset_launch_counts() -> None:
    from emoasr_tpu_torch.ops import lstm_scan, topk

    for kernel in all_kernels():
        kernel.reset_counts()
    topk.SHAPE_LAUNCHES.clear()
    lstm_scan.SHAPE_LAUNCHES.clear()


def write_vocab(root: str, vocab_size: int) -> str:
    vocab = os.path.join(root, "vocab.txt")
    with open(vocab, "w", encoding="utf-8") as f:
        f.write("\n".join(["<blank> 0", "<unk> 1", "<eos> 2"]
                          + [f"▁w{i} {i}" for i in range(3, vocab_size)]) + "\n")
    return vocab


def write_corpus(root: str, name: str, lengths, vocab_size: int, feat_dim: int, seed: int):
    """Synthetic manifest `<name>.tsv`: one utterance of random features per
    entry of `lengths` (frames), 5-40 random token ids over the whole
    vocabulary, utt ids carrying start/end times (ms)."""
    import pandas as pd

    rng = np.random.default_rng(seed)
    os.makedirs(os.path.join(root, f"feats_{name}"))
    rows, frames = [], 0
    for i, T in enumerate(lengths):
        U = int(rng.integers(5, 40))
        path = os.path.join(root, f"feats_{name}", f"utt{i}.npy")
        np.save(path, rng.standard_normal(size=(T, feat_dim), dtype=np.float32))
        toks = rng.integers(3, vocab_size, size=U)
        start = i * 100000
        rows.append(dict(
            feat_path=path, utt_id=f"spk{i % 7}-utt{i}-{start}-{start + T * 10}",
            token_id=" ".join(map(str, toks)), text=" ".join(f"w{t}" for t in toks),
            xlen=T, ylen=U,
        ))
        frames += T
    tsv = os.path.join(root, f"{name}.tsv")
    pd.DataFrame(rows).to_csv(tsv, sep="\t", index=False)
    return tsv, frames * 0.010


def train_lengths(cfg, batches_per_bucket):
    """Utterance lengths, sorted, that fill `batches_per_bucket[i]` whole
    batches of the i-th bucket (shortest first), spread over 200..1600."""
    from emoasr_tpu_torch.data.batching import derive_buckets

    buckets = derive_buckets(cfg.buckets, cfg.max_xlens_batch, cfg.max_ylens_batch, cfg.batch_size)
    lengths, lo = [], 199
    for b, n_batches in zip(buckets, batches_per_bucket):
        n = b.batch_size * n_batches
        lengths += [lo + 1 + ((b.max_xlen - lo - 1) * j) // max(n - 1, 1) for j in range(n)]
        lo = b.max_xlen
    return lengths, buckets


def read_train_log(conf_path: str):
    """(per-step loss_total, per-step lr, epoch seconds) from the trainer's log."""
    import re

    losses, lrs, epoch_s = [], [], []
    with open(os.path.join(os.path.splitext(conf_path)[0], "log", "train.log")) as f:
        for line in f:
            m = re.search(r"step \d+/\d+ .*loss_total: (\S+) lr: (\S+)", line)
            if m:
                losses.append(float(m.group(1)))
                lrs.append(float(m.group(2)))
            m = re.search(r"epoch \d+ done in ([0-9.]+)s", line)
            if m:
                epoch_s.append(float(m.group(1)))
    return losses, lrs, epoch_s


def train_full_width(args, root: str, card: str, compute_dtype: str = "float32",
                     per_bucket=(2, 2, 2, 2, 3), profile: bool = False) -> dict:
    """Train the L1 model at full width through the port's train CLI:
    SpecAugment and dropout on, one epoch over all five buckets (by
    default 11 micro-steps: two optimizer updates at accum_grad 5 and one
    open micro-step), in `compute_dtype` (bfloat16: the forward on a bf16
    copy of the float32 masters, K1 and K4 through their bf16 launchers).
    `profile`: with `--profile` (batches 8-12 traced; the trace must name
    K1's, K2's and K4's kernels)."""
    import yaml

    from emoasr_tpu_torch.config import load_config
    from emoasr_tpu_torch.models.asr import ASR
    from emoasr_tpu_torch.train import loop
    from emoasr_tpu_torch.train.checkpoint import load_state_dict
    from emoasr_tpu_torch.train.optim import make_lr_fn

    with open(L1_CONF) as f:
        conf = yaml.safe_load(f)
    cfg0 = load_config(L1_CONF)
    per_bucket = list(per_bucket)
    half = compute_dtype != "float32"
    lengths, buckets = train_lengths(cfg0, per_bucket)
    train_tsv, _ = write_corpus(root, "train", lengths, conf["vocab_size"], conf["feat_dim"], args.seed + 1)
    n_test = args.n_utts
    test_tsv, wav_s = write_corpus(
        root, "test", [200 + (1400 * i) // max(n_test - 1, 1) for i in range(n_test)],
        conf["vocab_size"], conf["feat_dim"], args.seed)
    conf.update(vocab_path=write_vocab(root, conf["vocab_size"]), train_path=train_tsv,
                test_path=test_tsv, dev_path=None, enc_fused_attn=True, num_epochs=1,
                save_step=1, log_step=1, seed=args.seed, compute_dtype=compute_dtype)
    conf_path = os.path.join(root, "l1_ctc_transformer.yaml")
    with open(conf_path, "w") as f:
        yaml.safe_dump(conf, f)
    cfg = load_config(conf_path)
    require((cfg.enc_num_layers, cfg.enc_hidden_size, cfg.enc_num_attention_heads,
             cfg.enc_intermediate_size, cfg.vocab_size, cfg.accum_grad, cfg.spec_augment,
             cfg.dropout_enc_rate, cfg.dropout_attn_rate) == (12, 256, 4, 2048, 10000, 5, True, 0.1, 0.1),
            "the L1 config is not at full width with SpecAugment and dropout on")
    n_steps, n_utts = sum(per_bucket), len(lengths)

    prof = os.path.join(root, "train_trace")
    reset_launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    state = loop.main(["-conf", conf_path] + (["--profile", prof] if profile else []))
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    launches = launch_counts()
    traced = None
    if profile:
        traced = require_traced(os.path.join(prof, "train_steps.pt.trace.json"), "the train CLI's --profile",
                                {"K1": "ctc_head_fwd_kernel", "K2": "ctc_alpha_kernel", "K4 fwd": "fwd_f32",
                                 "K4 bwd": "bwd_dq"})
        print(f"  --profile: batches 8-12 of the epoch traced, kernel events {traced}")

    losses, lrs, epoch_s = read_train_log(conf_path)
    require(state.step == n_steps and len(losses) == n_steps,
            f"training took {state.step} micro-steps and logged {len(losses)}, want {n_steps}")
    require(all(np.isfinite(losses)), f"a training loss is not finite: {losses}")
    require(state.skipped == 0, f"{state.skipped} micro-steps were skipped")
    require(state.mini_step == n_steps % cfg.accum_grad, f"open accumulation holds {state.mini_step} micro-steps")
    lr_fn = make_lr_fn(cfg)
    want_lr = lr_fn(n_steps // cfg.accum_grad)
    got_lr = state.optimizer.param_groups[0]["lr"]
    require(abs(got_lr - want_lr) <= 1e-12 * want_lr + 1e-30, f"optimizer LR {got_lr}, noam gives {want_lr}")
    require(abs(lrs[-1] - lr_fn((n_steps + cfg.accum_grad - 1) // cfg.accum_grad)) < 1e-6, "logged LR is not the noam value")
    want = {"ctc_head_fwd": n_steps, "ctc_head_grad_e": n_steps, "ctc_head_grad_w": n_steps,
            "ctc_alpha": n_steps, "ctc_beta_grad": n_steps,
            "attention_fwd": cfg.enc_num_layers * n_steps, "attention_bwd": cfg.enc_num_layers * n_steps,
            "topk": 0, "attention_bias_fwd": 0, "attention_bias_bwd": 0, "decoder_step": 0,
            "decoder_step_indirect": 0, "lm_step_indirect": 0, "rnnt_joint": 0, "lstm_fwd": 0, "lstm_bwd": 0,
            **{k: 0 for k in BF16_KEYS}, **{k: 0 for k in SHARD_KEYS}}
    if half:  # the same kernels, launched through their bf16 launchers
        for k in ("ctc_head_fwd", "ctc_head_grad_e", "ctc_head_grad_w", "attention_fwd", "attention_bwd"):
            want[f"{k}_bf16"], want[k] = want[k], 0
    require(launches == want, f"training launches {launches}, want {want}")

    ckpt = os.path.join(os.path.splitext(conf_path)[0], "checkpoints", "model.ep1")
    require(os.path.exists(ckpt) and os.path.exists(ckpt.replace("model.", "optim.")),
            "the trainer wrote no model.ep1 / optim.ep1")
    torch.manual_seed(cfg.seed)
    init, trained = ASR(cfg).state_dict(), load_state_dict(ckpt)
    changed = [k for k in init if not torch.equal(init[k], trained[k])]
    require(len(changed) >= 0.9 * len(init) and "decoder.output.weight" in changed
            and "encoder.conv.conv.0.weight" in changed,
            f"only {len(changed)} of {len(init)} parameter tensors changed in training")
    for k, v in trained.items():
        require(bool(torch.isfinite(v).all()), f"trained parameter {k} is not finite")
    _require_f32_masters(state, trained)
    epoch = epoch_s[0] if epoch_s else float("nan")
    print(f"  trained {n_steps} {compute_dtype} micro-steps ({n_utts} utts, buckets x{per_bucket}) in {dt:.2f} s "
          f"(the epoch loop {epoch:.2f} s: {n_steps / epoch:.2f} micro-steps/s, {n_utts / epoch:.1f} utt/s, "
          f"first call, warm-up included) on {card}")
    print(f"  loss {losses[0]:.2f} -> {losses[-1]:.2f}, skipped 0, LR {got_lr:.4e} (noam), "
          f"{len(changed)}/{len(init)} tensors changed; launches {launches}")
    return {"conf_path": conf_path, "cfg": cfg, "ckpt": ckpt, "test_tsv": test_tsv, "train_tsv": train_tsv,
            "wav_s": wav_s, "launches": launches, "seconds": dt, "epoch_seconds": epoch,
            "micro_steps": n_steps, "micro_steps_per_s": n_steps / epoch, "utt_per_s": n_utts / epoch,
            "losses": losses, "buckets": buckets, "trace_kernels": traced}


def _require_f32_masters(state, checkpoint: dict) -> None:
    """The trainer's parameters and Adam moments, and the checkpoint it
    wrote, are float32 whatever the compute dtype."""
    require(all(p.dtype == torch.float32 for p in state.model.parameters()), "a master parameter is not float32")
    moments = [v for st in state.optimizer.state.values() for v in st.values()
               if torch.is_tensor(v) and v.is_floating_point() and v.dim() > 0]
    require(moments and all(v.dtype == torch.float32 for v in moments), "an Adam moment is not float32")
    require(all(v.dtype == torch.float32 for v in checkpoint.values() if v.is_floating_point()),
            "the checkpoint holds a tensor that is not float32")


# one micro-step, card against CPU: loss rtol 1e-4; each gradient tensor
# within 5e-3 of its largest CPU entry (12 layers of f32 sums in other
# orders, the lattice's posterior at 1e-3; see LATTICE_TOL) plus 1e-5 of the
# largest gradient entry of the whole model (the key biases' true gradient
# is zero, softmax being invariant to a per-query constant: what they hold
# is rounding noise).  The output layer's gradient is held more closely: its
# blank and label columns are orders of magnitude larger than the columns on
# no path, which hold only the softmax term, so the weight is compared
# vocabulary column by column (5e-3 of the column's own largest entry + 1e-7)
# and the bias in two groups (columns on a path of this batch, the others).
# The L4 micro-step is held to the same: its sums differ in order in K4, K7
# (J = 512 products), K8 (129 steps) and the chunked joint backward; its
# lattice runs in float64 on both sides.
STEP_TOL = {"loss": 1e-4, "grad": 5e-3, "grad_floor": 1e-5, "column_atol": 1e-7}


def check_micro_step(tr: dict, dev, want_used: dict, heads=None) -> dict:
    """Loss (and each loss term) and gradients of one micro-step at full
    width, 4 rows of the 400-frame bucket, dropout and SpecAugment off: the
    card (kernels, each launched as often as `want_used` says) against the
    CPU (plain versions), on the trainer's checkpoint (with its soft labels
    where `tr` names a `kd_label_path`).  `heads`: the
    vocabulary-sized output layers, held by vocabulary column, with a
    function of the batch giving the columns on its paths (by default the
    CTC or RNN-T head, `decoder.output`, whose paths are the labels and
    blank)."""
    from emoasr_tpu_torch.data.asr_dataset import ASRDataset
    from emoasr_tpu_torch.eval.test_asr import load_asr_model

    cfg = tr["cfg"]
    heads = heads or (("decoder.output", lambda b: np.append(b["ys"][:4].reshape(-1), cfg.blank_id)),)
    ds = ASRDataset(cfg, tr["train_tsv"], phase="train", kd_label_path=tr.get("kd_label_path"))
    batcher = ds.make_batcher(shuffle=False)
    bi, idx = next(b for b in batcher if batcher.buckets[b[0]].max_xlen == 400)
    batch = ds.collate(idx[:4], 400, batcher.buckets[bi].max_ylen)
    res = {}
    for name, d in (("cuda", dev), ("cpu", torch.device("cpu"))):
        model = load_asr_model(tr["ckpt"], cfg).to(d).eval()
        t = {k: torch.from_numpy(v).to(d) for k, v in batch.items() if isinstance(v, np.ndarray)}
        before = launch_counts()
        loss, loss_dict = model(t["xs"], t["xlens"], t["ys"], t["ylens"], t["ys_in"], t["ys_out"],
                                t.get("soft_labels"))
        params = dict(model.named_parameters())
        grads = torch.autograd.grad(loss, list(params.values()))
        used = {k: launch_counts()[k] - before[k] for k in before}
        if name == "cuda":
            require(all(used[k] == n for k, n in want_used.items()),
                    f"the micro-step check did not go through the kernels: {used}, want {want_used}")
        res[name] = ({k: v.item() for k, v in loss_dict.items()}, {k: g.cpu() for k, g in zip(params, grads)})
    (d1, g1), (d0, g0) = res["cuda"], res["cpu"]
    l1, l0 = d1["loss_total"], d0["loss_total"]
    for k in d0:
        require(np.isfinite(d1[k]) and abs(d1[k] - d0[k]) <= STEP_TOL["loss"] * abs(d0[k]),
                f"micro-step {k}: card {d1[k]}, CPU {d0[k]}")
    worst, worst_name = 0.0, "none: every error is below the floor"
    floor = STEP_TOL["grad_floor"] * max(g.abs().max().item() for g in g0.values())
    for k in g0:
        scale = g0[k].abs().max().item()
        rel = max(_max_err(g1[k], g0[k]) - floor, 0.0) / max(scale, 1e-30)
        if rel > worst:
            worst, worst_name = rel, k
        require(rel <= STEP_TOL["grad"], f"micro-step gradient of {k}: card vs CPU {rel:.3e} of its largest entry")
    by_head = {}
    for head, on_path_of in heads:
        _, rel_w = _require_close_by_column(f"micro-step gradient of {head}.weight", g1[f"{head}.weight"],
                                            g0[f"{head}.weight"], 0, STEP_TOL["column_atol"], STEP_TOL["grad"])
        on_path = torch.from_numpy(np.unique(on_path_of(batch)).astype(np.int64))
        rel_b = _require_close_by_group(f"micro-step gradient of {head}.bias", g1[f"{head}.bias"],
                                        g0[f"{head}.bias"], _vocab_groups(cfg.vocab_size, on_path),
                                        STEP_TOL["column_atol"], STEP_TOL["grad"])
        by_head[head] = (rel_w, rel_b)
    terms = ", ".join(f"{k} {d1[k]:.4f} vs {d0[k]:.4f}" for k in d0)
    print(f"  one micro-step {tuple(batch['xs'].shape)} card vs CPU plain: {terms}; "
          f"worst gradient {worst:.2e} of its largest entry ({worst_name}; tol {STEP_TOL['grad']}, floor {floor:.2e}); "
          + "; ".join(f"{h}: weight by vocabulary column {w:.2e} of the column's largest entry, bias by group {b:.2e}"
                      for h, (w, b) in by_head.items()))
    rel_w, rel_b = by_head[heads[0][0]]
    return {"loss_card": l1, "loss_cpu": l0, "loss_terms_card": d1, "loss_terms_cpu": d0,
            "worst_grad_rel_err": worst, "grad_floor": floor,
            "output_weight_column_rel_err": rel_w, "output_bias_group_rel_err": rel_b,
            "heads": {h: {"weight_column_rel_err": w, "bias_group_rel_err": b} for h, (w, b) in by_head.items()}}


def time_micro_step(tr: dict, dev, card: str) -> dict:
    """Where one micro-step of the largest bucket spends its time (host
    clock around synchronised phases, dropout on; the last of three), in
    the trainer's compute dtype (bf16: the casts of the masters are in the
    encoder's phase)."""
    from emoasr_tpu_torch.utils.precision import dtype_of

    from emoasr_tpu_torch.data.asr_dataset import ASRDataset
    from emoasr_tpu_torch.eval.test_asr import load_asr_model
    from emoasr_tpu_torch.train.optim import build_optimizer, clip_by_global_norm_

    cfg = tr["cfg"]
    big = max(tr["buckets"], key=lambda b: b.max_xlen)
    ds = ASRDataset(cfg, tr["train_tsv"], phase="train")
    bi, idx = next(b for b in ds.make_batcher(shuffle=False) if b[0] == len(tr["buckets"]) - 1)
    batch = ds.collate(idx, big.max_xlen, big.max_ylen)
    t = {k: torch.from_numpy(v).to(dev) for k, v in batch.items() if isinstance(v, np.ndarray)}
    model = load_asr_model(tr["ckpt"], cfg).to(dev).train()
    params = list(model.parameters())
    opt = build_optimizer(cfg, params)
    for g in opt.param_groups:
        g["lr"] = 1e-7

    def tick():
        torch.cuda.synchronize()
        return time.perf_counter()

    dt = dtype_of(cfg)
    xs = t["xs"].to(dt)
    for _ in range(3):
        t0 = tick()
        with compute_params(model, dt):
            eouts, elens, inter = model.encoder(xs, t["xlens"])
            t1 = tick()
            loss, _, _ = model.decoder(eouts, elens, inter, t["ys"], t["ylens"], t["ys_in"], t["ys_out"])
        t2 = tick()
        grads = torch.autograd.grad(loss, params)
        t3 = tick()
        clip_by_global_norm_(grads, cfg.clip_grad_norm)
        for p, g in zip(params, grads):
            p.grad = g
        opt.step()
        t4 = tick()
    head_phase = {"transformer": "attention decoder + label smoothing + aux CTC head and lattice",
                  "las": "LAS decoder (a step a label) + label smoothing"}.get(cfg.decoder_type, "CTC head + lattice")
    split = {"batch": list(t["xs"].shape), "compute_dtype": cfg.compute_dtype, "encoder_fwd_ms": (t1 - t0) * 1e3,
             "ctc_fwd_ms": (t2 - t1) * 1e3, "backward_ms": (t3 - t2) * 1e3, "clip_adam_ms": (t4 - t3) * 1e3}
    print(f"  one {tuple(t['xs'].shape)} {cfg.compute_dtype} micro-step on {card}: encoder forward "
          f"{split['encoder_fwd_ms']:.2f} ms, "
          f"{head_phase} forward {split['ctc_fwd_ms']:.2f} ms, backward {split['backward_ms']:.2f} ms, "
          f"clip + Adam {split['clip_adam_ms']:.2f} ms")
    return split


@contextlib.contextmanager
def compute_params(model, dtype: torch.dtype):
    """Inside, every floating parameter of `model` reads as its cast to
    `dtype`, recorded by autograd (so gradients reach the float32 masters),
    as the train step's forward sees them under a half `compute_dtype`;
    float32 leaves the model as it is.  The casts are made on entry."""
    if dtype == torch.float32:
        yield
        return
    params = [(m, n, p) for m in model.modules() for n, p in list(m._parameters.items())
              if p is not None and p.is_floating_point()]
    casts = {id(p): p.to(dtype) for _, _, p in params}
    try:
        for m, n, p in params:
            del m._parameters[n]
            setattr(m, n, casts[id(p)])
        yield
    finally:
        for m, n, p in params:
            delattr(m, n)
            m._parameters[n] = p


# bf16 against f32 on the card: one micro-step of the bf16 trainer's
# model.ep1 (float32 masters) on one batch, dropout and SpecAugment off, once
# with compute_dtype bfloat16 and once float32.  The loss within 2 % (the
# JAX package's own bf16 test, tests/test_bf16.py, holds its bf16 loss to 2 %
# of its f32 loss); each gradient tensor's error is reported relative to its
# float32 counterpart's largest entry, above a floor of one bf16 step of the
# model's largest entry (bf16 rounds every activation, so a first layer's
# sums over all frames carry errors of some 10 %); the whole gradient must
# point the same way, cosine >= 0.99.
BF16_LOSS_RTOL = 0.02
BF16_GRAD_COSINE = 0.99


def check_bf16_micro_step(tr: dict, dev, want_used: dict) -> dict:
    """The bf16 trainer's checkpoint, one batch of 4 rows of the 400-frame
    bucket: loss and gradients of the bf16 micro-step (through the bf16
    launchers, each launched as often as `want_used` says) against the
    float32 micro-step's on the card."""
    import dataclasses

    from emoasr_tpu_torch.data.asr_dataset import ASRDataset
    from emoasr_tpu_torch.eval.test_asr import load_asr_model
    from emoasr_tpu_torch.train.step import compute_loss
    from emoasr_tpu_torch.utils.device import set_matmul_precision

    cfg16 = tr["cfg"]
    ds = ASRDataset(cfg16, tr["train_tsv"], phase="train")
    batcher = ds.make_batcher(shuffle=False)
    bi, idx = next(b for b in batcher if batcher.buckets[b[0]].max_xlen == 400)
    batch = ds.collate(idx[:4], 400, batcher.buckets[bi].max_ylen)
    t = {k: torch.from_numpy(v).to(dev) for k, v in batch.items() if isinstance(v, np.ndarray)}
    model = load_asr_model(tr["ckpt"], cfg16).to(dev).eval()
    params = dict(model.named_parameters())
    res = {}
    for cfg in (cfg16, dataclasses.replace(cfg16, compute_dtype="float32")):
        set_matmul_precision(cfg.compute_dtype)  # as the train CLI sets it for this dtype
        before = launch_counts()
        loss, _ = compute_loss(model, cfg, t, None, False)
        grads = torch.autograd.grad(loss, list(params.values()))
        used = {k: launch_counts()[k] - before[k] for k in before}
        res[cfg.compute_dtype] = (loss.item(), dict(zip(params, grads)), used)
    (l16, g16, used16), (l32, g32, _) = res["bfloat16"], res["float32"]
    require(all(used16[k] == n for k, n in want_used.items()),
            f"the bf16 micro-step did not go through the bf16 kernels: {used16}, want {want_used}")
    require(all(g.dtype == torch.float32 and bool(torch.isfinite(g).all()) for g in g16.values()),
            "a bf16 micro-step's gradient is not finite float32")
    rel_loss = abs(l16 - l32) / abs(l32)
    require(np.isfinite(l16) and rel_loss <= BF16_LOSS_RTOL, f"bf16 micro-step loss {l16} vs f32 {l32}")
    # a floor of one bf16 step of the model's largest gradient entry: the key
    # biases' true gradient is zero (see STEP_TOL), what they hold is noise
    floor = BF16_STEP * max(g.abs().max().item() for g in g32.values())
    rel = {k: max(_max_err(g16[k], g32[k]) - floor, 0.0) / max(g32[k].abs().max().item(), 1e-30) for k in params}
    flat16 = torch.cat([g.reshape(-1).double() for g in g16.values()])
    flat32 = torch.cat([g.reshape(-1).double() for g in g32.values()])
    cosine = (flat16 @ flat32 / (flat16.norm() * flat32.norm())).item()
    require(cosine >= BF16_GRAD_COSINE, f"bf16 micro-step gradient: cosine {cosine} with the f32 one")
    worst = sorted(rel.items(), key=lambda kv: -kv[1])[:8]
    errs = np.array(list(rel.values()))
    shares = {f"below_{c}": float((errs < c).mean()) for c in (0.01, 0.05, 0.1)}
    print(f"  one micro-step {tuple(batch['xs'].shape)} bf16 vs f32 on the card: loss {l16:.4f} vs {l32:.4f} "
          f"({rel_loss:.2e}, tol {BF16_LOSS_RTOL}); gradient cosine {cosine:.6f} (tol {BF16_GRAD_COSINE}); each "
          f"tensor's error above the floor {floor:.2e} as a share of its f32 largest entry: median "
          f"{float(np.median(errs)):.2e}, "
          + ", ".join(f"{v:.0%} of {len(errs)} tensors below {c}" for c, v in zip((0.01, 0.05, 0.1), shares.values()))
          + "; the largest: " + ", ".join(f"{k} {v:.2e}" for k, v in worst))
    return {"loss_bf16": l16, "loss_f32": l32, "loss_rel_err": rel_loss, "grad_cosine": cosine,
            "grad_rel_err_median": float(np.median(errs)), "grad_rel_err_shares": shares, "grad_floor": floor,
            "grad_rel_err_largest": dict(worst)}


def decode_greedy_bf16(tr: dict, card: str, want_used: tuple) -> dict:
    """The bf16 trainer's `model.ep1` greedily through the eval CLI (the
    yaml's compute_dtype: bfloat16 decodes a bf16 cast of it), launching
    each kernel of `want_used` through its bf16 launcher."""
    import pandas as pd

    from emoasr_tpu_torch.eval import test_asr

    cfg, conf_path = tr["cfg"], tr["conf_path"]
    reset_launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = test_asr.main(["-conf", conf_path, "-ep", "1", "--beam_width", "0"])
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    launches = launch_counts()
    require(out is not None and out[3].startswith("WER:"), f"bf16 greedy decode: CLI returned {out}")
    df = pd.read_table(os.path.join(os.path.splitext(conf_path)[0], "results",
                                    "result_test_beam0_len0.0_ctc0.0_lm0.00_ep1.tsv"), comment="#")
    require(len(df) > 0 and all(launches[k] > 0 for k in want_used) and launches["attention_fwd"] == 0,
            f"bf16 greedy decode: {len(df)} rows, launches {launches}")
    print(f"  {cfg.compute_dtype} greedy decode of model.ep1: {out[3]}; {len(df)} utts in {dt:.3f} s = "
          f"{len(df) / dt:.2f} utt/s, RTF {dt / tr['wav_s']:.5f} (first call) on {card}; launches "
          f"{({k: n for k, n in launches.items() if n})}")
    return {"launches": launches, "seconds": dt, "utt_per_s": len(df) / dt, "rtf": dt / tr["wav_s"]}


def overfit_on_card(args, root: str) -> dict:
    """Learning on the card: a small corpus whose features carry the label
    identity, trained through the port's train CLI with `enc_fused_attn`
    and decoded by the port's eval CLI; WER must fall below 15."""
    import pandas as pd
    import yaml

    from emoasr_tpu_torch.eval import test_asr
    from emoasr_tpu_torch.train import loop

    root = os.path.join(root, "overfit")
    os.makedirs(os.path.join(root, "feats"))
    rng = np.random.default_rng(0)
    V, F, seg, rows = 12, 16, 6, []
    for i in range(32):
        U = int(rng.integers(2, 5))
        toks = rng.integers(3, V, size=U)
        x = np.zeros((U * seg, F), np.float32)
        for u, tok in enumerate(toks):
            x[u * seg:(u + 1) * seg, tok % F] = 2.0  # one active channel per segment
        x += rng.normal(size=x.shape).astype(np.float32) * 0.05
        path = os.path.join(root, "feats", f"u{i}.npy")
        np.save(path, x)
        rows.append(dict(feat_path=path, utt_id=f"spk-u{i}-{i * 1000}-{i * 1000 + U * seg * 10}",
                         token_id=" ".join(map(str, toks)), text=" ".join(f"w{t}" for t in toks),
                         xlen=U * seg, ylen=U))
    tsv = os.path.join(root, "train.tsv")
    pd.DataFrame(rows).to_csv(tsv, sep="\t", index=False)
    conf = dict(
        encoder_type="transformer", decoder_type="ctc", input_layer="linear", feat_dim=F,
        enc_hidden_size=32, enc_num_attention_heads=2, enc_num_layers=1, enc_intermediate_size=64,
        enc_fused_attn=True, vocab_size=V, vocab_path=write_vocab(root, V), train_path=tsv,
        dev_path=tsv, test_path=tsv, buckets=[[32, 8]], batch_size=8, max_xlens_batch=512,
        max_ylens_batch=64, num_epochs=60, learning_rate=5.0, lr_schedule_type="noam",
        num_warmup_steps=60, dropout_enc_rate=0.0, dropout_attn_rate=0.0, spec_augment=False,
        clip_grad_norm=5.0, log_step=50, save_step=60, seed=0,
    )
    conf_path = os.path.join(root, "overfit.yaml")
    with open(conf_path, "w") as f:
        yaml.safe_dump(conf, f)
    reset_launch_counts()
    t0 = time.perf_counter()
    state = loop.main(["-conf", conf_path])
    out = test_asr.main(["-conf", conf_path, "-ep", "60", "--beam_width", "0"])
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    launches = launch_counts()
    require(state.step == 240 and state.skipped == 0, f"overfit run: {state.step} steps, {state.skipped} skipped")
    require(launches["ctc_head_grad_w"] == 240 and launches["ctc_beta_grad"] == 240
            and launches["attention_bwd"] == 240, f"overfit run did not train through the kernels: {launches}")
    require(out is not None and out[2] < 15.0, f"overfit on the card: {out}")
    print(f"  overfit corpus (32 utts, 60 epochs, 240 micro-steps) on the card: {out[3]} in {dt:.1f} s")
    return {"wer": out[2], "seconds": dt, "conf_path": conf_path, "ep": "60", "tsv": tsv, "vocab_size": V}


def run_cli(conf: str, beam: int, n_utts: int, wav_s: float, card: str) -> dict:
    """Decode the corpus through the port's CLI; count launches; check rows."""
    import pandas as pd

    from emoasr_tpu_torch.eval import test_asr

    reset_launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = test_asr.main(["-conf", conf, "-ep", "1", "--beam_width", str(beam)])
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    launches = launch_counts()
    require(out is not None and out[3].startswith("WER:"), f"beam {beam}: CLI returned {out}")
    res_dir = os.path.join(os.path.splitext(conf)[0], "results")
    path = os.path.join(res_dir, f"result_test_beam{beam}_len0.0_ctc0.0_lm0.00_ep1.tsv")
    with open(path) as f:
        require(f.readline().startswith("# WER:"), f"beam {beam}: no WER comment in {path}")
    df = pd.read_table(path, comment="#")
    require(len(df) == n_utts and df["utt_id"].nunique() == n_utts,
            f"beam {beam}: {len(df)} result rows for {n_utts} utterances")
    print(f"  beam {beam}: {out[3]}; {n_utts} utts in {dt:.3f} s = {n_utts / dt:.2f} utt/s, "
          f"RTF {dt / wav_s:.5f} (first call, warm-up included) on {card}; "
          f"launches topk {launches['topk']}, attention_fwd {launches['attention_fwd']}")
    return {"launches": launches, "seconds": dt, "utt_per_s": n_utts / dt, "rtf": dt / wav_s}


def decode_path(args, tr: dict, dev, card: str) -> dict:
    """Decode the test corpus with the checkpoint the trainer wrote: beam 8
    and greedy through the eval CLI, then the encoder card-vs-CPU check."""
    from emoasr_tpu_torch.data.asr_dataset import ASRDataset
    from emoasr_tpu_torch.eval.decode import build_decode_fn
    from emoasr_tpu_torch.eval.test_asr import load_asr_model
    from emoasr_tpu_torch.search.ctc_beam import ctc_beam_search

    cfg, conf_path, ckpt, wav_s = tr["cfg"], tr["conf_path"], tr["ckpt"], tr["wav_s"]
    ds = ASRDataset(cfg, tr["test_tsv"], phase="test")
    batcher = ds.make_batcher()
    batches, buckets = list(batcher), batcher.buckets
    enc_frames = [((buckets[bi].max_xlen - 1) // 2 - 1) // 2 for bi, _ in batches]
    print(f"  corpus: {args.n_utts} utts, {wav_s:.1f} s of audio, {len(batches)} batches, "
          f"encoder frames per batch {enc_frames}")

    runs = {}
    for beam in (8, 0):
        r = run_cli(conf_path, beam, args.n_utts, wav_s, card)
        n_attn = r["launches"]["attention_fwd"]
        require(n_attn == cfg.enc_num_layers * len(batches),
                f"beam {beam}: {n_attn} attention launches, want {cfg.enc_num_layers} x {len(batches)} batches")
        if beam > 1:
            require(r["launches"]["topk"] >= sum(enc_frames),
                    f"beam {beam}: {r['launches']['topk']} top-k launches < {sum(enc_frames)} encoder frames")
        runs[beam] = r

    # one batch: encoder on the card (kernel) against the CPU (plain path)
    bi, idx = batches[-1]
    batch = ds.collate(idx[:4], buckets[bi].max_xlen, buckets[bi].max_ylen)
    xs, xlens = torch.from_numpy(batch["xs"]), torch.from_numpy(batch["xlens"]).long()
    with torch.no_grad():
        gpu = load_asr_model(ckpt, cfg).to(dev).eval()
        cpu = load_asr_model(ckpt, cfg).eval()
        before = launch_counts()["attention_fwd"]
        e1, l1, _ = gpu.encode(xs.to(dev), xlens.to(dev))
        require(launch_counts()["attention_fwd"] - before == cfg.enc_num_layers, "encoder check did not use the kernel")
        e0, l0, _ = cpu.encode(xs, xlens)
    require(torch.equal(l1.cpu(), l0), "encoder lengths differ between card and CPU")
    enc_err = max((e1[b, :n].cpu() - e0[b, :n]).abs().max().item() for b, n in enumerate(l0.tolist()))
    require(enc_err <= ENC_TOL, f"encoder card vs CPU: max abs err {enc_err} > {ENC_TOL}")
    print(f"  encoder ({cfg.enc_num_layers} layers, {tuple(xs.shape)}) card vs CPU plain: max abs err {enc_err:.3e} (tol {ENC_TOL})")

    # beam hypotheses, card vs CPU, on the first batch of 4 or more
    # utterances (reported only)
    bi, idx = next(b for b in batches if len(b[1]) >= 4)
    idx = idx[:8]
    batch = ds.collate(idx, buckets[bi].max_xlen, buckets[bi].max_ylen)
    hyp = {}
    for name, model, d in (("cuda", gpu, dev), ("cpu", cpu, "cpu")):
        fn = build_decode_fn(model, cfg, beam_width=8, device=d)
        h, hl, _ = fn(batch["xs"], batch["xlens"])
        hyp[name] = [h[b, 0, : hl[b, 0]].tolist() for b in range(len(idx))]
    same = sum(a == b for a, b in zip(hyp["cuda"], hyp["cpu"])) / len(hyp["cpu"])
    print(f"  beam-8 best hypotheses identical card vs CPU: {same:.2f} of {len(hyp['cpu'])}")
    # where one full batch of the largest bucket spends its decode time:
    # encoder + CTC head, then the beam loop (host clock around
    # synchronised work; the second of two passes is kept)
    big = max(buckets, key=lambda b: b.max_xlen)
    bi, idx = next(b for b in batches if buckets[b[0]] == big)
    batch = ds.collate(idx, big.max_xlen, big.max_ylen, pad_to_batch=big.batch_size)
    xs = torch.from_numpy(batch["xs"]).to(dev)
    xlens = torch.from_numpy(batch["xlens"]).long().to(dev)
    with torch.no_grad():
        for _ in range(2):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            eouts, elens, _ = gpu.encode(xs, xlens)
            lp = torch.log_softmax(gpu.decoder.logits(eouts).float(), dim=-1)
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            ctc_beam_search(lp, elens, 8, cfg.blank_id, cfg.eos_id)
            torch.cuda.synchronize()
            t2 = time.perf_counter()
    split = {"batch": list(xs.shape), "frames": int(lp.shape[1]),
             "encoder_head_ms": (t1 - t0) * 1e3, "beam_ms": (t2 - t1) * 1e3,
             "beam_ms_per_frame": (t2 - t1) * 1e3 / lp.shape[1]}
    print(f"  one {tuple(xs.shape)} batch: encoder + CTC head {split['encoder_head_ms']:.2f} ms, "
          f"beam-8 loop {split['beam_ms']:.2f} ms over {split['frames']} frames on {card}")
    return {"runs": runs, "enc_err": enc_err, "same_hyps": same, "bucket": big,
            "batches": len(batches), "split": split}


def train_conformer_steps(args, root: str, card: str) -> dict:
    """The L2 CTC(Conformer) model at full width through the train CLI: two
    micro-steps, one batch of the smallest and one of the largest bucket,
    SpecAugment and dropout on, `enc_fused_attn: true`: every layer's
    attention runs in the kernel with its score bias, forward and backward."""
    import yaml

    from emoasr_tpu_torch.config import load_config
    from emoasr_tpu_torch.train import loop

    with open(L2_CONF) as f:
        conf = yaml.safe_load(f)
    lengths, _ = train_lengths(load_config(L2_CONF), [1, 0, 0, 0, 1])
    sub = os.path.join(root, "l2")
    os.makedirs(sub)
    train_tsv, _ = write_corpus(sub, "train", lengths, conf["vocab_size"], conf["feat_dim"], args.seed + 2)
    conf.update(vocab_path=write_vocab(sub, conf["vocab_size"]), train_path=train_tsv, test_path=train_tsv,
                dev_path=None, enc_fused_attn=True, num_epochs=1, save_step=1, log_step=1, seed=args.seed)
    conf_path = os.path.join(sub, "l2_ctc_conformer.yaml")
    with open(conf_path, "w") as f:
        yaml.safe_dump(conf, f)
    cfg = load_config(conf_path)
    require((cfg.encoder_type, cfg.pos_encode_type, cfg.enc_num_layers, cfg.enc_hidden_size,
             cfg.enc_intermediate_size, cfg.conv_kernel_size, cfg.dropout_attn_rate)
            == ("conformer", "rel", 12, 256, 1024, 31, 0.1), "the L2 config is not at full width")
    reset_launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    state = loop.main(["-conf", conf_path])
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    launches = launch_counts()
    losses, _, _ = read_train_log(conf_path)
    require(state.step == 2 and state.skipped == 0 and len(losses) == 2 and all(np.isfinite(losses)),
            f"Conformer training: {state.step} micro-steps, {state.skipped} skipped, losses {losses}")
    n = cfg.enc_num_layers * 2
    require(launches["attention_bias_fwd"] == launches["attention_fwd"] == n
            and launches["attention_bias_bwd"] == launches["attention_bwd"] == n,
            f"Conformer training did not go through the attention kernel with its bias: {launches}")
    print(f"  trained 2 micro-steps ({len(lengths)} utts, smallest and largest bucket) in {dt:.2f} s on {card}: "
          f"losses {losses[0]:.2f}, {losses[1]:.2f}; attention with bias fwd {launches['attention_bias_fwd']}, "
          f"bwd {launches['attention_bias_bwd']} launches")
    return {"launches": launches, "seconds": dt, "losses": losses}


class _LogCapture:
    """Collects the root logger's messages that contain `needle` (as a
    filter: the CLIs replace the root logger's handlers when they start)."""

    def __init__(self, needle: str):
        self.needle, self.lines = needle, []

    def filter(self, record) -> bool:
        if self.needle in record.getMessage():
            self.lines.append(record.getMessage())
        return True

    def __enter__(self):
        import logging

        logging.getLogger().addFilter(self)
        return self

    def __exit__(self, *exc):
        import logging

        logging.getLogger().removeFilter(self)


# L3-1 on the card against the CPU's plain path: the encoder as ENC_TOL; one
# decoder step's logits (six layers of f32 sums in other orders) 1e-3.  The
# beam's top-1 hypotheses are compared token for token: seed weights give
# nearly flat scores, where a rounding difference can turn a beam, so the
# share of equal hypotheses is reported and must reach HYP_SHARE.
STEP_LOGITS_TOL = 1e-3
HYP_SHARE = 0.5


def decode_l3_1(args, root: str, test_tsv: str, wav_s: float, dev, card: str) -> dict:
    """The slice's path: L3-1 at full width through the eval CLI, beam 10
    with joint CTC 0.3, `fused_indirect` then `fused`; then one batch card
    against CPU, and where one large batch's time goes."""
    import pandas as pd
    import yaml

    from emoasr_tpu_torch.config import load_config
    from emoasr_tpu_torch.data.asr_dataset import ASRDataset
    from emoasr_tpu_torch.eval import test_asr
    from emoasr_tpu_torch.eval.decode import build_decode_fn, ctc_len_caps
    from emoasr_tpu_torch.eval.test_asr import load_asr_model
    from emoasr_tpu_torch.models.asr import ASR
    from emoasr_tpu_torch.models.layers import make_pad_mask
    from emoasr_tpu_torch.search.attention_beam import attention_beam_search
    from emoasr_tpu_torch.search.common import TOPK_KERNEL_MIN_V, topk_lastdim
    from emoasr_tpu_torch.search.ctc_prefix_score import (
        ctc_prefix_initial_state, ctc_prefix_score_psi, ctc_prefix_state_update)
    from emoasr_tpu_torch.train.checkpoint import save_state_dict

    with open(L3_1_CONF) as f:
        base = yaml.safe_load(f)
    sub = os.path.join(root, "l3_1")
    os.makedirs(sub)
    base.update(vocab_path=write_vocab(sub, base["vocab_size"]), test_path=test_tsv, enc_fused_attn=True,
                seed=args.seed)
    torch.manual_seed(args.seed)
    confs, state = {}, None
    for mode in ("fused_indirect", "fused"):
        confs[mode] = os.path.join(sub, f"l3_1_{mode}.yaml")
        with open(confs[mode], "w") as f:
            yaml.safe_dump(dict(base, dec_step_mode=mode), f)
        cfg = load_config(confs[mode])
        if state is None:
            state = ASR(cfg).state_dict()  # weights from the seed
        save_state_dict(state, os.path.join(os.path.splitext(confs[mode])[0], "checkpoints", "model.ep1"))
    require((cfg.encoder_type, cfg.enc_num_layers, cfg.enc_hidden_size, cfg.enc_num_attention_heads,
             cfg.enc_intermediate_size, cfg.conv_kernel_size, cfg.decoder_type, cfg.dec_num_layers,
             cfg.dec_hidden_size, cfg.dec_intermediate_size, cfg.vocab_size, cfg.beam_width,
             cfg.decode_ctc_weight, cfg.len_weight, cfg.compute_dtype)
            == ("conformer", 12, 256, 4, 1024, 31, "transformer", 6, 256, 2048, 10000, 10, 0.3, 2, "float32"),
            "the L3-1 config is not at full width")
    ds_ = ASRDataset(cfg, test_tsv, phase="test")
    batcher = ds_.make_batcher()
    batches, buckets = list(batcher), batcher.buckets
    n_utts = sum(len(idx) for _, idx in batches)

    runs = {}
    for mode, conf in confs.items():
        reset_launch_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with _LogCapture("force-finalized") as cap:
            out = test_asr.main(["-conf", conf, "-ep", "1"])
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        launches = launch_counts()
        require(out is not None and out[3].startswith("WER:"), f"L3-1 {mode}: CLI returned {out}")
        path = os.path.join(os.path.splitext(conf)[0], "results", "result_test_beam10_len2.0_ctc0.3_lm0.00_ep1.tsv")
        df = pd.read_table(path, comment="#")
        require(len(df) == n_utts and df["utt_id"].nunique() == n_utts, f"L3-1 {mode}: {len(df)} rows for {n_utts} utts")
        decoded = int(df["token_id"].notna().sum())
        require(decoded == n_utts, f"L3-1 {mode}: {n_utts - decoded} utterances were not decoded")
        forced = int(cap.lines[0].split()[0]) if cap.lines else 0
        step_kernel = "decoder_step_indirect" if mode == "fused_indirect" else "decoder_step"
        other = "decoder_step" if mode == "fused_indirect" else "decoder_step_indirect"
        steps = launches[step_kernel] // cfg.dec_num_layers
        n_attn = cfg.enc_num_layers * len(batches)
        require(launches["attention_fwd"] == launches["attention_bias_fwd"] == n_attn,
                f"L3-1 {mode}: attention launches {launches}, want {n_attn} with the bias")
        require(steps >= len(batches) and launches[step_kernel] == steps * cfg.dec_num_layers
                and launches[other] == 0 and launches["topk"] == steps,
                f"L3-1 {mode}: launches {launches}")
        print(f"  {mode}: {out[3]}; {n_utts} utts in {dt:.3f} s = {n_utts / dt:.2f} utt/s, RTF {dt / wav_s:.5f} "
              f"(first call, warm-up included) on {card}; {steps} beam steps in {len(batches)} batches, "
              f"{forced} of {n_utts} hypotheses force-finalized at their step budget; launches topk "
              f"{launches['topk']}, attention with bias {launches['attention_bias_fwd']}, {step_kernel} "
              f"{launches[step_kernel]}")
        runs[mode] = {"launches": launches, "seconds": dt, "utt_per_s": n_utts / dt, "rtf": dt / wav_s,
                      "beam_steps": steps, "forced_finalisations": forced}
    require(runs["fused"]["beam_steps"] == runs["fused_indirect"]["beam_steps"],
            "the two step modes took different numbers of beam steps")
    # a beam wider than K5's row group of 16 (two groups an utterance), which
    # the JAX CLI decodes and the port refused before
    reset_launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = test_asr.main(["-conf", confs["fused_indirect"], "-ep", "1", "--beam_width", "17"])
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    launches = launch_counts()
    require(out is not None and out[3].startswith("WER:"), f"L3-1 beam 17: CLI returned {out}")
    df = pd.read_table(os.path.join(os.path.splitext(confs["fused_indirect"])[0], "results",
                                    "result_test_beam17_len2.0_ctc0.3_lm0.00_ep1.tsv"), comment="#")
    require(len(df) == n_utts and int(df["token_id"].notna().sum()) == n_utts,
            f"L3-1 beam 17: {len(df)} rows, {int(df['token_id'].notna().sum())} decoded, for {n_utts} utts")
    steps = launches["decoder_step_indirect"] // cfg.dec_num_layers
    # K3 pre-selects a step's candidates; at W = 17 the pool of W x W = 289 scores goes to it too
    topk_a_step = 1 + int(17 * 17 >= TOPK_KERNEL_MIN_V)
    require(steps >= len(batches) and launches["decoder_step"] == 0 and launches["topk"] == topk_a_step * steps,
            f"L3-1 beam 17: launches {launches}")
    print(f"  fused_indirect, --beam_width 17: {out[3]}; {n_utts} utts in {dt:.3f} s, RTF {dt / wav_s:.5f} (first "
          f"call) on {card}; {steps} beam steps, decoder_step_indirect {launches['decoder_step_indirect']} launches")
    runs["fused_indirect_beam17"] = {"launches": launches, "seconds": dt, "utt_per_s": n_utts / dt,
                                     "rtf": dt / wav_s, "beam_steps": steps}
    a, b = (pd.read_table(os.path.join(os.path.splitext(c)[0], "results",
                                       "result_test_beam10_len2.0_ctc0.3_lm0.00_ep1.tsv"), comment="#")
            for c in confs.values())
    same_modes = float((a.sort_values("utt_id")["token_id"].values == b.sort_values("utt_id")["token_id"].values).mean())
    print(f"  fused_indirect and fused write the same hypothesis for {same_modes:.3f} of the utterances")

    # one batch, card (kernels) against CPU (plain versions)
    cfg = load_config(confs["fused_indirect"])
    ckpt = os.path.join(os.path.splitext(confs["fused_indirect"])[0], "checkpoints", "model.ep1")
    bi, idx = next(b for b in batches if buckets[b[0]].max_xlen == 400)
    batch = ds_.collate(idx[:4], 400, buckets[bi].max_ylen)
    xs, xlens = torch.from_numpy(batch["xs"]), torch.from_numpy(batch["xlens"]).long()
    W = cfg.beam_width
    with torch.no_grad():
        gpu, cpu = load_asr_model(ckpt, cfg).to(dev).eval(), load_asr_model(ckpt, cfg).eval()
        before = launch_counts()
        e1, l1, _ = gpu.encode(xs.to(dev), xlens.to(dev))
        e0, l0, _ = cpu.encode(xs, xlens)
        require(torch.equal(l1.cpu(), l0), "L3-1 encoder lengths differ between card and CPU")
        enc_err = max((e1[b, :n].cpu() - e0[b, :n]).abs().max().item() for b, n in enumerate(l0.tolist()))
        require(enc_err <= ENC_TOL, f"L3-1 encoder card vs CPU: max abs err {enc_err} > {ENC_TOL}")
        # one decoder step at position 3 of every beam, on the CPU's encoder
        # output, at the yaml's beam and at 17 (two row groups an utterance)
        B, T = e0.shape[0], e0.shape[1]
        widths = (cfg.beam_width, 17)
        step_err = {}
        for W in widths:
            g = torch.Generator().manual_seed(args.seed)
            toks = torch.randint(3, cfg.vocab_size, (B * W,), generator=g)
            pos = torch.full((B, W), 3)
            logits = {}
            for name, model, d in (("cuda", gpu, dev), ("cpu", cpu, torch.device("cpu"))):
                dec, eo, el = model.decoder, e0.to(d), l0.to(d)
                cross = dec.precompute_cross_kv(eo)
                caches = [tuple(torch.randn(B, W, 8, 4, 64, generator=torch.Generator().manual_seed(i)).to(d)
                                for i in (2 * j, 2 * j + 1)) for j in range(cfg.dec_num_layers)]
                anc = torch.randint(0, W, (B, W, 8), generator=torch.Generator().manual_seed(99)).to(d, torch.int32)
                anc[:, :, 3] = torch.arange(W, dtype=torch.int32, device=d)[None, :]
                logits[name], _ = dec.decode_step_cached_indirect(
                    toks.to(d), pos.to(d), caches, anc, cross, make_pad_mask(el, T)[:, None, None, :],
                    beam_width=W, step_mode="fused_indirect", elens=el)
            step_err[W] = _max_err(logits["cuda"].cpu(), logits["cpu"])
            require(step_err[W] <= STEP_LOGITS_TOL,
                    f"L3-1 decoder step (beam {W}) card vs CPU: max abs err {step_err[W]} > {STEP_LOGITS_TOL}")
        used = {k: launch_counts()[k] - before[k] for k in before}
        require(used["attention_bias_fwd"] == cfg.enc_num_layers
                and used["decoder_step_indirect"] == len(widths) * cfg.dec_num_layers,
                f"the L3-1 card-vs-CPU check did not go through the kernels: {used}")
        hyp = {}
        for W in widths:
            for name, model, d in (("cuda", gpu, dev), ("cpu", cpu, "cpu")):
                fn = build_decode_fn(model, cfg, W, cfg.len_weight, cfg.decode_ctc_weight, top1=True, device=d)
                h, hl, _ = fn(batch["xs"], batch["xlens"])
                hyp[name, W] = [h[b, 0, : hl[b, 0]].tolist() for b in range(len(batch["utt_ids"]))]
    same, lens_ = {}, {}
    for W in widths:
        same[W] = sum(x == y for x, y in zip(hyp["cuda", W], hyp["cpu", W])) / len(hyp["cpu", W])
        lens_[W] = [len(x) for x in hyp["cpu", W]]
        require(same[W] >= HYP_SHARE,
                f"L3-1 beam {W} top-1 hypotheses card vs CPU: only {same[W]:.2f} agree (want {HYP_SHARE})")
    print(f"  one (4,400,80) batch card vs CPU plain: encoder max abs err {enc_err:.3e} (tol {ENC_TOL}); "
          + "; ".join(f"beam {W}: one decoder step's logits {step_err[W]:.3e} (tol {STEP_LOGITS_TOL}), top-1 "
                      f"hypotheses equal for {same[W]:.2f} of 4 (lengths {lens_[W]}; required {HYP_SHARE})"
                      for W in widths))
    W = cfg.beam_width

    # where one full batch of the largest bucket spends its time (host clock
    # around synchronised work, second of two passes), and the parts of one
    # beam step timed alone by CUDA events at pos 64
    big = max(buckets, key=lambda b: b.max_xlen)
    bi, idx = next(b for b in batches if buckets[b[0]] == big)
    batch = ds_.collate(idx, big.max_xlen, big.max_ylen, pad_to_batch=big.batch_size)
    xs = torch.from_numpy(batch["xs"]).to(dev)
    xlens = torch.from_numpy(batch["xlens"]).long().to(dev)
    dec = gpu.decoder

    def tick():
        torch.cuda.synchronize()
        return time.perf_counter()

    with torch.no_grad():
        for _ in range(2):
            t0 = tick()
            eouts, elens, _ = gpu.encode(xs, xlens)
            t1 = tick()
            cross = dec.precompute_cross_kv(eouts)
            lp = torch.log_softmax(dec.ctc.logits(eouts).float(), dim=-1)
            caps = ctc_len_caps(cfg, lp, elens)
            t2 = tick()
            B, T = eouts.shape[0], eouts.shape[1]
            emask = make_pad_mask(elens, T)[:, None, None, :]
            before = launch_counts()["decoder_step_indirect"]
            attention_beam_search(
                eouts, elens, None, vocab_size=cfg.vocab_size, beam_width=W, eos_id=cfg.eos_id,
                blank_id=cfg.blank_id, len_weight=cfg.len_weight, decode_ctc_weight=cfg.decode_ctc_weight,
                ctc_log_probs=lp, max_decode_ylen=cfg.max_decode_ylen, row_caps=caps, need_results=1,
                cached_step=(
                    lambda n, L: dec.init_cache(n, L),
                    None,
                    lambda t, p, c, a: dec.decode_step_cached_indirect(
                        t, p, c, a, cross, emask, beam_width=W, step_mode="fused_indirect", elens=elens),
                ))
            t3 = tick()
            n_steps = (launch_counts()["decoder_step_indirect"] - before) // cfg.dec_num_layers
        L, p64 = 130, 64
        caches = [tuple(torch.randn(B, W, L, 4, 64, device=dev) for _ in range(2)) for _ in range(cfg.dec_num_layers)]
        anc = torch.randint(0, W, (B, W, L), device=dev, dtype=torch.int32)
        toks = torch.randint(3, cfg.vocab_size, (B * W,), device=dev)
        pos = torch.full((B, W), p64, device=dev)
        step_ms = cuda_time_ms(lambda: dec.decode_step_cached_indirect(
            toks, pos, caches, anc, cross, emask, beam_width=W, step_mode="fused_indirect", elens=elens), iters=20)
        dense_ms = cuda_time_ms(lambda: dec.decode_step_cached_indirect(
            toks, pos, caches, anc, cross, emask, beam_width=W, step_mode="indirect", elens=elens), iters=20)
        scores = torch.log_softmax(torch.randn(B, W, cfg.vocab_size, device=dev), -1)
        topk_ms = cuda_time_ms(lambda: topk_lastdim(scores, 15), iters=20)
        lp_T = lp.transpose(1, 2).contiguous()
        r = ctc_prefix_initial_state(lp, elens, cfg.blank_id, W)
        hyps = torch.randint(3, cfg.vocab_size, (B, W, cfg.max_decode_ylen + 2), device=dev)
        lens_w = torch.full((B, W), p64 + 1, device=dev)
        cs = torch.randint(3, cfg.vocab_size, (B, W, 15), device=dev)
        psi_ms = cuda_time_ms(lambda: ctc_prefix_score_psi(lp_T, elens, hyps, lens_w, cs, r, cfg.blank_id, cfg.eos_id), iters=20)
        upd_ms = cuda_time_ms(lambda: ctc_prefix_state_update(lp_T, elens, hyps, lens_w, cs[:, :, 0], r, cfg.blank_id), iters=20)
    beam_ms = (t3 - t2) * 1e3
    split = {"batch": list(xs.shape), "frames": int(T), "encoder_ms": (t1 - t0) * 1e3,
             "cross_kv_ctc_caps_ms": (t2 - t1) * 1e3, "beam_ms": beam_ms, "beam_steps": int(n_steps),
             "ms_per_beam_step": beam_ms / max(n_steps, 1), "decoder_step_6_layers_ms": step_ms,
             "decoder_step_6_layers_dense_route_ms": dense_ms, "topk_ms": topk_ms,
             "ctc_prefix_psi_ms": psi_ms, "ctc_prefix_state_update_ms": upd_ms,
             "row_caps": [int(c) for c in caps.tolist()]}
    rest = split["ms_per_beam_step"] - step_ms - topk_ms - psi_ms - upd_ms
    print(f"  one {tuple(xs.shape)} batch on {card}: encoder {split['encoder_ms']:.2f} ms, cross K/V + CTC head + caps "
          f"{split['cross_kv_ctc_caps_ms']:.2f} ms, beam loop {beam_ms:.1f} ms over {n_steps} steps = "
          f"{split['ms_per_beam_step']:.3f} ms a step; alone, by CUDA events at pos {p64}: decoder step (embed, "
          f"6 x K5 indirect, output layer) {step_ms:.3f} ms (the dense route {dense_ms:.3f}), top-k (K3) "
          f"{topk_ms:.3f}, prefix scores {psi_ms:.3f}, lattice update {upd_ms:.3f}; the rest of a step "
          f"(selection, bookkeeping, the host) {rest:.3f} ms")
    return {"runs": runs, "enc_err": enc_err, "step_err": step_err[W], "same_hyps": same[W],
            "step_err_beam17": step_err[17], "same_hyps_beam17": same[17], "same_modes": same_modes,
            "split": split, "batches": len(batches), "n_utts": n_utts, "bucket": big, "confs": confs}


# L3-3 on the card against the CPU's plain path: one step's fused scores
# (decoder log-softmax + 0.5 x LM log-softmax: six and four layers of f32
# sums in other orders) 1e-3, as one decoder step's logits in L3-1; top-1
# hypotheses equal for HYP_SHARE of one batch.  The two routes of the LM
# step through the CLI: the same hypothesis for LM_ROUTES_SHARE of the
# corpus (seed weights give nearly flat scores, where a rounding difference
# can turn a beam).
FUSED_SCORES_TOL = 1e-3
LM_ROUTES_SHARE = 0.95


def decode_l3_3(args, root: str, tr: dict, dev, card: str) -> dict:
    """The slice's path: L3-3 (L3-1's model with Transformer-LM shallow
    fusion 0.5) at full width through the eval CLI, beam 10 with joint CTC
    0.3, `fused_indirect` decoder steps, the LM step by K6 and then by the
    dense route; one batch card against CPU; where one large batch's time
    goes; one CTC beam-8 decode of the L1 model with the LM in `cached`
    mode."""
    import pandas as pd
    import yaml
    from torch.profiler import ProfilerActivity, profile

    from emoasr_tpu_torch.config import load_config
    from emoasr_tpu_torch.data.asr_dataset import ASRDataset
    from emoasr_tpu_torch.eval import test_asr
    from emoasr_tpu_torch.eval.decode import build_decode_fn, ctc_len_caps
    from emoasr_tpu_torch.eval.test_asr import load_asr_model, load_lm
    from emoasr_tpu_torch.models.asr import ASR
    from emoasr_tpu_torch.models.layers import make_pad_mask
    from emoasr_tpu_torch.models.lm import bert as bert_mod
    from emoasr_tpu_torch.models.lm.lm import LM
    from emoasr_tpu_torch.search.attention_beam import attention_beam_search
    from emoasr_tpu_torch.search.common import make_lm_fusion
    from emoasr_tpu_torch.train.checkpoint import save_state_dict

    sub = os.path.join(root, "l3_3")
    os.makedirs(sub)
    vocab = write_vocab(sub, 10000)
    with open(LM_CONF) as f:
        lm_base = yaml.safe_load(f)
    lm_conf = os.path.join(sub, "lm.yaml")
    with open(lm_conf, "w") as f:
        yaml.safe_dump(dict(lm_base, vocab_path=vocab), f)
    lm_cfg = load_config(lm_conf)
    require((lm_cfg.lm_type, lm_cfg.num_layers, lm_cfg.hidden_size, lm_cfg.num_attention_heads,
             lm_cfg.intermediate_size, lm_cfg.vocab_size, lm_cfg.max_seq_len)
            == ("transformer", 4, 512, 8, 2048, 10000, 256), "the LM config is not at full width")
    lm_path = os.path.join(sub, "lm", "checkpoints", "model.ep1")
    torch.manual_seed(args.seed + 1)
    save_state_dict(LM(lm_cfg).state_dict(), lm_path)  # weights from the seed
    with open(L3_3_CONF) as f:
        base = yaml.safe_load(f)
    conf = os.path.join(sub, "l3_3.yaml")
    with open(conf, "w") as f:
        yaml.safe_dump(dict(base, vocab_path=vocab, test_path=tr["test_tsv"], enc_fused_attn=True,
                            dec_step_mode="fused_indirect", seed=args.seed, lm_conf=lm_conf,
                            lm_path=lm_path), f)
    cfg = load_config(conf)
    require((cfg.encoder_type, cfg.enc_num_layers, cfg.enc_hidden_size, cfg.decoder_type, cfg.dec_num_layers,
             cfg.dec_hidden_size, cfg.vocab_size, cfg.beam_width, cfg.decode_ctc_weight, cfg.len_weight,
             cfg.lm_weight, cfg.compute_dtype)
            == ("conformer", 12, 256, "transformer", 6, 256, 10000, 10, 0.3, 2, 0.5, "float32"),
            "the L3-3 config is not at full width")
    ckpt = os.path.join(os.path.splitext(conf)[0], "checkpoints", "model.ep1")
    torch.manual_seed(args.seed)
    save_state_dict(ASR(cfg).state_dict(), ckpt)  # weights from the seed
    ds_ = ASRDataset(cfg, tr["test_tsv"], phase="test")
    batcher = ds_.make_batcher()
    batches, buckets = list(batcher), batcher.buckets
    n_utts, wav_s = sum(len(idx) for _, idx in batches), tr["wav_s"]
    result = "result_test_beam10_len2.0_ctc0.3_lm0.50transformer_ep1.tsv"

    # k6, dense, then dense, k6 again: the host's pace drifts within a call,
    # so each route's wall time is the mean of a run early and a run late.
    # The kernels line counts the first pair's launches.
    runs, repeat, tables = {}, {}, {}
    for i, (route, fused) in enumerate((("k6", True), ("dense", False), ("dense", False), ("k6", True))):
        test_asr._SETUP_CACHE.clear()  # each run loads its models, as the first did
        bert_mod.FUSED_INDIRECT_STEP = fused
        reset_launch_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        try:
            with _LogCapture("force-finalized") as cap:
                out = test_asr.main(["-conf", conf, "-ep", "1", "--save_dir", route])
            torch.cuda.synchronize()
        finally:
            bert_mod.FUSED_INDIRECT_STEP = None
        dt = time.perf_counter() - t0
        launches = launch_counts()
        require(out is not None and out[3].startswith("WER:") and out[0] == 0.5, f"L3-3 {route}: CLI returned {out}")
        df = pd.read_table(os.path.join(os.path.splitext(conf)[0], "results", route, result), comment="#")
        require(len(df) == n_utts and int(df["token_id"].notna().sum()) == n_utts,
                f"L3-3 {route}: {len(df)} rows, {int(df['token_id'].notna().sum())} decoded of {n_utts}")
        hyps = df.sort_values("utt_id")["token_id"].values
        require(route not in tables or (tables[route] == hyps).all(),
                f"L3-3 {route}: the repeated run wrote other hypotheses than the first")
        tables[route] = hyps
        forced = int(cap.lines[0].split()[0]) if cap.lines else 0
        steps = launches["decoder_step_indirect"] // cfg.dec_num_layers
        n_attn = cfg.enc_num_layers * len(batches)
        require(launches["attention_fwd"] == launches["attention_bias_fwd"] == n_attn,
                f"L3-3 {route}: attention launches {launches}, want {n_attn} with the bias")
        require(steps >= len(batches) and launches["decoder_step_indirect"] == steps * cfg.dec_num_layers
                and launches["decoder_step"] == 0 and launches["topk"] == steps
                and launches["lm_step_indirect"] == (lm_cfg.num_layers * steps if fused else 0),
                f"L3-3 {route}: launches {launches}")
        print(f"  LM step by {route}: {out[3]}; {n_utts} utts in {dt:.3f} s = {n_utts / dt:.2f} utt/s, RTF "
              f"{dt / wav_s:.5f} (first call, models loaded, warm-up included) on {card}; {steps} beam steps in "
              f"{len(batches)} batches, {forced} of {n_utts} hypotheses force-finalized; launches topk "
              f"{launches['topk']}, attention with bias {launches['attention_bias_fwd']}, decoder_step_indirect "
              f"{launches['decoder_step_indirect']}, lm_step_indirect {launches['lm_step_indirect']}")
        (runs if i < 2 else repeat)[route] = {
            "launches": launches, "seconds": dt, "utt_per_s": n_utts / dt, "rtf": dt / wav_s,
            "beam_steps": steps, "forced_finalisations": forced}
    test_asr._SETUP_CACHE.clear()
    for route in runs:
        runs[route]["mean_rtf_of_both_runs"] = (runs[route]["rtf"] + repeat[route]["rtf"]) / 2
    print(f"  mean RTF of the early and the late run: K6 {runs['k6']['mean_rtf_of_both_runs']:.5f}, "
          f"the dense route {runs['dense']['mean_rtf_of_both_runs']:.5f}")
    same_routes = float((tables["k6"] == tables["dense"]).mean())
    require(same_routes >= LM_ROUTES_SHARE,
            f"L3-3: the K6 and dense LM routes agree on {same_routes:.3f} of the hypotheses (want {LM_ROUTES_SHARE})")
    print(f"  K6 and the dense LM route write the same hypothesis for {same_routes:.3f} of the utterances")

    # one batch, card (kernels) against CPU (plain versions)
    bi, idx = next(b for b in batches if buckets[b[0]].max_xlen == 400)
    batch = ds_.collate(idx[:4], 400, buckets[bi].max_ylen)
    xs, xlens = torch.from_numpy(batch["xs"]), torch.from_numpy(batch["xlens"]).long()
    W, V = cfg.beam_width, cfg.vocab_size
    bert_mod.FUSED_INDIRECT_STEP = True
    try:
        with torch.no_grad():
            gpu, cpu = load_asr_model(ckpt, cfg).to(dev).eval(), load_asr_model(ckpt, cfg).eval()
            lm_gpu, lm_cpu = load_lm(lm_conf, lm_path)[0].to(dev), load_lm(lm_conf, lm_path)[0]
            e0, l0, _ = cpu.encode(xs, xlens)
            B, T = e0.shape[0], e0.shape[1]
            g = torch.Generator().manual_seed(args.seed)
            toks = torch.randint(3, V, (B, W), generator=g)
            pos = torch.full((B, W), 3)
            heads = {"dec": (cfg.dec_num_layers, cfg.dec_num_attention_heads, cfg.dec_hidden_size),
                     "lm": (lm_cfg.num_layers, lm_cfg.num_attention_heads, lm_cfg.hidden_size)}
            dec_caches, lm_caches = ([tuple(torch.randn(B, W, 8, H, D // H, generator=g) for _ in range(2))
                                      for _ in range(n)] for n, H, D in heads.values())
            anc = torch.randint(0, W, (B, W, 8), generator=g, dtype=torch.int32)
            anc[:, :, 3] = torch.arange(W, dtype=torch.int32)[None, :]
            fused_scores = {}
            before = launch_counts()
            for name, model, lm, d in (("cuda", gpu, lm_gpu, dev), ("cpu", cpu, lm_cpu, torch.device("cpu"))):
                dec, el = model.decoder, l0.to(d)
                cross = dec.precompute_cross_kv(e0.to(d))
                logits, _ = dec.decode_step_cached_indirect(
                    toks.reshape(-1).to(d), pos.to(d), [tuple(x.to(d) for x in kv) for kv in dec_caches],
                    anc.to(d), cross, make_pad_mask(el, T)[:, None, None, :], beam_width=W,
                    step_mode="fused_indirect", elens=el)
                lm_logp, _ = lm.predict_step_indirect(
                    toks.to(d), pos.to(d), [tuple(x.to(d) for x in kv) for kv in lm_caches], anc.to(d))
                fused_scores[name] = (torch.log_softmax(logits.float(), -1).reshape(B, W, V)
                                      + cfg.lm_weight * lm_logp).cpu()
            used = {k: launch_counts()[k] - before[k] for k in before}
            require(used["decoder_step_indirect"] == cfg.dec_num_layers and used["lm_step_indirect"] == lm_cfg.num_layers,
                    f"the L3-3 card-vs-CPU step did not go through the kernels: {used}")
            score_err = _max_err(fused_scores["cuda"], fused_scores["cpu"])
            require(score_err <= FUSED_SCORES_TOL,
                    f"L3-3 fused scores card vs CPU: max abs err {score_err} > {FUSED_SCORES_TOL}")
            hyp = {}
            for name, model, lm, d in (("cuda", gpu, lm_gpu, dev), ("cpu", cpu, lm_cpu, "cpu")):
                fn = build_decode_fn(model, cfg, W, cfg.len_weight, cfg.decode_ctc_weight,
                                     lm=make_lm_fusion(lm, cfg.lm_weight), top1=True, device=d)
                h, hl, _ = fn(batch["xs"], batch["xlens"])
                hyp[name] = [h[b, 0, : hl[b, 0]].tolist() for b in range(len(batch["utt_ids"]))]
    finally:
        bert_mod.FUSED_INDIRECT_STEP = None
    same = sum(x == y for x, y in zip(hyp["cuda"], hyp["cpu"])) / len(hyp["cpu"])
    require(same >= HYP_SHARE, f"L3-3 top-1 hypotheses card vs CPU: only {same:.2f} agree (want {HYP_SHARE})")
    print(f"  one (4,400,80) batch card vs CPU plain: one step's fused scores (att + {cfg.lm_weight} LM) max abs "
          f"err {score_err:.3e} (tol {FUSED_SCORES_TOL}), top-1 hypotheses equal for {same:.2f} of 4 (lengths "
          f"{[len(x) for x in hyp['cpu']]}; required {HYP_SHARE})")

    # where one full batch of the largest bucket spends its time: the beam
    # loop without the LM, with the LM step by K6 and by the dense route
    # (host clock around synchronised work; a warm-up pass each, then the
    # order none, k6, dense, dense, k6, none and the mean of each route's two
    # passes), and the LM step alone by CUDA events
    big = max(buckets, key=lambda b: b.max_xlen)
    bi, idx = next(b for b in batches if buckets[b[0]] == big)
    batch = ds_.collate(idx, big.max_xlen, big.max_ylen, pad_to_batch=big.batch_size)
    xs = torch.from_numpy(batch["xs"]).to(dev)
    xlens = torch.from_numpy(batch["xlens"]).long().to(dev)
    dec = gpu.decoder
    fusion = make_lm_fusion(lm_gpu, cfg.lm_weight)
    routes = {"none": None, "k6": True, "dense": False}
    split = {"batch": list(xs.shape), **{r: {"beam_ms": []} for r in routes}}
    with torch.no_grad():
        eouts, elens, _ = gpu.encode(xs, xlens)
        cross = dec.precompute_cross_kv(eouts)
        lp = torch.log_softmax(dec.ctc.logits(eouts).float(), dim=-1)
        caps = ctc_len_caps(cfg, lp, elens)
        B, T = eouts.shape[0], eouts.shape[1]
        emask = make_pad_mask(elens, T)[:, None, None, :]

        def beam_loop(route: str) -> tuple:
            bert_mod.FUSED_INDIRECT_STEP = routes[route]
            try:
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                before = launch_counts()["decoder_step_indirect"]
                attention_beam_search(
                    eouts, elens, None, vocab_size=V, beam_width=W, eos_id=cfg.eos_id, blank_id=cfg.blank_id,
                    len_weight=cfg.len_weight, lm=None if route == "none" else fusion,
                    decode_ctc_weight=cfg.decode_ctc_weight, ctc_log_probs=lp, max_decode_ylen=cfg.max_decode_ylen,
                    row_caps=caps, need_results=1,
                    cached_step=(
                        lambda n, L: dec.init_cache(n, L), None,
                        lambda t, p, c, a: dec.decode_step_cached_indirect(
                            t, p, c, a, cross, emask, beam_width=W, step_mode="fused_indirect", elens=elens),
                    ))
                torch.cuda.synchronize()
            finally:
                bert_mod.FUSED_INDIRECT_STEP = None
            return (time.perf_counter() - t0) * 1e3, (launch_counts()["decoder_step_indirect"] - before) // cfg.dec_num_layers

        for route in routes:  # warm-up
            beam_loop(route)
        for route in ("none", "k6", "dense", "dense", "k6", "none"):
            beam_ms, n_steps = beam_loop(route)
            split[route]["beam_ms"].append(beam_ms)
            split[route]["beam_steps"] = int(n_steps)
        # a traced pass each, after the timed ones (tracing costs the host
        # time of its own): the device's busy time
        for route in routes:
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                beam_loop(route)
            split[route]["device_busy_ms"] = sum(e.self_device_time_total for e in prof.key_averages()) / 1e3
        Lc, p64 = 256, 64
        toks = torch.randint(3, V, (B, W, Lc), device=dev)
        lens_w = torch.full((B, W), p64 + 1, device=dev)
        for route in ("k6", "dense"):
            bert_mod.FUSED_INDIRECT_STEP = routes[route]
            try:
                states = fusion.indirect.init_states(B, W, Lc)
                split[route]["lm_step_ms"] = cuda_time_ms(
                    lambda: fusion.indirect.predict_beams(toks, lens_w, states), iters=20)
            finally:
                bert_mod.FUSED_INDIRECT_STEP = None
    for route in routes:
        s = split[route]
        s["ms_per_beam_step"] = sum(s["beam_ms"]) / len(s["beam_ms"]) / max(s["beam_steps"], 1)
        # the share of the untraced loop's wall time the device had no work
        s["device_idle_share"] = 1 - s["device_busy_ms"] / (sum(s["beam_ms"]) / len(s["beam_ms"]))
    for route in ("k6", "dense"):
        s = split[route]
        s["lm_share_of_step"] = s["lm_step_ms"] / s["ms_per_beam_step"]
        s["step_minus_no_lm_ms"] = s["ms_per_beam_step"] - split["none"]["ms_per_beam_step"]
    per = {r: ", ".join(f"{x:.1f}" for x in split[r]["beam_ms"]) for r in routes}
    print(f"  one {tuple(xs.shape)} batch on {card}, beam loop over {split['k6']['beam_steps']} steps (ms, two passes): "
          f"no LM {per['none']} = {split['none']['ms_per_beam_step']:.3f} ms a step; the LM step by K6 {per['k6']} = "
          f"{split['k6']['ms_per_beam_step']:.3f} ms a step (+{split['k6']['step_minus_no_lm_ms']:.3f}); by the dense "
          f"route {per['dense']} = {split['dense']['ms_per_beam_step']:.3f} ms a step "
          f"(+{split['dense']['step_minus_no_lm_ms']:.3f}); the LM step alone (embed, 4 layers, head, log-softmax; "
          f"CUDA events at pos 64, Lc 256) {split['k6']['lm_step_ms']:.3f} ms by K6 "
          f"({split['k6']['lm_share_of_step']:.2f} of a step), {split['dense']['lm_step_ms']:.3f} ms by the dense "
          f"route ({split['dense']['lm_share_of_step']:.2f}); device busy (torch.profiler, a traced pass after "
          f"the timed ones) "
          + ", ".join(f"{r} {split[r]['device_busy_ms']:.1f} ms, idle {split[r]['device_idle_share']:.2f}"
                      for r in routes))

    # the CTC prefix beam's LM branch on the card: one batch of the L1 model
    # the trainer wrote, beam 8, the LM in `cached` mode (no kernel of its own)
    l1cfg = tr["cfg"]
    l1_ds = ASRDataset(l1cfg, tr["test_tsv"], phase="test")
    l1_batcher = l1_ds.make_batcher()
    bi, idx = next(iter(l1_batcher))
    b1 = l1_ds.collate(idx, l1_batcher.buckets[bi].max_xlen, l1_batcher.buckets[bi].max_ylen)
    l1 = load_asr_model(tr["ckpt"], l1cfg)
    with torch.no_grad():
        plain_fn = build_decode_fn(l1, l1cfg, beam_width=8, device=dev)
        lm_fn = build_decode_fn(l1, l1cfg, beam_width=8, lm=make_lm_fusion(lm_gpu, 0.5, mode="cached"), device=dev)
        h0, hl0, _ = plain_fn(b1["xs"], b1["xlens"])
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        h1, hl1, sc1 = lm_fn(b1["xs"], b1["xlens"])
        torch.cuda.synchronize()
    ctc_lm_s = time.perf_counter() - t0
    nb = len(b1["utt_ids"])
    require(h1.shape[1] == 8 and bool(torch.isfinite(sc1[:nb, 0]).all()),
            f"CTC beam with the LM: shapes {tuple(h1.shape)}, best scores {sc1[:nb, 0].tolist()}")
    changed = sum(h0[b, 0, : hl0[b, 0]].tolist() != h1[b, 0, : hl1[b, 0]].tolist() for b in range(nb))
    print(f"  CTC beam 8 + LM (cached) on one L1 batch {tuple(b1['xs'].shape)}: {ctc_lm_s:.3f} s, finite scores; "
          f"the LM changed the best hypothesis of {changed} of {nb} utterances")
    return {"runs": runs, "repeat": repeat, "fused_scores_err": score_err, "same_hyps": same, "same_routes": same_routes,
            "split": split, "batches": len(batches), "n_utts": n_utts, "conf": conf, "lm_conf": lm_conf,
            "lm_path": lm_path, "tables": tables,
            "ctc_beam_lm": {"seconds": ctc_lm_s, "batch": list(b1["xs"].shape), "best_changed": changed}}


# bf16 decoding on the card against the CPU's plain bf16 path: one step's
# fused scores (the decoder's log-softmax, plus 0.5 x the LM's for L3-3)
# from the same encoder output, caches and ancestor table.  bf16 rounds
# every activation, and a product that straddles a rounding boundary on one
# side and not on the other moves everything after it, so the card is held
# within twice the CPU's own bf16-vs-f32 distance of the same step, plus
# one bf16 step of the largest score (as the CPU tests hold the port's bf16
# decode to the JAX package's).
def _bf16_conf(conf: str, ckpt: str, sub: str, name: str, **over) -> str:
    """A copy of the yaml `conf` with `compute_dtype: bfloat16` (and `over`)
    as `<sub>/<name>.yaml`, whose run directory holds `ckpt` as model.ep1."""
    import yaml

    with open(conf) as f:
        base = yaml.safe_load(f)
    path = os.path.join(sub, f"{name}.yaml")
    with open(path, "w") as f:
        yaml.safe_dump(dict(base, compute_dtype="bfloat16", **over), f)
    dst = os.path.join(sub, name, "checkpoints", "model.ep1")
    os.makedirs(os.path.dirname(dst))
    os.symlink(ckpt, dst)
    return path


def _top1(conf: str, result: str) -> dict:
    """{utt_id: token ids} of a result TSV the eval CLI wrote."""
    import pandas as pd

    df = pd.read_table(os.path.join(os.path.splitext(conf)[0], "results", result), comment="#")
    return {u: str(t) for u, t in zip(df["utt_id"], df["token_id"])}


def _share_equal(a: dict, b: dict) -> float:
    require(set(a) == set(b), "two decodes of one corpus hold other utterances")
    return sum(a[u] == b[u] for u in a) / len(a)


def _shared_prefix(a: dict, b: dict) -> float:
    """The mean share of its tokens that a hypothesis of `a` shares, from the
    start, with the same utterance's of `b` (seed weights give flat scores:
    once two decodes take different tokens they seldom meet again, so this
    says how long they went together)."""
    shares = []
    for u in a:
        x, y = a[u].split(), b[u].split()
        n = next((i for i, (p, q) in enumerate(zip(x, y)) if p != q), min(len(x), len(y)))
        shares.append(n / max(len(x), len(y), 1))
    return sum(shares) / len(shares)


def decode_bf16(args, root: str, tr: dict, mp: dict, l3: dict, l33: dict, l4: dict, dev, card: str) -> dict:
    """Phase 13: the 40-utterance corpus decoded in bf16 at full width.  L1
    beam 8, L3-1 (`fused_indirect`, `fused`, and the dense `indirect` route)
    and L4 ALSD beam 10 through the eval CLI on bf16 copies of the earlier
    phases' yamls and checkpoints; L3-3 through `build_decode_fn` and
    `decode_dataset` with the LM cast to bf16 (as `bench.py` casts it; the
    CLI keeps the LM float32), its layer step by K6 and then by the dense
    route.  Launch counts prove the bf16 launchers ran; one step of one L3-1
    and one L3-3 batch is held against the CPU; top-1 agreement with the
    float32 decodes and between the routes is printed."""
    from emoasr_tpu_torch.config import load_config
    from emoasr_tpu_torch.data.asr_dataset import ASRDataset
    from emoasr_tpu_torch.eval import test_asr
    from emoasr_tpu_torch.eval.decode import build_decode_fn
    from emoasr_tpu_torch.eval.test_asr import decode_dataset, load_asr_model, load_lm
    from emoasr_tpu_torch.models.layers import make_pad_mask
    from emoasr_tpu_torch.models.lm import bert as bert_mod
    from emoasr_tpu_torch.search.common import make_lm_fusion
    from emoasr_tpu_torch.utils.precision import cast_floating
    from emoasr_tpu_torch.utils.vocab import Vocab

    bf = torch.bfloat16
    sub = os.path.join(root, "bf16_decode")
    os.makedirs(sub)
    wav_s, runs, agree, prefix = tr["wav_s"], {}, {}, {}

    def cli(conf: str, what: str, beam=None, wav: float = wav_s) -> tuple:
        test_asr._SETUP_CACHE.clear()
        reset_launch_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        argv = ["-conf", conf, "-ep", "1"] + ([] if beam is None else ["--beam_width", str(beam)])
        with _LogCapture("force-finalized") as cap:
            out = test_asr.main(argv)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        launches = launch_counts()
        require(out is not None and out[3].startswith("WER:"), f"bf16 {what}: CLI returned {out}")
        forced = int(cap.lines[0].split()[0]) if cap.lines else 0
        runs[what] = {"launches": launches, "seconds": dt, "utt_per_s": args.n_utts / dt, "rtf": dt / wav,
                      "forced_finalisations": forced}
        return out, launches

    def no_f32(launches: dict, what: str) -> None:
        used = [k for k, n in launches.items() if n and k != "topk" and not k.endswith("_bf16")
                and k not in ("ctc_alpha", "ctc_beta_grad")]
        require(not used, f"bf16 {what}: float32 launchers ran: {used}")

    # L1 CTC(Transformer), the trainer's model.ep1, CTC prefix beam 8
    cfg1 = tr["cfg"]
    conf = _bf16_conf(tr["conf_path"], tr["ckpt"], sub, "l1")
    out, launches = cli(conf, "l1_beam8", 8)
    require(launches["attention_fwd_bf16"] == cfg1.enc_num_layers * mp["batches"] and launches["topk"] > 0,
            f"bf16 L1 beam 8: launches {launches}")
    no_f32(launches, "L1 beam 8")
    result = "result_test_beam8_len0.0_ctc0.0_lm0.00_ep1.tsv"
    pair = (_top1(conf, result), _top1(tr["conf_path"], result))
    agree["l1_beam8_vs_f32"], prefix["l1_beam8_vs_f32"] = _share_equal(*pair), _shared_prefix(*pair)
    print(f"  L1 beam 8: {out[3]}; RTF {runs['l1_beam8']['rtf']:.5f} (first call) on {card}; launches "
          f"attention_fwd_bf16 {launches['attention_fwd_bf16']}, topk {launches['topk']}; the same top-1 as the "
          f"float32 decode for {agree['l1_beam8_vs_f32']:.3f} (leading tokens shared {prefix['l1_beam8_vs_f32']:.3f})")

    # L3-1, beam 10 with joint CTC 0.3: K5 in bf16 (both variants), then the dense route
    result = "result_test_beam10_len2.0_ctc0.3_lm0.00_ep1.tsv"
    confs = {}
    for mode, kernel in (("fused_indirect", "decoder_step_indirect_bf16"), ("fused", "decoder_step_bf16"),
                         ("indirect", None)):
        src = l3["confs"]["fused" if mode == "fused" else "fused_indirect"]
        ckpt = os.path.join(os.path.splitext(src)[0], "checkpoints", "model.ep1")
        confs[mode] = conf = _bf16_conf(src, ckpt, sub, f"l3_1_{mode}", dec_step_mode=mode)
        cfg = load_config(conf)
        out, launches = cli(conf, f"l3_1_{mode}")
        steps = launches["topk"]
        n_attn = cfg.enc_num_layers * l3["batches"]
        require(launches["attention_bias_fwd_bf16"] == launches["attention_fwd_bf16"] == n_attn,
                f"bf16 L3-1 {mode}: attention launches {launches}, want {n_attn} with the bias")
        step_launches = {k: launches[k] for k in ("decoder_step_bf16", "decoder_step_indirect_bf16")}
        require(steps >= l3["batches"] and all(n == (cfg.dec_num_layers * steps if k == kernel else 0)
                                               for k, n in step_launches.items()),
                f"bf16 L3-1 {mode}: {steps} beam steps, step launches {step_launches}")
        no_f32(launches, f"L3-1 {mode}")
        runs[f"l3_1_{mode}"]["beam_steps"] = steps
        used = f"{kernel} {launches[kernel]}" if kernel else "no K5"
        print(f"  L3-1 {mode}: {out[3]}; RTF {runs[f'l3_1_{mode}']['rtf']:.5f} (first call) on {card}; {steps} beam "
              f"steps, {runs[f'l3_1_{mode}']['forced_finalisations']} force-finalized; launches {used}, attention "
              f"with bias (bf16) {launches['attention_bias_fwd_bf16']}")
    tops = {m: _top1(c, result) for m, c in confs.items()}
    for key, pair in (("l3_1_fused_indirect_vs_f32", (tops["fused_indirect"], _top1(l3["confs"]["fused_indirect"], result))),
                      ("l3_1_fused_indirect_vs_dense_bf16", (tops["fused_indirect"], tops["indirect"])),
                      ("l3_1_fused_vs_fused_indirect", (tops["fused"], tops["fused_indirect"]))):
        agree[key], prefix[key] = _share_equal(*pair), _shared_prefix(*pair)
    print(f"  L3-1 bf16 top-1 (equal; leading tokens shared): fused_indirect as float32 "
          f"{agree['l3_1_fused_indirect_vs_f32']:.3f}; {prefix['l3_1_fused_indirect_vs_f32']:.3f}, as the dense bf16 "
          f"route {agree['l3_1_fused_indirect_vs_dense_bf16']:.3f}; {prefix['l3_1_fused_indirect_vs_dense_bf16']:.3f}, "
          f"fused as fused_indirect {agree['l3_1_fused_vs_fused_indirect']:.3f}; "
          f"{prefix['l3_1_fused_vs_fused_indirect']:.3f}")

    # L3-3: the LM cast to bf16, fused at 0.5, through build_decode_fn + decode_dataset
    ckpt33 = os.path.join(os.path.splitext(l33["conf"])[0], "checkpoints", "model.ep1")
    conf33 = _bf16_conf(l33["conf"], ckpt33, sub, "l3_3")
    cfg33 = load_config(conf33)
    lm16, lm_cfg = load_lm(l33["lm_conf"], l33["lm_path"])
    lm16 = cast_floating(lm16.to(dev), bf)
    ds33 = ASRDataset(cfg33, tr["test_tsv"], phase="test")
    vocab = Vocab(cfg33.vocab_path)
    fn33 = build_decode_fn(load_asr_model(ckpt33, cfg33), cfg33, cfg33.beam_width, cfg33.len_weight,
                           cfg33.decode_ctc_weight, lm=make_lm_fusion(lm16, cfg33.lm_weight), top1=True, device=dev)
    tables33 = {}
    for route, fused in (("k6", True), ("dense", False)):
        bert_mod.FUSED_INDIRECT_STEP = fused
        reset_launch_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        try:
            rows = decode_dataset(cfg33, ds33, fn33, vocab)
            torch.cuda.synchronize()
        finally:
            bert_mod.FUSED_INDIRECT_STEP = None
        dt = time.perf_counter() - t0
        launches = launch_counts()
        steps = launches["topk"]
        require(len(rows) == args.n_utts and all(r[1] is not None for r in rows), f"bf16 L3-3 {route}: {len(rows)} rows")
        require(steps > 0 and launches["decoder_step_indirect_bf16"] == cfg33.dec_num_layers * steps
                and launches["lm_step_indirect_bf16"] == (lm_cfg.num_layers * steps if fused else 0),
                f"bf16 L3-3 {route}: {steps} beam steps, launches {launches}")
        no_f32(launches, f"L3-3 {route}")
        tables33[route] = {r[0]: str(r[1]) for r in rows}
        runs[f"l3_3_{route}"] = {"launches": launches, "seconds": dt, "utt_per_s": args.n_utts / dt,
                                 "rtf": dt / wav_s, "beam_steps": steps}
        print(f"  L3-3 (LM bf16) LM step by {route}: {args.n_utts} utts in {dt:.3f} s, RTF {dt / wav_s:.5f} (models "
              f"loaded once, first call of this route) on {card}; {steps} beam steps; launches decoder_step_indirect_bf16 "
              f"{launches['decoder_step_indirect_bf16']}, lm_step_indirect_bf16 {launches['lm_step_indirect_bf16']}")
    f32_k6 = dict(zip(sorted(tables33["k6"]), (str(t) for t in l33["tables"]["k6"])))
    for key, pair in (("l3_3_k6_vs_dense_bf16", (tables33["k6"], tables33["dense"])),
                      ("l3_3_k6_vs_f32", (tables33["k6"], f32_k6))):
        agree[key], prefix[key] = _share_equal(*pair), _shared_prefix(*pair)
    print(f"  L3-3 bf16 top-1 (equal; leading tokens shared): K6 as the dense bf16 route "
          f"{agree['l3_3_k6_vs_dense_bf16']:.3f}; {prefix['l3_3_k6_vs_dense_bf16']:.3f}, as the float32 decode with "
          f"K6 {agree['l3_3_k6_vs_f32']:.3f}; {prefix['l3_3_k6_vs_f32']:.3f}")

    # L4 RNN-T(Conformer), the trainer's model.ep1, ALSD beam 10
    cfg4 = l4["cfg"]
    conf = _bf16_conf(l4["conf_path"], l4["ckpt"], sub, "l4")
    out, launches = cli(conf, "l4_beam10", cfg4.beam_width, l4["wav_s"])
    require(launches["attention_bias_fwd_bf16"] == cfg4.enc_num_layers * l4["batches"] and launches["topk"] > 0
            and launches["lstm_fwd_bf16"] == launches["rnnt_joint_bf16"] == 0, f"bf16 L4 beam: launches {launches}")
    no_f32(launches, "L4 beam 10")
    result = f"result_test_beam{cfg4.beam_width}_len0.0_ctc0.0_lm0.00_ep1.tsv"
    pair = (_top1(conf, result), _top1(l4["conf_path"], result))
    agree["l4_beam10_vs_f32"], prefix["l4_beam10_vs_f32"] = _share_equal(*pair), _shared_prefix(*pair)
    print(f"  L4 ALSD beam {cfg4.beam_width}: {out[3]}; RTF {runs['l4_beam10']['rtf']:.5f} (first call) on {card}; "
          f"launches topk {launches['topk']}, attention with bias (bf16) {launches['attention_bias_fwd_bf16']}; the same "
          f"top-1 as the float32 decode for {agree['l4_beam10_vs_f32']:.3f} (leading tokens shared "
          f"{prefix['l4_beam10_vs_f32']:.3f})")

    # one step of one L3-1 and one L3-3 batch: card (bf16 kernels) against the CPU (plain bf16, and f32)
    ds_ = ASRDataset(cfg33, tr["test_tsv"], phase="test")
    batcher = ds_.make_batcher()
    bi, idx = next(b for b in batcher if batcher.buckets[b[0]].max_xlen == 400)
    batch = ds_.collate(idx[:4], 400, batcher.buckets[bi].max_ylen)
    xs, xlens = torch.from_numpy(batch["xs"]), torch.from_numpy(batch["xlens"]).long()
    W, V = cfg33.beam_width, cfg33.vocab_size
    g = torch.Generator().manual_seed(args.seed)
    step_err = {}
    with torch.no_grad():
        cpu16 = cast_floating(load_asr_model(ckpt33, cfg33), bf).eval()
        e0, l0, _ = cpu16.encode(xs.to(bf), xlens)
        B, T = e0.shape[0], e0.shape[1]
        toks = torch.randint(3, V, (B, W), generator=g)
        pos = torch.full((B, W), 3)
        rnd = lambda *shape: torch.randn(*shape, generator=g).to(bf).float()  # values bf16 holds exactly
        dec_caches = [tuple(rnd(B, W, 8, cfg33.dec_num_attention_heads, cfg33.dec_hidden_size // cfg33.dec_num_attention_heads)
                            for _ in range(2)) for _ in range(cfg33.dec_num_layers)]
        lm_caches = [tuple(rnd(B, W, 8, lm_cfg.num_attention_heads, lm_cfg.hidden_size // lm_cfg.num_attention_heads)
                           for _ in range(2)) for _ in range(lm_cfg.num_layers)]
        anc = torch.randint(0, W, (B, W, 8), generator=g, dtype=torch.int32)
        anc[:, :, 3] = torch.arange(W, dtype=torch.int32)[None, :]
        sides = {"cuda": (cast_floating(load_asr_model(ckpt33, cfg33).to(dev), bf).eval(), lm16, dev, bf),
                 "cpu": (cpu16, cast_floating(load_lm(l33["lm_conf"], l33["lm_path"])[0], bf), torch.device("cpu"), bf),
                 "cpu f32": (load_asr_model(ckpt33, cfg33).eval(), load_lm(l33["lm_conf"], l33["lm_path"])[0],
                             torch.device("cpu"), torch.float32)}
        bert_mod.FUSED_INDIRECT_STEP = True
        try:
            scores = {}
            before = launch_counts()
            for name, (model, lm, d, dt) in sides.items():
                dec, el = model.decoder, l0.to(d)
                cross = dec.precompute_cross_kv(e0.to(d, dt))
                logits, _ = dec.decode_step_cached_indirect(
                    toks.reshape(-1).to(d), pos.to(d), [tuple(x.to(d, dt) for x in kv) for kv in dec_caches],
                    anc.to(d), cross, make_pad_mask(el, T)[:, None, None, :], beam_width=W,
                    step_mode="fused_indirect", elens=el.to(torch.int32))
                att = torch.log_softmax(logits.float(), -1).reshape(B, W, V)
                lm_logp, _ = lm.predict_step_indirect(
                    toks.to(d), pos.to(d), [tuple(x.to(d, dt) for x in kv) for kv in lm_caches], anc.to(d))
                scores[name] = {"l3_1": att.cpu(), "l3_3": (att + cfg33.lm_weight * lm_logp.float()).cpu()}
            used = {k: launch_counts()[k] - before[k] for k in before}
        finally:
            bert_mod.FUSED_INDIRECT_STEP = None
    require(used["decoder_step_indirect_bf16"] == cfg33.dec_num_layers and used["lm_step_indirect_bf16"] == lm_cfg.num_layers,
            f"the bf16 card-vs-CPU step did not go through the bf16 kernels: {used}")
    for what in ("l3_1", "l3_3"):
        s16, s32, got = scores["cpu"][what], scores["cpu f32"][what], scores["cuda"][what]
        noise = (s16 - s32).abs().max().item()
        tol = 2 * noise + BF16_STEP * s32.abs().max().item()
        err = _max_err(got, s16)
        require(err <= tol, f"bf16 {what} step card vs CPU: max abs err {err} > {tol} (CPU bf16 vs f32: {noise})")
        step_err[what] = {"max_abs_err": err, "tol": tol, "cpu_bf16_vs_f32": noise}
        print(f"  one (4,400,80) batch, one {what.upper().replace('_', '-')} step's scores on the card (bf16 kernels) vs "
              f"the CPU's plain bf16 path: max abs err {err:.3e} (tol {tol:.3e} = 2 x the CPU's bf16-vs-f32 "
              f"{noise:.3e} + one bf16 step of the largest score)")
    return {"runs": runs, "same_top1": agree, "leading_tokens_shared": prefix, "step_card_vs_cpu": step_err}


def train_l4(args, root: str, card: str, compute_dtype: str = "float32", per_bucket=(2, 2, 2, 2, 2)) -> dict:
    """The L4 RNN-T(Conformer) model at full width through the port's train
    CLI: SpecAugment and dropout on, `enc_fused_attn: true`, one epoch over
    the five buckets (by default 10 micro-steps: two optimizer updates at
    accum_grad 5), in `compute_dtype`.  K7 (the joint), K8 (the prediction
    network's LSTM over U+1 tokens, forward and backward) and K4 with its
    score bias run every micro-step, through their bf16 launchers under
    bfloat16."""
    import yaml

    from emoasr_tpu_torch.config import load_config
    from emoasr_tpu_torch.models.asr import ASR
    from emoasr_tpu_torch.train import loop
    from emoasr_tpu_torch.train.checkpoint import load_state_dict

    with open(L4_CONF) as f:
        conf = yaml.safe_load(f)
    sub = os.path.join(root, "l4" if compute_dtype == "float32" else f"l4_{compute_dtype}")
    os.makedirs(sub)
    per_bucket = list(per_bucket)
    lengths, buckets = train_lengths(load_config(L4_CONF), per_bucket)
    train_tsv, _ = write_corpus(sub, "train", lengths, conf["vocab_size"], conf["feat_dim"], args.seed + 3)
    n_test = args.n_utts
    test_tsv, wav_s = write_corpus(
        sub, "test", [200 + (1400 * i) // max(n_test - 1, 1) for i in range(n_test)],
        conf["vocab_size"], conf["feat_dim"], args.seed + 4)
    conf.update(vocab_path=write_vocab(sub, conf["vocab_size"]), train_path=train_tsv, test_path=test_tsv,
                dev_path=None, enc_fused_attn=True, num_epochs=1, save_step=1, log_step=1, seed=args.seed,
                compute_dtype=compute_dtype)
    conf_path = os.path.join(sub, "l4_rnnt_conformer.yaml")
    with open(conf_path, "w") as f:
        yaml.safe_dump(conf, f)
    cfg = load_config(conf_path)
    require((cfg.encoder_type, cfg.pos_encode_type, cfg.enc_num_layers, cfg.enc_hidden_size,
             cfg.enc_num_attention_heads, cfg.enc_intermediate_size, cfg.conv_kernel_size, cfg.decoder_type,
             cfg.embedding_size, cfg.dec_hidden_size, cfg.dec_num_layers, cfg.joint_hidden_size, cfg.vocab_size,
             cfg.accum_grad, cfg.rnnt_joint_mode, cfg.beam_width, cfg.spec_augment, cfg.dropout_enc_rate,
             cfg.compute_dtype)
            == ("conformer", "rel", 12, 256, 4, 1024, 31, "rnn_transducer", 128, 512, 1, 512, 1000, 5, "pallas",
                10, True, 0.1, compute_dtype), "the L4 config is not at full width")
    n_steps = sum(per_bucket)
    reset_launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    state = loop.main(["-conf", conf_path])
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    launches = launch_counts()
    losses, _, epoch_s = read_train_log(conf_path)
    require(state.step == n_steps and len(losses) == n_steps and all(np.isfinite(losses)),
            f"L4 training: {state.step} micro-steps, losses {losses}")
    require(state.skipped == 0 and state.mini_step == n_steps % cfg.accum_grad,
            f"L4 training: {state.skipped} skipped, {state.mini_step} micro-steps open")
    n_dec, n_enc = n_steps * cfg.dec_num_layers, n_steps * cfg.enc_num_layers
    want = {"rnnt_joint": n_steps, "lstm_fwd": n_dec, "lstm_bwd": n_dec, "attention_fwd": n_enc,
            "attention_bwd": n_enc, "attention_bias_fwd": n_enc, "attention_bias_bwd": n_enc, "topk": 0,
            "ctc_head_fwd": 0, "ctc_alpha": 0, **{k: 0 for k in BF16_KEYS}}
    if compute_dtype != "float32":  # the same kernels, launched through their bf16 launchers
        for k in ("rnnt_joint", "lstm_fwd", "lstm_bwd", "attention_fwd", "attention_bwd", "attention_bias_fwd",
                  "attention_bias_bwd"):
            want[f"{k}_bf16"], want[k] = want[k], 0
    require(all(launches[k] == n for k, n in want.items()), f"L4 training launches {launches}, want {want}")
    ckpt = os.path.join(os.path.splitext(conf_path)[0], "checkpoints", "model.ep1")
    torch.manual_seed(cfg.seed)
    init, trained = ASR(cfg).state_dict(), load_state_dict(ckpt)
    changed = [k for k in init if not torch.equal(init[k], trained[k])]
    require(len(changed) >= 0.9 * len(init) and all(k in changed for k in (
        "decoder.output.weight", "decoder.rnns.0.weight_hh_l0", "decoder.embed.weight", "decoder.w_enc.weight",
        "encoder.conv.conv.0.weight")), f"only {len(changed)} of {len(init)} parameter tensors changed in training")
    for k, v in trained.items():
        require(bool(torch.isfinite(v).all()), f"trained parameter {k} is not finite")
    _require_f32_masters(state, trained)
    epoch = epoch_s[0] if epoch_s else float("nan")
    print(f"  trained {n_steps} {compute_dtype} micro-steps ({len(lengths)} utts, buckets x{per_bucket}) in {dt:.2f} s (the epoch "
          f"loop {epoch:.2f} s: {n_steps / epoch:.2f} micro-steps/s, first call, warm-up included) on {card}")
    print(f"  loss {losses[0]:.2f} -> {losses[-1]:.2f}, skipped 0, {len(changed)}/{len(init)} tensors changed; "
          f"launches {({k: n for k, n in launches.items() if n})}")
    return {"conf_path": conf_path, "cfg": cfg, "ckpt": ckpt, "test_tsv": test_tsv, "train_tsv": train_tsv,
            "wav_s": wav_s, "launches": launches, "seconds": dt, "epoch_seconds": epoch, "micro_steps": n_steps,
            "micro_steps_per_s": n_steps / epoch, "utt_per_s": len(lengths) / epoch, "losses": losses,
            "buckets": buckets}


def time_l4_micro_step(tr: dict, dev, card: str) -> dict:
    """Where one L4 micro-step of the largest bucket spends its time (host
    clock around synchronised phases, dropout on; the last of three):
    encoder, prediction network (K8), joint (K7), lattice, backward, clip +
    Adam; then three parts of the backward alone (the lattice's autograd,
    the chunked joint backward, K8's backward)."""
    from emoasr_tpu_torch.data.asr_dataset import ASRDataset
    from emoasr_tpu_torch.eval.test_asr import load_asr_model
    from emoasr_tpu_torch.ops.lstm_scan import lstm_scan_fused
    from emoasr_tpu_torch.ops.rnnt import joint_gather_backward, rnnt_alpha_rowscan
    from emoasr_tpu_torch.ops.rnnt_joint import fused_joint_gather
    from emoasr_tpu_torch.train.optim import build_optimizer, clip_by_global_norm_
    from emoasr_tpu_torch.utils.precision import dtype_of

    cfg = tr["cfg"]
    big = max(tr["buckets"], key=lambda b: b.max_xlen)
    ds = ASRDataset(cfg, tr["train_tsv"], phase="train")
    bi, idx = next(b for b in ds.make_batcher(shuffle=False) if b[0] == len(tr["buckets"]) - 1)
    batch = ds.collate(idx, big.max_xlen, big.max_ylen)
    t = {k: torch.from_numpy(v).to(dev) for k, v in batch.items() if isinstance(v, np.ndarray)}
    dt = dtype_of(cfg)
    t["xs"] = t["xs"].to(dt)
    model = load_asr_model(tr["ckpt"], cfg).to(dev).train()
    dec = model.decoder
    params = list(model.parameters())
    opt = build_optimizer(cfg, params)
    for g in opt.param_groups:
        g["lr"] = 1e-7

    def tick():
        torch.cuda.synchronize()
        return time.perf_counter()

    for _ in range(3):
        t0 = tick()
        casts = compute_params(model, dt)
        casts.__enter__()
        eouts, elens, _ = model.encoder(t["xs"], t["xlens"])
        t1 = tick()
        douts, _ = dec.recurrency(t["ys_in"])
        t2 = tick()
        lp_blank, lp_label = fused_joint_gather(dec.w_enc(eouts), dec.w_dec(douts), dec.output.weight.t(),
                                                dec.output.bias, t["ys"], cfg.blank_id)
        t3 = tick()
        loss = -torch.mean(rnnt_alpha_rowscan(lp_blank, lp_label, elens, t["ylens"]))
        t4 = tick()
        grads = torch.autograd.grad(loss, params)
        t5 = tick()
        clip_by_global_norm_(grads, cfg.clip_grad_norm)
        for p, g in zip(params, grads):
            p.grad = g
        opt.step()
        t6 = tick()
        # three parts of the backward, each alone: the lattice's autograd,
        # the chunked joint backward, and K8's backward
        lb, ll = lp_blank.detach().requires_grad_(True), lp_label.detach().requires_grad_(True)
        lat = -torch.mean(rnnt_alpha_rowscan(lb, ll, elens, t["ylens"]))
        t7 = tick()
        g_blank, g_label = torch.autograd.grad(lat, (lb, ll))
        t8 = tick()
        joint_gather_backward(dec.w_enc(eouts).detach(), dec.w_dec(douts).detach(), dec.output.weight.t().detach(),
                              dec.output.bias.detach(), t["ys"], g_blank, g_label, cfg.blank_id)
        t9 = tick()
        rnn = dec.rnns[0]
        x_proj = torch.nn.functional.linear(dec.embed(t["ys_in"]), rnn.weight_ih_l0,
                                            rnn.bias_ih_l0 + rnn.bias_hh_l0).detach().requires_grad_(True)
        zeros = x_proj.new_zeros((x_proj.shape[0], rnn.hidden_size))
        w_hh = rnn.weight_hh_l0.detach().requires_grad_(True)
        ys_k8, _ = lstm_scan_fused(x_proj, w_hh, zeros, zeros)
        t10 = tick()
        torch.autograd.grad(ys_k8, (x_proj, w_hh), torch.ones_like(ys_k8))
        t11 = tick()
        casts.__exit__(None, None, None)
    split = {"batch": list(t["xs"].shape), "labels": list(t["ys_in"].shape), "frames": int(eouts.shape[1]),
             "compute_dtype": cfg.compute_dtype,
             "encoder_fwd_ms": (t1 - t0) * 1e3, "prediction_net_ms": (t2 - t1) * 1e3,
             "joint_ms": (t3 - t2) * 1e3, "lattice_ms": (t4 - t3) * 1e3, "backward_ms": (t5 - t4) * 1e3,
             "clip_adam_ms": (t6 - t5) * 1e3, "lattice_backward_ms": (t8 - t7) * 1e3,
             "joint_backward_ms": (t9 - t8) * 1e3, "lstm_backward_ms": (t11 - t10) * 1e3}
    print(f"  one L4 {tuple(t['xs'].shape)} {cfg.compute_dtype} micro-step (U+1 = {t['ys_in'].shape[1]}, "
          f"T' = {split['frames']}) on "
          f"{card}: encoder {split['encoder_fwd_ms']:.2f} ms, prediction network {split['prediction_net_ms']:.2f}, "
          f"joint {split['joint_ms']:.2f}, lattice {split['lattice_ms']:.2f}, backward {split['backward_ms']:.2f} "
          f"(alone: the lattice's {split['lattice_backward_ms']:.2f}, the chunked joint's "
          f"{split['joint_backward_ms']:.2f}, K8's {split['lstm_backward_ms']:.2f}), clip + Adam "
          f"{split['clip_adam_ms']:.2f}")
    return split


def decode_l4(args, tr: dict, dev, card: str) -> dict:
    """The trainer's L4 `model.ep1` through the eval CLI: greedy, then the
    ALSD beam at width 10; K8 is launched no time (the prediction network
    steps one token at a time); one batch's greedy and beam top-1
    hypotheses on the card equal the CPU's."""
    import pandas as pd

    from emoasr_tpu_torch.data.asr_dataset import ASRDataset
    from emoasr_tpu_torch.eval import test_asr
    from emoasr_tpu_torch.eval.decode import build_decode_fn
    from emoasr_tpu_torch.eval.test_asr import load_asr_model

    cfg, conf_path, wav_s = tr["cfg"], tr["conf_path"], tr["wav_s"]
    ds = ASRDataset(cfg, tr["test_tsv"], phase="test")
    batcher = ds.make_batcher()
    batches, buckets = list(batcher), batcher.buckets
    n_utts = sum(len(idx) for _, idx in batches)
    frames = sum(((buckets[bi].max_xlen - 1) // 2 - 1) // 2 for bi, _ in batches)
    runs = {}
    for beam in (0, cfg.beam_width):
        reset_launch_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = test_asr.main(["-conf", conf_path, "-ep", "1", "--beam_width", str(beam)])
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        launches = launch_counts()
        require(out is not None and out[3].startswith("WER:"), f"L4 beam {beam}: CLI returned {out}")
        path = os.path.join(os.path.splitext(conf_path)[0], "results",
                            f"result_test_beam{beam}_len0.0_ctc0.0_lm0.00_ep1.tsv")
        df = pd.read_table(path, comment="#")
        require(len(df) == n_utts and df["utt_id"].nunique() == n_utts, f"L4 beam {beam}: {len(df)} rows")
        n_enc = cfg.enc_num_layers * len(batches)
        require(launches["lstm_fwd"] == launches["lstm_bwd"] == launches["rnnt_joint"] == 0,
                f"L4 beam {beam}: decoding launched K7/K8: {launches}")
        require(launches["attention_bias_fwd"] == launches["attention_fwd"] == n_enc,
                f"L4 beam {beam}: attention launches {launches}, want {n_enc} with the bias")
        if beam > 1:  # two label rounds a frame, up to each batch's longest utterance
            require(0 < launches["topk"] <= 2 * frames and launches["topk"] % 2 == 0,
                    f"L4 beam {beam}: {launches['topk']} top-k launches for {frames} encoder frames")
        else:
            require(launches["topk"] == 0, f"L4 greedy: {launches['topk']} top-k launches")
        print(f"  beam {beam}: {out[3]}; {n_utts} utts in {dt:.3f} s = {n_utts / dt:.2f} utt/s, RTF {dt / wav_s:.5f} "
              f"(first call, warm-up included) on {card}; launches topk {launches['topk']}, attention with bias "
              f"{launches['attention_bias_fwd']}, lstm_fwd {launches['lstm_fwd']}")
        runs[f"beam{beam}"] = {"launches": launches, "seconds": dt, "utt_per_s": n_utts / dt, "rtf": dt / wav_s}

    # one batch, card (kernels) against CPU (plain versions): greedy and top-1 hypotheses
    bi, idx = next(b for b in batches if len(b[1]) >= 4)
    batch = ds.collate(idx[:4], buckets[bi].max_xlen, buckets[bi].max_ylen)
    hyps = {}
    for name, d in (("cuda", dev), ("cpu", "cpu")):
        model = load_asr_model(tr["ckpt"], cfg)
        for beam in (0, cfg.beam_width):
            h, hl, _ = build_decode_fn(model, cfg, beam_width=beam, device=d)(batch["xs"], batch["xlens"])
            h, hl = h.cpu(), hl.cpu()
            hyps[name, beam] = [(h[b, : hl[b]] if h.dim() == 2 else h[b, 0, : hl[b, 0]]).tolist() for b in range(4)]
    for beam in (0, cfg.beam_width):
        require(hyps["cuda", beam] == hyps["cpu", beam],
                f"L4 beam {beam}: card and CPU hypotheses differ: {hyps['cuda', beam]} vs {hyps['cpu', beam]}")
    lens = [len(h) for h in hyps["cuda", cfg.beam_width]]
    print(f"  one batch {tuple(batch['xs'].shape)}: greedy and beam-{cfg.beam_width} top-1 hypotheses identical card vs "
          f"CPU (4 of 4; beam lengths {lens}, leading eos included)")
    return {"runs": runs, "n_utts": n_utts, "batches": len(batches), "frames": frames}


# ---------------------------------------------------------------- slices 3c and 6a
#
# Training of the attention family (L3-1) and of the Transformer, BERT and RNN
# LMs, their perplexity, and RNN-LM shallow fusion in the three beams.

LM_CONFS = {t: os.path.join(REPO, "configs", "lm", f"libri_{t}.yaml") for t in ("rnn", "transformer", "bert")}
# the RNN LM's (B, T, H) at its three buckets (L = 256: L/4, L/2, L tokens;
# min(90, 3000 // t) rows), input 512, in each of its two layers
LSTM_RNNLM_CASES = (((11, 256, 512), True), ((23, 128, 512), True), ((46, 64, 512), True))
# the PPL on the card against the CPU's on the same batches: sums of some
# 10^4 f32 log-probabilities in other orders
PPL_RTOL = 1e-4
# BERT's pseudo-PPL: the (11, 256) batch's (B L, L, V) float32 logits would
# take 28.8 GB; the chunked form must stay far below that
PLL_PEAK_BYTES = 8 << 30
# rows of the (11, 256) bucket that BERT's pseudo-PPL keeps in its check
# against the CPU (each some 130 masked copies of 256 tokens on the CPU)
BERT_PLL_LONG_ROWS = 3


def _launch_deltas(module, factory: str):
    """Patch `module.<factory>` (a factory of train steps) so that every step it
    builds records the launch counts of each call; returns (the list the
    deltas go to, a function that undoes the patch)."""
    deltas, orig = [], getattr(module, factory)

    def counting(*a, **kw):
        step = orig(*a, **kw)

        def wrapped(*sa, **skw):
            before = launch_counts()
            out = step(*sa, **skw)
            after = launch_counts()
            deltas.append({k: after[k] - before[k] for k in before})
            return out

        return wrapped

    setattr(module, factory, counting)
    return deltas, lambda: setattr(module, factory, orig)


def _zero_launches(**want) -> dict:
    return {**{k: 0 for k in launch_counts()}, **want}


# biases whose true gradient is zero: the attention's key bias (a constant
# on every key, which the softmax removes) and the convolution bias before a
# BatchNorm (which the batch mean removes)
INERT_BIASES = ("linear_k.bias", "depthwise_conv.bias")
# the noam warm-up of the copies whose update is held against a reference
# (L3-1's, phase 29's L1): the first update at 5 x 256^-0.5 x 50^-1.5 =
# 8.8e-4 (the shipped 25000 steps give 7.9e-08, an update that does not show)
UPDATE_WARMUP = 50


def train_l3_1(args, root: str, card: str, test_tsv: str, wav_s: float, compute_dtype: str = "float32",
               per_bucket=(1, 1, 1, 1, 1)) -> dict:
    """The L3-1 model (Conformer 12 x 256, Transformer decoder 6 x 256, FF
    2048, V = 10000, aux CTC 0.3, label smoothing 0.1) at full width through
    the train CLI: SpecAugment and dropout on, `enc_fused_attn: true`, one
    epoch over `per_bucket` batches of the five buckets up to (18, 1600)
    (by default 5 micro-steps: one optimizer update at accum_grad 5), in
    `compute_dtype`.  Every micro-step launches K1 (forward, both
    gradients) and K2 (alpha, beta) once for the aux CTC loss and K4 with
    its score bias (forward, backward) once a Conformer layer."""
    import yaml

    from emoasr_tpu_torch.config import load_config
    from emoasr_tpu_torch.models.asr import ASR
    from emoasr_tpu_torch.train import loop
    from emoasr_tpu_torch.train.checkpoint import load_state_dict

    with open(L3_1_CONF) as f:
        conf = yaml.safe_load(f)
    sub = os.path.join(root, "l3_1_train" if compute_dtype == "float32" else f"l3_1_train_{compute_dtype}")
    os.makedirs(sub)
    per_bucket = list(per_bucket)
    lengths, buckets = train_lengths(load_config(L3_1_CONF), per_bucket)
    train_tsv, _ = write_corpus(sub, "train", lengths, conf["vocab_size"], conf["feat_dim"], args.seed + 5)
    conf.update(vocab_path=write_vocab(sub, conf["vocab_size"]), train_path=train_tsv, test_path=test_tsv,
                dev_path=None, enc_fused_attn=True, dec_step_mode="fused_indirect", num_epochs=1, save_step=1,
                log_step=1, seed=args.seed, compute_dtype=compute_dtype, num_warmup_steps=UPDATE_WARMUP)
    conf_path = os.path.join(sub, "l3_1_ctc_joint.yaml")
    with open(conf_path, "w") as f:
        yaml.safe_dump(conf, f)
    cfg = load_config(conf_path)
    require((cfg.encoder_type, cfg.pos_encode_type, cfg.enc_num_layers, cfg.enc_hidden_size,
             cfg.enc_num_attention_heads, cfg.enc_intermediate_size, cfg.conv_kernel_size, cfg.decoder_type,
             cfg.dec_num_layers, cfg.dec_hidden_size, cfg.dec_intermediate_size, cfg.vocab_size, cfg.mtl_ctc_weight,
             cfg.lsm_prob, cfg.accum_grad, cfg.spec_augment, cfg.dropout_enc_rate, cfg.dropout_dec_rate,
             cfg.compute_dtype)
            == ("conformer", "rel", 12, 256, 4, 1024, 31, "transformer", 6, 256, 2048, 10000, 0.3, 0.1, 5, True, 0.1,
                0.1, compute_dtype), "the L3-1 config is not at full width")
    n_steps, n_enc = sum(per_bucket), cfg.enc_num_layers
    sfx = "" if compute_dtype == "float32" else "_bf16"
    per_step = _zero_launches(**{f"ctc_head_fwd{sfx}": 1, f"ctc_head_grad_e{sfx}": 1, f"ctc_head_grad_w{sfx}": 1,
                                 "ctc_alpha": 1, "ctc_beta_grad": 1, f"attention_fwd{sfx}": n_enc,
                                 f"attention_bwd{sfx}": n_enc, f"attention_bias_fwd{sfx}": n_enc,
                                 f"attention_bias_bwd{sfx}": n_enc})
    reset_launch_counts()
    deltas, undo = _launch_deltas(loop, "make_train_step")
    try:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state = loop.main(["-conf", conf_path])
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
    finally:
        undo()
    launches = launch_counts()
    losses, _, epoch_s = read_train_log(conf_path)
    require(state.step == n_steps and len(losses) == n_steps and all(np.isfinite(losses)),
            f"L3-1 training: {state.step} micro-steps, losses {losses}")
    require(state.skipped == 0 and state.mini_step == n_steps % cfg.accum_grad,
            f"L3-1 training: {state.skipped} skipped, {state.mini_step} micro-steps open")
    require(len(deltas) == n_steps and all(d == per_step for d in deltas),
            f"L3-1 training: launches by micro-step {deltas}, want each {per_step}")
    ckpt = os.path.join(os.path.splitext(conf_path)[0], "checkpoints", "model.ep1")
    torch.manual_seed(cfg.seed)
    init, trained = ASR(cfg).state_dict(), load_state_dict(ckpt)
    changed = [k for k in init if not torch.equal(init[k], trained[k])]
    if n_steps >= cfg.accum_grad:
        require(len(changed) >= 0.9 * len(init) and all(k in changed for k in (
            "decoder.output.weight", "decoder.ctc.output.weight", "decoder.embed.weight",
            "decoder.transformers.5.feed_forward.w1.weight", "encoder.conv.conv.0.weight")),
            f"only {len(changed)} of {len(init)} parameter tensors changed in training")
    else:  # no update yet: only the BatchNorm statistics moved, the accumulation is open
        require(changed and all(".batch_norm." in k and "running" in k or "num_batches" in k for k in changed),
                f"L3-1 training without an update changed {changed}")
    for k, v in trained.items():
        require(bool(torch.isfinite(v).all()), f"trained parameter {k} is not finite")
    if n_steps >= cfg.accum_grad:
        _require_f32_masters(state, trained)
    else:  # no Adam moment yet: the masters, the open accumulation and the checkpoint
        require(all(p.dtype == torch.float32 for p in state.model.parameters())
                and all(g.dtype == torch.float32 for g in state.acc_grads)
                and all(v.dtype == torch.float32 for v in trained.values() if v.is_floating_point()),
                "a master, an accumulated gradient or a checkpoint tensor is not float32")
    epoch = epoch_s[0] if epoch_s else float("nan")
    print(f"  trained {n_steps} {compute_dtype} micro-steps ({len(lengths)} utts, buckets x{per_bucket}) in {dt:.2f} s "
          f"(the epoch loop {epoch:.2f} s: {n_steps / epoch:.2f} micro-steps/s, first call, warm-up included) on "
          f"{card}; loss {losses[0]:.2f} -> {losses[-1]:.2f}, {len(changed)}/{len(init)} tensors changed; every "
          f"micro-step launched {({k: n for k, n in per_step.items() if n})}")
    return {"conf_path": conf_path, "cfg": cfg, "ckpt": ckpt, "test_tsv": test_tsv, "train_tsv": train_tsv,
            "wav_s": wav_s, "launches": launches, "seconds": dt, "epoch_seconds": epoch, "micro_steps": n_steps,
            "micro_steps_per_s": n_steps / epoch, "utt_per_s": len(lengths) / epoch, "losses": losses,
            "buckets": buckets, "per_step_launches": {k: n for k, n in per_step.items() if n}}


def check_l3_1_update(tr: dict, dev) -> dict:
    """One optimizer update of the trained L3-1 model (4 rows of the
    400-frame bucket, dropout and SpecAugment off, accum_grad 1, the copy's
    warm-up LR) through the train step on the card and on the CPU: the
    parameters after it within PAR_PARAM_TOL LRs of each other everywhere
    and within 2 % of the LR on all but 1 % of each tensor's entries, and
    the update shows.  Adam's first step moves an entry by about the LR, in
    the sign of its gradient: where the true gradient is zero (the biases in
    INERT_BIASES: a constant on every key, or before a BatchNorm) rounding
    noise decides that sign, so those are held to the first bound only, and
    so is an entry whose gradient on the CPU is no larger than the card's
    and the CPU's gradients differ there (`updates_close`'s `noise`)."""
    from emoasr_tpu_torch.data.asr_dataset import ASRDataset
    from emoasr_tpu_torch.eval.test_asr import load_asr_model
    from emoasr_tpu_torch.train.optim import build_optimizer
    from emoasr_tpu_torch.train.step import TrainState, make_train_step

    cfg = tr["cfg"].replace(accum_grad=1, dropout_enc_rate=0.0, dropout_dec_rate=0.0, dropout_attn_rate=0.0,
                            spec_augment=False)
    ds = ASRDataset(cfg, tr["train_tsv"], phase="train")
    batcher = ds.make_batcher(shuffle=False)
    bi, idx = next(b for b in batcher if batcher.buckets[b[0]].max_xlen == 400)
    batch = ds.collate(idx[:4], 400, batcher.buckets[bi].max_ylen)
    after, grads, lr = {}, {}, None
    for name, d in (("cuda", dev), ("cpu", torch.device("cpu"))):
        model = load_asr_model(tr["ckpt"], cfg).to(d)
        before = {k: v.detach().cpu().clone() for k, v in model.named_parameters()}
        state = TrainState(model=model, optimizer=build_optimizer(cfg, model.parameters()))
        m = make_train_step(cfg)(state, {k: torch.from_numpy(v).to(d) for k, v in batch.items()
                                        if isinstance(v, np.ndarray)})
        require(m["grad_finite"] and state.step == 1, f"L3-1 update on {name}: {m}")
        lr = m["lr"]
        after[name] = {k: v.detach().cpu() for k, v in model.named_parameters()}
        grads[name] = first_step_grads(state.optimizer.state_dict(), optimizer_order(model, state.optimizer))
    moved, worst, worst_share, n_noise = updates_close("L3-1 update, card vs CPU", after["cuda"], after["cpu"],
                                                       before, lr, gradient_noise(grads["cuda"], grads["cpu"]))
    print(f"  one L3-1 update (LR {lr:.3e}, 4 x 400 frames) card vs CPU: parameters within {worst:.3e} "
          f"({worst / lr:.3f} LR; at most {worst_share:.4f} of a tensor's entries beyond 2 % of the LR, {n_noise} "
          f"entries' gradients within the two devices' difference of zero), largest move {moved:.3e}")
    return {"lr": lr, "param_max_abs_err": worst, "share_beyond_2pct_lr": worst_share, "largest_move": moved,
            "noise_entries": n_noise}


def optimizer_order(model, optimizer) -> list:
    """The parameter names of an optimizer's state_dict indices."""
    names = {id(p): n for n, p in model.named_parameters()}
    return [names[id(p)] for g in optimizer.param_groups for p in g["params"]]


def first_step_grads(opt_sd: dict, order: list) -> dict:
    """The gradients (the decay term included) that Adam's first step took,
    by name: the first moment, which starts at zero, over 1 - beta1."""
    return {order[i]: opt_sd["state"][i]["exp_avg"].detach().double().cpu() / (1.0 - g["betas"][0])
            for g in opt_sd["param_groups"] for i in g["params"]}


# an entry's first-step gradient may be rounding noise only below this share
# of its tensor's largest: a gradient that is wrong throughout marks nothing
GRAD_NOISE_REL = 1e-3


def gradient_noise(got: dict, want: dict) -> dict:
    """Per entry, whether `want`'s gradient is no larger than the two runs'
    difference there and below GRAD_NOISE_REL of its tensor's largest:
    rounding noise decides the sign of Adam's first step there."""
    return {k: (w.abs() <= (got[k] - w).abs()) & (w.abs() <= GRAD_NOISE_REL * w.abs().max()) for k, w in want.items()}


def updates_close(tag: str, got: dict, want: dict, before: dict, lr: float, noise: dict) -> tuple:
    """Parameters after one Adam update (`got` against `want`, both from
    `before`): within PAR_PARAM_TOL LRs everywhere, and within 2 % of the LR
    on all but 1 % of each tensor's entries, except the INERT_BIASES and the
    entries that `noise` (`gradient_noise` of the two runs' first-step
    gradients) marks (see `check_l3_1_update`); the update showed (an entry
    of `want` moved by at least half the LR).  Returns (largest move,
    largest gap, largest share beyond 2 % of the LR, entries marked)."""
    keys = [k for k in want if want[k].is_floating_point()]
    require(set(got) == set(want), f"{tag}: the tensors differ")
    moved = max((want[k].double() - before[k].double()).abs().max().item() for k in keys)
    require(moved >= 0.5 * lr, f"{tag}: the parameters moved {moved:.3e} at LR {lr:.3e}")
    worst, worst_share, marked = 0.0, 0.0, 0
    for k in keys:
        diff = (got[k].double() - want[k].double()).abs()
        beyond = diff > 0.02 * lr
        if k in noise:
            beyond &= ~noise[k].reshape(beyond.shape)
            marked += int(noise[k].sum())
        share = 0.0 if k.endswith(INERT_BIASES) else beyond.double().mean().item()
        require(diff.max().item() <= PAR_PARAM_TOL * lr and share <= 0.01,
                f"{tag}, {k}: {diff.max().item():.3e} (LR {lr:.3e}), {share:.4f} of its entries beyond 2 % of the LR")
        worst, worst_share = max(worst, diff.max().item()), max(worst_share, share)
    return moved, worst, worst_share, marked


def l3_1_heads(cfg):
    """The L3-1 micro-step check's vocabulary-sized layers: the attention
    output (on the paths: the labels and eos) and the aux CTC head (the
    labels and blank)."""
    return (("decoder.output", lambda b: np.append(b["ys_out"][:4].reshape(-1), cfg.eos_id)),
            ("decoder.ctc.output", lambda b: np.append(b["ys"][:4].reshape(-1), cfg.blank_id)))


def _att_beam_launches(launches: dict, cfg, n_batches: int, tag: str) -> int:
    """Checks an attention-beam decode's launches (K4 with its bias once a
    layer a batch, K5 indirect 6 a beam step, one K3 a step); returns the
    beam steps."""
    steps = launches["decoder_step_indirect"] // cfg.dec_num_layers
    n_attn = cfg.enc_num_layers * n_batches
    require(launches["attention_fwd"] == launches["attention_bias_fwd"] == n_attn, f"{tag}: launches {launches}")
    require(steps >= n_batches and launches["decoder_step_indirect"] == steps * cfg.dec_num_layers
            and launches["decoder_step"] == 0 and launches["topk"] == steps, f"{tag}: launches {launches}")
    return steps


def decode_trained_l3_1(tr: dict, card: str, lm: dict = None) -> dict:
    """The L3-1 trainer's `model.ep1` through the eval CLI: beam 10, joint
    CTC 0.3, length weight 2, `dec_step_mode: fused_indirect` (the yaml's);
    with `lm` (`train_lms`'s RNN LM) fused at 0.5 through `--lm_conf` and
    `--lm_path`."""
    import pandas as pd

    from emoasr_tpu_torch.data.asr_dataset import ASRDataset
    from emoasr_tpu_torch.eval import test_asr

    cfg, conf_path = tr["cfg"], tr["conf_path"]
    batcher = ASRDataset(cfg, tr["test_tsv"], phase="test").make_batcher()
    n_batches, n_utts = len(batcher), sum(len(i) for _, i in batcher)
    argv = ["-conf", conf_path, "-ep", "1"]
    name = "result_test_beam10_len2.0_ctc0.3_lm0.00_ep1.tsv"
    if lm is not None:
        argv += ["--lm_weight", "0.5", "--lm_conf", lm["conf_path"], "--lm_path", lm["ckpt"]]
        name = "result_test_beam10_len2.0_ctc0.3_lm0.50rnn_ep1.tsv"
    reset_launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with _LogCapture("force-finalized") as cap:
        out = test_asr.main(argv)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    launches = launch_counts()
    tag = "L3-1 (trained)" + (" + RNN LM" if lm else "")
    require(out is not None and out[3].startswith("WER:"), f"{tag}: CLI returned {out}")
    df = pd.read_table(os.path.join(os.path.splitext(conf_path)[0], "results", name), comment="#")
    require(len(df) == n_utts and int(df["token_id"].notna().sum()) == n_utts, f"{tag}: {len(df)} rows")
    steps = _att_beam_launches(launches, cfg, n_batches, tag)
    if lm is not None:  # the RNN LM's one-token steps take the scan
        require(launches["lstm_fwd"] == launches["lstm_bwd"] == 0, f"{tag}: K8 launched: {launches}")
    forced = int(cap.lines[0].split()[0]) if cap.lines else 0
    print(f"  {tag}, beam 10, joint CTC 0.3, fused_indirect: {out[3]}; {n_utts} utts in {dt:.3f} s, RTF "
          f"{dt / tr['wav_s']:.5f} (first call) on {card}; {steps} beam steps, {forced} hypotheses force-finalized; "
          f"launches topk {launches['topk']}, decoder_step_indirect {launches['decoder_step_indirect']}, attention "
          f"with bias {launches['attention_bias_fwd']}")
    return {"launches": launches, "seconds": dt, "rtf": dt / tr["wav_s"], "beam_steps": steps,
            "forced_finalisations": forced, "n_utts": n_utts}


def write_lm_corpus(root: str, vocab_size: int, seed: int):
    """A sharded synthetic text corpus (`train/` of two files) whose rows
    fill one batch of each LM bucket a shard for every LM type (11 rows of
    200-254 tokens, 23 of 100-126, 46 of 40-62: with the causal shift or
    the RNN LM's sos/eos framing, the (11, 256), (23, 128) and (46, 64)
    buckets), and a test file: 11 rows of 129-139 tokens (the (11, 256)
    bucket), 3 of 70-100 and 3 of 20-60.  Token ids 3..V-2 (V-1 is BERT's
    mask)."""
    import pandas as pd

    rng = np.random.default_rng(seed)

    def rows(spec, tag):
        out = []
        for n, lo, hi in spec:
            for _ in range(n):
                L = int(rng.integers(lo, hi + 1))
                out.append(dict(utt_id=f"{tag}{len(out)}", token_id=" ".join(map(str, rng.integers(3, vocab_size - 1, L))),
                                ylen=L))
        return pd.DataFrame(out)

    train_dir = os.path.join(root, "train")
    os.makedirs(train_dir)
    n_rows = 0
    for shard in ("a", "b"):
        df = rows(((11, 200, 254), (23, 100, 126), (46, 40, 62)), shard)
        df.to_csv(os.path.join(train_dir, f"{shard}.tsv"), sep="\t", index=False)
        n_rows += len(df)
    test_tsv = os.path.join(root, "test.tsv")
    rows(((11, 129, 139), (3, 70, 100), (3, 20, 60)), "t").to_csv(test_tsv, sep="\t", index=False)
    return train_dir, test_tsv, n_rows


def _read_lm_log(conf_path: str):
    import re

    with open(os.path.join(os.path.splitext(conf_path)[0], "log", "train.log")) as f:
        return [float(m.group(1)) for m in re.finditer(r"step \d+ [^\n]*?loss_total: (\S+) ", f.read())]


def train_lms(args, root: str, card: str) -> dict:
    """`configs/lm/libri_{rnn,transformer,bert}.yaml` at full width (RNN 2 x
    512 LSTM, embedding 512; Transformer and BERT 4 x 512, 8 heads, FF 2048;
    V = 10000, max_seq_len 256, batch_size 90, dropout on, AdamW) through
    `train_lm` over the sharded corpus: one epoch, 6 steps (one batch of
    each bucket a shard), `train_size` set to 90 x 6 so that the lindecay
    schedule spans this run.  The RNN LM's steps launch K8 forward and
    backward twice each (two layers); the others launch no kernel."""
    import yaml

    from emoasr_tpu_torch.config import load_config
    from emoasr_tpu_torch.models.lm.lm import LM
    from emoasr_tpu_torch.ops import lstm_scan
    from emoasr_tpu_torch.train import train_lm
    from emoasr_tpu_torch.train.checkpoint import load_state_dict

    sub = os.path.join(root, "lm")
    os.makedirs(sub)
    train_dir, test_tsv, n_rows = write_lm_corpus(sub, 10000, args.seed + 6)
    out = {}
    for t, path in LM_CONFS.items():
        with open(path) as f:
            conf = yaml.safe_load(f)
        n_steps = 6
        conf.update(train_path=train_dir, test_path=test_tsv, vocab_path=None, train_size=90 * n_steps, num_epochs=1,
                    save_step=1, log_step=1, seed=args.seed)
        conf_path = os.path.join(sub, f"libri_{t}.yaml")
        with open(conf_path, "w") as f:
            yaml.safe_dump(conf, f)
        cfg = load_config(conf_path)
        width = (cfg.lm_type, cfg.vocab_size, cfg.hidden_size, cfg.num_layers, cfg.max_seq_len, cfg.batch_size)
        require(width == {"rnn": ("rnn", 10000, 512, 2, 256, 90), "transformer": ("transformer", 10000, 512, 4, 256, 90),
                          "bert": ("bert", 10000, 512, 4, 256, 90)}[t]
                and (t != "rnn" or (cfg.embedding_size, cfg.dropout_rate, cfg.add_sos_eos) == (512, 0.2, True)),
                f"the {t} LM config is not at full width: {width}")
        per_step = _zero_launches(**({"lstm_fwd": cfg.num_layers, "lstm_bwd": cfg.num_layers} if t == "rnn" else {}))
        reset_launch_counts()
        deltas, undo = _launch_deltas(train_lm, "make_lm_train_step")
        try:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            state = train_lm.main(["-conf", conf_path])
            torch.cuda.synchronize()
            dt = time.perf_counter() - t0
        finally:
            undo()
        launches = launch_counts()
        k8_shapes = dict(lstm_scan.SHAPE_LAUNCHES)
        losses = _read_lm_log(conf_path)
        require(state.step == n_steps and len(losses) == n_steps and all(np.isfinite(losses)) and state.skipped == 0,
                f"{t} LM training: {state.step} steps, losses {losses}, {state.skipped} skipped")
        require(len(deltas) == n_steps and all(d == per_step for d in deltas),
                f"{t} LM training: launches by step {deltas}, want each {per_step}")
        if t == "rnn":  # every bucket's shape, in both layers, forward and backward
            want_shapes = {(kind, B, T, 512, "f32"): 2 * cfg.num_layers  # one batch a shard, each layer
                           for kind in ("fwd", "bwd") for (B, T, _), _ in LSTM_RNNLM_CASES}
            require(k8_shapes == want_shapes, f"RNN LM training: K8 launches by shape {k8_shapes}, want {want_shapes}")
        ckpt = os.path.join(os.path.splitext(conf_path)[0], "checkpoints", "model.ep1")
        torch.manual_seed(cfg.seed)
        init, trained = LM(cfg).state_dict(), load_state_dict(ckpt)
        changed = [k for k in init if not torch.equal(init[k], trained[k])]
        require(len(changed) >= 0.9 * len(init) and all(bool(torch.isfinite(v).all()) for v in trained.values()),
                f"{t} LM: {len(changed)} of {len(init)} tensors changed")
        _require_f32_masters(state, trained)
        print(f"  {t} LM: {n_steps} steps over {n_rows} rows in 2 shards in {dt:.2f} s (first call) on {card}; loss "
              f"{losses[0]:.3f} -> {losses[-1]:.3f}; {len(changed)}/{len(init)} tensors changed; launches a step "
              f"{({k: n for k, n in per_step.items() if n}) or 'none'}"
              + (f"; K8 by shape {k8_shapes}" if t == "rnn" else ""))
        out[t] = {"conf_path": conf_path, "cfg": cfg, "ckpt": ckpt, "test_tsv": test_tsv, "train_dir": train_dir,
                  "launches": launches, "seconds": dt, "steps": n_steps, "losses": losses,
                  "k8_by_shape": {"/".join(map(str, k)): n for k, n in k8_shapes.items()}}
    return out


def check_rnn_lm_step(lm: dict, dev) -> dict:
    """One RNN LM step on the card (K8 forward and backward, twice each)
    against the CPU (the plain scan), on the trainer's checkpoint, 8 rows
    of the (46, 64) bucket, dropout off: the loss within STEP_TOL and every
    gradient within STEP_TOL of its largest entry (the output layer by
    vocabulary column, its bias by group)."""
    from emoasr_tpu_torch.data.lm_dataset import LMDataset
    from emoasr_tpu_torch.models.lm.lm import LM, load_lm_state_dict
    from emoasr_tpu_torch.train.checkpoint import load_state_dict

    cfg = lm["cfg"]
    ds = LMDataset(cfg, os.path.join(lm["train_dir"], "a.tsv"), phase="train", seed=cfg.seed)
    batch = next(b for b in ds.batches(ds.make_batcher(shuffle=False)) if b["ys_in"].shape[1] == 64)
    batch = {k: v[:8] for k, v in batch.items() if isinstance(v, np.ndarray)}
    res = {}
    for name, d in (("cuda", dev), ("cpu", torch.device("cpu"))):
        model = LM(cfg)
        load_lm_state_dict(model, load_state_dict(lm["ckpt"]))
        model = model.to(d).eval()
        t = {k: torch.from_numpy(v).to(d) for k, v in batch.items()}
        before = launch_counts()
        loss, _ = model(t["ys_in"], t["ylens"], t["labels"])
        params = dict(model.named_parameters())
        grads = torch.autograd.grad(loss, list(params.values()))
        used = {k: launch_counts()[k] - before[k] for k in before}
        if name == "cuda":
            require(used["lstm_fwd"] == used["lstm_bwd"] == cfg.num_layers,
                    f"the RNN LM step check did not go through K8: {used}")
        res[name] = (loss.item(), {k: g.cpu() for k, g in zip(params, grads)})
    (l1, g1), (l0, g0) = res["cuda"], res["cpu"]
    require(np.isfinite(l1) and abs(l1 - l0) <= STEP_TOL["loss"] * abs(l0), f"RNN LM step loss: card {l1}, CPU {l0}")
    floor = STEP_TOL["grad_floor"] * max(g.abs().max().item() for g in g0.values())
    worst = 0.0
    for k in g0:
        rel = max(_max_err(g1[k], g0[k]) - floor, 0.0) / max(g0[k].abs().max().item(), 1e-30)
        worst = max(worst, rel)
        require(rel <= STEP_TOL["grad"], f"RNN LM step gradient of {k}: card vs CPU {rel:.3e} of its largest entry")
    _, rel_w = _require_close_by_column("RNN LM step gradient of lm.output.weight", g1["lm.output.weight"],
                                        g0["lm.output.weight"], 0, STEP_TOL["column_atol"], STEP_TOL["grad"])
    labels = torch.from_numpy(batch["labels"])
    rel_b = _require_close_by_group("RNN LM step gradient of lm.output.bias", g1["lm.output.bias"], g0["lm.output.bias"],
                                    _vocab_groups(cfg.vocab_size, labels[labels >= 0]), STEP_TOL["column_atol"],
                                    STEP_TOL["grad"])
    print(f"  one RNN LM step {tuple(batch['ys_in'].shape)} card (K8) vs CPU plain: loss {l1:.5f} vs {l0:.5f}; worst "
          f"gradient {worst:.2e} of its largest entry (tol {STEP_TOL['grad']}); the output layer by vocabulary column "
          f"{rel_w:.2e}, its bias by group {rel_b:.2e}")
    return {"loss_card": l1, "loss_cpu": l0, "worst_grad_rel_err": worst, "output_weight_column_rel_err": rel_w,
            "output_bias_group_rel_err": rel_b}


def time_rnn_lm_step(lm: dict, dev, card: str) -> dict:
    """Where one RNN LM step of the largest bucket, (11, 256), spends its
    time (host clock around synchronised phases, dropout on; the last of
    three): embedding + the two LSTM layers (K8 forward), the output layer
    and the loss, the backward (K8 backward twice), clip + AdamW."""
    from emoasr_tpu_torch.data.lm_dataset import LMDataset
    from emoasr_tpu_torch.models.lm.lm import LM, load_lm_state_dict
    from emoasr_tpu_torch.models.lm.bert import mlm_loss
    from emoasr_tpu_torch.train.checkpoint import load_state_dict
    from emoasr_tpu_torch.train.optim import build_optimizer, clip_by_global_norm_

    cfg = lm["cfg"]
    ds = LMDataset(cfg, os.path.join(lm["train_dir"], "a.tsv"), phase="train", seed=cfg.seed)
    batch = next(b for b in ds.batches(ds.make_batcher(shuffle=False)) if b["ys_in"].shape[1] == 256)
    t = {k: torch.from_numpy(v).to(dev) for k, v in batch.items() if isinstance(v, np.ndarray)}
    model = LM(cfg)
    load_lm_state_dict(model, load_state_dict(lm["ckpt"]))
    model = model.to(dev).train()
    rnn = model.lm
    opt = build_optimizer(cfg, model, use_adamw=True)
    for g in opt.param_groups:
        g["lr"] = 1e-9
    params = list(model.parameters())

    def tick():
        torch.cuda.synchronize()
        return time.perf_counter()

    for _ in range(3):
        t0 = tick()
        out, _ = rnn.rnns(rnn.dropout(rnn.embed(t["ys_in"].long())))
        t1 = tick()
        loss = mlm_loss(rnn.output(rnn.dropout(out)), t["labels"])
        t2 = tick()
        grads = torch.autograd.grad(loss, params)
        t3 = tick()
        clip_by_global_norm_(grads, cfg.clip_grad_norm)
        for p, g in zip(params, grads):
            p.grad = g
        opt.step()
        t4 = tick()
    split = {"batch": list(t["ys_in"].shape), "embed_lstm_fwd_ms": (t1 - t0) * 1e3,
             "output_loss_fwd_ms": (t2 - t1) * 1e3, "backward_ms": (t3 - t2) * 1e3, "clip_adamw_ms": (t4 - t3) * 1e3}
    print(f"  one {tuple(t['ys_in'].shape)} RNN LM step on {card}: embedding + 2 LSTM layers (K8) "
          f"{split['embed_lstm_fwd_ms']:.2f} ms, output layer + loss {split['output_loss_fwd_ms']:.2f} ms, backward "
          f"{split['backward_ms']:.2f} ms, clip + AdamW {split['clip_adamw_ms']:.2f} ms")
    return split


def lm_ppl(lms: dict, dev, card: str) -> dict:
    """The PPL CLI on each trained LM over the test file (BERT:
    pseudo-PPL, the (11, 256) batch included) on the card, then
    `evaluate_ppl` on the CPU: equal within PPL_RTOL; BERT's peak device
    memory far below the (B L, L, V) logits'.  The RNN and Transformer LMs
    are held over the whole file.  BERT's CPU pseudo-PPL over the whole
    file took 53 s of a run (NVIDIA H100 80GB HBM3, 700.00 W: the CPU
    beside it), so BERT is held in two links: the CLI's value equal to
    `evaluate_ppl` on the card over the whole file, and `evaluate_ppl` on
    the card against the CPU over the shorter buckets' rows and
    BERT_PLL_LONG_ROWS rows of the (11, 256) bucket, which still make a
    batch 256 tokens wide (a cut of depth: the CPU's cost goes with the
    masked copies, one a valid token)."""
    import pandas as pd

    from emoasr_tpu_torch.data.lm_dataset import LMDataset
    from emoasr_tpu_torch.eval import test_ppl
    from emoasr_tpu_torch.models.lm.lm import LM, load_lm_state_dict
    from emoasr_tpu_torch.train.checkpoint import load_state_dict

    out = {}
    for t, lm in lms.items():
        cfg = lm["cfg"]
        reset_launch_counts()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(dev)
        t0 = time.perf_counter()
        cnt, ppl = test_ppl.main(["-conf", lm["conf_path"], "-ep", "1"])
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated(dev)
        launches = launch_counts()
        model = LM(cfg)
        load_lm_state_dict(model, load_state_dict(lm["ckpt"]))
        tsv, cnt_c, ppl_c, note = lm["test_tsv"], cnt, ppl, ""
        if t == "bert":
            cnt1, ppl1 = test_ppl.evaluate_ppl(cfg, model.to(dev), LMDataset(cfg, tsv, phase="test"))
            require(cnt1 == cnt and abs(ppl1 - ppl) <= 1e-6 * ppl,  # one program on one card: the same sums
                    f"BERT pseudo-PPL: the CLI {cnt} tokens {ppl}, evaluate_ppl on the card {cnt1} tokens {ppl1}")
            rows = pd.read_table(tsv)
            long = rows["ylen"] >= 128  # the rows of the (11, 256) bucket
            tsv = os.path.join(os.path.dirname(tsv), "test_checked.tsv")
            pd.concat([rows[long].iloc[:BERT_PLL_LONG_ROWS], rows[~long]]).to_csv(tsv, sep="\t", index=False)
            shapes = [tuple(b["ys_in"].shape) for b in LMDataset(cfg, tsv, phase="test").batches(
                LMDataset(cfg, tsv, phase="test").make_batcher(shuffle=False, drop_tail=False))]
            require((BERT_PLL_LONG_ROWS, 256) in shapes, f"BERT pseudo-PPL CPU check: batches {shapes}")
            t1 = time.perf_counter()
            cnt_c, ppl_c = test_ppl.evaluate_ppl(cfg, model, LMDataset(cfg, tsv, phase="test"))
            torch.cuda.synchronize()
            note = (f"; the CLI = evaluate_ppl on the card over the whole file ({ppl1:.6f}); card vs CPU over "
                    f"batches {shapes} ({time.perf_counter() - t1:.2f} s on {next(model.parameters()).device})")
            model = model.cpu()
        t1 = time.perf_counter()
        cnt0, ppl0 = test_ppl.evaluate_ppl(cfg, model, LMDataset(cfg, tsv, phase="test"))
        cpu_s = time.perf_counter() - t1
        require(cnt_c == cnt0 > 0 and np.isfinite(ppl) and abs(ppl_c - ppl0) <= PPL_RTOL * ppl0,
                f"{t} LM PPL: card {cnt_c} tokens {ppl_c}, CPU {cnt0} tokens {ppl0}")
        if t == "bert":
            require(peak < PLL_PEAK_BYTES, f"BERT pseudo-PPL peak device memory {peak} bytes")
        if t == "rnn":  # the forward over each test batch, in both layers
            require(launches["lstm_fwd"] == 3 * cfg.num_layers and launches["lstm_bwd"] == 0,
                    f"RNN LM PPL: K8 launches {launches}")
        kind = "pseudo-PPL" if t == "bert" else "PPL"
        print(f"  {t} LM {kind} CLI over {cnt} tokens: {ppl:.6f} on the card ({dt:.2f} s, peak device memory "
              f"{peak / 2 ** 30:.2f} GiB){note}: {ppl_c:.6f} over {cnt_c} tokens vs {ppl0:.6f} on the CPU "
              f"({cpu_s:.2f} s): rel err {abs(ppl_c - ppl0) / ppl0:.2e} (tol {PPL_RTOL}); {card}")
        out[t] = {"tokens": cnt, "ppl_card": ppl, "checked_tokens": cnt_c, "checked_ppl_card": ppl_c,
                  "ppl_cpu": ppl0, "seconds": dt, "cpu_seconds": cpu_s, "peak_device_bytes": peak,
                  "launches": launches}
    return out


def _short_batch(cfg, tsv: str, n: int = 3):
    """The first `n` utterances of the shortest bucket of `tsv` that holds
    `n`, collated."""
    from emoasr_tpu_torch.data.asr_dataset import ASRDataset

    ds = ASRDataset(cfg, tsv, phase="test")
    batcher = ds.make_batcher()
    bi, idx = min((b for b in batcher if len(b[1]) >= n), key=lambda b: batcher.buckets[b[0]].max_xlen)
    return ds.collate(idx[:n], batcher.buckets[bi].max_xlen, batcher.buckets[bi].max_ylen)


def _top1_card_vs_cpu(tag: str, cfg, ckpt: str, lm_of, batch, dev, beam: int, share: float, **kw) -> dict:
    """`build_decode_fn` with the LM fusion `lm_of(device)` at `beam` on the
    card and on the CPU: the top-1 hypotheses of `batch` equal for at least
    `share` of its utterances."""
    from emoasr_tpu_torch.eval.decode import build_decode_fn
    from emoasr_tpu_torch.eval.test_asr import load_asr_model

    hyps = {}
    for name, d in (("cuda", dev), ("cpu", torch.device("cpu"))):
        fn = build_decode_fn(load_asr_model(ckpt, cfg), cfg, beam, lm=lm_of(d), device=d, **kw)
        h, hl, _ = fn(batch["xs"], batch["xlens"])
        h, hl = h.cpu(), hl.cpu()
        hyps[name] = [(h[b, : hl[b]] if h.dim() == 2 else h[b, 0, : hl[b, 0]]).tolist()
                      for b in range(len(batch["utt_ids"]))]
    same = sum(a == b for a, b in zip(hyps["cuda"], hyps["cpu"])) / len(hyps["cpu"])
    require(same >= share, f"{tag}: top-1 hypotheses card vs CPU equal for {same:.2f} (want {share}): "
            f"{hyps['cuda']} vs {hyps['cpu']}")
    print(f"  {tag}: one {tuple(batch['xs'].shape)} batch, top-1 hypotheses card vs CPU equal for {same:.2f} "
          f"(required {share}; lengths {[len(x) for x in hyps['cpu']]})")
    return {"same_top1": same, "lengths": [len(x) for x in hyps["cpu"]]}


def rnn_lm_fusion(args, rnn: dict, l1: dict, l3: dict, l4: dict, dev, card: str) -> dict:
    """The trained RNN LM fused at 0.5: into the L1 CTC prefix beam (beam
    8) and the L3-1 attention beam (beam 10, joint CTC 0.3) through the eval
    CLI, and, in Python, into the L4 ALSD beam (beam 10) with a 2 x 512 RNN
    LM over L4's vocabulary of 1000 (libri_rnn.yaml's widths, weights from
    the seed).  K8 is launched no time (one-token LSTM steps take the
    scan); one short batch's top-1 hypotheses on the card against the CPU:
    all equal for L1 and L4 (as the L4 decode check holds them), HYP_SHARE
    for L3-1 (as the L3-1 decode check: near-flat scores)."""
    import dataclasses

    import pandas as pd

    from emoasr_tpu_torch.eval import test_asr
    from emoasr_tpu_torch.models.lm.lm import LM
    from emoasr_tpu_torch.search.common import make_lm_fusion

    lm_model = test_asr.load_lm(rnn["conf_path"], rnn["ckpt"])[0]
    fusion_of = lambda d: make_lm_fusion(lm_model.to(d), 0.5)  # noqa: E731
    out = {}
    # L1: the CTC prefix beam through the CLI, then one batch card vs CPU
    conf_path, cfg = l1["conf_path"], l1["cfg"]
    reset_launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = test_asr.main(["-conf", conf_path, "-ep", "1", "--beam_width", "8", "--lm_weight", "0.5",
                         "--lm_conf", rnn["conf_path"], "--lm_path", rnn["ckpt"]])
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    launches = launch_counts()
    require(res is not None and res[3].startswith("WER:"), f"L1 + RNN LM: CLI returned {res}")
    df = pd.read_table(os.path.join(os.path.splitext(conf_path)[0], "results",
                                    "result_test_beam8_len0.0_ctc0.0_lm0.50rnn_ep1.tsv"), comment="#")
    require(len(df) == args.n_utts and launches["topk"] > 0 and launches["lstm_fwd"] == 0,
            f"L1 + RNN LM: {len(df)} rows, launches {launches}")
    print(f"  L1 CTC beam 8 + RNN LM 0.5 through the eval CLI: {res[3]}; {len(df)} utts in {dt:.3f} s, RTF "
          f"{dt / l1['wav_s']:.5f} (first call) on {card}; launches topk {launches['topk']}, lstm_fwd 0")
    out["l1_ctc_beam8"] = {"launches": launches, "seconds": dt, "rtf": dt / l1["wav_s"],
                           **_top1_card_vs_cpu("L1 CTC beam 8 + RNN LM", cfg, l1["ckpt"], fusion_of,
                                               _short_batch(cfg, l1["test_tsv"]), dev, 8, 1.0)}
    # L3-1: the attention beam through the CLI, then one batch card vs CPU
    run = decode_trained_l3_1(l3, card, lm=rnn)
    cfg = l3["cfg"]
    out["l3_1_beam10"] = {**run, **_top1_card_vs_cpu(
        "L3-1 beam 10 + joint CTC 0.3 + RNN LM", cfg, l3["ckpt"], fusion_of, _short_batch(cfg, l3["test_tsv"]), dev,
        cfg.beam_width, HYP_SHARE, len_weight=cfg.len_weight, decode_ctc_weight=cfg.decode_ctc_weight, top1=True)}
    # L4: ALSD in Python with an RNN LM over its vocabulary, on a copy of the checkpoint that emits labels
    cfg4 = l4["cfg"]
    lm4_cfg = dataclasses.replace(rnn["cfg"], vocab_size=cfg4.vocab_size)
    torch.manual_seed(args.seed)
    lm4 = LM(lm4_cfg).eval()
    with torch.no_grad():  # a prior that pulls the labels toward one token
        lm4.state_dict()["lm.output.bias"][ALSD_LM_TOKEN] += GRID_LM_BIAS
    batch = _short_batch(cfg4, l4["test_tsv"])
    ckpt4, shift = _emitting_copy(cfg4, l4["ckpt"], batch, ALSD_LM_TOKEN)
    reset_launch_counts()
    res4 = _top1_card_vs_cpu(f"L4 ALSD beam 10 + RNN LM (V = 1000, seed weights, token {ALSD_LM_TOKEN}'s bias "
                             f"+{GRID_LM_BIAS}, and in the ASR's copy +{shift:.2f})", cfg4, ckpt4,
                             lambda d: make_lm_fusion(lm4.to(d), 0.5), batch, dev, cfg4.beam_width, 1.0)
    launches = launch_counts()
    require(launches["topk"] > 0 and launches["lstm_fwd"] == launches["lstm_bwd"] == 0,
            f"L4 ALSD + RNN LM: launches {launches}")
    require(min(res4["lengths"]) > 1, f"L4 ALSD + RNN LM: an empty top-1 hypothesis, lengths {res4['lengths']} "
            "(the leading eos included)")
    out["l4_alsd10"] = {"launches": launches, "blank_shift": shift, **res4}
    return out


# the RNN LM's token whose output bias the ALSD check raises (GRID_LM_BIAS)
ALSD_LM_TOKEN = 3


def _emitting_copy(cfg, ckpt: str, batch, token: int) -> tuple:
    """(path, shift): a copy of an RNN-T checkpoint whose logit of `token`
    is raised by `shift`, 5 nats past the largest margin of blank over it at
    `batch`'s frames from the empty hypothesis, so that the copy emits it
    (the 10-step L4 model emits no label, and shallow fusion only adds
    log-probabilities: no LM makes a model that never emits emit)."""
    from emoasr_tpu_torch.eval.test_asr import load_asr_model
    from emoasr_tpu_torch.train.checkpoint import load_state_dict, save_state_dict
    from emoasr_tpu_torch.train.step import preprocess

    model = load_asr_model(ckpt, cfg).eval()
    xs, xlens = torch.from_numpy(batch["xs"]), torch.from_numpy(batch["xlens"]).long()
    with torch.no_grad():
        eouts, elens, _ = model.encode(*preprocess(cfg, xs, xlens))
        douts, _ = model.decoder.recurrency(torch.full((xs.shape[0], 1), cfg.eos_id, dtype=torch.long))
        logp = torch.log_softmax(model.decoder.joint(eouts, douts).float(), dim=-1)[:, :, 0]  # (B, T', V)
    margin = logp[..., cfg.blank_id] - logp[..., token]
    valid = torch.arange(margin.shape[1])[None, :] < elens[:, None]
    shift = float(margin[valid].max()) + 5.0
    sd = load_state_dict(ckpt)
    sd["decoder.output.bias"][token] += shift
    path = ckpt + ".emitting"
    save_state_dict(sd, path)
    return path, shift


# ------------------------------------------------ slices 6b and 7a: the rest
# of the LM package, N-best rescoring and error correction

ELECTRA_CONF = os.path.join(REPO, "configs", "lm", "ted2_electra.yaml")
PELECTRA_CONF = os.path.join(REPO, "configs", "lm", "ted2_pelectra.yaml")
PC_MLM_CONF = os.path.join(REPO, "configs", "csj", "del_pc_mlm.yaml")
HIE_PHONE_CONF = os.path.join(REPO, "configs", "csj", "asr_hie_phone.yaml")
# the phone encoder's largest bucket: del_pc_mlm's (L, 2L) = (256 words, 512
# phones), min(100, 10000 // 256, 20000 // 512) = 39 rows; 4 heads of 64
PHONE_BUCKET = (39, 512, 4, 64)
# ELECTRA / P-ELECTRA steps card against CPU: the generator's loss, the
# discriminator's BCE (times 50) and their sum over 24 (16) layers of f32
# sums in other orders; the tolerances of the ASR micro-steps (STEP_TOL)
SCORE_RTOL = 1e-5


def _write_conf(path: str, base: str, **over) -> str:
    import yaml

    with open(base) as f:
        conf = yaml.safe_load(f)
    conf.update(over)
    with open(path, "w") as f:
        yaml.safe_dump(conf, f)
    return path


def write_p2w_corpus(path: str, spec, vocab_size: int, n_phones: int, seed: int, error_labels: bool = False):
    """A P2W TSV: rows of word ids 3..V-2 (V-1 is the mask) with their phone
    sequence, each word spelled by a fixed 3-4 phones out of 3..n_phones-1,
    `spec` = ((rows, fewest words, most words), ...); with `error_labels`,
    an `error_label` column (one C/S/I a word)."""
    import pandas as pd

    rng = np.random.default_rng(seed)
    spell = [rng.integers(3, n_phones, size=int(rng.integers(3, 5))) for _ in range(vocab_size)]
    rows = []
    for n, lo, hi in spec:
        for _ in range(n):
            words = rng.integers(3, vocab_size - 1, size=int(rng.integers(lo, hi + 1)))
            phones = np.concatenate([spell[w] for w in words])
            row = dict(utt_id=f"p{len(rows)}-{len(rows) * 10000}-{len(rows) * 10000 + 250 * len(words)}",
                       token_id=" ".join(map(str, words)), phone_token_id=" ".join(map(str, phones)),
                       ylen=len(words), plen=len(phones))
            if error_labels:
                row["error_label"] = " ".join(rng.choice(["C", "C", "C", "S", "I"], len(words)))
            rows.append(row)
    pd.DataFrame(rows).to_csv(path, sep="\t", index=False)
    return path, len(rows)


def _train_lm_cli(tag: str, conf_path: str, n_steps: int, per_step: dict, card: str) -> dict:
    """`train_lm` on the card; every step's launches must be `per_step`."""
    from emoasr_tpu_torch.config import load_config
    from emoasr_tpu_torch.train import train_lm
    from emoasr_tpu_torch.train.checkpoint import load_state_dict

    cfg = load_config(conf_path)
    reset_launch_counts()
    deltas, undo = _launch_deltas(train_lm, "make_lm_train_step")
    try:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state = train_lm.main(["-conf", conf_path])
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
    finally:
        undo()
    launches = launch_counts()
    losses = _read_lm_log(conf_path)
    require(state.step == n_steps and len(losses) == n_steps and all(np.isfinite(losses)) and state.skipped == 0,
            f"{tag} training: {state.step} steps, losses {losses}, {state.skipped} skipped")
    require(len(deltas) == n_steps and all(d == per_step for d in deltas),
            f"{tag} training: launches by step {deltas}, want each {per_step}")
    ckpt = os.path.join(os.path.splitext(conf_path)[0], "checkpoints", "model.ep1")
    trained = load_state_dict(ckpt)
    require(all(bool(torch.isfinite(v).all()) for v in trained.values()), f"{tag}: a trained tensor is not finite")
    _require_f32_masters(state, trained)
    print(f"  {tag}: {n_steps} steps in {dt:.2f} s (first call) on {card}; loss {losses[0]:.3f} -> {losses[-1]:.3f}; "
          f"launches a step {({k: n for k, n in per_step.items() if n}) or 'none'}")
    return {"conf_path": conf_path, "cfg": cfg, "ckpt": ckpt, "launches": launches, "seconds": dt,
            "steps": n_steps, "losses": losses, "state": state}


def _lm_pair(cfg, ckpt: str, dev):
    """The LM of `ckpt` on the card and on the CPU, in eval mode."""
    from emoasr_tpu_torch.models.lm.lm import LM, load_lm_state_dict
    from emoasr_tpu_torch.train.checkpoint import load_state_dict

    out = []
    for d in (dev, torch.device("cpu")):
        m = LM(cfg)
        load_lm_state_dict(m, load_state_dict(ckpt))
        out.append(m.to(d).eval())
    return out


def check_lm_step_vs_cpu(tag: str, cfg, ckpt: str, batch: dict, dev, want_used: dict) -> dict:
    """One step of the LM of `ckpt` on the card against the CPU, dropout
    off: ELECTRA and P-ELECTRA around one `generated` drawn on the card (the
    generator's sample at the masked positions) and given to both sides;
    the loss terms within STEP_TOL["loss"], every gradient within
    STEP_TOL["grad"] of its largest entry plus STEP_TOL["grad_floor"] of the
    model's largest; `want_used` the card's launches."""
    from emoasr_tpu_torch.models.lm.bert import mlm_loss
    from emoasr_tpu_torch.models.lm.lm import ELECTRAModel, PELECTRAModel

    t = {k: torch.from_numpy(v) for k, v in batch.items() if isinstance(v, np.ndarray)}
    generated = None
    res = {}
    for name, model in zip(("cuda", "cpu"), _lm_pair(cfg, ckpt, dev)):
        d = next(model.parameters()).device
        b = {k: v.to(d) for k, v in t.items()}
        before = launch_counts()
        inner = model.lm
        if "error_labels" in b:
            loss, ld = model(b["ys_in"], b["ylens"], error_labels=b["error_labels"])
        elif isinstance(inner, (ELECTRAModel, PELECTRAModel)):
            if isinstance(inner, ELECTRAModel):
                glogits = inner.generator_logits(b["ys_in"], b["ylens"])
                gloss = mlm_loss(glogits, b["labels"])
            else:
                gloss, _, glogits = inner.gmodel(b["ys_in"], b["ylens"], b["labels"], b["ps"], b["plens"],
                                                 return_logits=True)
            if generated is None:
                g = torch.Generator(device=d)
                g.manual_seed(7)
                generated = inner.sample_replacements(glogits, b["ys_in"], b["labels"], g).cpu()
            loss, ld = inner.joint(gloss, b["ys_in"], b["ylens"], b["labels"], generated.to(d))
        else:
            loss, ld = model(b["ys_in"], b["ylens"], b.get("labels"), b.get("ps"), b.get("plens"))
        params = dict(model.named_parameters())
        grads = torch.autograd.grad(loss, list(params.values()), allow_unused=True)
        used = {k: launch_counts()[k] - before[k] for k in before}
        if name == "cuda":
            require(all(used[k] == n for k, n in want_used.items()), f"{tag} step check launches {used}, want {want_used}")
        res[name] = ({k: float(v.detach()) for k, v in ld.items()},
                     {k: (torch.zeros_like(p) if g is None else g).cpu() for (k, p), g in zip(params.items(), grads)})
    (l1, g1), (l0, g0) = res["cuda"], res["cpu"]
    for k in l0:
        require(np.isfinite(l1[k]) and abs(l1[k] - l0[k]) <= STEP_TOL["loss"] * max(abs(l0[k]), 1e-6),
                f"{tag} step {k}: card {l1[k]}, CPU {l0[k]}")
    floor = STEP_TOL["grad_floor"] * max(g.abs().max().item() for g in g0.values())
    worst = 0.0
    for k in g0:
        rel = max(_max_err(g1[k], g0[k]) - floor, 0.0) / max(g0[k].abs().max().item(), 1e-30)
        worst = max(worst, rel)
        require(rel <= STEP_TOL["grad"], f"{tag} step gradient of {k}: card vs CPU {rel:.3e} of its largest entry")
    print(f"  one {tag} step {tuple(batch['ys_in'].shape)} card vs CPU{' (the same generated ids)' if generated is not None else ''}: "
          + ", ".join(f"{k} {l1[k]:.6f} vs {l0[k]:.6f}" for k in l0 if k.startswith("loss"))
          + f"; worst gradient {worst:.2e} of its largest entry (tol {STEP_TOL['grad']}, past "
          f"{STEP_TOL['grad_floor']} of the model's largest)")
    return {"losses_card": l1, "losses_cpu": l0, "worst_grad_rel_err": worst}


def _first_batch(dataset, rows: int, width: int = None):
    """The first `rows` rows of the first batch (of `width` tokens, when
    given), collated by `dataset` in manifest order."""
    for b in dataset.batches(dataset.make_batcher(shuffle=False)):
        if width is None or b["ys_in"].shape[1] == width:
            return {k: (v[:rows] if isinstance(v, np.ndarray) else v) for k, v in b.items()}
    raise AssertionError("no batch of that width")


def train_electra(args, root: str, card: str, dev) -> dict:
    """`configs/lm/ted2_electra.yaml` at full width (generator and
    discriminator 12 x 256, 4 heads, FF 1024, V = 9798, max_seq_len 256,
    batch 90, 35 masks a row, AdamW, lindecay) through `train_lm` over a
    sharded corpus that fills each of its three buckets once a shard (6
    steps, `train_size` 90 x 6); one step against the CPU; then
    `electra-disc` on an error-label corpus, 6 steps.  No kernel: the BERT
    stacks are plain PyTorch, as the JAX ones are."""
    import pandas as pd

    from emoasr_tpu_torch.data.lm_dataset import LMDataset

    sub = os.path.join(root, "electra")
    os.makedirs(sub)
    train_dir, test_tsv, n_rows = write_lm_corpus(sub, 9798, args.seed + 11)
    disc_dir = os.path.join(sub, "train_disc")
    os.makedirs(disc_dir)
    rng = np.random.default_rng(args.seed + 12)
    for f in sorted(os.listdir(train_dir)):
        df = pd.read_table(os.path.join(train_dir, f))
        df["error_label"] = [" ".join(rng.choice(["C", "C", "C", "S", "I"], n)) for n in df["ylen"]]
        df.to_csv(os.path.join(disc_dir, f), sep="\t", index=False)
    out = {}
    for t, data in (("electra", train_dir), ("electra-disc", disc_dir)):
        conf_path = _write_conf(os.path.join(sub, f"ted2_{t}.yaml"), ELECTRA_CONF, lm_type=t, train_path=data,
                                test_path=test_tsv, vocab_path=None, train_size=90 * 6, num_epochs=1, save_step=1,
                                log_step=1, seed=args.seed)
        from emoasr_tpu_torch.config import load_config

        cfg = load_config(conf_path)
        width = (cfg.vocab_size, cfg.gen_hidden_size, cfg.gen_num_layers, cfg.disc_hidden_size, cfg.disc_num_layers,
                 cfg.gen_intermediate_size, cfg.max_seq_len, cfg.batch_size, cfg.num_to_mask, cfg.electra_disc_weight)
        require(width == (9798, 256, 12, 256, 12, 1024, 256, 90, 35, 50), f"the ELECTRA config is not at full width: {width}")
        out[t] = _train_lm_cli(f"{t} (ted2_electra.yaml)", conf_path, 6, _zero_launches(), card)
    cfg = out["electra"]["cfg"]
    batch = _first_batch(LMDataset(cfg, os.path.join(train_dir, "a.tsv"), phase="train", seed=1), 4, 64)
    out["electra"]["step_check"] = check_lm_step_vs_cpu("ELECTRA", cfg, out["electra"]["ckpt"], batch, dev, {})
    cfg = out["electra-disc"]["cfg"]
    batch = _first_batch(LMDataset(cfg, os.path.join(disc_dir, "a.tsv"), phase="train", seed=1), 4, 64)
    out["electra-disc"]["step_check"] = check_lm_step_vs_cpu("electra-disc", cfg, out["electra-disc"]["ckpt"],
                                                             batch, dev, {})
    return out


# the P2W corpora: with del_pc_mlm's insertion headroom (y 1.2 + 4) rows of
# 40-60 words (3-4 phones a word: at most 240 phones) take the (128, 256)
# bucket and rows of 100-120 words (300-480 phones) the (256, 512) one
P2W_SMALL, P2W_BIG = (40, 60), (100, 120)


def train_p2w(args, root: str, card: str, dev) -> dict:
    """P-ELECTRA (`ted2_pelectra.yaml`: a P2W generator, phone encoder and
    CMLM decoder 4 x 256, FF 1024, and a 12 x 256 discriminator, V = 9798,
    45 phones, TextAugment, batch 100) and the deletable PC-MLM
    (`del_pc_mlm.yaml`: 4 + 4 x 256, V = 10872, TextAugment 0.4, mask
    insertion Poisson 0.2, buckets of up to 20000 phones) at full width,
    `enc_fused_attn: true`, through `train_lm`: every step launches K4
    forward and backward (dropout 0.1) once a phone-encoder layer.  One
    step of each against the CPU; then one `pctc` step (K1, K2) and the
    pseudo-PPL of the PC-MLM checkpoint."""
    from emoasr_tpu_torch.config import load_config
    from emoasr_tpu_torch.data.lm_dataset import P2WDataset

    sub = os.path.join(root, "p2w")
    os.makedirs(sub)
    out = {}
    # P-ELECTRA: its buckets hold 23 and 11 rows (max_ylens_batch 3000)
    pel_tsv, _ = write_p2w_corpus(os.path.join(sub, "pelectra_train.tsv"),
                                  ((46, *P2W_SMALL), (22, *P2W_BIG)), 9798, 44, args.seed + 13)
    conf_path = _write_conf(os.path.join(sub, "ted2_pelectra.yaml"), PELECTRA_CONF, train_path=pel_tsv,
                            test_path=pel_tsv, dev_path=None, vocab_path=None, phone_vocab_path=None,
                            enc_fused_attn=True, train_size=100 * 4, num_epochs=1, save_step=1, log_step=1,
                            seed=args.seed)
    cfg = load_config(conf_path)
    width = (cfg.lm_type, cfg.vocab_size, cfg.src_vocab_size, cfg.enc_hidden_size, cfg.enc_num_layers,
             cfg.dec_num_layers, cfg.disc_num_layers, cfg.batch_size, cfg.text_augment, cfg.dropout_enc_rate)
    require(width == ("pelectra", 9798, 45, 256, 4, 4, 12, 100, True, 0.1), f"P-ELECTRA config: {width}")
    n_enc = cfg.enc_num_layers
    per_step = _zero_launches(attention_fwd=n_enc, attention_bwd=n_enc)
    out["pelectra"] = _train_lm_cli("pelectra (ted2_pelectra.yaml)", conf_path, 4, per_step, card)
    batch = _first_batch(P2WDataset(cfg, pel_tsv, phase="train", seed=1), 3, 128)
    out["pelectra"]["step_check"] = check_lm_step_vs_cpu(
        "P-ELECTRA", cfg, out["pelectra"]["ckpt"], batch, dev, {"attention_fwd": n_enc, "attention_bwd": n_enc})

    # the deletable PC-MLM: buckets of 78 and 39 rows, two batches each; its
    # noam schedule keeps the shipped `train_size`, so these steps take the
    # first LRs of its 154-step warm-up, as a run of the config does
    pc_tsv, _ = write_p2w_corpus(os.path.join(sub, "pc_mlm_train.tsv"), ((156, *P2W_SMALL), (78, *P2W_BIG)),
                                 10872, 43, args.seed + 14)
    test_tsv, n_test = write_p2w_corpus(os.path.join(sub, "pc_mlm_test.tsv"), ((39, *P2W_BIG), (3, 20, 40)),
                                        10872, 43, args.seed + 15)
    conf_path = _write_conf(os.path.join(sub, "del_pc_mlm.yaml"), PC_MLM_CONF, train_path=pc_tsv,
                            test_path=test_tsv, dev_path=None, vocab_path=None, enc_fused_attn=True,
                            num_epochs=1, save_step=1, log_step=1, seed=args.seed)
    cfg = load_config(conf_path)
    width = (cfg.lm_type, cfg.vocab_size, cfg.src_vocab_size, cfg.enc_hidden_size, cfg.enc_num_layers,
             cfg.dec_num_layers, cfg.max_plens_batch, cfg.max_ylens_batch, cfg.mask_insert_poisson_lam,
             cfg.textaug_max_mask_prob)
    require(width == ("pbert", 10872, 45, 256, 4, 4, 20000, 10000, 0.2, 0.4), f"PC-MLM config: {width}")
    out["pbert"] = _train_lm_cli("pbert (del_pc_mlm.yaml)", conf_path, 4, per_step, card)
    batch = _first_batch(P2WDataset(cfg, pc_tsv, phase="train", seed=1), 3, 128)
    out["pbert"]["step_check"] = check_lm_step_vs_cpu(
        "PC-MLM", cfg, out["pbert"]["ckpt"], batch, dev, {"attention_fwd": n_enc, "attention_bwd": n_enc})
    out["pbert"]["ppl"] = p2w_ppl(out["pbert"], test_tsv, n_test, dev, card)

    # pctc: the P2W CTC decoder over the phone encoder, one step of the big bucket
    ctc_tsv, _ = write_p2w_corpus(os.path.join(sub, "pctc_train.tsv"), ((39, *P2W_BIG),), 10872, 43, args.seed + 16)
    conf_path = _write_conf(os.path.join(sub, "del_pc_mlm_pctc.yaml"), PC_MLM_CONF, lm_type="pctc",
                            train_path=ctc_tsv, test_path=None, dev_path=None, vocab_path=None, enc_fused_attn=True,
                            num_epochs=1, save_step=1, log_step=1, seed=args.seed)
    out["pctc"] = _train_lm_cli("pctc (del_pc_mlm.yaml widths)", conf_path, 1, _zero_launches(
        attention_fwd=n_enc, attention_bwd=n_enc, ctc_head_fwd=1, ctc_head_grad_e=1, ctc_head_grad_w=1, ctc_alpha=1,
        ctc_beta_grad=1), card)
    return out


def p2w_ppl(pc: dict, test_tsv: str, n_test: int, dev, card: str) -> dict:
    """The PC-MLM's pseudo-PPL through the PPL CLI on the card over a test
    file that fills the phone encoder's largest bucket (39 rows of 100-120
    words, up to 480 phones) and three short rows, peak device memory under
    PLL_PEAK_BYTES; then `evaluate_ppl` on the card and on the CPU over the
    three short rows: equal within PPL_RTOL."""
    import pandas as pd

    from emoasr_tpu_torch.data.lm_dataset import P2WDataset
    from emoasr_tpu_torch.eval import test_ppl

    cfg = pc["cfg"]
    reset_launch_counts()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    cnt, ppl = test_ppl.main(["-conf", pc["conf_path"], "-ep", "1"])
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated(dev)
    launches = launch_counts()
    batches = list(P2WDataset(cfg, test_tsv, phase="test").batches(
        P2WDataset(cfg, test_tsv, phase="test").make_batcher(shuffle=False, drop_tail=False)))
    shapes = [tuple(b["ps"].shape) for b in batches]
    require(np.isfinite(ppl) and cnt > 0 and peak < PLL_PEAK_BYTES and (39, 512) in shapes,
            f"PC-MLM pseudo-PPL: {cnt} tokens, {ppl}, peak {peak} bytes, batches {shapes}")
    require(launches["attention_fwd"] == cfg.enc_num_layers * len(batches) and launches["attention_bwd"] == 0,
            f"PC-MLM pseudo-PPL: the phones are encoded once a batch; launches {launches}")
    small = os.path.join(os.path.dirname(test_tsv), "pc_mlm_test_small.tsv")
    pd.read_table(test_tsv).iloc[-3:].to_csv(small, sep="\t", index=False)
    gpu, cpu = _lm_pair(cfg, pc["ckpt"], dev)
    c1, p1 = test_ppl.evaluate_ppl(cfg, gpu, P2WDataset(cfg, small, phase="test"))
    t1 = time.perf_counter()
    c0, p0 = test_ppl.evaluate_ppl(cfg, cpu, P2WDataset(cfg, small, phase="test"))
    cpu_s = time.perf_counter() - t1
    require(c1 == c0 > 0 and abs(p1 - p0) <= PPL_RTOL * p0, f"PC-MLM pseudo-PPL card {c1} {p1}, CPU {c0} {p0}")
    print(f"  PC-MLM pseudo-PPL over {cnt} tokens ({n_test} rows, batches {shapes}): {ppl:.4f} on the card in "
          f"{dt:.2f} s, peak device memory {peak / 2 ** 30:.3f} GiB (limit {PLL_PEAK_BYTES / 2 ** 30:.0f}); three rows "
          f"card {p1:.6f} vs CPU {p0:.6f} ({cpu_s:.2f} s): rel err {abs(p1 - p0) / p0:.2e} (tol {PPL_RTOL}); {card}")
    return {"tokens": cnt, "ppl_card": ppl, "seconds": dt, "peak_device_bytes": peak, "batches": shapes,
            "small_ppl_card": p1, "small_ppl_cpu": p0, "launches": launches}


def write_phone_corpus(root: str, name: str, lengths, vocab_size: int, n_phones: int, feat_dim: int, seed: int):
    """`write_corpus` with the phone columns: 5-10 words an utterance, each
    spelled by 1-2 phones out of 3..n_phones-1 (short enough for CTC on
    T / 4 frames)."""
    import pandas as pd

    rng = np.random.default_rng(seed)
    os.makedirs(os.path.join(root, f"feats_{name}"))
    rows, frames = [], 0
    for i, T in enumerate(lengths):
        words = rng.integers(3, vocab_size, size=int(rng.integers(5, 11)))
        phones = rng.integers(3, n_phones, size=int(rng.integers(len(words), 2 * len(words) + 1)))
        path = os.path.join(root, f"feats_{name}", f"utt{i}.npy")
        np.save(path, rng.standard_normal(size=(T, feat_dim), dtype=np.float32))
        start = i * 100000
        rows.append(dict(feat_path=path, utt_id=f"spk{i % 7}-utt{i}-{start}-{start + T * 10}",
                         token_id=" ".join(map(str, words)), text=" ".join(f"w{t}" for t in words),
                         phone_token_id=" ".join(map(str, phones)), phone_text=" ".join(f"p{t}" for t in phones),
                         xlen=T, ylen=len(words)))
        frames += T
    tsv = os.path.join(root, f"{name}.tsv")
    pd.DataFrame(rows).to_csv(tsv, sep="\t", index=False)
    return tsv, frames * 0.010


def correction(args, root: str, pc: dict, dev, card: str) -> dict:
    """`configs/csj/asr_hie_phone.yaml` (Transformer 12 x 256, FF 2048, CTC
    over V = 10872 and a hierarchical phone CTC over 43 phones from layer 6,
    SpecAugment, `enc_fused_attn: true`) through the train CLI: two
    micro-steps of its (200, 48) bucket, each launching K1 and K2 twice
    (the word and the phone head) and K4 forward and backward once a layer.
    Then its `model.ep1` through `test_asr --decode_phone` (greedy) and
    through `correct` with the PC-MLM checkpoint at mask_th 0.9 and
    lm_weight 0.5 over 20 utterances, on the card and on the CPU: the
    corrected TSVs equal row for row; the RTF (`--runtime`)."""
    import pandas as pd

    from emoasr_tpu_torch.config import load_config
    from emoasr_tpu_torch.eval import correct, test_asr
    from emoasr_tpu_torch.train import loop

    sub = os.path.join(root, "correction")
    os.makedirs(sub)
    cfg0 = load_config(HIE_PHONE_CONF)
    lengths, _ = train_lengths(cfg0, (2, 0, 0, 0, 0))
    train_tsv, _ = write_phone_corpus(sub, "train", lengths, cfg0.vocab_size, cfg0.phone_vocab_size, 80, args.seed + 17)
    n_test = 20
    test_tsv, wav_s = write_phone_corpus(sub, "test", [200 + (200 * i) // (n_test - 1) for i in range(n_test)],
                                         cfg0.vocab_size, cfg0.phone_vocab_size, 80, args.seed + 18)
    pvocab = os.path.join(sub, "vocab_phone.txt")
    with open(pvocab, "w", encoding="utf-8") as f:
        f.write("\n".join(["<blank> 0", "<unk> 1", "<eos> 2"] + [f"p{i} {i}" for i in range(3, 43)]) + "\n")
    conf_path = _write_conf(os.path.join(sub, "asr_hie_phone.yaml"), HIE_PHONE_CONF, train_path=train_tsv,
                            test_path=test_tsv, dev_path=None, vocab_path=write_vocab(sub, cfg0.vocab_size),
                            phone_vocab_path=pvocab, enc_fused_attn=True, num_epochs=1, save_step=1, log_step=1,
                            seed=args.seed)
    cfg = load_config(conf_path)
    width = (cfg.enc_num_layers, cfg.enc_hidden_size, cfg.enc_intermediate_size, cfg.vocab_size, cfg.phone_vocab_size,
             cfg.hie_mtl_phone, cfg.inter_ctc_layer_id, cfg.mtl_phone_ctc_weight, cfg.spec_augment)
    require(width == (12, 256, 2048, 10872, 43, True, 6, 0.3, True), f"asr_hie_phone config: {width}")
    n = cfg.enc_num_layers
    per_step = _zero_launches(ctc_head_fwd=2, ctc_head_grad_e=2, ctc_head_grad_w=2, ctc_alpha=2, ctc_beta_grad=2,
                              attention_fwd=n, attention_bwd=n)
    reset_launch_counts()
    deltas, undo = _launch_deltas(loop, "make_train_step")
    try:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state = loop.main(["-conf", conf_path])
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
    finally:
        undo()
    train_launches = launch_counts()
    losses, _, _ = read_train_log(conf_path)
    require(state.step == 2 and len(losses) == 2 and all(np.isfinite(losses)) and state.skipped == 0,
            f"asr_hie_phone training: {state.step} micro-steps, losses {losses}")
    require(deltas == [per_step, per_step], f"asr_hie_phone launches by micro-step {deltas}, want each {per_step}")
    print(f"  asr_hie_phone: 2 micro-steps in {dt:.2f} s (first call) on {card}; losses {losses}; launches a "
          f"micro-step {({k: v for k, v in per_step.items() if v})}")

    # the phone hypotheses through the eval CLI
    reset_launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = test_asr.main(["-conf", conf_path, "-ep", "1", "--beam_width", "0", "--decode_phone"])
    torch.cuda.synchronize()
    dt_phone = time.perf_counter() - t0
    phone_launches = launch_counts()
    res = os.path.join(sub, "asr_hie_phone", "results", "result_test_beam0_len0.0_ctc0.0_lm0.00_ep1_phone.tsv")
    df = pd.read_table(res, comment="#")
    require(out[3].startswith("PER") and len(df) == n_test and df["reftext"].str.startswith("p").all(),
            f"decode_phone: {out}, {len(df)} rows")
    require(phone_launches["attention_fwd"] > 0 and phone_launches["ctc_head_fwd"] == 0,
            f"decode_phone launches {phone_launches}")
    print(f"  test_asr --decode_phone (greedy): {out[3]}; {n_test} utts in {dt_phone:.2f} s (first call), "
          f"RTF {dt_phone / wav_s:.5f}; launches attention_fwd {phone_launches['attention_fwd']}")

    # correction with the PC-MLM, card then CPU
    argv = ["-conf", conf_path, "-ep", "1", "--lm_conf", pc["conf_path"], "--lm_ep", "1", "--mask_th", "0.9",
            "--lm_weight", "0.5"]
    out_tsv = os.path.join(sub, "asr_hie_phone", "results", "result_correct_test_th0.90_lm0.50_ep1.tsv")
    reset_launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    wer, info = correct.main(argv)
    torch.cuda.synchronize()
    dt_corr = time.perf_counter() - t0
    corr_launches = launch_counts()
    card_df = pd.read_table(out_tsv, comment="#")
    shutil.move(out_tsv, out_tsv + ".card")
    t0 = time.perf_counter()
    cpu_wer, cpu_info = correct.main(argv + ["--cpu"])
    cpu_s = time.perf_counter() - t0
    cpu_df = pd.read_table(out_tsv, comment="#")
    same = (card_df.fillna("").values == cpu_df.fillna("").values).all(axis=1)
    require(len(card_df) == n_test and same.all() and info == cpu_info,
            f"correction card vs CPU: {int(same.sum())} of {len(card_df)} rows equal; {info} vs {cpu_info}")
    # the phone encoder (4 layers) once a batch, the ASR encoder once a batch
    require(corr_launches["attention_fwd"] > 0 and corr_launches["attention_bwd"] == 0,
            f"correction launches {corr_launches}")
    rtfs = correct.main(argv + ["--runtime", "--runtime_num_samples", str(n_test), "--runtime_num_repeats", "2"])
    print(f"  correct (PC-MLM, mask_th 0.9, lm_weight 0.5): {info}; {n_test} utts in {dt_corr:.2f} s (first call) on "
          f"{card}, the CPU's TSV equal row for row ({cpu_s:.2f} s on the CPU); RTF by --runtime {rtfs}; launches "
          f"attention_fwd {corr_launches['attention_fwd']}")
    return {"train_launches": train_launches, "train_seconds": dt, "losses": losses,
            "decode_phone": {"per": out[3], "seconds": dt_phone, "rtf": dt_phone / wav_s, "launches": phone_launches},
            "correct": {"wer": info, "seconds": dt_corr, "cpu_seconds": cpu_s, "rtf_runtime": rtfs,
                        "rows_equal": int(same.sum()), "launches": corr_launches},
            "launches": train_launches, "decode_launches": phone_launches, "correct_launches": corr_launches}


def rescoring(args, root: str, tr: dict, lms: dict, dev, card: str) -> dict:
    """The L1 trainer's `model.ep1` through the eval CLI with `--nbest`
    (beam 8) over the test corpus, then `rescore` on the card with the
    trained Transformer and BERT LMs (`libri_*.yaml`) and ELECTRA at
    `ted2_electra.yaml`'s widths over the L1 vocabulary (V = 10000, the
    n-best's; weights from the seed): each LM's scoring time; then
    `score_lm` on the CPU over the first three utterances' hypotheses:
    within SCORE_RTOL of the card's, and the same best hypotheses."""
    import pandas as pd

    from emoasr_tpu_torch.config import load_config
    from emoasr_tpu_torch.eval import rescore, test_asr
    from emoasr_tpu_torch.models.lm.lm import LM
    from emoasr_tpu_torch.train.checkpoint import save_model

    sub = os.path.join(root, "rescore")
    os.makedirs(sub)
    t0 = time.perf_counter()
    test_asr.main(["-conf", tr["conf_path"], "-ep", "1", "--beam_width", "8", "--nbest"])
    nb_s = time.perf_counter() - t0
    nbest = os.path.join(os.path.splitext(tr["conf_path"])[0], "results",
                         "result_test_beam8_len0.0_ctc0.0_lm0.00_ep1_nbest.tsv")
    df = pd.read_table(nbest).dropna()
    require(len(df) >= args.n_utts and df["utt_id"].nunique() == args.n_utts, f"n-best: {len(df)} rows")
    e_conf = _write_conf(os.path.join(sub, "ted2_electra_v10000.yaml"), ELECTRA_CONF, vocab_size=10000,
                         mask_id=9999, vocab_path=None, train_path=None, seed=args.seed)
    torch.manual_seed(args.seed)
    save_model(os.path.join(sub, "ted2_electra_v10000", "checkpoints", "model.ep1"), LM(load_config(e_conf)))
    confs = {"transformer": lms["transformer"]["conf_path"], "bert": lms["bert"]["conf_path"], "electra": e_conf}
    first = df["utt_id"].unique()[:3]
    few = df[df["utt_id"].isin(first)]
    out = {}
    for t, conf in confs.items():
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        wer, lm_w, len_w = rescore.main([nbest, "-ref", tr["test_tsv"], "-lm_conf", conf, "-lm_ep", "1",
                                         "--lm_tag", t])
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        scored = pd.read_table(nbest.replace(".tsv", f"_{t}.tsv"))
        cfg = load_config(conf)
        gpu, cpu = _lm_pair(cfg, os.path.join(os.path.splitext(conf)[0], "checkpoints", "model.ep1"), dev)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        card_few = rescore.score_lm(few, gpu, max_len=cfg.max_seq_len)
        torch.cuda.synchronize()
        few_s = time.perf_counter() - t1
        cpu_few = rescore.score_lm(few, cpu, max_len=cfg.max_seq_len)
        a, b = card_few["score_lm"].to_numpy(), cpu_few["score_lm"].to_numpy()
        rel = float(np.max(np.abs(a - b) / np.maximum(np.abs(b), 1e-6)))
        full = scored["score_lm"].to_numpy()[df["utt_id"].isin(first).to_numpy()]  # the CLI keeps the rows' order
        rel_full = float(np.max(np.abs(full - b) / np.maximum(np.abs(b), 1e-6)))
        ref = pd.read_table(tr["test_tsv"])
        pick = lambda s: rescore.rescore(s, ref, 0.5, 0.5)[2]["token_id"].tolist()  # noqa: E731
        require(rel <= SCORE_RTOL and rel_full <= SCORE_RTOL and pick(card_few) == pick(cpu_few),
                f"{t} score_lm card vs CPU rel err {rel:.2e} (whole n-best's padding {rel_full:.2e}); best "
                f"{pick(card_few)} vs {pick(cpu_few)}")
        print(f"  rescore with {t} ({cfg.lm_type}): {len(df)} hypotheses of {args.n_utts} utts scored and the "
              f"grid searched in {dt:.2f} s (first call) on {card}; best WER {wer:.2f} at lm {lm_w:.2f} len "
              f"{len_w:.2f}; score_lm of {len(few)} hypotheses card ({few_s * 1e3:.1f} ms) vs CPU: rel err {rel:.2e} "
              f"(whole n-best's padding {rel_full:.2e}; tol {SCORE_RTOL}), the same best hypotheses")
        out[t] = {"seconds": dt, "few_seconds": few_s, "rel_err": rel, "rel_err_padding": rel_full, "best_wer": wer,
                  "n_hyps": len(df)}
    out["nbest_seconds"] = nb_s
    return out


def check_attention_phone(dev, gen) -> dict:
    """K4 at the phone encoder's largest bucket, PHONE_BUCKET, in float32
    and bf16, forward and backward with dropout 0.1, each launched twice
    (bit-identical), against the plain version on the kernel's own keep
    mask."""
    from emoasr_tpu_torch.ops.attention import attention_bwd_plain, attention_plain, dropout_keep_mask

    B, T, H, D = PHONE_BUCKET
    lens = torch.randint(T // 4, T + 1, (B,), generator=gen, device=dev)
    lens[0], lens[1] = T, 1
    worst = {}
    for dtype in (torch.float32, torch.bfloat16):
        q, k, v, d_out = (torch.randn(B, T, H, D, generator=gen, device=dev).to(dtype) for _ in range(4))
        scale, seed = 1.0 / D ** 0.5, 24680
        mask = dropout_keep_mask(B, T, H, DROPOUT_RATE, seed, dev, dtype)
        got = _twice(lambda: _attention_grads(q, k, v, d_out, lens, scale, DROPOUT_RATE, seed))
        want = (attention_plain(q, k, v, lens, scale, DROPOUT_RATE, dropout_mask=mask),
                *attention_bwd_plain(q, k, v, d_out, lens, scale, DROPOUT_RATE, None, mask)[:3])
        tag = f"attention fwd+bwd {dtype} {PHONE_BUCKET} (the phone encoder) dropout {DROPOUT_RATE}"
        if dtype == torch.float32:
            errs = _hold_attention_grads(tag, got, want, lens)
        else:
            err_o = _max_err(got[0], want[0])
            require(err_o <= ATTN_TOL[dtype], f"{tag} out: max |kernel - plain| = {err_o} > {ATTN_TOL[dtype]}")
            errs = [err_o] + [_require_close_bf16(f"{tag} {w}", a, b) for w, a, b in zip(("dq", "dk", "dv"), got[1:],
                                                                                          want[1:])]
        worst[dtype] = errs
        print(f"  {tag}: out {errs[0]:.2e}, dq dk dv {max(errs[1:]):.2e}; two launches bit-identical")
    return {"fwd": worst[torch.float32][0], "bwd": max(worst[torch.float32][1:]),
            "fwd_bf16": worst[torch.bfloat16][0], "bwd_bf16": max(worst[torch.bfloat16][1:])}


# ---------------------------------------------------------------- slice 7b: distillation and the analysis tools

# soft labels, card against CPU: the probabilities (a float32 softmax of 8
# logits at temperature 3) within KD_PROB_TOL; the ids equal wherever the
# CPU's gap between the k-th and the (k+1)-th logit exceeds the measured
# card-vs-CPU logit error (the ranks within the top k too, where every gap
# above them does); every position's probabilities sum to 1 within it
KD_PROB_TOL = 1e-5
KD_TOPK = 8
# the L4 distillation micro-step's device memory: the full (18, 399, 129,
# 1000) joint is 3.7 GB a float32 tensor
KD_PEAK_BYTES = 60 << 30
# `analysis ctc_prob`: the per-frame probabilities, card against CPU
ANALYSIS_PROB_TOL = 1e-5
# the overfit model's grid: a seed-weight LM's output bias of one token
# raised so far that LM weight 0.5 costs WER where weight 0 scores 0 (a
# CPU rehearsal of the grid: WER 0 and 9.5 at a raise of 10 and of 30):
# the grid's points then differ
GRID_LM_BIAS = 30.0


def _capture_topk_rows():
    """Patch `make_label._topk_temp` so that every (N, V) logits tensor it
    takes is kept (a chunk's rows); returns (the list, a function that
    undoes the patch)."""
    from emoasr_tpu_torch.eval import make_label

    rows, orig = [], make_label._topk_temp

    def keep(x, topk, temp):
        rows.append(x.detach().clone())
        return orig(x, topk, temp)

    make_label._topk_temp = keep
    return rows, lambda: setattr(make_label, "_topk_temp", orig)


def _label_rows_tsv(path: str, corpus_tsv: str, bert: bool, mask_id: int = 9999) -> int:
    """The rows `make_label` reads for a training corpus: a causal LM labels
    every position of each utterance (start_pos 0: position 0 takes its
    hard label), BERT one pre-masked row for each position, in order."""
    import pandas as pd

    rows = []
    for r in pd.read_table(corpus_tsv).itertuples():
        ids = r.token_id.split()
        if not bert:
            rows.append(dict(utt_id=r.utt_id, token_id=r.token_id, start_pos=0, end_pos=len(ids)))
            continue
        for p in range(len(ids)):
            rows.append(dict(utt_id=r.utt_id, token_id=" ".join(ids[:p] + [str(mask_id)] + ids[p + 1:]),
                             mask_pos=p))
    pd.DataFrame(rows).to_csv(path, sep="\t", index=False)
    return len(rows)


def _flat_labels(labels: dict) -> list:
    return [lab for utt in labels for lab in labels[utt]]


def make_soft_labels(tag: str, lm_conf: str, data_tsv: str, ref_tsv: str, pkl: str, dev, card: str,
                     cpu_check: bool = True) -> dict:
    """`make_label make` on the card through the CLI, K3 launched once a
    chunk; with `cpu_check` the same labels made on the CPU from the same
    checkpoint, held to the card's (see KD_PROB_TOL), K3's make_label class
    exactly against its plain version on the chunks' logits, and `make_label
    eval` of the pickle against `ref_tsv`."""
    import io
    import pickle

    import pandas as pd

    from emoasr_tpu_torch.config import load_config
    from emoasr_tpu_torch.eval import make_label
    from emoasr_tpu_torch.eval.test_asr import load_lm
    from emoasr_tpu_torch.ops.topk import topk_lastdim_kernel, topk_plain

    ckpt = os.path.join(os.path.splitext(lm_conf)[0], "checkpoints", "model.ep1")
    lm_cfg = load_config(lm_conf)
    n_rows = len(pd.read_table(data_tsv))
    n_chunks = -(-n_rows // make_label.BATCH_SIZE)
    card_rows, undo = _capture_topk_rows()
    reset_launch_counts()
    try:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with contextlib.redirect_stderr(io.StringIO()):  # a warning for every hard label
            labels = make_label.cli(["make", "-lm_conf", lm_conf, "-lm_ep", "1", "-data", data_tsv, "-save_path", pkl])
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
    finally:
        undo()
    launches = launch_counts()
    require(launches["topk"] == n_chunks == len(card_rows), f"{tag} make_label: K3 launched {launches['topk']} "
            f"times for {n_chunks} chunks ({len(card_rows)} with positions to label)")
    require(all(n == 0 for k, n in launches.items() if k != "topk"), f"{tag} make_label: launches {launches}")
    flat = _flat_labels(labels)
    n_soft = sum(len(r) for r in card_rows)
    require(len(flat) - n_soft == (0 if lm_cfg.lm_type == "bert" else len(labels)),
            f"{tag} make_label: {n_soft} top-k labels of {len(flat)} positions")
    sums = np.array([sum(p for _, p in lab) for lab in flat])
    sum_err = float(np.abs(sums - 1).max())
    require(sum_err <= KD_PROB_TOL, f"{tag} make_label: a position's probabilities sum to 1 + {sum_err:.2e}")
    with open(pkl, "rb") as f:
        require(pickle.load(f) == labels, f"{tag} make_label: the pickle is not what the CLI returned")
    shape_n = max(len(r) for r in card_rows)
    out = {"seconds": dt, "rows": n_rows, "chunks": n_chunks, "positions": len(flat), "launches": launches,
           "max_n": shape_n, "V": lm_cfg.vocab_size, "sum_err": sum_err, "pkl": pkl}
    print(f"  {tag} ({lm_cfg.lm_type}, V = {lm_cfg.vocab_size}): make_label over {n_rows} rows, {len(flat)} "
          f"positions in {n_chunks} chunks in {dt:.2f} s on {card} (first call); K3 {launches['topk']} launches, "
          f"the largest ({shape_n}, {lm_cfg.vocab_size}) k = {KD_TOPK}; every position's probabilities sum to 1 "
          f"within {sum_err:.1e}")
    if not cpu_check:
        return out

    # the CPU's labels from the same checkpoint, and its logits rows
    cpu_lm, _ = load_lm(lm_conf, ckpt)
    cpu_rows, undo = _capture_topk_rows()
    fn = make_label.make_bert_label if lm_cfg.lm_type == "bert" else make_label.make_lm_label
    try:
        t0 = time.perf_counter()
        with contextlib.redirect_stderr(io.StringIO()):
            want = fn(pd.read_table(data_tsv).dropna(), cpu_lm, pkl + ".cpu", topk=KD_TOPK, temp=3.0,
                      add_sos_eos=lm_cfg.add_sos_eos, eos_id=lm_cfg.eos_id, max_seq_len=lm_cfg.max_seq_len)
        cpu_s = time.perf_counter() - t0
    finally:
        undo()
    require(len(cpu_rows) == len(card_rows) and all(c.shape == w.shape for c, w in zip(card_rows, cpu_rows)),
            f"{tag} make_label: the card's and the CPU's chunks differ")
    logit_err = max(_max_err(c.cpu(), w) for c, w in zip(card_rows, cpu_rows))
    vals = torch.cat([torch.topk(w, KD_TOPK + 1, dim=-1).values for w in cpu_rows])  # CPU logits, descending
    gaps = vals[:, :-1] - vals[:, 1:]  # gap i: between ranks i and i + 1
    boundary = gaps[:, -1] > logit_err  # the top-k set is decided
    ranked = (gaps > logit_err).all(dim=1)  # and so is every rank in it
    want_flat = _flat_labels(want)
    hard = {i for i, lab in enumerate(flat) if len(lab) == 1 and lab[0][1] == 1.0}
    require(want.keys() == labels.keys() and len(want_flat) == len(flat)
            and all(flat[i] == want_flat[i] for i in hard), f"{tag} make_label: the pickles differ in shape")
    got_soft = [lab for i, lab in enumerate(flat) if i not in hard]
    want_soft = [lab for i, lab in enumerate(want_flat) if i not in hard]
    require(len(got_soft) == len(vals), f"{tag}: {len(got_soft)} top-k labels, {len(vals)} logits rows")
    prob_err = 0.0
    for i, (g, w) in enumerate(zip(got_soft, want_soft)):
        prob_err = max(prob_err, max(abs(a[1] - b[1]) for a, b in zip(g, w)))
        gi, wi = [v for v, _ in g], [v for v, _ in w]
        require(not bool(boundary[i]) or sorted(gi) == sorted(wi), f"{tag} make_label position {i}: top-k ids {gi} "
                f"on the card, {wi} on the CPU (gap {float(gaps[i, -1]):.2e}, the logit error {logit_err:.2e})")
        require(not bool(ranked[i]) or gi == wi, f"{tag} make_label position {i}: ranks {gi} vs {wi}")
    require(prob_err <= KD_PROB_TOL, f"{tag} make_label: probabilities card vs CPU {prob_err:.2e}")
    # K3 at the make_label class, exactly against its plain version (launched after the count was read)
    for r in card_rows:
        v1, i1 = topk_lastdim_kernel(r, KD_TOPK)
        v2, i2 = topk_lastdim_kernel(r, KD_TOPK)
        v0, i0 = topk_plain(r, KD_TOPK)
        require(torch.equal(v1, v0) and torch.equal(i1, i0) and torch.equal(v1, v2) and torch.equal(i1, i2),
                f"{tag}: K3 at ({len(r)}, {r.shape[-1]}) k = {KD_TOPK} differs from its plain version")
    with contextlib.redirect_stdout(io.StringIO()) as buf:
        acc1, acck, cnt = make_label.cli(["eval", pkl, "-ref", ref_tsv])
    exempt_set, exempt_rank = int((~boundary).sum()), int((~ranked).sum())
    print(f"  {tag}: the CPU's labels ({cpu_s:.2f} s) against the card's: probabilities within {prob_err:.1e} (tol "
          f"{KD_PROB_TOL}); the card-vs-CPU logit error {logit_err:.2e}; top-k sets equal at {len(vals) - exempt_set} "
          f"of {len(vals)} positions ({exempt_set} exempted: the gap between ranks k and k + 1 within that error), "
          f"ranks at {len(vals) - exempt_rank} ({exempt_rank} exempted); K3 on the chunks' logits exact against its "
          f"plain version, twice bit-identical; make_label eval: {' '.join(buf.getvalue().split())}")
    out.update(cpu_seconds=cpu_s, prob_err=prob_err, logit_err=logit_err, exempt_set=exempt_set,
               exempt_rank=exempt_rank, accuracy=[acc1, acck, cnt], k3_err=0.0)
    return out


def soft_label_phase(args, root: str, lms: dict, dev, card: str) -> dict:
    """Phase 22: the distillation corpora (L1's and L3's over V = 10000, L4's
    over 1000, written as the train CLI's corpora are: one batch of the 400
    and of the 1600-frame bucket) and their soft labels through `make_label
    make` on the card: the trained Transformer LM (causal) and BERT (one
    pre-masked row a position) over the first, each held to the CPU's; then
    a Transformer LM at `libri_transformer.yaml`'s widths with V = 1000
    (the only change: no shipped LM has L4's vocabulary; weights from the
    seed) over L4's corpus."""
    from emoasr_tpu_torch.config import load_config
    from emoasr_tpu_torch.models.lm.lm import LM
    from emoasr_tpu_torch.train.checkpoint import save_model

    sub = os.path.join(root, "kd")
    os.makedirs(sub)
    per_bucket = (0, 1, 0, 0, 1)
    lengths, _ = train_lengths(load_config(L1_CONF), per_bucket)
    corpus, _ = write_corpus(sub, "train_v10000", lengths, 10000, 80, args.seed + 11)
    lengths4, _ = train_lengths(load_config(L4_CONF), per_bucket)
    corpus4, _ = write_corpus(sub, "train_v1000", lengths4, 1000, 80, args.seed + 12)
    t0 = time.perf_counter()
    out = {"corpus": corpus, "corpus_v1000": corpus4}
    for t in ("transformer", "bert"):
        data = os.path.join(sub, f"rows_{t}.tsv")
        _label_rows_tsv(data, corpus, bert=t == "bert")
        out[t] = make_soft_labels(f"libri {t} LM", lms[t]["conf_path"], data, corpus,
                                  os.path.join(sub, f"soft_{t}.pkl"), dev, card)
    lm4 = _write_conf(os.path.join(sub, "libri_transformer_v1000.yaml"), LM_CONF, vocab_size=1000, mask_id=999,
                      vocab_path=None, train_path=None, seed=args.seed)
    torch.manual_seed(args.seed)
    save_model(os.path.join(sub, "libri_transformer_v1000", "checkpoints", "model.ep1"), LM(load_config(lm4)))
    data4 = os.path.join(sub, "rows_v1000.tsv")
    _label_rows_tsv(data4, corpus4, bert=False)
    out["v1000"] = make_soft_labels("libri transformer LM at V = 1000 (seed weights)", lm4, data4, corpus4,
                                    os.path.join(sub, "soft_v1000.pkl"), dev, card, cpu_check=False)
    out["seconds"] = time.perf_counter() - t0
    print(f"  the soft-label phase took {out['seconds']:.1f} s on {card}")
    return out


def _set_kd_cfg(model, cfg) -> None:
    """Give the model and every submodule that keeps a config `cfg` (the
    decoders read kd_type and kd_ctc_position from theirs)."""
    for m in model.modules():
        if hasattr(m, "cfg"):
            m.cfg = cfg


def kd_micro_steps(tag: str, cfg, ckpt: str, tsv: str, pkl: str, steps, dev, card: str, want_step: dict) -> dict:
    """Micro-steps on the card through the port's train step from `ckpt`,
    over `ASRDataset(kd_label_path=pkl)`: `steps` lists (the bucket's
    max_xlen, that step's config); dropout and SpecAugment on; each step
    launches `want_step`; `loss_kd` finite and nonzero."""
    from emoasr_tpu_torch.data.asr_dataset import ASRDataset
    from emoasr_tpu_torch.eval.test_asr import load_asr_model
    from emoasr_tpu_torch.models.layers import set_dropout_generator
    from emoasr_tpu_torch.train.optim import build_optimizer
    from emoasr_tpu_torch.train.step import TrainState, make_train_step
    from emoasr_tpu_torch.utils.device import set_matmul_precision

    set_matmul_precision(cfg.compute_dtype)
    ds = ASRDataset(cfg, tsv, phase="train", kd_label_path=pkl)
    batcher = ds.make_batcher(shuffle=False)
    by_len = {batcher.buckets[bi].max_xlen: (bi, idx) for bi, idx in batcher}
    torch.manual_seed(cfg.seed)
    model = load_asr_model(ckpt, cfg).to(dev)
    set_dropout_generator(model, torch.Generator().manual_seed(cfg.seed))
    state = TrainState(model=model, optimizer=build_optimizer(cfg, model.parameters()))
    gen = torch.Generator(device=dev)
    gen.manual_seed(cfg.seed)
    reset_launch_counts()
    torch.cuda.reset_peak_memory_stats(dev)
    losses, per_step, shapes = [], [], []
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for max_xlen, step_cfg in steps:
        bi, idx = by_len[max_xlen]
        b = batcher.buckets[bi]
        batch = ds.collate(idx, b.max_xlen, b.max_ylen, pad_to_batch=b.batch_size)
        t = {k: torch.from_numpy(v).to(dev) for k, v in batch.items() if isinstance(v, np.ndarray)}
        _set_kd_cfg(state.model, step_cfg)
        before = launch_counts()
        m = make_train_step(step_cfg)(state, t, gen)
        after = launch_counts()
        per_step.append({k: after[k] - before[k] for k in before})
        losses.append({k: v.item() for k, v in m.items() if k.startswith("loss")})
        shapes.append((tuple(batch["xs"].shape), tuple(batch["soft_labels"].shape)))
        require(m["grad_finite"] and np.isfinite(losses[-1]["loss_kd"]) and losses[-1]["loss_kd"] != 0.0,
                f"{tag} distillation micro-step {len(losses)}: {losses[-1]}")
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated(dev)
    launches = launch_counts()
    want = _zero_launches(**want_step)
    require(all(d == want for d in per_step), f"{tag} distillation micro-steps: launches by step {per_step}, want "
            f"each {want}")
    print(f"  {tag}: {len(steps)} distillation micro-steps (batches {[s[0] for s in shapes]}, soft labels "
          f"{[s[1] for s in shapes]}) in {dt:.2f} s on {card} (first call), peak device memory {peak / 2**30:.2f} "
          f"GiB; losses {[{k: round(v, 4) for k, v in l.items()} for l in losses]}; launches a step "
          f"{({k: n for k, n in want_step.items() if n})}")
    return {"seconds": dt, "peak_bytes": peak, "losses": losses, "launches": launches, "shapes": shapes}


def kd_phase(args, root: str, tr: dict, l4: dict, soft: dict, dev, card: str) -> dict:
    """Phase 23: the distillation routes at full width, each a copy of its
    shipped yaml with `kd_weight: 0.5` and `enc_fused_attn: true`, nothing
    else changed: L1 (alignment KD: the dense logits, K2 through the dense
    CTC loss, the forced alignment; `kd_ctc_position` all, one step at mid;
    from the trainer's `model.ep1`), L3 (`l3_transformer_conformer.yaml`,
    BERT's soft labels with <eos>: K1 and K2 in the aux CTC, K4 with its
    bias; seed weights) and L4 (the full joint: K8 and K4, not K7;
    `kd_type` word and align at the (18, 399, 129) bucket; from the
    trainer's `model.ep1`); one micro-step of each against the CPU
    (`check_micro_step`, L4's in both kd_types)."""
    import dataclasses

    from emoasr_tpu_torch.config import load_config
    from emoasr_tpu_torch.models.asr import ASR
    from emoasr_tpu_torch.train.checkpoint import save_model

    sub = os.path.join(root, "kd_steps")
    os.makedirs(sub)
    vocab = write_vocab(sub, 10000)
    out = {}
    t_phase = time.perf_counter()

    # L1: alignment KD
    c1 = _write_conf(os.path.join(sub, "l1_kd.yaml"), L1_CONF, kd_weight=0.5, enc_fused_attn=True, vocab_path=vocab,
                     train_path=soft["corpus"], dev_path=None, seed=args.seed)
    cfg1 = load_config(c1)
    n1 = cfg1.enc_num_layers
    mid = dataclasses.replace(cfg1, kd_ctc_position="mid")
    l1_step = {"ctc_alpha": 1, "ctc_beta_grad": 1, "attention_fwd": n1, "attention_bwd": n1}
    out["l1"] = kd_micro_steps("L1 + kd_weight 0.5", cfg1, tr["ckpt"], soft["corpus"], soft["transformer"]["pkl"],
                               [(400, cfg1), (1600, cfg1), (400, mid)], dev, card, l1_step)
    out["l1"]["step_check"] = check_micro_step({"cfg": cfg1, "ckpt": tr["ckpt"], "train_tsv": soft["corpus"],
                                                "kd_label_path": soft["transformer"]["pkl"]}, dev, l1_step)

    # L3: soft-label distillation of the attention decoder, the aux CTC on its kernels
    c3 = _write_conf(os.path.join(sub, "l3_kd.yaml"), L3_3_CONF, kd_weight=0.5, enc_fused_attn=True,
                     vocab_path=vocab, train_path=soft["corpus"], dev_path=None, seed=args.seed)
    cfg3 = load_config(c3)
    ck3 = os.path.join(sub, "l3_kd", "checkpoints", "model.ep0")
    torch.manual_seed(cfg3.seed)
    save_model(ck3, ASR(cfg3))
    n3 = cfg3.enc_num_layers
    l3_step = {"ctc_head_fwd": 1, "ctc_head_grad_e": 1, "ctc_head_grad_w": 1, "ctc_alpha": 1, "ctc_beta_grad": 1,
               "attention_fwd": n3, "attention_bwd": n3, "attention_bias_fwd": n3, "attention_bias_bwd": n3}
    out["l3"] = kd_micro_steps("L3 + kd_weight 0.5", cfg3, ck3, soft["corpus"], soft["bert"]["pkl"],
                               [(400, cfg3), (1600, cfg3)], dev, card, l3_step)
    out["l3"]["step_check"] = check_micro_step({"cfg": cfg3, "ckpt": ck3, "train_tsv": soft["corpus"],
                                                "kd_label_path": soft["bert"]["pkl"]}, dev, l3_step,
                                               heads=l3_1_heads(cfg3))

    # L4: word and align KD over the full joint
    c4 = _write_conf(os.path.join(sub, "l4_kd.yaml"), l4["conf_path"], kd_weight=0.5, train_path=soft["corpus_v1000"])
    cfg4 = load_config(c4)
    require((cfg4.rnnt_joint_mode, cfg4.vocab_size, cfg4.joint_hidden_size, cfg4.kd_type, cfg4.enc_fused_attn)
            == ("pallas", 1000, 512, "word", True), f"the L4 KD config: {cfg4}")
    align = dataclasses.replace(cfg4, kd_type="align")
    n4 = cfg4.enc_num_layers
    l4_step = {"lstm_fwd": 1, "lstm_bwd": 1, "attention_fwd": n4, "attention_bwd": n4, "attention_bias_fwd": n4,
               "attention_bias_bwd": n4}
    out["l4"] = kd_micro_steps("L4 + kd_weight 0.5", cfg4, l4["ckpt"], soft["corpus_v1000"], soft["v1000"]["pkl"],
                               [(1600, cfg4), (1600, align)], dev, card, l4_step)
    require(out["l4"]["peak_bytes"] < KD_PEAK_BYTES,
            f"L4 distillation: peak device memory {out['l4']['peak_bytes']} bytes, limit {KD_PEAK_BYTES}")
    for kd_type, c in (("word", cfg4), ("align", align)):
        out["l4"][f"step_check_{kd_type}"] = check_micro_step(
            {"cfg": c, "ckpt": l4["ckpt"], "train_tsv": soft["corpus_v1000"], "kd_label_path": soft["v1000"]["pkl"]},
            dev, l4_step)
    for k in ("l1", "l3", "l4"):
        for key, chk in out[k].items():
            if key.startswith("step_check"):
                d1 = chk["loss_terms_card"]
                require(np.isfinite(d1["loss_kd"]) and d1["loss_kd"] != 0.0, f"{k} {key}: loss_kd {d1['loss_kd']}")
    out["seconds"] = time.perf_counter() - t_phase
    print(f"  the distillation micro-steps and their checks took {out['seconds']:.1f} s on {card}")
    return out


def _walk_steps(fb: np.ndarray, xlen: int, ylen: int) -> list:
    """The forced alignment's walk over one utterance's alpha + beta (the
    rule of `ops/rnnt.py::rnnt_align_walk`): (t, u, advanced, margin) at
    every decision."""
    t = u = 0
    steps = []
    while t + 1 < xlen and u < ylen:
        a, b = fb[t + 1, u], fb[t, u + 1]
        steps.append((t, u, bool(a > b), float(abs(a - b))))
        t, u = (t + 1, u) if a > b else (t, u + 1)
    return steps


def forced_align_phase(l4: dict, dev, card: str) -> dict:
    """Phase 24: `ASR.forced_align` (RNN-T) on the trainer's L4 `model.ep1`,
    one batch (8 rows of the 400-frame bucket), card against CPU: the walks
    equal at every decision whose margin on the CPU exceeds the measured
    card-vs-CPU error of alpha + beta, each row compared up to its first
    decision within that error (after it the walks may part)."""
    from emoasr_tpu_torch.data.asr_dataset import ASRDataset
    from emoasr_tpu_torch.eval.test_asr import load_asr_model
    from emoasr_tpu_torch.ops.rnnt import rnnt_fwd_bwd

    cfg = l4["cfg"]
    ds = ASRDataset(cfg, l4["train_tsv"], phase="train")
    batcher = ds.make_batcher(shuffle=False)
    bi, idx = next(b for b in batcher if batcher.buckets[b[0]].max_xlen == 400)
    batch = ds.collate(idx[:8], 400, batcher.buckets[bi].max_ylen)
    res = {}
    for name, d in (("cuda", dev), ("cpu", torch.device("cpu"))):
        model = load_asr_model(l4["ckpt"], cfg).to(d).eval()
        t = {k: torch.from_numpy(v).to(d) for k, v in batch.items() if isinstance(v, np.ndarray)}
        reset_launch_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        aligns = model.forced_align(t["xs"], t["xlens"], t["ys"], t["ylens"]).cpu()
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        launches = launch_counts()
        with torch.no_grad():
            eouts, elens, _ = model.encode(t["xs"], t["xlens"])
            lp = torch.log_softmax(model.decoder.joint(eouts, model.decoder.recurrency(t["ys_in"])[0]).float(), -1)
            fb = rnnt_fwd_bwd(lp, elens, t["ys"], t["ylens"]).cpu().numpy()
        res[name] = (aligns.numpy(), fb, elens.cpu().numpy(), dt, launches)
    (a1, fb1, el, dt, launches), (a0, fb0, el0, cpu_dt, _) = res["cuda"], res["cpu"]
    require(np.array_equal(el, el0), "forced alignment: the encoder lengths differ")
    n_enc = cfg.enc_num_layers
    require(launches["lstm_fwd"] == 1 and launches["attention_bias_fwd"] == n_enc and launches["rnnt_joint"] == 0,
            f"forced alignment launches {launches}")
    ylens = batch["ylens"]
    valid = (np.arange(fb0.shape[1])[None, :, None] < el[:, None, None]) & (
        np.arange(fb0.shape[2])[None, None, :] <= ylens[:, None, None])
    fb_err = float(np.abs(fb1 - fb0)[valid].max())
    decisions = exempt = 0
    for b in range(len(ylens)):
        s1, s0 = _walk_steps(fb1[b], int(el[b]), int(ylens[b])), _walk_steps(fb0[b], int(el[b]), int(ylens[b]))
        for x1, x0 in zip(s1, s0):
            if x0[3] <= fb_err:  # a near-tie: this row's walks are compared no further
                exempt += 1
                break
            require(x1[:3] == x0[:3], f"forced alignment row {b}: the card's walk {x1} vs the CPU's {x0}")
            decisions += 1
        else:
            require(np.array_equal(a1[b], a0[b]), f"forced alignment row {b}: {a1[b]} vs {a0[b]}")
    print(f"  RNN-T forced alignment of {tuple(batch['xs'].shape)} (U up to {int(ylens.max())}) through "
          f"ASR.forced_align: {dt * 1e3:.1f} ms on {card} (CPU {cpu_dt * 1e3:.0f} ms); alpha + beta card vs CPU "
          f"{fb_err:.2e}; {decisions} walk decisions equal, {exempt} exempted (margin within that error); launches "
          f"{({k: n for k, n in launches.items() if n})}")
    return {"seconds": dt, "cpu_seconds": cpu_dt, "fwd_bwd_err": fb_err, "decisions": decisions, "exempt": exempt,
            "launches": launches, "same_aligns": bool(np.array_equal(a1, a0))}


def _grid_against_cli(tag: str, conf: str, ep: str, data: str, lm_conf: str, k3: bool) -> dict:
    """The fusion grid (lm 0 and 0.5 x len 0 and 1) of `conf`'s CTC beam 8
    with the LM `lm_conf` (`model.ep1`) over `data` on the card, then the
    eval CLI at each of its points: each point's TSV equal to the CLI's;
    K4 launched, and K3 where `k3` (the beam's top-k takes it from V =
    TOPK_KERNEL_MIN_V on).  Returns the grid's best tuple and the CLI's (wer, lm, len, info) a
    point, in the grid's order."""
    import pandas as pd

    from emoasr_tpu_torch.eval import fusion_grid, test_asr

    base = ["-conf", conf, "-ep", ep, "--beam_width", "8", "--data", data, "--lm_conf", lm_conf, "--lm_ep", "1"]
    reset_launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    best = fusion_grid.main(fusion_grid.parse_args(base + ["--lm_min", "0", "--lm_max", "0.5", "--lm_step", "0.5",
                                                           "--len_min", "0", "--len_max", "1", "--save_dir", "grid"]))
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    launches = launch_counts()
    require((launches["topk"] > 0) == k3 and launches["attention_fwd"] > 0, f"{tag} fusion grid launches {launches}")
    res = os.path.join(os.path.splitext(conf)[0], "results")
    wers = []
    for lm_w in (0.0, 0.5):
        for len_w in (0.0, 1.0):
            r = test_asr.main(base + ["--lm_weight", str(lm_w), "--len_weight", str(len_w), "--save_dir", "cli"])
            name = f"result_test_beam8_len{len_w:.1f}_ctc0.0_lm{lm_w:.2f}{'transformer' if lm_w else ''}_ep{ep}.tsv"
            got, want = (pd.read_table(os.path.join(res, d, name), comment="#") for d in ("grid", "cli"))
            require(got.equals(want), f"{tag} fusion grid point ({lm_w}, {len_w}): its TSV differs from the eval "
                                      f"CLI's")
            wers.append((r[2], r[0], r[1], r[3]))
    return {"best": best, "wers": wers, "seconds": dt, "launches": launches, "res": res}


def analysis_phase(root: str, tr: dict, lms: dict, overfit: dict, seed: int, card: str) -> dict:
    """Phase 25: `analysis ctc_prob` on L1's `model.ep1` (card against CPU
    within ANALYSIS_PROB_TOL; K4 in the encoder); the fusion grid (lm 0 and
    0.5 x len 0 and 1) on L1's CTC beam 8 with the trained Transformer LM
    over four test utterances, each point's TSV equal to the eval CLI's at
    the same weights on the card (every point's WER is 100 or more on this
    one-epoch model, so the grid keeps its start tuple there and its pick
    is tested on the next grid); the same grid on phase 5's overfit model
    (WER below 15) with a Transformer LM at `libri_transformer.yaml`'s
    widths over its vocabulary (V = 12, weights from the seed, the output
    bias of token 3 raised by GRID_LM_BIAS) over eight of its utterances:
    each point's TSV equal to the CLI's, and the best pair the first of the
    lowest WERs, which must be below 100 and differ between the points
    (so a pick of the highest, or of the last of equal ones, fails);
    `align_hyps` on the rescoring phase's n-best."""
    import io

    import pandas as pd

    from emoasr_tpu_torch.config import load_config
    from emoasr_tpu_torch.eval import align_hyps, analysis
    from emoasr_tpu_torch.models.lm.lm import LM
    from emoasr_tpu_torch.train.checkpoint import save_model

    sub = os.path.join(root, "analysis")
    os.makedirs(sub)
    out = {}
    t_phase = time.perf_counter()
    test = pd.read_table(tr["test_tsv"])
    utt = test["utt_id"].iloc[0]
    probs, first = {}, ""
    for name in ("cuda", "cpu"):
        reset_launch_counts()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(io.StringIO()) as buf:
            probs[name] = analysis.main(["ctc_prob", "-conf", tr["conf_path"], "-ep", "1", "-utt_id", utt]
                                        + (["--cpu"] if name == "cpu" else []))
        out[f"ctc_prob_{name}_seconds"] = time.perf_counter() - t0
        if name == "cuda":
            out["ctc_prob_launches"] = launch_counts()
            first = buf.getvalue().splitlines()[0]
    err = _max_err(torch.from_numpy(probs["cuda"]), torch.from_numpy(probs["cpu"]))
    require(err <= ANALYSIS_PROB_TOL, f"analysis ctc_prob: card vs CPU {err:.2e}")
    require(out["ctc_prob_launches"]["attention_fwd"] == tr["cfg"].enc_num_layers,
            f"analysis ctc_prob launches {out['ctc_prob_launches']}")
    print(f"  analysis ctc_prob of {utt} ({probs['cuda'].shape[0]} frames): {out['ctc_prob_cuda_seconds']:.2f} s on "
          f"{card}, card vs CPU {err:.1e} (tol {ANALYSIS_PROB_TOL}); its first line: {first}")
    out["ctc_prob_err"] = err

    data = os.path.join(sub, "test4.tsv")
    test.iloc[:4].to_csv(data, sep="\t", index=False)
    l1 = _grid_against_cli("L1", tr["conf_path"], "1", data, lms["transformer"]["conf_path"], True)
    print(f"  fusion grid (2 x 2) of L1 beam 8 + the Transformer LM over 4 utterances: {l1['seconds']:.2f} s on "
          f"{card}; WERs {[round(w[0], 2) for w in l1['wers']]}, each point's TSV equal to the eval CLI's; the grid "
          f"returns {tuple(l1['best'][:3])} (no point below WER 100); K3 {l1['launches']['topk']} launches")

    lm_conf = _write_conf(os.path.join(sub, "libri_transformer_v12.yaml"), LM_CONF, vocab_size=overfit["vocab_size"],
                          mask_id=overfit["vocab_size"] - 1, vocab_path=None, train_path=None, seed=seed)
    torch.manual_seed(seed)
    lm = LM(load_config(lm_conf))
    with torch.no_grad():  # a prior that pulls the beam toward token 3 where the LM weighs in
        lm.state_dict()["lm.transformer.cls.predictions.bias"][3] += GRID_LM_BIAS
    save_model(os.path.join(sub, "libri_transformer_v12", "checkpoints", "model.ep1"), lm)
    data = os.path.join(sub, "overfit8.tsv")
    pd.read_table(overfit["tsv"]).iloc[:8].to_csv(data, sep="\t", index=False)
    ov = _grid_against_cli("overfit", overfit["conf_path"], overfit["ep"], data, lm_conf, False)
    low = min(w[0] for w in ov["wers"])
    want_best = next(w for w in ov["wers"] if w[0] == low)
    require(low < 100.0 and len({w[0] for w in ov["wers"]}) > 1 and tuple(ov["best"]) == tuple(want_best),
            f"overfit fusion grid best {ov['best']}, the eval CLI's points give {want_best}")
    print(f"  fusion grid (2 x 2) of the overfit model's beam 8 + a seed-weight Transformer LM at V = "
          f"{overfit['vocab_size']} (token 3's bias +{GRID_LM_BIAS}) over 8 utterances: {ov['seconds']:.2f} s on {card}; WERs "
          f"{[round(w[0], 2) for w in ov['wers']]}, each point's TSV equal to the eval CLI's; best "
          f"{tuple(ov['best'][:3])}, the first of the lowest (its top-k over V = {overfit['vocab_size']} is the "
          f"stable sort's, not K3's)")
    out.update(grid_wers=[w[0] for w in l1["wers"]], grid_best=list(l1["best"][:3]), grid_seconds=l1["seconds"],
               launches=l1["launches"], overfit_grid_wers=[w[0] for w in ov["wers"]],
               overfit_grid_best=list(ov["best"][:3]), overfit_grid_seconds=ov["seconds"],
               overfit_launches=ov["launches"])
    res = l1["res"]

    nbest = os.path.join(res, "result_test_beam8_len0.0_ctc0.0_lm0.00_ep1_nbest.tsv")
    t0 = time.perf_counter()
    aligned = align_hyps.main(align_hyps.build_argparser().parse_args([nbest, "-ref", tr["test_tsv"]]))
    out["align_seconds"] = time.perf_counter() - t0
    df = pd.read_table(aligned)
    n_hyp = len(pd.read_table(nbest).dropna())
    require(0 < len(df) <= n_hyp and all(len(str(a).split()) == len(str(h).split())
                                         for a, h in zip(df["error_label"], df["token_id"])),
            f"align_hyps: {len(df)} rows of {n_hyp} hypotheses")
    labels = " ".join(df["error_label"].astype(str)).split()
    counts = {c: labels.count(c) for c in "CSID"}
    print(f"  align_hyps (SID) on the L1 beam-8 n-best: {len(df)} of {n_hyp} hypotheses labelled in "
          f"{out['align_seconds']:.2f} s, labels {counts}")
    out.update(align_rows=len(df), align_labels=counts, seconds=time.perf_counter() - t_phase)
    return out


# ------------------------------------------------ slices 8a and 5: the RNN
# encoder (K8 over T' frames), the LAS decoder and its beam (K3, K4, K6), the
# fbank front end, the prep CLI and the native host paths

# No shipped yaml builds a LAS decoder or an RNN encoder.  LAS(Transformer)
# takes the decoder keys the JAX package benchmarked (tools/bench_decode.py:
# 112-119) on the L1 encoder; CTC(RNN) is L1 with `encoder_type: rnn`.
LAS_DECODER = dict(decoder_type="las", dec_hidden_size=256, dec_num_layers=1, dec_intermediate_size=256,
                   embedding_size=128, vocab_size=10000, max_decode_ylen=64, dropout_dec_rate=0.0)
LAS_BEAM, LAS_LEN_WEIGHT, LAS_LM_WEIGHT = 4, 1.0, 0.5
# the overfit LAS's hypotheses that end at <eos> before the 64-step cap, at
# least; its top-1 hypotheses card vs CPU equal, at least
EOS_SHARE = 0.5
LAS_HYP_SHARE = 0.75
# the overfit run: epochs over the 32 utterances (4 micro-steps an epoch)
LAS_OVERFIT_EPOCHS = 60
# K8 at the RNN encoder's shapes (B, T', H): the largest bucket, the (46, 400)
# bucket of the training phase and the (50, 200) bucket of the decode corpus
LSTM_RNN_ENCODER_CASES = (((18, 399, 256), True), ((46, 99, 256), True), ((50, 49, 256), True))
FBANK_TOL = 3e-4  # card against CPU; tests/test_frontend_golden.py holds the JAX fbank to it
N_WAVS = 40


def train_two_steps(args, root: str, name: str, card: str, want_step: dict, **over) -> dict:
    """L1's yaml with `over` at full width through the train CLI: two
    micro-steps, one batch of the (46, 400) and one of the (18, 1600)
    bucket, SpecAugment and dropout on, `enc_fused_attn: true`; every
    micro-step launches what `want_step` says.  -> the run's record, as
    `check_micro_step` takes it."""
    import yaml

    from emoasr_tpu_torch.config import load_config
    from emoasr_tpu_torch.ops import lstm_scan
    from emoasr_tpu_torch.train import loop

    with open(L1_CONF) as f:
        conf = yaml.safe_load(f)
    lengths, buckets = train_lengths(load_config(L1_CONF), [0, 1, 0, 0, 1])
    sub = os.path.join(root, name)
    os.makedirs(sub)
    train_tsv, _ = write_corpus(sub, "train", lengths, conf["vocab_size"], conf["feat_dim"], args.seed + 8)
    conf.update(over)
    conf.update(vocab_path=write_vocab(sub, conf["vocab_size"]), train_path=train_tsv, test_path=train_tsv,
                dev_path=None, enc_fused_attn=True, num_epochs=1, save_step=1, log_step=1, seed=args.seed)
    conf_path = os.path.join(sub, f"{name}.yaml")
    with open(conf_path, "w") as f:
        yaml.safe_dump(conf, f)
    cfg = load_config(conf_path)
    require((cfg.enc_num_layers, cfg.enc_hidden_size, cfg.vocab_size, cfg.spec_augment, cfg.dropout_enc_rate)
            == (12, 256, 10000, True, 0.1), f"the {name} config is not at full width with its dropout")
    reset_launch_counts()
    deltas, undo = _launch_deltas(loop, "make_train_step")
    try:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state = loop.main(["-conf", conf_path])
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
    finally:
        undo()
    launches, k8_shapes = launch_counts(), dict(lstm_scan.SHAPE_LAUNCHES)
    losses, _, _ = read_train_log(conf_path)
    require(state.step == 2 and state.skipped == 0 and len(losses) == 2 and all(np.isfinite(losses)),
            f"{name} training: {state.step} micro-steps, {state.skipped} skipped, losses {losses}")
    want = _zero_launches(**want_step)
    require(len(deltas) == 2 and all(d == want for d in deltas), f"{name} training: launches by step {deltas}, want {want}")
    ckpt = os.path.join(sub, name, "checkpoints", "model.ep1")
    print(f"  {name}: 2 micro-steps ({len(lengths)} utts, the (46, 400) and (18, 1600) buckets) in {dt:.2f} s "
          f"(first call) on {card}: losses {losses[0]:.2f}, {losses[1]:.2f}; launches a micro-step "
          f"{({k: n for k, n in want_step.items() if n})}" + (f"; K8 by shape {k8_shapes}" if k8_shapes else ""))
    return {"conf_path": conf_path, "cfg": cfg, "ckpt": ckpt, "train_tsv": train_tsv, "launches": launches,
            "seconds": dt, "losses": losses, "buckets": buckets, "k8_shapes": k8_shapes}


def write_las_overfit_corpus(root: str, overfit_tsv: str) -> str:
    """Phase 5's 32 utterances (their labels) as 80-dim features for the
    conv2d input layer: one active channel per label, 24 frames each."""
    import pandas as pd

    os.makedirs(os.path.join(root, "feats"))
    rng = np.random.default_rng(1)
    rows = []
    for i, r in enumerate(pd.read_table(overfit_tsv).itertuples()):
        toks = [int(t) for t in r.token_id.split()]
        x = rng.normal(size=(24 * len(toks), 80)).astype(np.float32) * 0.05
        for u, tok in enumerate(toks):
            x[24 * u:24 * (u + 1), (7 * tok) % 80] = 2.0
        path = os.path.join(root, "feats", f"u{i}.npy")
        np.save(path, x)
        rows.append(dict(feat_path=path, utt_id=r.utt_id, token_id=r.token_id, text=r.text, xlen=len(x),
                         ylen=len(toks)))
    tsv = os.path.join(root, "las_overfit.tsv")
    pd.DataFrame(rows).to_csv(tsv, sep="\t", index=False)
    return tsv


def _cli_rows(conf: str, result: str):
    import pandas as pd

    return pd.read_table(os.path.join(os.path.splitext(conf)[0], "results", result), comment="#")


def las_phase(args, root: str, lms: dict, overfit: dict, dev, card: str) -> dict:
    """LAS(Transformer) at full width (L1's encoder 12 x 256, the LAS
    decoder 1 x 256, embedding 128, intermediate 256, V = 10000, at most 64
    labels): two micro-steps through the train CLI (K4 with dropout,
    forward and backward) and one against the CPU; then the same widths
    overfitted on phase 5's labels (80-dim features, dropout and
    SpecAugment off) through the train CLI, and its `model.ep{N}` through
    the eval CLI: greedy, beam 4 with `len_weight` 1.0 (K3 on the (B, 4,
    10000) pre-selection and the (B, 16) pool), beam 4 with phase 15's
    libri Transformer LM at 0.5 (K6); one batch of each against the CPU;
    width 1 against greedy on the card."""
    import pandas as pd

    from emoasr_tpu_torch.config import load_config
    from emoasr_tpu_torch.eval import test_asr
    from emoasr_tpu_torch.eval.decode import build_decode_fn
    from emoasr_tpu_torch.eval.test_asr import load_asr_model, load_lm
    from emoasr_tpu_torch.models.lm import bert as bert_mod
    from emoasr_tpu_torch.search.common import make_lm_fusion
    from emoasr_tpu_torch.train import loop
    from emoasr_tpu_torch.train.step import preprocess

    t_phase = time.perf_counter()
    n_layers = 12
    tr = train_two_steps(args, root, "las", card, {"attention_fwd": n_layers, "attention_bwd": n_layers},
                         encoder_type="transformer", **LAS_DECODER)
    cfg = tr["cfg"]
    require((cfg.decoder_type, cfg.dec_hidden_size, cfg.dec_num_layers, cfg.dec_intermediate_size, cfg.embedding_size,
             cfg.max_decode_ylen, cfg.enc_num_attention_heads, cfg.enc_intermediate_size)
            == ("las", 256, 1, 256, 128, 64, 4, 2048), "the LAS(Trf) config is not the benchmarked one")
    step = check_micro_step(tr, dev, {"attention_fwd": n_layers, "attention_bwd": n_layers}, heads=(
        ("decoder.output", lambda b: np.append(b["ys_out"][:4].reshape(-1), cfg.eos_id)),))
    split = time_micro_step(tr, dev, card)

    # overfit the same widths on phase 5's labels
    sub = os.path.join(root, "las_overfit")
    os.makedirs(sub)
    tsv = write_las_overfit_corpus(sub, overfit["tsv"])
    conf = _write_conf(os.path.join(sub, "las_overfit.yaml"), tr["conf_path"], train_path=tsv, test_path=tsv,
                       dev_path=None, batch_size=8, accum_grad=1, spec_augment=False, dropout_enc_rate=0.0,
                       dropout_attn_rate=0.0, learning_rate=1.0, num_warmup_steps=100,
                       num_epochs=LAS_OVERFIT_EPOCHS, save_step=LAS_OVERFIT_EPOCHS, log_step=4)
    ocfg = load_config(conf)
    ep = str(LAS_OVERFIT_EPOCHS)
    reset_launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    state = loop.main(["-conf", conf])
    torch.cuda.synchronize()
    t_overfit = time.perf_counter() - t0
    losses, _, _ = read_train_log(conf)
    n_steps = 4 * LAS_OVERFIT_EPOCHS
    require(state.step == n_steps and state.skipped == 0 and all(np.isfinite(losses)),
            f"LAS overfit: {state.step} micro-steps, {state.skipped} skipped")
    overfit_launches = launch_counts()
    require(overfit_launches["attention_bwd"] == n_layers * n_steps, "the LAS overfit did not train through K4")
    print(f"  LAS overfit: {n_steps} micro-steps over 32 utts in {t_overfit:.1f} s on {card} "
          f"({1e3 * t_overfit / n_steps:.1f} ms a micro-step, first call); loss {losses[0]:.2f} -> {losses[-1]:.2f}")

    lm = lms["transformer"]
    modes = {"greedy": ["--beam_width", "0"],
             "beam4": ["--beam_width", str(LAS_BEAM), "--len_weight", str(LAS_LEN_WEIGHT)],
             "beam4_lm": ["--beam_width", str(LAS_BEAM), "--len_weight", str(LAS_LEN_WEIGHT), "--lm_weight",
                          str(LAS_LM_WEIGHT), "--lm_conf", lm["conf_path"], "--lm_path", lm["ckpt"]]}
    results = {"greedy": "result_test_beam0_len0.0_ctc0.0_lm0.00_ep{ep}.tsv",
               "beam4": f"result_test_beam{LAS_BEAM}_len{LAS_LEN_WEIGHT:.1f}_ctc0.0_lm0.00_ep{{ep}}.tsv",
               "beam4_lm": f"result_test_beam{LAS_BEAM}_len{LAS_LEN_WEIGHT:.1f}_ctc0.0_lm{LAS_LM_WEIGHT:.2f}"
                           "transformer_ep{ep}.tsv"}
    n_utts, n_batches, runs = 32, 4, {}
    audio_s = 0.010 * int(pd.read_table(tsv)["xlen"].sum())
    pre, pool = (10000, LAS_BEAM, "float32"), (LAS_BEAM * LAS_BEAM, LAS_BEAM, "float32")
    for mode, argv in modes.items():
        test_asr._SETUP_CACHE.clear()
        bert_mod.FUSED_INDIRECT_STEP = mode == "beam4_lm"
        reset_launch_counts()
        try:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = test_asr.main(["-conf", conf, "-ep", ep] + argv)
            torch.cuda.synchronize()
            dt = time.perf_counter() - t0
        finally:
            bert_mod.FUSED_INDIRECT_STEP = None
        launches = launch_counts()
        df = _cli_rows(conf, results[mode].format(ep=ep))
        require(out is not None and out[3].startswith("WER:") and len(df) == n_utts, f"LAS {mode}: CLI returned {out}")
        require(launches["attention_fwd"] == n_layers * n_batches and launches["lstm_fwd"] == 0,
                f"LAS {mode}: launches {launches}")
        steps = launches.topk_shapes.get(pre, 0)
        if mode == "greedy":
            require(launches["topk"] == 0, f"LAS greedy launched top-k: {launches}")
            lens = [len(str(t).split()) if isinstance(t, str) else 0 for t in df["token_id"]]
            ended = float(np.mean([n < cfg.max_decode_ylen for n in lens]))
        else:
            ended = float(df["token_id"].notna().mean())
            require(steps >= n_batches and launches.topk_shapes.get(pool, 0) == steps
                    and launches["topk"] == 2 * steps, f"LAS {mode}: K3 by class {launches.topk_shapes}")
        require(launches["lm_step_indirect"] == (4 * steps if mode == "beam4_lm" else 0),
                f"LAS {mode}: K6 launches {launches['lm_step_indirect']} for {steps} beam steps")
        require(ended >= EOS_SHARE, f"LAS {mode}: {ended:.2f} of the hypotheses end at <eos> (want {EOS_SHARE})")
        print(f"  LAS {mode}: {out[3]}; {ended:.2f} of {n_utts} hypotheses end at <eos>; {n_utts} utts in {dt:.3f} s "
              f"(RTF {dt / audio_s:.5f}, first call) on {card}; K3 pre-selection {steps}, pool "
              f"{launches.topk_shapes.get(pool, 0)}, K6 {launches['lm_step_indirect']}, K4 {launches['attention_fwd']}")
        runs[mode] = {"launches": launches, "seconds": dt, "rtf": dt / audio_s, "wer": out[2], "eos_share": ended,
                      "beam_steps": steps}

    # one batch of 8 against the CPU in each mode, then width 1 against greedy on the card
    ckpt = os.path.join(os.path.splitext(conf)[0], "checkpoints", f"model.ep{ep}")
    batch = _short_batch(ocfg, tsv, 8)
    lm_of = lambda d: make_lm_fusion(load_lm(lm["conf_path"], lm["ckpt"])[0].to(d), LAS_LM_WEIGHT)
    same = {"greedy": _top1_card_vs_cpu("LAS greedy", ocfg, ckpt, lambda d: None, batch, dev, 0, LAS_HYP_SHARE),
            "beam4": _top1_card_vs_cpu("LAS beam 4", ocfg, ckpt, lambda d: None, batch, dev, LAS_BEAM, LAS_HYP_SHARE,
                                       len_weight=LAS_LEN_WEIGHT)}
    bert_mod.FUSED_INDIRECT_STEP = True
    try:
        same["beam4_lm"] = _top1_card_vs_cpu("LAS beam 4 + LM (K6)", ocfg, ckpt, lm_of, batch, dev, LAS_BEAM,
                                             LAS_HYP_SHARE, len_weight=LAS_LEN_WEIGHT)
    finally:
        bert_mod.FUSED_INDIRECT_STEP = None
    model = load_asr_model(ckpt, ocfg)
    g, gl, _ = build_decode_fn(model, ocfg, 0, device=dev)(batch["xs"], batch["xlens"])
    with torch.no_grad():  # the beam at width 1 (build_decode_fn takes greedy for widths up to 1, as JAX does)
        eouts, elens, _ = model.encode(*preprocess(ocfg, torch.from_numpy(batch["xs"]).to(dev),
                                                   torch.from_numpy(batch["xlens"]).long().to(dev)))
        b, bl, bs = model.decoder.decode_beam(eouts, elens, 1)
    g, gl, b, bl, bs = (x.cpu() for x in (g, gl, b, bl, bs))
    for r in range(len(batch["utt_ids"])):
        if bs[r, 0] > -1e29:  # the beam ended: its labels between the framing eos are greedy's
            require(b[r, 0, 1:bl[r, 0] - 1].tolist() == g[r, :gl[r]].tolist(), f"LAS width 1 row {r} is not greedy")
        else:  # no result: greedy ran to the cap or emitted eos first
            require(int(gl[r]) in (0, cfg.max_decode_ylen), f"LAS width 1 row {r}: no result, greedy {int(gl[r])}")
    print(f"  LAS width 1 on the card equals greedy on all {len(batch['utt_ids'])} rows "
          f"({int((bs[:, 0] > -1e29).sum())} ended); the phase took {time.perf_counter() - t_phase:.1f} s")
    return {"train": tr, "step_check": step, "step_split": split, "overfit_seconds": t_overfit,
            "overfit_launches": overfit_launches, "overfit_losses": [losses[0], losses[-1]],
            "greedy_wer": runs["greedy"]["wer"], "runs": runs, "same_top1_card_vs_cpu": same,
            "seconds": time.perf_counter() - t_phase}


def ctc_rnn_phase(args, root: str, tr: dict, dev, card: str) -> dict:
    """CTC(RNN): L1 with `encoder_type: rnn` (conv2d, 12 biLSTM layers of
    256 a direction, directions summed, V = 10000) through the train CLI,
    two micro-steps (K8 forward and backward once a direction a layer, K1,
    K2) and one against the CPU; the `model.ep1` through the eval CLI over
    phase 6's 40-utterance corpus, greedy and with the CTC prefix beam 8
    (K8 forward, K3); one short batch of each card against CPU."""
    from emoasr_tpu_torch.data.asr_dataset import ASRDataset
    from emoasr_tpu_torch.ops import lstm_scan

    t_phase = time.perf_counter()
    per_step = {"lstm_fwd": 24, "lstm_bwd": 24, "ctc_head_fwd": 1, "ctc_head_grad_e": 1, "ctc_head_grad_w": 1,
                "ctc_alpha": 1, "ctc_beta_grad": 1}
    rt = train_two_steps(args, root, "ctc_rnn", card, per_step, encoder_type="rnn")
    cfg = rt["cfg"]
    require((cfg.encoder_type, cfg.input_layer, cfg.enc_hidden_sum_fwd_bwd) == ("rnn", "conv2d", True),
            "the CTC(RNN) config is not L1's with an RNN encoder")
    want_shapes = {(kind, B, T, 256, "f32"): 24 for kind in ("fwd", "bwd") for B, T in ((46, 99), (18, 399))}
    require(rt["k8_shapes"] == want_shapes, f"CTC(RNN) training: K8 by shape {rt['k8_shapes']}, want {want_shapes}")
    step = check_micro_step(rt, dev, per_step)
    split = time_micro_step(rt, dev, card)
    conf = _write_conf(os.path.join(root, "ctc_rnn", "ctc_rnn_test.yaml"), rt["conf_path"], test_path=tr["test_tsv"])
    os.makedirs(os.path.join(root, "ctc_rnn", "ctc_rnn_test", "checkpoints"))
    shutil.copy(rt["ckpt"], os.path.join(root, "ctc_rnn", "ctc_rnn_test", "checkpoints", "model.ep1"))
    runs, k8_decode = {}, {}
    n_batches = len(list(ASRDataset(cfg, tr["test_tsv"], phase="test").make_batcher()))
    for beam in (0, 8):
        r = run_cli(conf, beam, args.n_utts, tr["wav_s"], card)
        require(r["launches"]["lstm_fwd"] == 24 * n_batches and r["launches"]["lstm_bwd"] == 0,
                f"CTC(RNN) beam {beam}: K8 launches {r['launches']}")
        require((r["launches"]["topk"] > 0) == (beam > 1), f"CTC(RNN) beam {beam}: top-k launches {r['launches']}")
        for k, n in lstm_scan.SHAPE_LAUNCHES.items():
            k8_decode[k] = k8_decode.get(k, 0) + n
        runs[beam] = r
    batch = _short_batch(cfg, tr["test_tsv"], 3)
    same = {beam: _top1_card_vs_cpu(f"CTC(RNN) beam {beam}", cfg, rt["ckpt"], lambda d: None, batch, dev, beam,
                                    HYP_SHARE) for beam in (0, 8)}
    print(f"  CTC(RNN): K8 by shape in the decodes {k8_decode}; the phase took {time.perf_counter() - t_phase:.1f} s")
    return {"train": rt, "step_check": step, "step_split": split, "runs": runs, "same_top1_card_vs_cpu": same, "k8_decode": k8_decode,
            "seconds": time.perf_counter() - t_phase}


def write_wavs(root: str, n: int, seed: int):
    """`n` 16 kHz PCM16 wavs of 1-16 s: two or three tones and noise, from
    `seed`; -> (the wav TSV with labels of phase 5's vocabulary, seconds of
    audio)."""
    import wave

    import pandas as pd

    rng = np.random.default_rng(seed)
    os.makedirs(os.path.join(root, "wavs"))
    rows, total = [], 0.0
    for i in range(n):
        secs = 1.0 + 15.0 * i / max(n - 1, 1)
        t = np.arange(int(secs * 16000)) / 16000.0
        x = sum(rng.uniform(1000, 6000) * np.sin(2 * np.pi * rng.uniform(100, 4000) * t + rng.uniform(0, 6.3))
                for _ in range(int(rng.integers(2, 4))))
        pcm = np.clip(x + rng.normal(size=t.shape) * 300, -32768, 32767).astype(np.int16)
        path = os.path.join(root, "wavs", f"utt{i}.wav")
        with wave.open(path, "wb") as w:
            w.setnchannels(1)
            w.setsampwidth(2)
            w.setframerate(16000)
            w.writeframes(pcm.tobytes())
        toks = rng.integers(3, 12, size=int(rng.integers(2, 8)))
        start = i * 100000
        rows.append(dict(utt_id=f"spk{i % 5}-wav{i}-{start}-{start + int(secs * 1000)}", wav_path=path,
                         text=" ".join(f"w{t}" for t in toks), token_id=" ".join(map(str, toks))))
        total += secs
    tsv = os.path.join(root, "wavs.tsv")
    pd.DataFrame(rows).to_csv(tsv, sep="\t", index=False)
    return tsv, total


def frontend_phase(args, root: str, overfit: dict, card: str) -> dict:
    """Slice 8a: 40 synthetic wavs through the prep CLI (`wav_to_feats` on
    the card, `norm_feats`, `prep_tsv`, `sort_bylen`), every feature file
    against the CPU's fbank; the eval CLI decodes the manifest with phase
    5's model (plumbing: the features are real fbank, that model's are
    not); the native WER equal to the Python path's and native-collated
    batches bit-equal to the `np.load` path's."""
    import pandas as pd

    from emoasr_tpu_torch.config import load_config
    from emoasr_tpu_torch.corpora import prep
    from emoasr_tpu_torch.data.asr_dataset import ASRDataset
    from emoasr_tpu_torch.eval import test_asr
    from emoasr_tpu_torch.eval.wer import compute_wers
    from emoasr_tpu_torch.frontend.fbank import load_wav, log_mel_fbank

    t_phase = time.perf_counter()
    sub = os.path.join(root, "frontend")
    os.makedirs(sub)
    tsv, audio_s = write_wavs(sub, N_WAVS, args.seed + 9)
    wavs = list(pd.read_table(tsv)["wav_path"])
    reset_launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    prep.main(["wav_to_feats", tsv])
    torch.cuda.synchronize()
    t_feats = time.perf_counter() - t0
    prep.main(["norm_feats", tsv, tsv.replace(".tsv", "_norm.pkl")])
    prep.main(["prep_tsv", tsv])
    prep.main(["sort_bylen", tsv])
    manifest = tsv.replace(".tsv", "_sorted.tsv")
    df = pd.read_table(manifest)
    require(len(df) == N_WAVS and list(df["xlen"]) == sorted(df["xlen"]), f"the sorted manifest: {len(df)} rows")
    worst, t_cpu = 0.0, 0.0
    for wav in wavs:
        t0 = time.perf_counter()
        want, n = log_mel_fbank(torch.from_numpy(load_wav(wav))[None])
        t_cpu += time.perf_counter() - t0
        got = np.load(wav.replace(".wav", ".npy"))
        require(got.shape == (int(n[0]), 80), f"{wav}: features {got.shape}, CPU {int(n[0])} frames")
        worst = max(worst, _require_close(f"fbank {wav}", torch.from_numpy(got), want[0, :int(n[0])], FBANK_TOL, 0.0))
    print(f"  wav_to_feats: {N_WAVS} wavs, {audio_s:.1f} s of audio in {t_feats:.2f} s on {card} (the CPU's fbank "
          f"{t_cpu:.2f} s); card vs CPU max abs err {worst:.2e} (tol {FBANK_TOL}); norm_feats, prep_tsv, sort_bylen")

    # the manifest through the eval CLI with phase 5's model (its first 16 feature columns)
    conf = _write_conf(os.path.join(sub, "decode.yaml"), overfit["conf_path"], test_path=manifest,
                       buckets=[[400, 8], [800, 8], [1600, 8]], max_xlens_batch=12800)
    os.makedirs(os.path.join(sub, "decode", "checkpoints"))
    shutil.copy(os.path.join(os.path.splitext(overfit["conf_path"])[0], "checkpoints", f"model.ep{overfit['ep']}"),
                os.path.join(sub, "decode", "checkpoints", f"model.ep{overfit['ep']}"))
    out = test_asr.main(["-conf", conf, "-ep", overfit["ep"], "--beam_width", "0"])
    launches = launch_counts()
    rows = _cli_rows(conf, f"result_test_beam0_len0.0_ctc0.0_lm0.00_ep{overfit['ep']}.tsv")
    require(out is not None and len(rows) == N_WAVS and launches["attention_fwd"] > 0,
            f"the fbank manifest through the eval CLI: {out}, {len(rows)} rows, launches {launches}")
    hyps = [str(t).split() if isinstance(t, str) else [] for t in rows["text"]]
    refs = [t.split() for t in rows["reftext"]]
    native_wer, python_wer = compute_wers(hyps, refs), compute_wers(hyps, refs, native=False)
    require(native_wer == python_wer, f"native WER {native_wer} != Python {python_wer}")
    cfg = load_config(conf)
    got, want = (list(ASRDataset(cfg, manifest, "test", native_loader=n).batches()) for n in (True, False))
    require(len(got) == len(want) > 1 and all(
        all(np.array_equal(g[k], w[k]) and g[k].dtype == w[k].dtype if isinstance(g[k], np.ndarray) else g[k] == w[k]
            for k in g) for g, w in zip(got, want)), "native-collated batches differ from the np.load path's")
    print(f"  the manifest through the eval CLI with phase 5's model: {out[3]}; native WER {native_wer[0]:.2f} = "
          f"Python's; {len(got)} native-collated batches bit-equal to np.load's; the phase took "
          f"{time.perf_counter() - t_phase:.1f} s")
    return {"launches": launches, "wavs": N_WAVS, "audio_seconds": audio_s, "feats_seconds": t_feats,
            "cpu_fbank_seconds": t_cpu, "fbank_max_abs_err": worst, "wer": out[2], "native_wer": native_wer[0],
            "seconds": time.perf_counter() - t_phase}


KERNEL_ROWS = (
    # name, source, file:line of the TPU kernel it replaces
    ("topk", "emoasr_tpu_torch/csrc/topk.cu", "emoasr_tpu/ops/topk_pallas.py:64"),
    ("attention_fwd", "emoasr_tpu_torch/csrc/attention.cu", "emoasr_tpu/ops/attention_pallas.py:76"),
    ("attention_bwd", "emoasr_tpu_torch/csrc/attention.cu", "emoasr_tpu/ops/attention_pallas.py:111"),
    ("ctc_head_fwd", "emoasr_tpu_torch/csrc/ctc_head.cu", "emoasr_tpu/ops/ctc_head_pallas.py:48"),
    ("ctc_head_grad_e", "emoasr_tpu_torch/csrc/ctc_head.cu", "emoasr_tpu/ops/ctc_head_pallas.py:100"),
    ("ctc_head_grad_w", "emoasr_tpu_torch/csrc/ctc_head.cu", "emoasr_tpu/ops/ctc_head_pallas.py:144"),
    ("ctc_alpha", "emoasr_tpu_torch/csrc/ctc_lattice.cu", "emoasr_tpu/ops/ctc_pallas.py:59"),
    ("ctc_beta_grad", "emoasr_tpu_torch/csrc/ctc_lattice.cu", "emoasr_tpu/ops/ctc_pallas.py:107"),
    ("attention_bias_fwd", "emoasr_tpu_torch/csrc/attention.cu", "emoasr_tpu/ops/attention_pallas.py:93"),
    ("attention_bias_bwd", "emoasr_tpu_torch/csrc/attention.cu", "emoasr_tpu/ops/attention_pallas.py:131"),
    ("decoder_step", "emoasr_tpu_torch/csrc/decoder_step.cu", "emoasr_tpu/ops/decoder_step_pallas.py:86"),
    ("decoder_step_indirect", "emoasr_tpu_torch/csrc/decoder_step.cu", "emoasr_tpu/ops/decoder_step_pallas.py:347"),
    ("lm_step_indirect", "emoasr_tpu_torch/csrc/lm_step.cu", "emoasr_tpu/ops/lm_step_pallas.py:85"),
    ("rnnt_joint", "emoasr_tpu_torch/csrc/rnnt_joint.cu", "emoasr_tpu/ops/rnnt_pallas.py:51"),
    ("lstm_fwd", "emoasr_tpu_torch/csrc/lstm_scan.cu", "emoasr_tpu/ops/lstm_pallas.py:56"),
    ("lstm_bwd", "emoasr_tpu_torch/csrc/lstm_scan.cu", "emoasr_tpu/ops/lstm_pallas.py:117"),
    # the bf16 launchers, as the bf16 training paths launch them
    ("ctc_head_fwd_bf16", "emoasr_tpu_torch/csrc/ctc_head.cu", "emoasr_tpu/ops/ctc_head_pallas.py:48"),
    ("ctc_head_grad_e_bf16", "emoasr_tpu_torch/csrc/ctc_head.cu", "emoasr_tpu/ops/ctc_head_pallas.py:100"),
    ("ctc_head_grad_w_bf16", "emoasr_tpu_torch/csrc/ctc_head.cu", "emoasr_tpu/ops/ctc_head_pallas.py:144"),
    ("attention_fwd_bf16", "emoasr_tpu_torch/csrc/attention.cu", "emoasr_tpu/ops/attention_pallas.py:76"),
    ("attention_bwd_bf16", "emoasr_tpu_torch/csrc/attention.cu", "emoasr_tpu/ops/attention_pallas.py:111"),
    ("attention_bias_fwd_bf16", "emoasr_tpu_torch/csrc/attention.cu", "emoasr_tpu/ops/attention_pallas.py:93"),
    ("attention_bias_bwd_bf16", "emoasr_tpu_torch/csrc/attention.cu", "emoasr_tpu/ops/attention_pallas.py:131"),
    ("rnnt_joint_bf16", "emoasr_tpu_torch/csrc/rnnt_joint.cu", "emoasr_tpu/ops/rnnt_pallas.py:51"),
    ("lstm_fwd_bf16", "emoasr_tpu_torch/csrc/lstm_scan.cu", "emoasr_tpu/ops/lstm_pallas.py:56"),
    ("lstm_bwd_bf16", "emoasr_tpu_torch/csrc/lstm_scan.cu", "emoasr_tpu/ops/lstm_pallas.py:117"),
    # the bf16 launchers of the beam steps, as the bf16 decoding paths launch them
    ("decoder_step_bf16", "emoasr_tpu_torch/csrc/decoder_step.cu", "emoasr_tpu/ops/decoder_step_pallas.py:86"),
    ("decoder_step_indirect_bf16", "emoasr_tpu_torch/csrc/decoder_step.cu",
     "emoasr_tpu/ops/decoder_step_pallas.py:347"),
    ("lm_step_indirect_bf16", "emoasr_tpu_torch/csrc/lm_step.cu", "emoasr_tpu/ops/lm_step_pallas.py:85"),
    # the vocabulary split (phase 29's (1, 2) runs): K7's launcher with the column offset, and K1 on
    # a rank's 5000 of L1's and L3-1's 10000 columns
    ("rnnt_joint_shard", "emoasr_tpu_torch/csrc/rnnt_joint.cu", "emoasr_tpu/ops/rnnt_pallas.py:51"),
    ("ctc_head_fwd_v5000", "emoasr_tpu_torch/csrc/ctc_head.cu", "emoasr_tpu/ops/ctc_head_pallas.py:48"),
    ("ctc_head_grad_e_v5000", "emoasr_tpu_torch/csrc/ctc_head.cu", "emoasr_tpu/ops/ctc_head_pallas.py:100"),
    ("ctc_head_grad_w_v5000", "emoasr_tpu_torch/csrc/ctc_head.cu", "emoasr_tpu/ops/ctc_head_pallas.py:144"),
)

# the same launchers at shapes no main path of this script runs: the widths
# above what the kernels first took (K7 with fewer cells a block, K8 with
# eight units a block; no shipped configuration is that wide), K7 at CSJ's
# vocabulary (V = 4000) and K5 and K6 at W = 33.  They are checked and timed
# in phases 3 and 14 and reported beside the `kernels` line.
WIDE_ROWS = (
    ("rnnt_joint_j1024", "emoasr_tpu_torch/csrc/rnnt_joint.cu", "emoasr_tpu/ops/rnnt_pallas.py:51"),
    ("rnnt_joint_j1024_bf16", "emoasr_tpu_torch/csrc/rnnt_joint.cu", "emoasr_tpu/ops/rnnt_pallas.py:51"),
    ("rnnt_joint_v4000", "emoasr_tpu_torch/csrc/rnnt_joint.cu", "emoasr_tpu/ops/rnnt_pallas.py:51"),
    ("rnnt_joint_v4000_bf16", "emoasr_tpu_torch/csrc/rnnt_joint.cu", "emoasr_tpu/ops/rnnt_pallas.py:51"),
    ("lstm_fwd_h1024", "emoasr_tpu_torch/csrc/lstm_scan.cu", "emoasr_tpu/ops/lstm_pallas.py:56"),
    ("lstm_bwd_h1024", "emoasr_tpu_torch/csrc/lstm_scan.cu", "emoasr_tpu/ops/lstm_pallas.py:117"),
    ("lstm_fwd_h1024_bf16", "emoasr_tpu_torch/csrc/lstm_scan.cu", "emoasr_tpu/ops/lstm_pallas.py:56"),
    ("lstm_bwd_h1024_bf16", "emoasr_tpu_torch/csrc/lstm_scan.cu", "emoasr_tpu/ops/lstm_pallas.py:117"),
    # beams wider than a row group of 16 (W = 33: three groups an utterance)
    ("decoder_step_w33", "emoasr_tpu_torch/csrc/decoder_step.cu", "emoasr_tpu/ops/decoder_step_pallas.py:86"),
    ("decoder_step_indirect_w33", "emoasr_tpu_torch/csrc/decoder_step.cu",
     "emoasr_tpu/ops/decoder_step_pallas.py:347"),
    ("lm_step_indirect_w33", "emoasr_tpu_torch/csrc/lm_step.cu", "emoasr_tpu/ops/lm_step_pallas.py:85"),
    ("decoder_step_w33_bf16", "emoasr_tpu_torch/csrc/decoder_step.cu", "emoasr_tpu/ops/decoder_step_pallas.py:86"),
    ("decoder_step_indirect_w33_bf16", "emoasr_tpu_torch/csrc/decoder_step.cu",
     "emoasr_tpu/ops/decoder_step_pallas.py:347"),
    ("lm_step_indirect_w33_bf16", "emoasr_tpu_torch/csrc/lm_step.cu", "emoasr_tpu/ops/lm_step_pallas.py:85"),
    # K7's launcher with the column offset in bf16 (no bf16 run splits the vocabulary)
    ("rnnt_joint_shard_bf16", "emoasr_tpu_torch/csrc/rnnt_joint.cu", "emoasr_tpu/ops/rnnt_pallas.py:51"),
)


# ------------------------------------------------ slice 8b: data and tensor parallelism

# parameters after one update, ranks against one process: Adam's first step
# moves an entry by at most the LR, and flips it where the two gradients'
# signs differ in rounding noise (the key biases' true gradient is zero);
# see `updates_close`
PAR_PARAM_TOL = 2.0  # times the update's LR
# the summed micro-gradient, ranks against one process, of each tensor's
# largest entry beyond STEP_TOL's floor: the ranks sum the one-process
# rows in another order (measured 0.0); the ranks' conv2d in TF32 gave 9.5e-4
PAR_GRAD_TOL = 1e-5
PAR_ENC_TOL = 1e-5  # one batch's encoder output, rows split over two ranks against one process
# the conv2d subsampler's parameters: the weight and bias gradients of its
# cuDNN backward are not reproducible run to run (two plain runs' gradients
# of the first convolution differ by up to 2.9e-06, their `model.ep1` in the
# last bits), so (a) holds them to `updates_close` and every other tensor
# bit for bit
CUDNN_NONDET = ("encoder.conv.",)
PAR_TIMEOUT = 600  # seconds for the phase's processes, which run side by side


def _start(argv: list, log: str, env=None) -> tuple:
    """`python argv...` from the checkout in the background, output to `log`."""
    run_env = dict(os.environ, PYTHONPATH=REPO, **(env or {}))
    for k in ("RANK", "WORLD_SIZE", "LOCAL_RANK", "LOCAL_WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT"):
        run_env.pop(k, None)
    out = open(log, "w")
    return subprocess.Popen([sys.executable, *argv], cwd=REPO, env=run_env, stdout=out,
                            stderr=subprocess.STDOUT), out, log


def _finish(run: tuple, what: str, deadline: float) -> str:
    proc, out, log = run
    try:
        rc = proc.wait(timeout=max(deadline - time.time(), 1))
    except subprocess.TimeoutExpired:
        proc.kill()
        proc.wait()
        rc = "timeout"
    out.close()
    with open(log) as f:
        text = f.read()
    require(rc == 0, f"{what}: exit {rc}:\n{text[-4000:]}")
    return text


def _par_grads(tag: str, got: dict, want: dict) -> dict:
    """A rank's first micro-step against one process's: the loss terms
    (STEP_TOL) and the summed micro-gradient (PAR_GRAD_TOL of each tensor's
    largest entry beyond STEP_TOL's floor; also the gap without the floor,
    but for the INERT_BIASES, whose gradient is rounding noise)."""
    for k, b in want["metrics"][0].items():
        a = got["metrics"][0][k]
        if k.startswith("loss"):
            require(np.isfinite(a) and abs(a - b) <= STEP_TOL["loss"] * abs(b), f"{tag} {k}: ranks {a}, one process {b}")
    g1, g0 = got["grads"], want["grads"]
    require(set(g1) == set(g0), f"{tag}: the gradients' tensors differ")
    floor = STEP_TOL["grad_floor"] * max(g.abs().max().item() for g in g0.values())
    worst = raw = 0.0
    for k in g0:
        err, top = _max_err(g1[k], g0[k]), max(g0[k].abs().max().item(), 1e-30)
        rel = max(err - floor, 0.0) / top
        require(rel <= PAR_GRAD_TOL, f"{tag} gradient of {k}: ranks vs one process {rel:.3e} of its largest entry")
        worst, raw = max(worst, rel), raw if k.endswith(INERT_BIASES) else max(raw, err / top)
    return {"loss_total": got["metrics"][0]["loss_total"], "worst_grad_rel_err": worst, "worst_grad_rel_err_raw": raw}


def _train_log(conf_path: str) -> str:
    with open(os.path.join(os.path.splitext(conf_path)[0], "log", "train.log")) as f:
        return f.read()


def _dev_wer(conf_path: str) -> float:
    import re

    found = re.findall(r"dev WER \(greedy\): (\S+)", _train_log(conf_path))
    require(len(found) == 1, f"{conf_path}: {len(found)} dev WER lines")
    return float(found[0])


def parallel_phase(args, root: str, tr: dict, dev, card: str) -> dict:
    """Phase 29 (see the module note): the train CLI under torchrun on NCCL
    (a world of one) and on (2,) and (1, 2) over gloo on the one card, each
    against the plain CLI; the summed micro-gradient of L1 steps on (2,)
    and (1, 2) through the rank programs, the keep masks of K4's blocks,
    and the eval CLI's --dp, each against one process."""
    import pandas as pd
    import yaml

    from emoasr_tpu_torch.data.asr_dataset import ASRDataset
    from emoasr_tpu_torch.models.asr import ASR
    from emoasr_tpu_torch.ops.attention import dropout_keep_mask
    from emoasr_tpu_torch.parallel import ranks
    from emoasr_tpu_torch.train.checkpoint import load_state_dict
    from emoasr_tpu_torch.train.optim import build_optimizer, make_lr_fn

    t_phase = time.perf_counter()
    sub = os.path.join(root, "parallel")
    os.makedirs(sub)
    cfg = tr["cfg"]
    with open(tr["conf_path"]) as f:
        conf = yaml.safe_load(f)
    lengths, _ = train_lengths(cfg, (0, 0, 0, 0, 2))  # two batches of the (18, 1600) bucket
    train_tsv, _ = write_corpus(sub, "train", lengths, cfg.vocab_size, cfg.feat_dim, args.seed + 29)
    # one update (accum_grad 2) at a visible LR, then rank 0's greedy validation on phase 6's corpus
    run_conf = dict(conf, train_path=train_tsv, accum_grad=2, num_warmup_steps=UPDATE_WARMUP, dev_path=tr["test_tsv"])
    meshes = {"plain": None, "torchrun": None, "data": ([-1], ["data"]), "model": ([1, 2], ["data", "model"])}
    confs = {}
    for name, mesh in meshes.items():
        confs[name] = os.path.join(sub, f"{name}.yaml")
        with open(confs[name], "w") as f:
            yaml.safe_dump(dict(run_conf, **({} if mesh is None else dict(mesh_shape=mesh[0], mesh_axes=mesh[1]))), f)
    ds = ASRDataset(cfg, train_tsv, phase="train")
    batcher = ds.make_batcher(shuffle=False)
    batches = [{k: torch.from_numpy(v.astype(np.int64) if v.dtype == np.int32 else v)
                for k, v in ds.collate(idx, batcher.buckets[bi].max_xlen, batcher.buckets[bi].max_ylen).items()
                if isinstance(v, np.ndarray)} for bi, idx in batcher]
    require(len(batches) == 2 and all(b["xs"].shape[0] == 18 for b in batches), "two batches of 18 rows")
    sd = load_state_dict(tr["ckpt"])
    step_conf = dict(conf, accum_grad=2)  # one micro-step: the summed micro-gradient, no update
    jobs = [dict(program="train_steps", mesh_shape=shape, mesh_axes=axes, backend="gloo", device="cuda",
                 conf=step_conf, batches=batches[:1], state_dict=sd)
            for shape, axes in (((2,), ("data",)), ((1, 2), ("data", "model")))]
    jobs.append(dict(program="encode", mesh_shape=(2,), mesh_axes=("data",), backend="gloo", device="cuda",
                     conf=conf, state_dict=sd, xs=batches[0]["xs"], xlens=batches[0]["xlens"]))
    gloo = {"EMOASR_DIST_BACKEND": "gloo"}
    torchrun = ["-m", "torch.distributed.run", "--standalone", "--nproc_per_node"]
    train_cli = ["-m", "emoasr_tpu_torch.train.loop", "-conf"]
    deadline = time.time() + PAR_TIMEOUT
    runs = {
        "plain": _start([*train_cli, confs["plain"]], os.path.join(sub, "plain.log")),
        "torchrun": _start([*torchrun, "1", *train_cli, confs["torchrun"]], os.path.join(sub, "torchrun.log")),
        "data": _start([*torchrun, "2", *train_cli, confs["data"]], os.path.join(sub, "data.log"), gloo),
        "model": _start([*torchrun, "2", *train_cli, confs["model"]], os.path.join(sub, "model.log"), gloo),
        "dp": _start([*torchrun, "2", "-m", "emoasr_tpu_torch.eval.test_asr", "-conf", tr["conf_path"], "-ep", "1",
                      "--beam_width", "8", "--dp", "--save_dir", "dp"], os.path.join(sub, "dp.log"), gloo),
    }
    two = ranks.Launch(2, os.path.join(sub, "ranks"), jobs)

    # meanwhile, in this process: the one-process references on the card and K4's blocks
    one = ranks.train_steps(None, step_conf, batches[:1], sd, device="cuda")
    one_enc = ranks.encode(None, conf, sd, batches[0]["xs"], batches[0]["xlens"], device="cuda")
    T2 = one_enc[0].shape[1]
    B, H = 18, cfg.enc_num_attention_heads
    rate, seed = cfg.dropout_attn_rate, 0x5EED_0F_8B
    full = dropout_keep_mask(B, T2, H, rate, seed, dev)
    require(torch.equal(dropout_keep_mask(B, T2, H, rate, seed, dev, block=(0, B, 0, H)), full),
            "K4's keep mask with offsets (0, 0, H) is not the mask without them")
    for r in range(2):
        require(torch.equal(dropout_keep_mask(B // 2, T2, H, rate, seed, dev, block=(r * B // 2, B, 0, H)),
                            full[r * B // 2:(r + 1) * B // 2]), f"K4's keep mask of rank {r}'s rows")
        require(torch.equal(dropout_keep_mask(B, T2, H // 2, rate, seed, dev, block=(0, B, r * H // 2, H)),
                            full[:, r * H // 2:(r + 1) * H // 2]), f"K4's keep mask of rank {r}'s heads")
    print(f"  K4's keep mask ({B}, {H}, {T2}, {T2}), rate {rate}: offsets (0, 0, {H}) draw the old bits; each "
          f"rank's rows (9 + 9) and heads (2 + 2) draw their block of the one-process mask")
    torch.manual_seed(cfg.seed)
    seed_model = ASR(cfg)
    init = seed_model.state_dict()  # the trainers' seed weights
    order = optimizer_order(seed_model, build_optimizer(cfg, seed_model.parameters()))

    res = two.wait(PAR_TIMEOUT)
    for k, r in runs.items():
        _finish(r, k, deadline)

    # (a) torchrun, NCCL in a world of one, against the plain run: bit for bit
    require("over nccl" in _train_log(confs["torchrun"]), "the torchrun trainer did not run over NCCL")
    logs = {n: read_train_log(confs[n]) for n in meshes}
    ck = {n: load_state_dict(os.path.join(os.path.splitext(confs[n])[0], "checkpoints", "model.ep1")) for n in meshes}
    grads = {n: first_step_grads(torch.load(os.path.join(os.path.splitext(confs[n])[0], "checkpoints", "optim.ep1"),
                                            map_location="cpu", weights_only=False)["optimizer"], order) for n in meshes}
    wer = {n: _dev_wer(confs[n]) for n in meshes}
    require(logs["plain"][:2] == logs["torchrun"][:2] and len(logs["plain"][0]) == 2 and wer["torchrun"] == wer["plain"],
            f"torchrun's losses / LRs / dev WER {logs['torchrun'][:2]} {wer['torchrun']} differ from the plain run's "
            f"{logs['plain'][:2]} {wer['plain']}")
    require(ck["plain"].keys() == ck["torchrun"].keys(), "torchrun's model.ep1 holds other tensors")
    differ = [k for k in ck["plain"] if not k.startswith(CUDNN_NONDET) and not torch.equal(ck["plain"][k],
                                                                                           ck["torchrun"][k])]
    require(not differ, f"torchrun's model.ep1 is not the plain run's bit for bit: {differ}")
    lr = make_lr_fn(cfg.replace(num_warmup_steps=UPDATE_WARMUP))(1)  # the one update's
    require(logs["plain"][1][-1] == round(lr, 6), f"the plain run's logged LR {logs['plain'][1]}, the update's {lr}")
    conv = [k for k in ck["plain"] if k.startswith(CUDNN_NONDET)]
    _, conv_gap, _, _ = updates_close("torchrun's model.ep1 vs the plain run's, the conv2d subsampler",
                                      {k: ck["torchrun"][k] for k in conv}, {k: ck["plain"][k] for k in conv}, init,
                                      lr, gradient_noise(grads["torchrun"], grads["plain"]))
    print(f"  (a) torchrun --nproc_per_node 1 (NCCL, a world of one) of the train CLI: losses {logs['torchrun'][0]}, "
          f"LR {lr:.4e}, dev WER {wer['torchrun']}, model.ep1 equal to the plain run's bit for bit on "
          f"{len(ck['plain']) - len(conv)} of {len(ck['plain'])} tensors, the conv2d subsampler's {len(conv)} (cuDNN's "
          f"backward) within {conv_gap:.3e}")

    # (b), (c): the train CLI on two ranks over gloo against the plain run; the
    # rank programs' summed micro-gradient against one process
    out = {"keep_mask_blocks": True, "torchrun_world1_bit_equal_but_conv": True, "torchrun_world1_conv_gap": conv_gap,
           "lr": lr, "dev_wer": wer["plain"]}
    n_layers = cfg.enc_num_layers
    want = {"attention": {"emo_attention_fwd_f32": n_layers, "emo_attention_bwd_f32": n_layers},
            "ctc_head": {"emo_ctc_head_fwd_f32": 1, "emo_ctc_head_grad_e_f32": 1, "emo_ctc_head_grad_w_f32": 1},
            "ctc_lattice": {"emo_ctc_alpha_f32": 1, "emo_ctc_beta_grad_f32": 1}}
    launches = {}
    for j, (tag, shape, described) in enumerate((("data", "(2,)", "mesh (2,) ('data',)"),
                                                 ("model", "(1, 2)", "mesh (1, 2) ('data', 'model')"))):
        text = _train_log(confs[tag])
        require(f"{described}: rank 0 of 2" in text and "over gloo" in text, f"the {shape} trainer's mesh: {text[:2000]}")
        losses, lrs, _ = logs[tag]
        require(len(losses) == 2 and lrs == logs["plain"][1] and all(
            abs(a - b) <= STEP_TOL["loss"] * abs(b) for a, b in zip(losses, logs["plain"][0])),
            f"{shape} train CLI: losses {losses}, LRs {lrs} against the plain run's {logs['plain'][:2]}")
        require(wer[tag] == wer["plain"], f"{shape} train CLI: rank 0's dev WER {wer[tag]}, the plain run's {wer['plain']}")
        moved, perr, share, n_noise = updates_close(f"{shape} train CLI's model.ep1 vs the plain run's", ck[tag],
                                                    ck["plain"], init, lr, gradient_noise(grads[tag], grads["plain"]))
        for r in range(2):
            got = res[r][j]["launches"]
            require(all(got[k][n] == c for k, w in want.items() for n, c in w.items()),
                    f"{shape} rank {r}: launches {got}, want {want}")
            for k in ("attention", "ctc_head", "ctc_lattice", "topk"):
                for n, c in got[k].items():
                    launches[(k, n)] = launches.get((k, n), 0) + c
            require(res[r][j]["skipped"] == 0, f"{shape} rank {r} skipped a micro-step")
        out[tag] = {**_par_grads(f"{shape} micro-step", res[0][j], one), "cli_losses": losses,
                    "param_max_abs_err": perr, "share_beyond_2pct_lr": share, "largest_move": moved,
                    "noise_entries": n_noise}
        print(f"  ({'b' if tag == 'data' else 'c'}) {shape} over gloo on the one card, dropout and SpecAugment on: the "
              f"train CLI's losses {losses} vs {logs['plain'][0]}, dev WER {wer[tag]}, model.ep1 within {perr:.3e} "
              f"({perr / lr:.3f} LR; at most {share:.4f} of a tensor's entries beyond 2 % of the LR, {n_noise} entries' "
              f"gradients within the two runs' difference of zero; largest move "
              f"{moved:.3e}); one micro-step through the rank programs: loss {out[tag]['loss_total']} vs "
              f"{one['metrics'][0]['loss_total']}, worst gradient {out[tag]['worst_grad_rel_err']:.2e} of its largest "
              f"entry beyond the floor (tol {PAR_GRAD_TOL}; {out[tag]['worst_grad_rel_err_raw']:.2e} without it, the "
              f"{INERT_BIASES} aside); each "
              f"rank launched {want}")

    # (d): --dp over phase 6's corpus against phase 6's TSV, and one batch's encoder output
    name = "result_test_beam8_len0.0_ctc0.0_lm0.00_ep1.tsv"
    res_dir = os.path.join(os.path.splitext(tr["conf_path"])[0], "results")
    dp = pd.read_table(os.path.join(res_dir, "dp", name), comment="#")
    ref = pd.read_table(os.path.join(res_dir, name), comment="#")
    require(list(dp["utt_id"]) == list(ref["utt_id"]) and len(dp) == args.n_utts,
            f"--dp wrote {len(dp)} rows, not phase 6's {len(ref)} in its order")
    same = float((dp["token_id"].fillna("").astype(str) == ref["token_id"].fillna("").astype(str)).mean())
    require(same >= HYP_SHARE, f"--dp rows equal to phase 6's: {same:.2f} < {HYP_SHARE}")
    enc = res[0][2]
    require(res[1][2] is None and torch.equal(enc[1], one_enc[1]), "--dp encoder lengths")
    enc_err = max((enc[0][b, :n] - one_enc[0][b, :n]).abs().max().item() for b, n in enumerate(one_enc[1].tolist()))
    require(enc_err <= PAR_ENC_TOL, f"encoder output, rows over two ranks vs one process: {enc_err:.3e}")
    print(f"  (d) the eval CLI with --dp on two ranks (gloo) over phase 6's {len(dp)} utts, beam 8: "
          f"{int(round(same * len(dp)))} of {len(dp)} rows equal to phase 6's (required {HYP_SHARE}); "
          f"one (18, {T2}) batch's encoder output over 9 + 9 rows vs one process: {enc_err:.2e} (tol {PAR_ENC_TOL})")
    dt = time.perf_counter() - t_phase
    print(f"  phase 29: {dt:.1f} s on {card}")
    counts = {"attention_fwd": launches[("attention", "emo_attention_fwd_f32")],
              "attention_bwd": launches[("attention", "emo_attention_bwd_f32")],
              "ctc_head_fwd": launches[("ctc_head", "emo_ctc_head_fwd_f32")],
              "ctc_head_grad_e": launches[("ctc_head", "emo_ctc_head_grad_e_f32")],
              "ctc_head_grad_w": launches[("ctc_head", "emo_ctc_head_grad_w_f32")],
              "ctc_alpha": launches[("ctc_lattice", "emo_ctc_alpha_f32")],
              "ctc_beta_grad": launches[("ctc_lattice", "emo_ctc_beta_grad_f32")],
              "topk": launches[("topk", "all")]}
    return {**out, "dp_same_rows": same, "dp_encoder_max_abs_err": enc_err, "seconds": dt,
            "launches": Launches({**_zero_launches(), **counts}, topk_shapes={})}


# ------------------------------------------------ slice 8c: the vocabulary split

# K7's whole-vocabulary launch (no column offset) on `k7_digest_inputs`, the
# SHA-256 of its outputs' bytes (lp_blank, then lp_label) by dtype as the
# source before the offset computes them: `python tools/k7_offset_bits.py
# --csrc <that source's csrc/>` (NVIDIA H100 80GB HBM3, CUDA 12.x's nvcc)
K7_WHOLE_SHA256 = {"float32": "683d53ff1407d5dbc95f3bc9259be3c1e83654a71bde91096ce78abcf3ac531d",
                   "bfloat16": "9b1b72f54a135268ef60ef01178df50bc69393b7077fe8cd2fc51a0d0a06d35d"}
# the vocabulary-split runs of phase 29: a model axis of 2 over gloo on the one card, the jobs
# in two groups of two (a launch of ranks and a one-rank launch each, side by side)
VOCAB_RANKS = 2
VOCAB_GROUPS = (("l3_1", "rnn_lm"), ("l4", "bert_lm"))
# the launchers of the vocabulary split, on the `kernels` line as rows of their own: K7 with the
# column offset, and K1 at V = 5000 (a rank's half of L1's and L3-1's 10000 columns), whose
# launches are counted on phase 29's (1, 2) runs
SHARD_KEYS = ("rnnt_joint_shard", "rnnt_joint_shard_bf16", "ctc_head_fwd_v5000", "ctc_head_grad_e_v5000",
              "ctc_head_grad_w_v5000")


def k7_digest_inputs(dev, dtype):
    """L4's largest bucket, (18, 399, 129), J = 512, V = 1000, from numpy's
    generator (the same bits on every machine); w as `weight.t()`."""
    rng = np.random.default_rng(19)
    B, T, U1, J, V = 18, 399, 129, 512, 1000

    def normal(*shape, scale=1.0):
        return torch.from_numpy((scale * rng.standard_normal(shape)).astype(np.float32)).to(dev, dtype)

    h_enc, h_dec, weight, bias = normal(B, T, J), normal(B, U1, J), normal(V, J, scale=J ** -0.5), normal(V, scale=0.1)
    labels = torch.from_numpy(rng.integers(1, V, (B, U1 - 1))).to(dev)
    return h_enc, h_dec, weight.t(), bias, labels


def k7_whole_digests(dev) -> dict:
    """SHA-256 of K7's whole-vocabulary outputs on `k7_digest_inputs`, by dtype."""
    import hashlib

    from emoasr_tpu_torch.ops.rnnt_joint import fused_joint_gather

    out = {}
    for dtype in (torch.float32, torch.bfloat16):
        with torch.no_grad():
            lpb, lpl = fused_joint_gather(*k7_digest_inputs(dev, dtype), 0)
        h = hashlib.sha256(lpb.cpu().numpy().tobytes())
        h.update(lpl.cpu().numpy().tobytes())
        out[str(dtype).replace("torch.", "")] = h.hexdigest()
    return out


def check_rnnt_joint_shard(dev, gen) -> dict:
    """K7's vocabulary-split launcher at L4's largest bucket, (18, 399,
    129), J = 512, on ranks 0 and 1 of a model axis of 2 (500 of 1000
    columns each, the blank on rank 0), in f32 and bf16, against
    `rnnt_joint_plain(..., v0)`: the block's lse and the owned blank and
    label logits (RNNT_JOINT_TOL; exactly 0 where the block does not own
    the column), twice bit-identical; the two ranks' outputs combined as
    `joint_gather_shard` combines them against the whole launch."""
    from emoasr_tpu_torch.ops.rnnt_joint import fused_joint_gather, joint_parts_shard, rnnt_joint_plain

    h_enc, h_dec, weight, bias, labels = rnnt_joint_case(dev, gen, 18, 399, 129, 512, 1000)
    per = 1000 // VOCAB_RANKS
    worst = {}
    for dtype, key in ((torch.float32, "rnnt_joint_shard"), (torch.bfloat16, "rnnt_joint_shard_bf16")):
        he, hd, wt, b = (x.to(dtype) for x in (h_enc, h_dec, weight, bias))
        parts, errs = [], []
        for r in range(VOCAB_RANKS):
            v0 = r * per
            args = (he, hd, wt[v0:v0 + per].t(), b[v0:v0 + per], labels, 0, v0)
            with torch.no_grad():
                got, again, want = joint_parts_shard(*args), joint_parts_shard(*args), rnnt_joint_plain(*args)
            torch.cuda.synchronize()
            tag = f"rnnt joint {str(dtype).replace('torch.', '')} rank {r} of {VOCAB_RANKS} (v0 = {v0}, {per} columns)"
            require(all(a.dtype == torch.float32 for a in got), f"{tag}: outputs are not float32")
            require(all(torch.equal(a, c) for a, c in zip(got, again)), f"{tag}: two launches differ")
            own = ((labels >= v0) & (labels < v0 + per))[:, None, :].expand_as(got[2])
            require(not got[2].masked_select(~own).any() and (r == 0 or not got[1].any()),
                    f"{tag}: a logit of a column another rank owns is not exactly 0")
            errs += [_require_close(f"{tag} {what}", a, c, RNNT_JOINT_TOL, 0.0)
                     for what, a, c in zip(("lse", "blank", "label"), got, want)]
            parts.append(got)
        lse = torch.logsumexp(torch.stack([p[0] for p in parts]), 0)
        with torch.no_grad():
            whole = fused_joint_gather(he, hd, wt.t(), b, labels, 0)
        comb = (sum(p[1] for p in parts) - lse, sum(p[2] for p in parts) - lse[:, :, :-1])
        errs += [_require_close(f"rnnt joint {dtype} two ranks combined vs the whole launch {what}", a, c,
                                RNNT_JOINT_TOL, 0.0) for what, a, c in zip(("lp_blank", "lp_label"), comb, whole)]
        worst[key] = max(errs)
        print(f"  rnnt joint {dtype}, ranks 0 and 1 of {VOCAB_RANKS} (18,399,129) J=512 V={per} of 1000: lse, blank, "
              f"label within {worst[key]:.2e} of rnnt_joint_plain with the offset and, combined, of the whole launch "
              f"(tol {RNNT_JOINT_TOL}); not owned: exactly 0; twice, bit-identical")
    return worst


def check_vocab_shards(dev, gen) -> dict:
    """Phase 3's checks of the vocabulary split: K1 on each rank's half of
    L1's head, (18, 399, 256) x (256, 5000 of 10000), S = 257, about half the
    path labels outside the block; K7 with the column offset
    (`check_rnnt_joint_shard`); K7 without it bit-identical to the source
    before the offset (K7_WHOLE_SHA256)."""
    worst = {}
    for r in range(VOCAB_RANKS):
        worst = _merge_worst(worst, check_head_case(
            dev, gen, f"rank {r} of {VOCAB_RANKS}, (18,399,256)x(256,5000 of 10000) S=257", (18, 399, 256, 10000, 128),
            torch.float32, block=(r, VOCAB_RANKS)))
    errs = {"ctc_head_fwd_v5000": worst["fwd"], "ctc_head_grad_e_v5000": worst["grad_e"],
            "ctc_head_grad_w_v5000": worst["grad_w"]}
    errs.update(check_rnnt_joint_shard(dev, gen))
    got = k7_whole_digests(dev)
    require(got == K7_WHOLE_SHA256, f"K7 without the offset: SHA-256 {got}, the source before it {K7_WHOLE_SHA256}")
    print(f"  K7 without the offset (f32, bf16) at (18,399,129) J=512 V=1000: the outputs' SHA-256 equal to the "
          f"source's before the offset ({got['float32'][:12]}..., {got['bfloat16'][:12]}...)")
    return errs


def trace_kernels(path: str) -> list:
    """The names of the CUDA kernels in a Chrome trace of `torch.profiler`."""
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    return [e.get("name", "") for e in events if e.get("cat") == "kernel"]


def require_traced(path: str, what: str, kernels: dict) -> dict:
    """`kernels`: {label: a substring of the kernel's name}; each named by
    some kernel event of the trace at `path`.  Their event counts."""
    require(os.path.exists(path), f"{what}: no trace at {path}")
    names = trace_kernels(path)
    counts = {label: sum(sub in n for n in names) for label, sub in kernels.items()}
    require(all(counts.values()), f"{what}: the trace's {len(names)} kernel events name {counts}")
    return counts


def _lm_rows(cfg, tsv: str, rows: int):
    """The first batch of `rows` rows and the longest bucket an LM dataset
    makes of `tsv`, without shuffling."""
    from emoasr_tpu_torch.data.lm_dataset import LMDataset

    ds = LMDataset(cfg, tsv, phase="train", seed=cfg.seed)
    batches = list(ds.batches(ds.make_batcher(shuffle=False)))
    batch = max(batches, key=lambda b: b["ys_in"].shape[0] * b["ys_in"].shape[1])
    return {k: torch.from_numpy(v[:rows]) for k, v in batch.items() if isinstance(v, np.ndarray)}


def _asr_rows(cfg, tsv: str):
    """One batch of the largest bucket of an ASR corpus, without shuffling."""
    from emoasr_tpu_torch.data.asr_dataset import ASRDataset

    ds = ASRDataset(cfg, tsv, phase="train")
    batcher = ds.make_batcher(shuffle=False)
    top = max(range(len(batcher.buckets)), key=lambda i: batcher.buckets[i].max_xlen)
    bi, idx = next(b for b in batcher if b[0] == top)
    batch = ds.collate(idx, batcher.buckets[bi].max_xlen, batcher.buckets[bi].max_ylen)
    return {k: torch.from_numpy(v.astype(np.int64) if v.dtype == np.int32 else v)
            for k, v in batch.items() if isinstance(v, np.ndarray)}


def vocab_phase_start(args, root: str, tr: dict, l3t: dict, l4: dict, lms: dict) -> dict:
    """Start phase 29's vocabulary-split runs (after the rest of the
    phase: beside its eight processes the card ran out of memory): one
    micro-step of L3-1 and of L4 and one step of the RNN LM and BERT, each
    at full width on `(1, VOCAB_RANKS)` over gloo through the rank
    programs, and the same jobs on one rank (a world of one: the
    one-process path) as the reference; the L3-1 job writes `model.ep1` on
    the mesh.  Also the eval CLI with `--profile` over phase 6's corpus."""
    import yaml

    from emoasr_tpu_torch.parallel import ranks
    from emoasr_tpu_torch.train.checkpoint import load_state_dict

    sub = os.path.join(root, "vocab_parallel")
    os.makedirs(sub)

    def conf_of(path, **over):
        with open(path) as f:
            return dict(yaml.safe_load(f), **over)

    l3_batch = _asr_rows(l3t["cfg"], l3t["train_tsv"])
    jobs = {
        "l3_1": dict(conf=conf_of(l3t["conf_path"], accum_grad=2), batches=[l3_batch],
                     state_dict=load_state_dict(l3t["ckpt"]), eval_batch=l3_batch),
        "l4": dict(conf=conf_of(l4["conf_path"], accum_grad=2), batches=[_asr_rows(l4["cfg"], l4["train_tsv"])],
                   state_dict=load_state_dict(l4["ckpt"])),
    }
    for t in ("rnn", "bert"):
        lm = lms[t]
        jobs[f"{t}_lm"] = dict(conf=conf_of(lm["conf_path"], accum_grad=2), lm=True, num_total_steps=100,
                               batches=[_lm_rows(lm["cfg"], os.path.join(lm["train_dir"], "a.tsv"), 90)],
                               state_dict=load_state_dict(lm["ckpt"]))
    save = os.path.join(sub, "l3_1_ckpt")
    mesh = dict(mesh_shape=(1, VOCAB_RANKS), mesh_axes=("data", "model"), backend="gloo", device="cuda")
    one = dict(mesh_shape=(1,), mesh_axes=("data",), backend="gloo", device="cuda")
    split = {n: dict(program="train_steps", **mesh, **job, **({"save_dir": save} if n == "l3_1" else {}))
             for n, job in jobs.items()}
    ref = {n: dict(program="train_steps", **one, **job) for n, job in jobs.items()}
    prof = os.path.join(sub, "eval_trace")
    # two groups of jobs a launch, side by side: four rank processes and two one-rank ones
    launches = [(group, ranks.Launch(VOCAB_RANKS, os.path.join(sub, f"ranks{g}"), [split[n] for n in group]),
                 ranks.Launch(1, os.path.join(sub, f"one{g}"), [ref[n] for n in group]))
                for g, group in enumerate(VOCAB_GROUPS)]
    return {"names": list(jobs), "save": save, "prof": prof, "t0": time.perf_counter(), "cfgs": {
                "l3_1": l3t["cfg"], "l4": l4["cfg"], "rnn_lm": lms["rnn"]["cfg"], "bert_lm": lms["bert"]["cfg"]},
            "state_dict": jobs["l3_1"]["state_dict"], "eval_batch": l3_batch, "launches": launches,
            "eval": _start(["-m", "emoasr_tpu_torch.eval.test_asr", "-conf", tr["conf_path"], "-ep", "1",
                            "--beam_width", "8", "--profile", prof, "--save_dir", "profile"],
                           os.path.join(sub, "eval_profile.log"))}


def vocab_phase_finish(vp: dict, dev, card: str) -> dict:
    """Phase 29's vocabulary-split checks: each job's loss (STEP_TOL) and
    summed micro-gradient (PAR_GRAD_TOL) against the one-rank run, the same
    loss terms on both ranks, each rank holding half of every vocabulary
    table and head, K7's vocabulary-split launcher (L4) and K1 (L3-1's aux
    CTC) once a rank; the mesh's `model.ep1` gathered back into the weights
    it started from, loaded by a one-process port model, whose eval loss is
    the mesh's; each rank's peak device memory beside the one-process
    run's; the eval CLI's trace naming K3's and K4's kernels."""
    from emoasr_tpu_torch.models.asr import ASR
    from emoasr_tpu_torch.train.checkpoint import load_state_dict
    from emoasr_tpu_torch.train.step import compute_loss

    res, ref = {}, {}  # by job: every rank's results, the one-rank run's
    for group, split, one in vp["launches"]:
        got, want = split.wait(PAR_TIMEOUT), one.wait(PAR_TIMEOUT)
        for j, name in enumerate(group):
            res[name], ref[name] = [got[r][j] for r in range(VOCAB_RANKS)], want[0][j]
    _finish(vp["eval"], "the eval CLI with --profile", time.time() + PAR_TIMEOUT)
    gib = 2.0 ** 30
    out, shard_launches, v5000 = {}, 0, {"fwd": 0, "grad_e": 0, "grad_w": 0}
    heads = {"l3_1": ("decoder.embed.weight", "decoder.output.weight", "decoder.ctc.output.weight"),
             "l4": ("decoder.embed.weight", "decoder.output.weight", "decoder.output.bias"),
             "rnn_lm": ("lm.embed.weight", "lm.output.weight"),
             "bert_lm": ("lm.bert.bert.embeddings.word_embeddings.weight",
                         "lm.bert.bert.embeddings.position_embeddings.weight")}
    for name in vp["names"]:
        one, got = ref[name], res[name]
        tag = f"{name} on (1, {VOCAB_RANKS})"
        grads = _par_grads(tag, got[0], one)
        require(all(g["metrics"] == got[0]["metrics"] for g in got), f"{tag}: the ranks' loss terms differ")
        for r, g in enumerate(got):
            require(all(g["shapes"][k][0] * VOCAB_RANKS == one["shapes"][k][0] for k in heads[name]),
                    f"{tag} rank {r}: {[(k, g['shapes'][k]) for k in heads[name]]} is not its share of "
                    f"{[one['shapes'][k] for k in heads[name]]}")
            n = g["launches"]
            if name == "l4":
                require(n["rnnt_joint"]["emo_rnnt_joint_shard_f32"] == 1 and n["rnnt_joint"]["emo_rnnt_joint_f32"] == 0
                        and n["lstm_scan"]["emo_lstm_fwd_f32"] >= 1, f"{tag} rank {r}: launches {n}")
                shard_launches += 1
            if name == "l3_1":
                require(n["ctc_head"]["emo_ctc_head_fwd_f32"] == 1, f"{tag} rank {r}: launches {n}")
                for k in v5000:
                    v5000[k] += n["ctc_head"][f"emo_ctc_head_{k}_f32"]
        peaks = [g["peak_bytes"] / gib for g in got]
        out[name] = {**grads, "peak_gib_ranks": peaks, "peak_gib_one": one["peak_bytes"] / gib}
        print(f"  {tag} over gloo, one micro-step at full width: loss {grads['loss_total']} vs one process "
              f"{one['metrics'][0]['loss_total']}; worst gradient {grads['worst_grad_rel_err']:.2e} of its largest entry "
              f"beyond the floor (tol {PAR_GRAD_TOL}); the ranks' loss terms equal; half of each of {len(heads[name])} "
              f"vocabulary tables and heads a rank; peak device memory {', '.join(f'{p:.2f}' for p in peaks)} GiB a "
              f"rank vs {one['peak_bytes'] / gib:.2f} GiB in one process")
    # the L3-1 mesh's model.ep1: the gathered shares are the weights it started from (no update
    # yet); the BatchNorm statistics moved with the micro-step's batch
    path = os.path.join(vp["save"], "model.ep1")
    ck = load_state_dict(path)
    cfg = vp["cfgs"]["l3_1"]
    model = ASR(cfg)
    params = [n for n, _ in model.named_parameters()]
    stats = [k for k in ck if k.endswith(("running_mean", "running_var"))]
    require(res["l3_1"][0]["roundtrip"] == 0.0 and ck.keys() == vp["state_dict"].keys()
            and all(torch.equal(ck[k], vp["state_dict"][k]) for k in params) and stats
            and all(bool(torch.isfinite(ck[k]).all()) and not torch.equal(ck[k], vp["state_dict"][k]) for k in stats),
            "the (1, 2) L3-1 model.ep1: its parameters are not its starting weights, or its BatchNorm statistics "
            "did not move")
    model.load_state_dict(ck)
    model = model.to(dev).eval()
    with torch.no_grad():
        _, loss = compute_loss(model, cfg, {k: v.to(dev) for k, v in vp["eval_batch"].items()}, None, False)
    mesh_loss, one_loss = res["l3_1"][0]["eval_loss"]["loss_total"], ref["l3_1"]["eval_loss"]["loss_total"]
    require(all(abs(x - one_loss) <= STEP_TOL["loss"] * abs(one_loss) for x in (mesh_loss, float(loss["loss_total"]))),
            f"L3-1 eval loss: mesh {mesh_loss}, its model.ep1 in one process {float(loss['loss_total'])}, "
            f"the one-rank run {one_loss}")
    print(f"  the (1, {VOCAB_RANKS}) L3-1 model.ep1 (gathered shares): {len(params)} parameters its starting weights "
          f"bit for bit, {len(stats)} BatchNorm statistics moved, read back onto the mesh exactly; loaded by a "
          f"one-process port model: eval loss {float(loss['loss_total'])}, the mesh's {mesh_loss}, the one-rank "
          f"run's {one_loss}")
    traced = require_traced(os.path.join(vp["prof"], "decode_dataset.pt.trace.json"), "the eval CLI's --profile",
                            {"K3": "topk_kernel", "K4": "fwd_f32"})
    print(f"  the eval CLI with --profile (beam 8 over phase 6's corpus): kernel events K3 {traced['K3']}, "
          f"K4 {traced['K4']}")
    dt = time.perf_counter() - vp["t0"]
    print(f"  phase 29's vocabulary-split runs: {dt:.1f} s from their start on {card}")
    counts = {"rnnt_joint_shard": shard_launches, **{f"ctc_head_{k}_v5000": n for k, n in v5000.items()}}
    return {**out, "eval_trace_kernels": traced, "seconds": dt, "l3_1_eval_loss": float(loss["loss_total"]),
            "launches": Launches({**_zero_launches(), **counts}, topk_shapes={})}


def time_rnnt_joint_shard(dev, gen, B: int, T: int, U1: int, J: int, V: int, dtype=torch.float32) -> dict:
    """K7's vocabulary-split launcher on rank 1's half (V / 2 columns from
    V / 2, the blank on the other rank) beside its plain version; the
    library route is the chunked route's forward on the same block."""
    from emoasr_tpu_torch.ops.rnnt import joint_parts_plain
    from emoasr_tpu_torch.ops.rnnt_joint import joint_parts_shard, rnnt_joint_plain

    h_enc, h_dec, weight, bias, labels = (x.to(dtype) if x.is_floating_point() else x
                                          for x in rnnt_joint_case(dev, gen, B, T, U1, J, V))
    per = V // VOCAB_RANKS
    w, b = weight[per:2 * per].t(), bias[per:2 * per]
    row = {}
    with torch.no_grad():
        for key, fn, iters in (("ms", lambda: joint_parts_shard(h_enc, h_dec, w, b, labels, 0, per), 10),
                               ("plain_ms", lambda: rnnt_joint_plain(h_enc, h_dec, w, b, labels, 0, per), 3),
                               ("library_ms", lambda: joint_parts_plain(h_enc, h_dec, w, b, labels - per, -per), 3)):
            row[key] = cuda_time_ms(fn, iters=iters, warmup=1)
    U, es = U1 - 1, h_enc.element_size()
    row.update(_bound(es * (B * T * J + B * U1 * J + J * per + per) + 4 * (B * U + 2 * B * T * U1 + B * T * U),
                      2.0 * B * T * U1 * J * per, dtype, 3 if dtype == torch.float32 else 0))
    row["shape"] = f"h_enc ({B},{T},{J}), h_dec ({B},{U1},{J}), w ({J},{per} of {V}), {dtype}"
    return {"rnnt_joint_shard" + ("" if dtype == torch.float32 else "_bf16"): row}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--n_utts", type=int, default=40, help="utterances of the decode corpus")
    args = ap.parse_args(argv)

    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 2
    from emoasr_tpu_torch.ops.cuda_lib import build_all
    from emoasr_tpu_torch.utils.device import set_matmul_precision

    # 1. device
    t_start = time.perf_counter()

    def phase(header: str) -> None:
        """Print a phase's header with the seconds the run has taken so far."""
        num, rest = header.split("]", 1)
        print(f"{num}] (at {time.perf_counter() - t_start:.0f} s){rest}")

    dev = torch.device("cuda", 0)
    card = torch.cuda.get_device_name(0)
    smi = nvidia_smi_line()
    phase(f"[1/30] device: {smi} (torch {torch.__version__}, CUDA {torch.version.cuda})")
    found = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    set_matmul_precision("float32")
    print(f"  TF32 found (matmul, cudnn) = {found}; the port's switch for float32 sets "
          f"({torch.backends.cuda.matmul.allow_tf32}, {torch.backends.cudnn.allow_tf32}), "
          f"and its entry points set it again themselves")

    # 2. build
    t0 = time.perf_counter()
    kernels = all_kernels()
    jobs = start_resource_builds(os.path.join(REPO, "build", "chip_smoke_resources"))
    floor = lattice_floor_kernel()
    build_all(kernels + [floor])
    resources = kernel_resources(jobs)
    phase(f"[2/30] built {', '.join(k.name for k in kernels)} from "
          f"{', '.join(sorted({k.source for k in kernels}))} in {time.perf_counter() - t0:.1f} s")
    print("  the kernels (nvcc -Xptxas -v, cuobjdump -sass): registers, spill stores / loads (bytes), "
          "static shared memory (bytes), HMMA + HGMMA instructions")
    for name, r in resources.items():
        print(f"    {r['source']} {name}: {r['registers']} registers, spills {r['spill_stores']} / {r['spill_loads']}, "
              f"smem {r['smem']}, {r['mma_instructions']} HMMA")

    # 3. kernels against their plain versions
    phase("[3/30] kernels against their plain versions on the card, forward and backward")
    gen = torch.Generator(device=dev)
    gen.manual_seed(args.seed)
    errs = {"topk": check_topk(dev, gen), **check_attention(dev, gen),
            "attention_bwd": check_attention_backward(dev, gen)}
    lat = check_ctc_lattice(dev, gen)
    errs.update(ctc_alpha=lat["ll"], ctc_beta_grad=lat["grad"])
    head = check_ctc_head(dev, gen)
    errs.update(ctc_head_fwd=head["fwd"], ctc_head_grad_e=head["grad_e"], ctc_head_grad_w=head["grad_w"])
    bias = check_attention_bias(dev, gen)
    errs.update(attention_bias_fwd=bias["fwd"], attention_bias_bwd=bias["bwd"], attention_bias_fwd_bf16=bias["fwd_bf16"])
    errs.update(check_decoder_step(dev, gen))
    errs.update(check_lm_step(dev, gen))
    check_beam_groups(dev, gen)
    errs.update(check_rnnt_joint(dev, gen))
    lstm = check_lstm(dev, gen)
    errs.update(lstm_fwd=lstm["fwd"], lstm_bwd=lstm["bwd"])
    lstm_rnnlm = check_lstm_cases(dev, gen, LSTM_RNNLM_CASES, "RNN LM")
    lstm_rnn_enc = check_lstm_cases(dev, gen, LSTM_RNN_ENCODER_CASES, "RNN encoder")
    attn_phone = check_attention_phone(dev, gen)
    print("  the bf16 parts (and K1 at H > 256): kernels against their plain versions")
    errs.update(check_ctc_head_bf16(dev, gen))
    errs.update(check_attention_backward_bf16(dev, gen))
    errs.update(check_rnnt_joint_bf16(dev, gen))
    errs.update(check_lstm_bf16(dev, gen))
    print("  the bf16 beam steps (K5 direct and indirect, K6) and the widths above J = 819 and H = 512")
    errs.update(check_decoder_step(dev, gen, torch.bfloat16))
    errs.update(check_lm_step(dev, gen, torch.bfloat16))
    check_beam_groups(dev, gen, torch.bfloat16)
    errs.update(check_rnnt_joint_wide(dev, gen))
    errs.update(check_rnnt_joint_edges(dev, gen))
    errs.update(check_lstm_wide(dev, gen))
    print("  the vocabulary split: K1 on a rank's half of L1's head, K7 with the column offset, K7 without it")
    errs.update(check_vocab_shards(dev, gen))

    scratch_root = os.path.join(REPO, "build", "chip_smoke")
    os.makedirs(scratch_root, exist_ok=True)
    root = tempfile.mkdtemp(dir=scratch_root)
    try:
        # 4. training at full width, then one micro-step against the CPU
        phase("[4/30] main path: L1 CTC(Transformer) training through the train CLI, 13 micro-steps, "
              "--profile over batches 8-12")
        tr = train_full_width(args, root, card, per_bucket=(3, 3, 2, 2, 3), profile=True)
        n_layers = tr["cfg"].enc_num_layers
        step_check = check_micro_step(tr, dev, {
            "ctc_head_fwd": 1, "ctc_head_grad_e": 1, "ctc_head_grad_w": 1, "ctc_alpha": 1, "ctc_beta_grad": 1,
            "attention_fwd": n_layers, "attention_bwd": n_layers})
        step_split = time_micro_step(tr, dev, card)

        # 5. learning on the card
        phase("[5/30] learning on the card: the small overfit corpus, train CLI then eval CLI")
        overfit = overfit_on_card(args, root)

        # 6. decode the trainer's checkpoint
        phase("[6/30] main path: decode of the trainer's model.ep1 through the eval CLI")
        mp = decode_path(args, tr, dev, card)

        # 7. the Conformer's attention with its bias, forward and backward
        phase("[7/30] main path: L2 CTC(Conformer) training, two micro-steps through the train CLI")
        l2 = train_conformer_steps(args, root, card)

        # 8. the slice's path: L3-1 joint-CTC beam decode
        phase("[8/30] main path: L3-1 Conformer + attention decoder, beam 10 with joint CTC, through the eval CLI")
        l3 = decode_l3_1(args, root, tr["test_tsv"], tr["wav_s"], dev, card)

        # 9. the slice's path: L3-3, the same with Transformer-LM shallow fusion
        phase("[9/30] main path: L3-3, L3-1 with Transformer-LM shallow fusion 0.5, through the eval CLI")
        l33 = decode_l3_3(args, root, tr, dev, card)

        # 10. the slice's path: L4 RNN-T(Conformer) training, then greedy and ALSD decoding
        phase("[10/30] main path: L4 RNN-T(Conformer) training through the train CLI, then its model.ep1 "
              "greedily and with the ALSD beam through the eval CLI")
        l4 = train_l4(args, root, card)
        n_layers = l4["cfg"].enc_num_layers
        l4_step = check_micro_step(l4, dev, {
            "rnnt_joint": 1, "lstm_fwd": 1, "lstm_bwd": 1, "attention_fwd": n_layers, "attention_bwd": n_layers,
            "attention_bias_fwd": n_layers, "attention_bias_bwd": n_layers})
        l4_split = time_l4_micro_step(l4, dev, card)
        l4_dec = decode_l4(args, l4, dev, card)
        require((torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32) == (False, False),
                "an entry point left TF32 on for a float32 model")

        # 11. the slice's path: L1 trained in bf16, then its model.ep1 greedily
        phase("[11/30] main path: L1 CTC(Transformer) training with compute_dtype bfloat16 through the train CLI, "
              "then its model.ep1 greedily through the eval CLI")
        l1b_root = os.path.join(root, "l1_bfloat16")
        os.makedirs(l1b_root)
        l1b = train_full_width(args, l1b_root, card, "bfloat16", per_bucket=(1, 1, 1, 1, 1))
        n_layers = l1b["cfg"].enc_num_layers
        l1b_step = check_bf16_micro_step(l1b, dev, {
            "ctc_head_fwd_bf16": 1, "ctc_head_grad_e_bf16": 1, "ctc_head_grad_w_bf16": 1, "ctc_alpha": 1,
            "ctc_beta_grad": 1, "attention_fwd_bf16": n_layers, "attention_bwd_bf16": n_layers, "ctc_head_fwd": 0,
            "attention_fwd": 0, "attention_bwd": 0})
        l1b_split = time_micro_step(l1b, dev, card)
        l1b_dec = decode_greedy_bf16(l1b, card, ("attention_fwd_bf16",))

        # 12. the slice's path: L4 trained in bf16, then its model.ep1 greedily
        phase("[12/30] main path: L4 RNN-T(Conformer) training with compute_dtype bfloat16 through the train CLI, "
              "then its model.ep1 greedily through the eval CLI")
        l4b = train_l4(args, root, card, "bfloat16", per_bucket=(1, 1, 1, 1, 1))
        n_layers = l4b["cfg"].enc_num_layers
        l4b_step = check_bf16_micro_step(l4b, dev, {
            "rnnt_joint_bf16": 1, "lstm_fwd_bf16": 1, "lstm_bwd_bf16": 1, "attention_fwd_bf16": n_layers,
            "attention_bwd_bf16": n_layers, "attention_bias_fwd_bf16": n_layers, "attention_bias_bwd_bf16": n_layers,
            "rnnt_joint": 0, "lstm_fwd": 0, "lstm_bwd": 0, "attention_fwd": 0, "attention_bwd": 0})
        l4b_split = time_l4_micro_step(l4b, dev, card)
        l4b_dec = decode_greedy_bf16(l4b, card, ("attention_fwd_bf16", "attention_bias_fwd_bf16"))

        # 13. the slice's path: bf16 beam decoding of L1, L3-1, L3-3 and L4
        phase("[13/30] main path: bf16 beam decoding at full width: L1 beam 8, L3-1 (K5 bf16, both variants), "
              "L3-3 with the LM in bf16 (K6 bf16 and the dense route), L4 ALSD beam 10")
        b16 = decode_bf16(args, root, tr, mp, l3, l33, {**l4, "batches": l4_dec["batches"]}, dev, card)

        # 14. slice 3c: L3-1 training, its micro-step against the CPU, its model.ep1 decoded; then in bf16
        phase("[14/30] main path: L3-1 (Conformer + attention decoder, aux CTC 0.3, label smoothing 0.1) training "
              "through the train CLI, then its model.ep1 through the eval CLI (beam 10, joint CTC 0.3); two bf16 "
              "micro-steps")
        n_l3_test = 20
        l3_test, l3_wav = write_corpus(root, "test_l3_train", [200 + (1400 * i) // (n_l3_test - 1)
                                                                for i in range(n_l3_test)], 10000, 80, args.seed + 7)
        l3t = train_l3_1(args, root, card, l3_test, l3_wav)
        n_layers = l3t["cfg"].enc_num_layers
        l3t_step = check_micro_step(l3t, dev, {
            "ctc_head_fwd": 1, "ctc_head_grad_e": 1, "ctc_head_grad_w": 1, "ctc_alpha": 1, "ctc_beta_grad": 1,
            "attention_fwd": n_layers, "attention_bwd": n_layers, "attention_bias_fwd": n_layers,
            "attention_bias_bwd": n_layers}, heads=l3_1_heads(l3t["cfg"]))
        l3t_split = time_micro_step(l3t, dev, card)
        l3t_update = check_l3_1_update(l3t, dev)
        l3t_dec = decode_trained_l3_1(l3t, card)
        l3b = train_l3_1(args, root, card, l3_test, l3_wav, "bfloat16", per_bucket=(0, 1, 0, 0, 1))
        l3b_step = check_bf16_micro_step(l3b, dev, {
            "ctc_head_fwd_bf16": 1, "ctc_head_grad_e_bf16": 1, "ctc_head_grad_w_bf16": 1, "ctc_alpha": 1,
            "ctc_beta_grad": 1, "attention_fwd_bf16": n_layers, "attention_bwd_bf16": n_layers,
            "attention_bias_fwd_bf16": n_layers, "attention_bias_bwd_bf16": n_layers, "ctc_head_fwd": 0,
            "attention_fwd": 0, "attention_bwd": 0})

        # 15. slice 6a: the three LMs trained through train_lm; one RNN LM step against the CPU
        phase("[15/30] main path: the RNN (K8), Transformer and BERT LMs trained through train_lm over a sharded "
              "corpus that fills every bucket")
        lms = train_lms(args, root, card)
        rnn_step = {**check_rnn_lm_step(lms["rnn"], dev), **time_rnn_lm_step(lms["rnn"], dev, card)}

        # 16. slice 6a: PPL and BERT's pseudo-PPL through the PPL CLI, against the CPU
        phase("[16/30] main path: PPL of the three checkpoints through the PPL CLI (BERT: chunked pseudo-PPL at the "
              "(11, 256) bucket), against the CPU")
        ppl = lm_ppl(lms, dev, card)

        # 17. slice 6a: RNN-LM shallow fusion in the three beams
        phase("[17/30] main path: RNN-LM shallow fusion 0.5 into the L1 CTC beam and the L3-1 attention beam "
              "through the eval CLI, and into the L4 ALSD beam in Python")
        fusion = rnn_lm_fusion(args, lms["rnn"], tr, l3t, l4, dev, card)

        # 18. slice 6b: ELECTRA and electra-disc through train_lm; one step each against the CPU
        phase("[18/30] main path: ELECTRA (ted2_electra.yaml, 12 + 12 x 256, V 9798) and electra-disc trained "
              "through train_lm; one step each against the CPU on the same generated ids")
        electra = train_electra(args, root, card, dev)

        # 19. slice 6b: P-ELECTRA, the deletable PC-MLM and pctc (K4 in the phone encoder, K1 and K2)
        phase("[19/30] main path: P-ELECTRA (ted2_pelectra.yaml) and the deletable PC-MLM (del_pc_mlm.yaml) "
              "trained through train_lm with the fused phone-encoder attention (K4 with dropout); one step each "
              "against the CPU; the PC-MLM's pseudo-PPL through the PPL CLI; one pctc step (K1, K2)")
        p2w = train_p2w(args, root, card, dev)

        # 20. slice 7a: error correction with the PC-MLM
        phase("[20/30] main path: asr_hie_phone.yaml trained through the train CLI (K1, K2, K4), its phone "
              "hypotheses through test_asr --decode_phone, and correction with the PC-MLM through the correction "
              "CLI, against the CPU")
        corr = correction(args, root, p2w["pbert"], dev, card)

        # 21. slice 7a: N-best rescoring of the L1 beam's n-best
        phase("[21/30] main path: the L1 beam-8 n-best through the rescoring CLI with the Transformer, BERT and "
              "ELECTRA LMs, score_lm against the CPU")
        resc = rescoring(args, root, tr, lms, dev, card)

        # 22. slice 7b: soft labels from the LMs through make_label (K3)
        phase("[22/30] main path: soft labels from the trained libri Transformer LM and BERT through make_label "
              "(K3 once a chunk), each held to the CPU's; the V = 1000 LM's for L4")
        soft = soft_label_phase(args, root, lms, dev, card)

        # 23. slice 7b: the distillation routes of L1, L3 and L4
        phase("[23/30] main path: distillation micro-steps through the train step: L1 alignment KD (K2, K4), L3 "
              "soft labels (K1, K2, K4 with its bias), L4 word and align KD over the full joint (K8, K4); one "
              "micro-step of each against the CPU")
        kd = kd_phase(args, root, tr, l4, soft, dev, card)

        # 24. slice 7b: RNN-T forced alignment
        phase("[24/30] main path: RNN-T forced alignment of the L4 model.ep1 through ASR.forced_align (K4, K8), "
              "card against CPU")
        fa = forced_align_phase(l4, dev, card)

        # 25. slice 7b: the analysis tools
        phase("[25/30] main path: analysis ctc_prob (K4), the fusion grid on L1's CTC beam with the Transformer "
              "LM (K3, K4) and align_hyps on the n-best")
        ana = analysis_phase(root, tr, lms, overfit, args.seed, card)

        # 26. slice 5: LAS(Transformer)
        phase("[26/30] main path: LAS(Transformer) at the benchmarked widths: two micro-steps through the train CLI "
              "(K4 with dropout) and one against the CPU; the same widths overfitted on phase 5's labels, then "
              "greedy, beam 4 (K3) and beam 4 with the libri Transformer LM at 0.5 (K6) through the eval CLI")
        las = las_phase(args, root, lms, overfit, dev, card)

        # 27. slice 5: CTC(RNN)
        phase("[27/30] main path: CTC(RNN), L1 with 12 biLSTM layers: two micro-steps through the train CLI (K8 at "
              "(18, 399, 256), K1, K2) and one against the CPU; greedy and CTC beam 8 through the eval CLI")
        ctc_rnn = ctc_rnn_phase(args, root, tr, dev, card)

        # 28. slice 8a: the front end, the prep CLI and the native paths
        phase("[28/30] main path: 40 wavs through the prep CLI (fbank on the card), the manifest through the eval CLI; "
              "the native WER and loader against their Python paths")
        front = frontend_phase(args, root, overfit, card)

        # 29. slice 8b: data and tensor parallelism
        phase("[29/30] main path: data and tensor parallelism: torchrun (NCCL, a world of one) of the train CLI, "
              "and the train CLI on (2,) and (1, 2) over gloo on the one card, the eval CLI's --dp on two ranks; "
              "the vocabulary split: L3-1, L4, the RNN LM and BERT on (1, 2) against one rank; the eval CLI's "
              "--profile")
        t29 = time.perf_counter()
        torch.cuda.empty_cache()  # the phase's processes share the card: return this process's cached blocks
        par = parallel_phase(args, root, tr, dev, card)
        vocab = vocab_phase_finish(vocab_phase_start(args, root, tr, l3t, l4, lms), dev, card)
        print(f"  phase 29 with the vocabulary-split runs: {time.perf_counter() - t29:.1f} s on {card}")
    finally:
        shutil.rmtree(root, ignore_errors=True)
    set_matmul_precision("float32")  # the bf16 entry points turned TF32 on for their float32 remainder

    # 14. timings at the largest bucket, then the result lines
    big = mp["bucket"]
    B, T2 = big.batch_size, ((big.max_xlen - 1) // 2 - 1) // 2
    lens = torch.linspace(T2 // 4, T2, B, device=dev).round().int()
    # K3 at the attention beam's pre-selection (B, W, V) with k = 1.5 W, and
    # beside it at the CTC beam's (B, V) with k = 8
    topk_shapes = [{**time_topk(dev, gen, shape, k, dt), "class": [shape[-1], k, str(dt).replace("torch.", "")]}
                   for shape, k in TOPK_SHAPES for dt in (torch.float32, torch.bfloat16)]
    # K3 at make_label's class: (N, V) logits, N a chunk's labelled positions (the largest chunk of phase 22)
    ml_launches = {10000: sum(soft[t]["launches"]["topk"] for t in ("transformer", "bert")),
                   1000: soft["v1000"]["launches"]["topk"]}
    make_label_k3 = [{**time_topk(dev, gen, (soft[t]["max_n"], soft[t]["V"]), KD_TOPK),
                      "class": [soft[t]["V"], KD_TOPK, "float32"], "launches": ml_launches[soft[t]["V"]]}
                     for t in ("transformer", "v1000")]
    times = {"topk": {**topk_shapes[0], "shapes": topk_shapes},
             "attention_fwd": time_attention(dev, gen, B, T2, 4, 64, lens),
             "attention_bwd": time_attention_backward(dev, gen, B, T2, 4, 64, lens)}
    times.update(time_ctc_head(dev, gen, B, T2, 256, 10000, big.max_ylen))
    times.update(time_ctc_lattice(dev, gen, B, T2, big.max_ylen, 10000, floor))
    wide_lattice = time_ctc_lattice(dev, gen, B, 1100, 512, 10000, floor)  # S = 1025: 17 warps of two states
    times.update(time_attention_bias(dev, gen, B, T2, 4, 64, lens))
    times.update(time_decoder_step(dev, gen, B, 10, 258, T2, 64, lens))
    times.update(time_lm_step(dev, gen, B, 10, 256, 64))
    l4_big = max(l4["buckets"], key=lambda b: b.max_xlen)
    l4_T = ((l4_big.max_xlen - 1) // 2 - 1) // 2
    times.update(time_rnnt_joint(dev, gen, l4_big.batch_size, l4_T, l4_big.max_ylen + 1, 512, 1000))
    times.update(time_lstm(dev, gen, l4_big.batch_size, l4_big.max_ylen + 1, 512, 128))
    bf = torch.bfloat16
    times.update(time_ctc_head(dev, gen, B, T2, 256, 10000, big.max_ylen, bf))
    times["attention_fwd_bf16"] = time_attention(dev, gen, B, T2, 4, 64, lens, bf)
    times["attention_bwd_bf16"] = time_attention_backward(dev, gen, B, T2, 4, 64, lens, bf)
    times.update(time_attention_bias(dev, gen, B, T2, 4, 64, lens, bf))
    times.update(time_rnnt_joint(dev, gen, l4_big.batch_size, l4_T, l4_big.max_ylen + 1, 512, 1000, bf))
    times.update(time_lstm(dev, gen, l4_big.batch_size, l4_big.max_ylen + 1, 512, 128, bf))
    times.update(time_decoder_step(dev, gen, B, 10, 258, T2, 64, lens, bf))
    times.update(time_lm_step(dev, gen, B, 10, 256, 64, bf))
    for dt, sfx in ((torch.float32, ""), (bf, "_bf16")):  # the widths above what the kernels took before
        r = time_rnnt_joint(dev, gen, l4_big.batch_size, l4_T, l4_big.max_ylen + 1, 1024, 1000, dt)
        times["rnnt_joint_j1024" + sfx] = r["rnnt_joint" + sfx]
        r = time_lstm(dev, gen, l4_big.batch_size, l4_big.max_ylen + 1, 1024, 128, dt)
        times["lstm_fwd_h1024" + sfx], times["lstm_bwd_h1024" + sfx] = r["lstm_fwd" + sfx], r["lstm_bwd" + sfx]
        # CSJ's vocabulary (c5, c6: V = 4000, J = 512, the same largest bucket as L4's)
        r = time_rnnt_joint(dev, gen, l4_big.batch_size, l4_T, l4_big.max_ylen + 1, 512, 4000, dt)
        times["rnnt_joint_v4000" + sfx] = r["rnnt_joint" + sfx]
        # K5 and K6 at W = 33, the L3 shapes otherwise (the errors: their checks' W > 16 cases)
        r = time_decoder_step(dev, gen, B, 33, 258, T2, 64, lens, dt)
        times["decoder_step_w33" + sfx] = r["decoder_step" + sfx]
        times["decoder_step_indirect_w33" + sfx] = r["decoder_step_indirect" + sfx]
        times["lm_step_indirect_w33" + sfx] = time_lm_step(dev, gen, B, 33, 256, 64, dt)["lm_step_indirect" + sfx]
        for k in ("decoder_step", "decoder_step_indirect", "lm_step_indirect"):
            errs[f"{k}_w33{sfx}"] = errs[f"{k}_wide{sfx}"]
    # the vocabulary split: K7's launcher with the column offset on a rank's 500 of L4's 1000 columns
    # (beside the whole-V K7 row and the chunked route on the same block), K1 at V = 5000
    times.update(time_rnnt_joint_shard(dev, gen, l4_big.batch_size, l4_T, l4_big.max_ylen + 1, 512, 1000))
    times.update(time_rnnt_joint_shard(dev, gen, l4_big.batch_size, l4_T, l4_big.max_ylen + 1, 512, 1000, bf))
    for k, r in time_ctc_head(dev, gen, B, T2, 256, 5000, big.max_ylen).items():
        times[f"{k}_v5000"] = r
    rnnlm_k8 = {}
    for (B_, T_, H_), _ in LSTM_RNNLM_CASES:  # the RNN LM's buckets, cuDNN's nn.LSTM(512, 512) beside
        r = time_lstm(dev, gen, B_, T_, H_, 512)
        for kind in ("fwd", "bwd"):
            rnnlm_k8.setdefault(kind, []).append({
                **r[f"lstm_{kind}"], "launches": lms["rnn"]["k8_by_shape"].get(f"{kind}/{B_}/{T_}/{H_}/f32", 0),
                "max_abs_err": lstm_rnnlm[kind]})
    times["lstm_fwd"]["rnnlm_shapes"], times["lstm_bwd"]["rnnlm_shapes"] = rnnlm_k8["fwd"], rnnlm_k8["bwd"]
    # K8 at the RNN encoder's largest bucket, cuDNN's one-direction nn.LSTM(256, 256) beside (K8 runs one
    # direction a launch); launches: phase 27's, training and decodes
    (B_, T_, H_), _ = LSTM_RNN_ENCODER_CASES[0]
    r = time_lstm(dev, gen, B_, T_, H_, H_)
    k8_rnn = {k: ctc_rnn["train"]["k8_shapes"].get(k, 0) + ctc_rnn["k8_decode"].get(k, 0)
              for k in set(ctc_rnn["train"]["k8_shapes"]) | set(ctc_rnn["k8_decode"])}
    for kind in ("fwd", "bwd"):
        times[f"lstm_{kind}"]["rnn_encoder_shapes"] = [{
            **r[f"lstm_{kind}"], "launches": k8_rnn.get((kind, B_, T_, H_, "f32"), 0),
            "max_abs_err": lstm_rnn_enc[kind]}]
    # K4 at the phone encoder's largest bucket (P-ELECTRA, PC-MLM, pctc; phone lengths of half to all of the
    # bucket), SDPA beside; launches: the P2W steps' and the PC-MLM pseudo-PPL's
    pB, pT, pH, pD = PHONE_BUCKET
    plens = torch.linspace(pT // 2, pT, pB, device=dev).round().int()
    p2w_paths = [p2w[t]["launches"] for t in ("pelectra", "pbert", "pctc")] + [p2w["pbert"]["ppl"]["launches"]]
    for dt, sfx in ((torch.float32, ""), (bf, "_bf16")):
        fwd, bwd = time_attention(dev, gen, pB, pT, pH, pD, plens, dt), time_attention_backward(dev, gen, pB, pT, pH,
                                                                                                 pD, plens, dt)
        for kind, r in (("fwd", fwd), ("bwd", bwd)):
            r.update(launches=sum(p[f"attention_{kind}{sfx}"] for p in p2w_paths),
                     max_abs_err=attn_phone[f"{kind}{sfx}"])
            times[f"attention_{kind}{sfx}"]["phone_shapes"] = [r]
            print(f"    attention_{kind}{sfx} (the phone encoder) {r['shape']}: {r['ms']:.4f} ms (bound "
                  f"{r['bound_ms']:.4f} by {r['bound_by']}, plain {r['plain_ms']:.4f}, SDPA {r['library_ms']:.4f}), "
                  f"{r['launches']} launches in the P2W steps and the pseudo-PPL")
    phase(f"[30/30] kernels timed at the largest bucket (B = {B}, T' = {T2}, S = {2 * big.max_ylen + 1}; "
          f"decoder step W = 10, pos = 64; L4: B = {l4_big.batch_size}, T' = {l4_T}, U+1 = {l4_big.max_ylen + 1}) "
          f"on {smi}")

    paths = [tr["launches"], l2["launches"], l4["launches"], l1b["launches"], l4b["launches"],
             l1b_dec["launches"], l4b_dec["launches"]] + [
        r["launches"] for r in (*mp["runs"].values(), *l3["runs"].values(), *l33["runs"].values(),
                                *l4_dec["runs"].values(), *b16["runs"].values(),
                                *lms.values(), *ppl.values(), *fusion.values())] + [
        l3t["launches"], l3b["launches"], l3t_dec["launches"],
        *(v["launches"] for v in electra.values()), *(p2w[t]["launches"] for t in ("pelectra", "pbert", "pctc")),
        p2w["pbert"]["ppl"]["launches"], corr["launches"], corr["decode_launches"], corr["correct_launches"],
        *(soft[t]["launches"] for t in ("transformer", "bert", "v1000")), *(kd[k]["launches"] for k in ("l1", "l3", "l4")),
        fa["launches"], ana["ctc_prob_launches"], ana["launches"], ana["overfit_launches"],
        las["train"]["launches"], las["overfit_launches"], *(r["launches"] for r in las["runs"].values()),
        ctc_rnn["train"]["launches"], *(r["launches"] for r in ctc_rnn["runs"].values()), front["launches"],
        par["launches"], vocab["launches"]]
    ms = lambda x: "none" if x is None else f"{x:.4f}"

    def row_of(name, src, rep, launches):
        t = times[name]
        extra = f", the dense route {t['dense_route_ms']:.4f}" if "dense_route_ms" in t else ""
        if "dropout_ms" in t:
            extra += (f"; with dropout {DROPOUT_RATE} {t['dropout_ms']:.4f} (plain {t['plain_dropout_ms']:.4f}, "
                      f"library {t['library_dropout_ms']:.4f})")
        at = f" at the {t['ops_at']}" if t["bound_by"] == "operations" and "ops_at" in t else ""
        print(f"  {name}: {t['ms']:.4f} ms (bound {t['bound_ms']:.4f} by {t['bound_by']}{at}, plain "
              f"{t['plain_ms']:.4f}, library {ms(t['library_ms'])}{extra}), {launches} launches")
        return {
            "name": name, "route": "cuda", "source": src, "replaces": rep, "launches": launches,
            "max_abs_err": errs[name], "ms": t["ms"], "plain_ms": t["plain_ms"],
            "bound_ms": t["bound_ms"], "bound_by": t["bound_by"], "library_ms": t["library_ms"],
            "shape": t["shape"],
            **{k: t[k] for k in ("ops_at", "dense_route_ms", "shapes", "floor_ms", "s1025", "dropout_ms",
                                 "plain_dropout_ms", "library_dropout_ms", "rnnlm_shapes", "phone_shapes",
                                 "rnn_encoder_shapes") if k in t},
        }

    # K3 by shape class over the main paths (a call is one launch of one grid)
    by_class = {}
    for p in paths:
        for cls, n in getattr(p, "topk_shapes", {}).items():
            by_class[cls] = by_class.get(cls, 0) + n
    require(sum(by_class.values()) == sum(p["topk"] for p in paths),
            "K3's launches by shape class do not add up to its launches")
    print("  K3 launches on the main paths by shape class (V, k, dtype): " +
          ", ".join(f"{cls}: {n}" for cls, n in sorted(by_class.items(), key=lambda kv: -kv[1])))
    for r in topk_shapes:  # make_label's launches have their own row
        r["launches"] = by_class.get(tuple(r["class"]), 0) - sum(
            m["launches"] for m in make_label_k3 if m["class"] == r["class"])
        print(f"    top-k {r['shape']}: {r['ms']:.4f} ms (bound {r['bound_ms']:.4f} by {r['bound_by']}, plain "
              f"{r['plain_ms']:.4f}, torch.topk {r['library_ms']:.4f}), {r['launches']} launches of its class")
    for kind in ("fwd", "bwd"):
        for r in rnnlm_k8[kind]:
            print(f"    lstm_{kind} (RNN LM) {r['shape']}: {r['ms']:.4f} ms (bound {r['bound_ms']:.4f} by "
                  f"{r['bound_by']}, plain {r['plain_ms']:.4f}, cuDNN nn.LSTM {r['library_ms']:.4f}), "
                  f"{r['launches']} launches in the RNN LM's training")
        for r in times[f"lstm_{kind}"]["rnn_encoder_shapes"]:
            require(r["launches"] > 0, f"K8 {kind} at the RNN encoder's largest bucket was launched no time")
            print(f"    lstm_{kind} (RNN encoder) {r['shape']}: {r['ms']:.4f} ms (bound {r['bound_ms']:.4f} by "
                  f"{r['bound_by']}, plain {r['plain_ms']:.4f}, cuDNN nn.LSTM(256, 256) {r['library_ms']:.4f}), "
                  f"{r['launches']} launches in phase 27")
    for name in ("ctc_alpha", "ctc_beta_grad"):
        times[name]["s1025"] = wide_lattice[name]
        for t in (times[name], wide_lattice[name]):
            print(f"    {name} {t['shape']}: {t['ms']:.4f} ms, chain_only floor {t['floor_ms']:.4f} ms "
                  f"({t['ms'] / t['floor_ms']:.2f}x), bound {t['bound_ms']:.4f} by {t['bound_by']}")
    rows = []
    for name, src, rep in KERNEL_ROWS:
        launches = sum(p[name] for p in paths)
        require(launches > 0, f"kernel {name} was launched no time on the main paths")
        rows.append(row_of(name, src, rep, launches))
    # K3 at make_label's class (phase 22), its own row; the V = 1000 labels beside it
    for r in make_label_k3:
        require(r["launches"] > 0, f"K3 at make_label's class {r['class']} was launched no time")
        print(f"  topk_make_label {r['shape']}: {r['ms']:.4f} ms (bound {r['bound_ms']:.4f} by {r['bound_by']}, "
              f"plain {r['plain_ms']:.4f}, torch.topk {r['library_ms']:.4f}), {r['launches']} launches in make_label")
    ml = make_label_k3[0]
    rows.append({"name": "topk_make_label", "route": "cuda", "source": "emoasr_tpu_torch/csrc/topk.cu",
                 "replaces": "emoasr_tpu/ops/topk_pallas.py:64", "launches": ml["launches"], "max_abs_err": 0.0,
                 **{k: ml[k] for k in ("ms", "plain_ms", "bound_ms", "bound_by", "library_ms", "shape")},
                 "shapes": make_label_k3})
    print("  the same launchers at shapes no main path runs (J = 1024, H = 1024, CSJ's V = 4000, W = 33):")
    wide = [row_of(name, src, rep, 0) for name, src, rep in WIDE_ROWS]
    print(json.dumps({
        "train": {k: tr[k] for k in ("micro_steps", "seconds", "epoch_seconds", "micro_steps_per_s",
                                     "utt_per_s", "launches", "losses", "trace_kernels")},
        "micro_step": {**step_split, **step_check}, "overfit": {k: overfit[k] for k in ("wer", "seconds")},
        "decode": {
            f"beam{b}": {k: r[k] for k in ("seconds", "utt_per_s", "rtf", "launches")}
            for b, r in mp["runs"].items()
        },
        "n_utts": args.n_utts, "batches": mp["batches"], "one_batch": mp["split"],
        "encoder_max_abs_err": mp["enc_err"], "same_beam_hyps": mp["same_hyps"],
        "l2_conformer_train": l2,
        "l3_1_decode": {**l3["runs"], "one_batch": l3["split"], "encoder_max_abs_err": l3["enc_err"],
                        "decoder_step_logits_max_abs_err": l3["step_err"], "same_top1_hyps_card_vs_cpu": l3["same_hyps"],
                        "beam17_decoder_step_logits_max_abs_err": l3["step_err_beam17"],
                        "beam17_same_top1_hyps_card_vs_cpu": l3["same_hyps_beam17"],
                        "same_hyps_fused_vs_fused_indirect": l3["same_modes"]},
        "l3_3_decode": {**l33["runs"], "repeat": l33["repeat"], "one_batch": l33["split"], "fused_scores_max_abs_err": l33["fused_scores_err"],
                        "same_top1_hyps_card_vs_cpu": l33["same_hyps"], "same_hyps_k6_vs_dense": l33["same_routes"],
                        "ctc_beam_lm": l33["ctc_beam_lm"]},
        "l4_train": {k: l4[k] for k in ("micro_steps", "seconds", "epoch_seconds", "micro_steps_per_s",
                                        "utt_per_s", "launches", "losses")},
        "l4_micro_step": {**l4_split, **l4_step},
        "l4_decode": {**l4_dec["runs"], "n_utts": l4_dec["n_utts"], "batches": l4_dec["batches"]},
        "l1_bf16_train": {k: l1b[k] for k in ("micro_steps", "seconds", "epoch_seconds", "micro_steps_per_s",
                                              "utt_per_s", "launches", "losses")},
        "l1_bf16_micro_step": {**l1b_split, **l1b_step},
        "l1_bf16_greedy_decode": l1b_dec,
        "l4_bf16_train": {k: l4b[k] for k in ("micro_steps", "seconds", "epoch_seconds", "micro_steps_per_s",
                                              "utt_per_s", "launches", "losses")},
        "l4_bf16_micro_step": {**l4b_split, **l4b_step},
        "l4_bf16_greedy_decode": l4b_dec,
        "bf16_beam_decode": b16,
        "l3_1_train": {k: l3t[k] for k in ("micro_steps", "seconds", "epoch_seconds", "micro_steps_per_s",
                                           "utt_per_s", "launches", "losses", "per_step_launches")},
        "l3_1_micro_step": {**l3t_split, **l3t_step}, "l3_1_update": l3t_update, "l3_1_trained_decode": l3t_dec,
        "l3_1_bf16_train": {k: l3b[k] for k in ("micro_steps", "seconds", "launches", "losses", "per_step_launches")},
        "l3_1_bf16_micro_step": l3b_step,
        "lm_train": {t: {k: v[k] for k in ("seconds", "steps", "losses", "launches", "k8_by_shape")}
                     for t, v in lms.items()},
        "rnn_lm_step": rnn_step, "lm_ppl": ppl, "rnn_lm_fusion": fusion,
        "electra_train": {t: {k: v[k] for k in ("seconds", "steps", "losses", "launches", "step_check")}
                          for t, v in electra.items()},
        "p2w_train": {t: {k: v[k] for k in ("seconds", "steps", "losses", "launches", "step_check", "ppl") if k in v}
                      for t, v in p2w.items()},
        "correction": {k: corr[k] for k in ("train_seconds", "losses", "decode_phone", "correct")},
        "rescoring": resc,
        "soft_labels": {t: {k: v for k, v in soft[t].items() if k != "launches"} for t in ("transformer", "bert", "v1000")},
        "distillation": {k: {key: v for key, v in kd[k].items() if key != "launches"} for k in ("l1", "l3", "l4")},
        "forced_align": {k: v for k, v in fa.items() if k != "launches"},
        "analysis": {k: v for k, v in ana.items() if not k.endswith("launches")},
        "las": {"train": {k: las["train"][k] for k in ("seconds", "losses", "launches")},
                "micro_step": {**las["step_split"], **las["step_check"]}, "overfit_seconds": las["overfit_seconds"],
                "overfit_losses": las["overfit_losses"], "greedy_wer": las["greedy_wer"],
                "runs": las["runs"], "same_top1_card_vs_cpu": las["same_top1_card_vs_cpu"], "seconds": las["seconds"]},
        "ctc_rnn": {"train": {k: ctc_rnn["train"][k] for k in ("seconds", "losses", "launches")},
                    "k8_by_shape": {"/".join(map(str, k)): n for k, n in k8_rnn.items()},
                    "micro_step": {**ctc_rnn["step_split"], **ctc_rnn["step_check"]}, "runs": ctc_rnn["runs"],
                    "same_top1_card_vs_cpu": ctc_rnn["same_top1_card_vs_cpu"], "seconds": ctc_rnn["seconds"]},
        "frontend": {k: v for k, v in front.items() if k != "launches"},
        "parallel": {k: v for k, v in par.items() if k != "launches"},
        "vocab_parallel": {k: v for k, v in vocab.items() if k != "launches"},
        "wide_widths": wide,
        "kernel_resources": resources,
        "card": smi, "total_seconds": time.perf_counter() - t_start,
    }))
    print(json.dumps({"kernels": rows}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": card, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
