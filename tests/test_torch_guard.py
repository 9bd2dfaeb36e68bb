"""Guards of the port's boundaries.

- Importing every module of `emoasr_tpu_torch`, and `chip_smoke`, loads no
  JAX and nothing of the JAX package (checked in a fresh interpreter).
- The entry points run on the GPU unless asked for the CPU, and raise where
  there is no GPU instead of falling back.
- CPU tensors take the kernels' plain versions; the launch counters stay 0.

The PyTorch thread count of an xdist run is set in `test_torch_threads.py`.
"""

import json
import os
import shutil
import subprocess
import sys

import numpy as np
import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_IMPORT_ALL = r"""
import importlib, json, pkgutil, sys
import emoasr_tpu_torch
names = [m.name for m in pkgutil.walk_packages(emoasr_tpu_torch.__path__, "emoasr_tpu_torch.")]
for n in names:
    importlib.import_module(n)
import chip_smoke
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "jaxlib", "flax", "optax", "orbax", "emoasr_tpu"))
print(json.dumps({"modules": names, "bad": bad}))
"""


def _env():
    env = dict(os.environ)
    env["PYTHONPATH"] = REPO
    return env


def test_imports_no_jax_and_nothing_of_the_jax_package():
    out = subprocess.run(
        [sys.executable, "-c", _IMPORT_ALL], cwd=REPO, env=_env(),
        capture_output=True, text=True, timeout=300,
    )
    assert out.returncode == 0, out.stderr
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert res["bad"] == []
    for mod in ("emoasr_tpu_torch.eval.test_asr", "emoasr_tpu_torch.ops.topk",
                "emoasr_tpu_torch.ops.attention", "emoasr_tpu_torch.search.ctc_beam",
                "emoasr_tpu_torch.ops.ctc", "emoasr_tpu_torch.ops.ctc_head",
                "emoasr_tpu_torch.ops.ctc_lattice", "emoasr_tpu_torch.ops.specaug",
                "emoasr_tpu_torch.train.loop", "emoasr_tpu_torch.train.optim",
                "emoasr_tpu_torch.train.step", "emoasr_tpu_torch.train.checkpoint",
                "emoasr_tpu_torch.ops.decoder_step", "emoasr_tpu_torch.models.decoders.transformer",
                "emoasr_tpu_torch.search.ctc_prefix_score", "emoasr_tpu_torch.search.attention_beam",
                "emoasr_tpu_torch.eval.decode", "emoasr_tpu_torch.utils.flax_import",
                "emoasr_tpu_torch.ops.lm_step", "emoasr_tpu_torch.models.lm.bert",
                "emoasr_tpu_torch.models.lm.lm", "emoasr_tpu_torch.ops.lstm", "emoasr_tpu_torch.ops.lstm_scan",
                "emoasr_tpu_torch.ops.rnnt", "emoasr_tpu_torch.ops.rnnt_joint",
                "emoasr_tpu_torch.models.decoders.rnnt", "emoasr_tpu_torch.search.rnnt_beam",
                "emoasr_tpu_torch.eval.rescore", "emoasr_tpu_torch.eval.correct",
                "emoasr_tpu_torch.data.lm_dataset", "emoasr_tpu_torch.eval.test_ppl",
                "emoasr_tpu_torch.train.train_lm", "emoasr_tpu_torch.frontend.fbank",
                "emoasr_tpu_torch.corpora.prep", "emoasr_tpu_torch.native",
                "emoasr_tpu_torch.models.decoders.las", "emoasr_tpu_torch.search.las_beam"):
        assert mod in res["modules"]


def test_port_sources_name_no_jax_import():
    """No source line of the port imports jax or the JAX package."""
    roots = [os.path.join(REPO, "emoasr_tpu_torch"), os.path.join(REPO, "chip_smoke.py")]
    offenders = []
    for root in roots:
        files = [root] if root.endswith(".py") else [
            os.path.join(d, f) for d, _, fs in os.walk(root) for f in fs if f.endswith(".py")
        ]
        for path in files:
            with open(path) as f:
                for n, line in enumerate(f, 1):
                    s = line.strip()
                    if s.startswith(("import ", "from ")) and (
                        s.split()[1].split(".")[0] in ("jax", "jaxlib", "flax", "optax", "orbax", "emoasr_tpu")
                    ):
                        offenders.append(f"{path}:{n}: {s}")
    assert offenders == []


def test_distillation_and_analysis_entry_points_raise_without_cuda(tmp_path):
    """`make_label make`, `analysis ctc_prob` and the fusion grid run on the
    GPU unless `--cpu` is given, and raise where there is none."""
    if torch.cuda.is_available():
        pytest.skip("a GPU is present")
    from emoasr_tpu_torch.eval import analysis, fusion_grid, make_label

    conf, lm = tmp_path / "exp.yaml", tmp_path / "lm.yaml"
    conf.write_text("feat_dim: 20\n")
    lm.write_text("lm_type: transformer\n")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        make_label.cli(["make", "-lm_conf", str(lm), "-lm_ep", "1", "-data", str(tmp_path / "rows.tsv"),
                        "-save_path", str(tmp_path / "soft.pkl")])
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        analysis.main(["ctc_prob", "-conf", str(conf), "-ep", "1", "-utt_id", "u0"])
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        fusion_grid.main(fusion_grid.parse_args(["-conf", str(conf), "-ep", "1", "--lm_max", "0"]))


def test_entry_points_raise_without_cuda(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a GPU is present")
    from emoasr_tpu_torch.config import config_from_dict
    from emoasr_tpu_torch.eval import test_asr, test_ppl
    from emoasr_tpu_torch.eval.decode import build_decode_fn
    from emoasr_tpu_torch.models.asr import ASR
    from emoasr_tpu_torch.train import loop, train_lm
    from emoasr_tpu_torch.utils.device import resolve_device

    cfg = config_from_dict(dict(
        feat_dim=20, enc_hidden_size=16, enc_num_attention_heads=2,
        enc_num_layers=1, enc_intermediate_size=32, vocab_size=10,
    ))
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        build_decode_fn(ASR(cfg), cfg)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        resolve_device("cuda")
    assert resolve_device("cpu").type == "cpu"
    l3 = config_from_dict(dict(
        encoder_type="conformer", decoder_type="transformer", pos_encode_type="rel",
        feat_dim=20, enc_hidden_size=16, enc_num_attention_heads=2, enc_num_layers=1,
        enc_intermediate_size=32, conv_kernel_size=3, dec_hidden_size=16, dec_num_attention_heads=2,
        dec_num_layers=1, dec_intermediate_size=32, vocab_size=10, mtl_ctc_weight=0.3,
        dec_step_mode="fused_indirect", enc_fused_attn=True,
    ))
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        build_decode_fn(ASR(l3), l3, beam_width=3, decode_ctc_weight=0.3)
    l4 = config_from_dict(dict(
        encoder_type="conformer", decoder_type="rnn_transducer", pos_encode_type="rel", feat_dim=20,
        enc_hidden_size=16, enc_num_attention_heads=2, enc_num_layers=1, enc_intermediate_size=32,
        conv_kernel_size=3, dec_hidden_size=16, dec_num_layers=1, vocab_size=10, rnnt_joint_mode="pallas",
    ))
    for beam in (0, 3):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            build_decode_fn(ASR(l4), l4, beam_width=beam)
    l4_conf = tmp_path / "l4.yaml"
    l4_conf.write_text("encoder_type: conformer\ndecoder_type: rnn_transducer\nfeat_dim: 20\n")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        loop.main(["-conf", str(l4_conf)])
    l3_conf = tmp_path / "l3.yaml"
    l3_conf.write_text("encoder_type: conformer\ndecoder_type: transformer\nfeat_dim: 20\n")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        test_asr.main(["-conf", str(l3_conf), "-ep", "1", "--beam_width", "3"])
    conf = tmp_path / "exp.yaml"
    conf.write_text("feat_dim: 20\n")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        test_asr.main(["-conf", str(conf), "-ep", "1"])
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        loop.main(["-conf", str(conf)])
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        loop.train(str(conf))
    assert not os.path.exists(tmp_path / "exp")  # it raised before it wrote anything
    for lm_type in ("transformer", "bert", "rnn"):  # the LM trainer and the PPL CLI
        lm_conf = tmp_path / f"{lm_type}.yaml"
        lm_conf.write_text(f"lm_type: {lm_type}\nvocab_size: 10\n")
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            train_lm.main(["-conf", str(lm_conf)])
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            test_ppl.main(["-conf", str(lm_conf), "-ep", "1"])
        assert not os.path.exists(tmp_path / lm_type)
    from emoasr_tpu_torch.eval import correct, rescore
    for lm_type in ("pbert", "electra"):  # the LM trainer, rescoring and correction
        lm_conf = tmp_path / f"{lm_type}.yaml"
        lm_conf.write_text(f"lm_type: {lm_type}\nvocab_size: 10\n")
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            train_lm.main(["-conf", str(lm_conf)])
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            rescore.main(["nbest.tsv", "-ref", "ref.tsv", "-lm_conf", str(lm_conf), "-lm_ep", "1"])
        assert not os.path.exists(tmp_path / lm_type)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        correct.main(["-conf", str(conf), "-ep", "1", "--lm_conf", str(tmp_path / "pbert.yaml"), "--lm_ep", "1"])


def test_parallel_entry_points_raise_without_cuda(tmp_path, monkeypatch):
    """The eval CLI's `--dp`, the trainers started by torchrun and the rank
    programs of `parallel/ranks.py` (in the calling process and as a rank
    of a launch) run on the GPU unless `--cpu` / `device="cpu"` is given:
    here they raise before they join a process group or write anything; a
    rank that shares a card over NCCL is refused by name."""
    if torch.cuda.is_available():
        pytest.skip("a GPU is present")
    from emoasr_tpu_torch.eval import test_asr
    from emoasr_tpu_torch.parallel import mesh, ranks
    from emoasr_tpu_torch.train import loop, train_lm

    conf = tmp_path / "exp.yaml"
    conf.write_text("feat_dim: 20\n")
    lm_conf = tmp_path / "bert.yaml"
    lm_conf.write_text("lm_type: bert\nvocab_size: 10\n")
    for env in ({}, {"WORLD_SIZE": "2", "RANK": "0", "LOCAL_RANK": "0"}):
        for k, v in env.items():
            monkeypatch.setenv(k, v)
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            test_asr.main(["-conf", str(conf), "-ep", "1", "--dp"])
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            loop.main(["-conf", str(conf)])
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            train_lm.main(["-conf", str(lm_conf)])
    for program in (ranks.train_steps, ranks.decode, ranks.encode):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            program(None, conf={}, batches=[]) if program is ranks.train_steps else program(
                None, conf={}, state_dict={}, xs=None, xlens=None)
    work = tmp_path / "ranks"
    work.mkdir()
    torch.save([dict(program="decode", mesh_shape=(1,), mesh_axes=("data",))], work / "jobs.pt")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        ranks._main(str(work), 0, 1)
    assert not torch.distributed.is_initialized() and mesh.active() is None
    assert sorted(os.listdir(work)) == ["jobs.pt"]
    assert not os.path.exists(tmp_path / "exp") and not os.path.exists(tmp_path / "bert")
    with pytest.raises(RuntimeError, match="NCCL refuses two ranks on one device"):
        mesh.pick_backend(torch.device("cuda"), None, local_world=2)
    with pytest.raises(ValueError, match="the CPU runs gloo"):
        mesh.pick_backend(torch.device("cpu"), "nccl")


def test_vocab_split_profile_and_grid_entry_points_raise_without_cuda(tmp_path, monkeypatch):
    """The rank programs on a mesh that splits the vocabulary (RNN-T, LAS,
    the RNN LM on (1, 2)), `--profile` of the train and eval CLIs and
    `fusion_grid --dp` (alone and as a torchrun rank) run on the GPU unless
    asked for the CPU: here they raise before they trace or join a process
    group."""
    if torch.cuda.is_available():
        pytest.skip("a GPU is present")
    from emoasr_tpu_torch.eval import fusion_grid, test_asr
    from emoasr_tpu_torch.parallel import mesh, ranks
    from emoasr_tpu_torch.train import loop

    conf = tmp_path / "exp.yaml"
    conf.write_text("feat_dim: 20\n")
    tp = dict(program="train_steps", mesh_shape=(1, 2), mesh_axes=("data", "model"), batches=[])
    jobs = [dict(tp, conf=dict(decoder_type="rnn_transducer", vocab_size=20)),
            dict(tp, conf=dict(decoder_type="las", vocab_size=20)),
            dict(tp, conf=dict(lm_type="rnn", vocab_size=30), lm=True)]
    for j, job in enumerate(jobs):
        work = tmp_path / f"ranks{j}"
        work.mkdir()
        torch.save([job], work / "jobs.pt")
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            ranks._main(str(work), 0, 2)
        assert sorted(os.listdir(work)) == ["jobs.pt"]
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            ranks.train_steps(None, conf=job["conf"], batches=[], lm=job.get("lm", False))
    prof = tmp_path / "prof"
    for env in ({}, {"WORLD_SIZE": "2", "RANK": "0", "LOCAL_RANK": "0"}):
        for k, v in env.items():
            monkeypatch.setenv(k, v)
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            loop.main(["-conf", str(conf), "--profile", str(prof)])
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            test_asr.main(["-conf", str(conf), "-ep", "1", "--profile", str(prof)] + (["--dp"] if env else []))
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            fusion_grid.main(fusion_grid.parse_args(["-conf", str(conf), "-ep", "1", "--dp"]))
    assert not prof.exists() and not torch.distributed.is_initialized() and mesh.active() is None


def test_rnn_las_and_prep_entry_points_raise_without_cuda(tmp_path):
    """The LAS and RNN-encoder models' decode functions, greedy and beam,
    and the prep CLI's fbank stage run on the GPU unless asked for the CPU;
    here they raise before they read or write anything."""
    if torch.cuda.is_available():
        pytest.skip("a GPU is present")
    from emoasr_tpu_torch.config import config_from_dict
    from emoasr_tpu_torch.corpora import prep
    from emoasr_tpu_torch.eval.decode import build_decode_fn
    from emoasr_tpu_torch.models.asr import ASR

    small = dict(feat_dim=20, enc_hidden_size=16, enc_num_attention_heads=2, enc_num_layers=1,
                 enc_intermediate_size=32, vocab_size=10, dec_hidden_size=16, dec_num_layers=1,
                 dec_intermediate_size=16)
    for over in (dict(decoder_type="las"), dict(encoder_type="rnn"), dict(encoder_type="rnn", decoder_type="las")):
        cfg = config_from_dict(dict(small, **over))
        for beam in (0, 3):
            with pytest.raises(RuntimeError, match="CUDA is not available"):
                build_decode_fn(ASR(cfg), cfg, beam_width=beam)
    (tmp_path / "wavs.tsv").write_text("wav_path\nnowhere.wav\n")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        prep.main(["wav_to_feats", str(tmp_path / "wavs.tsv")])
    assert sorted(os.listdir(tmp_path)) == ["wavs.tsv"]


def test_lm_fusion_raises_and_names_its_slice(tmp_path):
    """Shallow fusion takes the Transformer, RNN and ELECTRA LMs and refuses
    BERT (a masked LM has no next-token distribution) and the
    phone-conditioned types (a beam has no phones), naming the type, from
    the fusion adapter and from the eval CLI before it reads any
    checkpoint; the PPL CLI, the rescoring CLI and the correction CLI
    refuse the types they cannot take the same way.  Every LM type builds
    and has a weight import.  Without an LM, `with_weights` has no LM term
    to weigh."""
    from emoasr_tpu_torch.config import config_from_dict
    from emoasr_tpu_torch.eval import correct, rescore, test_asr, test_ppl
    from emoasr_tpu_torch.eval.decode import build_decode_fn
    from emoasr_tpu_torch.models.asr import ASR
    from emoasr_tpu_torch.models.lm.lm import LM, LM_TYPES
    from emoasr_tpu_torch.search.common import make_lm_fusion

    cfg = config_from_dict(dict(
        feat_dim=20, enc_hidden_size=16, enc_num_attention_heads=2,
        enc_num_layers=1, enc_intermediate_size=32, vocab_size=10,
    ))
    fn = build_decode_fn(ASR(cfg), cfg, beam_width=2, device="cpu")
    assert callable(fn.with_weights(None, 0.5)) and callable(fn.with_weights(0.3, None))
    bert = config_from_dict(dict(lm_type="bert", vocab_size=10, hidden_size=16, num_layers=1,
                                 num_attention_heads=2, intermediate_size=32))
    with pytest.raises(ValueError, match="masked LM"):
        make_lm_fusion(LM(bert), 0.5)
    sizes = dict(vocab_size=10, hidden_size=16, num_layers=1, num_attention_heads=2, intermediate_size=32,
                 src_vocab_size=8, enc_hidden_size=16, enc_num_attention_heads=2, enc_num_layers=1,
                 enc_intermediate_size=32, dec_hidden_size=16, dec_num_attention_heads=2, dec_num_layers=1,
                 dec_intermediate_size=32, gen_hidden_size=16, gen_num_attention_heads=2, gen_num_layers=1,
                 gen_intermediate_size=32, disc_hidden_size=16, disc_num_attention_heads=2, disc_num_layers=1,
                 disc_intermediate_size=32)
    for lm_type in LM_TYPES:
        assert LM(config_from_dict(dict(sizes, lm_type=lm_type))).lm.state_dict()
    assert make_lm_fusion(LM(config_from_dict(dict(sizes, lm_type="electra"))), 0.5).init_states(1, 2) is None
    for lm_type in ("ptransformer", "pbert", "pctc", "pelectra", "pelectra-disc"):
        with pytest.raises(ValueError, match=lm_type):
            make_lm_fusion(_WithCfg(config_from_dict(dict(sizes, lm_type=lm_type))), 0.5)
        lm_conf = tmp_path / f"{lm_type}.yaml"
        lm_conf.write_text(f"lm_type: {lm_type}\nvocab_size: 10\n")
        conf = tmp_path / "exp.yaml"
        conf.write_text(f"feat_dim: 20\nlm_weight: 0.3\nlm_conf: {lm_conf}\nlm_path: nowhere\n")
        with pytest.raises(ValueError, match=lm_type):
            test_asr.main(["-conf", str(conf), "-ep", "1", "--cpu"])
    for lm_type in ("electra", "electra-disc", "pelectra", "pelectra-disc", "pctc"):
        lm_conf = tmp_path / f"{lm_type}.yaml"
        lm_conf.write_text(f"lm_type: {lm_type}\nvocab_size: 10\n")
        with pytest.raises(ValueError, match=lm_type):
            test_ppl.main(["-conf", str(lm_conf), "-ep", "1", "--cpu"])
    for lm_type in ("electra", "pelectra", "ptransformer"):
        lm_conf = tmp_path / f"{lm_type}.yaml"
        with pytest.raises(ValueError, match=lm_type):
            correct.main(["-conf", str(tmp_path / "exp.yaml"), "-ep", "1", "--lm_conf", str(lm_conf),
                          "--lm_ep", "1", "--cpu"])
    for lm_type in ("ptransformer", "pbert", "pctc"):
        lm_conf = tmp_path / f"{lm_type}.yaml"
        with pytest.raises(ValueError, match=lm_type):
            rescore.main(["nowhere.tsv", "-ref", "nowhere.tsv", "-lm_conf", str(lm_conf), "-lm_ep", "1", "--cpu"])
    with pytest.raises(ValueError, match="dec_step_mode"):
        bad = config_from_dict(dict(feat_dim=20, vocab_size=10, dec_step_mode="quick"))
        build_decode_fn(ASR(bad), bad, device="cpu")


class _WithCfg(torch.nn.Module):
    """A module that carries an LM config, as the LM facade does."""

    def __init__(self, cfg):
        super().__init__()
        self.cfg = cfg


def test_every_entry_point_sets_the_tf32_switches(tmp_path, monkeypatch):
    """One function sets both switches (off for float32, on for a half
    compute dtype), and the eval CLIs and the train CLIs call it before they
    build a model."""
    from emoasr_tpu_torch.eval import test_asr, test_ppl
    from emoasr_tpu_torch.train import loop, train_lm
    from emoasr_tpu_torch.utils import device

    try:
        assert device.set_matmul_precision("bfloat16") is True
        assert torch.backends.cuda.matmul.allow_tf32 and torch.backends.cudnn.allow_tf32
        assert device.set_matmul_precision("float32") is False
        assert not torch.backends.cuda.matmul.allow_tf32 and not torch.backends.cudnn.allow_tf32
    finally:
        device.set_matmul_precision("float32")

    class Called(Exception):
        pass

    def spy(compute_dtype="float32"):
        raise Called(compute_dtype)

    conf = tmp_path / "exp.yaml"
    conf.write_text("feat_dim: 20\ncompute_dtype: float32\n")
    lm_conf = tmp_path / "lm.yaml"
    lm_conf.write_text("lm_type: rnn\nvocab_size: 10\ncompute_dtype: float32\n")
    for mod, argv in ((test_asr, ["-conf", str(conf), "-ep", "1", "--cpu"]),
                      (loop, ["-conf", str(conf), "--cpu"]),
                      (train_lm, ["-conf", str(lm_conf), "--cpu"]),
                      (test_ppl, ["-conf", str(lm_conf), "-ep", "1", "--cpu"])):
        monkeypatch.setattr(mod, "set_matmul_precision", spy)
        with pytest.raises(Called, match="float32"):
            mod.main(argv)


def test_chip_smoke_fails_without_cuda_and_alone(tmp_path):
    """No card: non-zero exit and no result line.  Alone in a directory
    (without the package): non-zero exit and no result line."""
    if torch.cuda.is_available():
        pytest.skip("a GPU is present")
    runs = [subprocess.run([sys.executable, "chip_smoke.py"], cwd=REPO,
                           env=_env(), capture_output=True, text=True, timeout=300)]
    shutil.copy(os.path.join(REPO, "chip_smoke.py"), tmp_path)
    env = dict(os.environ)
    env.pop("PYTHONPATH", None)
    runs.append(subprocess.run([sys.executable, "chip_smoke.py"], cwd=tmp_path,
                               env=env, capture_output=True, text=True, timeout=300))
    for r in runs:
        assert r.returncode != 0
        assert '"ok"' not in r.stdout


def test_cpu_tensors_take_the_plain_versions():
    from emoasr_tpu_torch.ops import attention, topk
    from emoasr_tpu_torch.search.common import topk_lastdim

    x = torch.from_numpy(np.random.default_rng(0).normal(size=(3, 400)).astype(np.float32))
    v, i = topk_lastdim(x, 5)
    v0, i0 = topk.topk_plain(x, 5)
    assert torch.equal(v, v0) and torch.equal(i, i0)
    q = torch.zeros(1, 6, 2, 8)
    o = attention.fused_self_attention(q, q, q, torch.tensor([4]), scale=0.5)
    assert torch.equal(o, attention.attention_plain(q, q, q, torch.tensor([4]), 0.5))
    assert topk.KERNEL.launches == 0 and attention.KERNEL.launches == 0
    assert topk.KERNEL._lib is None and attention.KERNEL._lib is None  # nothing built

    # the training kernels: forward and backward on the CPU are the plain versions'
    from emoasr_tpu_torch.ops import ctc_head, ctc_lattice

    rng = np.random.default_rng(1)
    e = torch.from_numpy(rng.normal(size=(2, 5, 8)).astype(np.float32)).requires_grad_(True)
    w = torch.from_numpy(rng.normal(size=(8, 7)).astype(np.float32))
    b = torch.zeros(7)
    z = torch.tensor([[0, 3, 0], [0, 6, 0]])
    lse, xs = ctc_head.fused_ctc_head(e, w, b, z)
    lse0, xs0 = ctc_head.ctc_head_plain(e, w, b, z)
    assert torch.equal(lse, lse0) and torch.equal(xs, xs0)
    lp = (xs - lse[:, :, None]).transpose(0, 1)
    ones = torch.ones(2, 3)
    xlens = torch.tensor([5, 4])
    ll = ctc_lattice.ctc_ll_from_path(lp, ones, ones, ones, xlens)
    assert torch.equal(ll, ctc_lattice.ctc_ll_plain(lp, ones, ones, ones, xlens))
    (g,) = torch.autograd.grad(ll.sum(), e)
    assert torch.isfinite(g).all() and g.abs().sum() > 0
    qg = torch.randn(1, 6, 2, 8, requires_grad=True)
    attention.fused_self_attention(qg, qg, qg, torch.tensor([4]), scale=0.5).sum().backward()
    assert qg.grad is not None
    for k in (ctc_head.KERNEL, ctc_lattice.KERNEL, attention.KERNEL):
        assert k.launches == 0 and not any(k.counts.values()) and k._lib is None
    with pytest.raises(ValueError, match="card only"):
        attention.dropout_keep_mask(1, 4, 2, 0.1, 0, torch.device("cpu"))

    # the score bias and the decoder step: plain versions too, nothing built
    from emoasr_tpu_torch.models.layers import TransformerDecoderLayer
    from emoasr_tpu_torch.ops import decoder_step

    bias = torch.randn(1, 2, 6, 6, requires_grad=True)
    ob = attention.fused_self_attention(qg, qg, qg, torch.tensor([4]), scale=0.5, bias=bias)
    assert torch.equal(ob, attention.attention_plain(qg, qg, qg, torch.tensor([4]), 0.5, bias=bias))
    ob.sum().backward()
    assert bias.grad is not None and bias.grad[..., 4:].abs().sum() == 0
    layer = TransformerDecoderLayer(2, 16, 32).eval()
    Bu, W, L, T = 2, 3, 5, 7
    with torch.no_grad():
        h = torch.randn(Bu * W, 16)
        ck, cv = torch.randn(Bu, W, L, 2, 8), torch.randn(Bu, W, L, 2, 8)
        cross = layer.compute_cross_kv(torch.randn(Bu, T, 16))
        pos, anc = torch.randint(0, L, (Bu, W)), torch.randint(0, W, (Bu, W, L))
        elens, wt = torch.tensor([7, 4]), layer._decode_step_weights()
        a = decoder_step.fused_decoder_layer_step(
            h, ck.reshape(Bu * W, L, 2, 8), cv.reshape(Bu * W, L, 2, 8), pos.reshape(-1), *cross, elens, wt,
            beam_width=W)
        b = decoder_step.decoder_layer_step_plain(
            h, ck.reshape(Bu * W, L, 2, 8), cv.reshape(Bu * W, L, 2, 8), pos.reshape(-1), *cross, elens, wt, W)
        c = decoder_step.fused_decoder_layer_step_indirect(h, ck, cv, pos, anc, *cross, elens, wt, beam_width=W)
        d = decoder_step.decoder_layer_step_indirect_plain(h, ck, cv, pos, anc, *cross, elens, wt, W)
    assert all(torch.equal(x, y) for x, y in zip(a, b)) and all(torch.equal(x, y) for x, y in zip(c, d))
    for k in (decoder_step.KERNEL, decoder_step.KERNEL_INDIRECT, attention.KERNEL):
        assert k.launches == 0 and not any(k.counts.values()) and k._lib is None


def test_rnnt_kernels_stay_plain_on_the_cpu():
    """The RNN-T joint and the LSTM recurrence: CPU tensors take the plain
    versions, forward and backward, and nothing is built or launched; a
    tensor on another device raises instead of falling back."""
    from emoasr_tpu_torch.ops import lstm, lstm_scan, rnnt, rnnt_joint

    rng = np.random.default_rng(2)
    he = torch.from_numpy(rng.normal(size=(2, 9, 8)).astype(np.float32)).requires_grad_(True)
    hd = torch.from_numpy(rng.normal(size=(2, 4, 8)).astype(np.float32))
    w, b = torch.from_numpy(rng.normal(size=(8, 11)).astype(np.float32)), torch.zeros(11)
    lab = torch.tensor([[3, 4, 2], [5, 2, 2]])
    got = rnnt_joint.fused_joint_gather(he, hd, w, b, lab)
    want = rnnt.joint_gather_plain(he, hd, w, b, lab)
    assert all(torch.equal(x, y) for x, y in zip(got, want))
    (g,) = torch.autograd.grad(got[0].sum() + got[1].sum(), he)
    assert torch.isfinite(g).all() and g.abs().sum() > 0
    xp = torch.from_numpy(rng.normal(size=(2, 12, 16)).astype(np.float32)).requires_grad_(True)
    whh, z = torch.from_numpy(0.1 * rng.normal(size=(16, 4)).astype(np.float32)), torch.zeros(2, 4)
    for fn in (lstm.lstm_scan, lstm_scan.lstm_scan_fused):
        ys, _ = fn(xp, whh, z, z)
        (g,) = torch.autograd.grad(ys.sum(), xp)
        assert torch.isfinite(g).all()
    for k in (rnnt_joint.KERNEL, lstm_scan.KERNEL):
        assert k.launches == 0 and not any(k.counts.values()) and k._lib is None
    with pytest.raises(ValueError, match="unsupported device"):
        rnnt_joint.fused_joint_gather(he.detach().to("meta"), hd.to("meta"), w.to("meta"), b.to("meta"), lab)
    with pytest.raises(ValueError, match="unsupported device"):
        lstm_scan.lstm_scan_fused(xp.detach().to("meta"), whh.to("meta"), z.to("meta"), z.to("meta"))
