"""Typed experiment configuration.

The reference (emoASR `utils/configure.py:7-14`) loads YAML into an
untyped ``namedtuple`` and probes optional keys with ``hasattr`` all over the
codebase.  Here one experiment = one frozen dataclass: every key the reference
ever probes is a typed field with an explicit default, so configs are
hashable (usable as jit static args), diffable, and self-documenting.  YAML
stays the on-disk format; unknown keys raise instead of being silently kept.

Copy of `emoasr_tpu/config.py`: the port reads the same YAML files, so it
keeps the same fields (some of them name JAX-side options that the port
ignores, such as `rng_impl`; `mesh_shape` / `mesh_axes` lay out the ranks
that `torchrun` starts, `parallel/mesh.py`).
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field, fields
from typing import Optional, Tuple

import yaml


@dataclass(frozen=True)
class ExpConfig:
    """One experiment (flat, mirroring the reference's YAML namespace).

    Field groups follow the reference YAML layout (e.g.
    emoASR `asr/correct/exps/csj/asr.yaml`,
    emoASR `lm/exps/ted2_nsp10k/electra.yaml`).
    """

    # ---- model selection ----
    encoder_type: str = "transformer"  # rnn | transformer | conformer
    decoder_type: str = "ctc"  # ctc | rnn_transducer | transformer | las
    lm_type: Optional[str] = None  # bert|transformer|electra[-disc]|pelectra[-disc]|rnn|ptransformer|pbert|pctc

    # ---- frontend ----
    input_layer: str = "conv2d"  # conv2d | embed | linear
    feat_dim: int = 80
    num_framestacks: int = 1
    spec_augment: bool = False
    max_mask_freq: int = 30
    max_mask_time: int = 40
    num_masks_freq: int = 2
    num_masks_time: int = 2
    # adaptive SpecAugment (when set, overrides max/num_masks_time)
    max_mask_time_ratio: Optional[float] = None
    num_masks_time_ratio: Optional[float] = None
    replace_with_zero: bool = True

    # ---- encoder ----
    enc_hidden_size: int = 256
    enc_num_attention_heads: int = 4
    enc_num_layers: int = 12
    enc_intermediate_size: int = 2048
    enc_num_projs: Optional[int] = None  # RNN encoder projection size
    enc_hidden_sum_fwd_bwd: bool = True  # RNN encoder: sum fwd+bwd outputs
    pos_encode_type: str = "abs"  # abs | rel (rel => conformer)
    conv_kernel_size: int = 31  # conformer depthwise conv

    # ---- decoder (attention/transducer) ----
    dec_hidden_size: int = 256
    dec_num_attention_heads: int = 4
    dec_num_layers: int = 6
    dec_intermediate_size: int = 2048
    dec_num_embeds: Optional[int] = None  # RNN-T prediction net embed size
    dec_rnnt_hidden_size: Optional[int] = None  # RNN-T prediction net LSTM size
    dec_rnnt_num_layers: int = 1
    joint_hidden_size: Optional[int] = None  # RNN-T joint net size
    # RNN-T joint memory strategy: "full" materializes (B,T,U+1,V) like the
    # reference; "chunked" streams time chunks with remat (O(BTU) memory);
    # "pallas" uses the fused TPU kernel forward (ops/rnnt_pallas.py)
    rnnt_joint_mode: str = "chunked"
    # attention-decoder beam step: "dense" runs the ~25-op XLA step,
    # "fused" the single Pallas program (ops/decoder_step_pallas.py),
    # "auto" picks fused on TPU (the step is small-op latency-bound
    # there) and dense elsewhere
    dec_step_mode: str = "auto"  # auto(=indirect) | indirect | dense | fused
    mtl_ctc_weight: float = 0.0  # aux CTC for attention / RNN-T decoders
    max_decode_ylen: int = 256  # emission cap (rnn_transducer.py:32)

    # ---- vocab / data ----
    blank_id: int = 0
    unk_id: int = 1
    eos_id: int = 2
    mask_id: Optional[int] = None
    phone_eos_id: Optional[int] = None
    vocab_path: str = ""
    phone_vocab_path: Optional[str] = None
    vocab_size: int = 0
    src_vocab_size: Optional[int] = None  # for input_layer == embed (P2W phone encoder)
    phone_vocab_size: Optional[int] = None
    train_path: str = ""
    dev_path: str = ""
    test_path: str = ""
    train_data_shuffle: bool = True
    train_size: Optional[int] = None  # LM: #examples, for total-step computation
    max_seq_len: int = 256
    add_sos_eos: bool = False

    # ---- checkpoints / logging ----
    model_path: str = ""
    optim_path: str = ""
    startep: int = 0
    log_step: int = 100
    save_step: int = 1

    # ---- training ----
    batch_size: int = 32
    max_xlens_batch: int = 30000
    max_ylens_batch: int = 3000
    num_epochs: int = 100
    learning_rate: float = 5.0
    lr_schedule_type: str = "noam"  # noam | epdecay | lindecay
    num_warmup_steps: Optional[int] = None
    warmup_proportion: Optional[float] = None
    lr_decay_start_epoch: Optional[int] = None
    lr_decay_rate: Optional[float] = None
    clip_grad_norm: float = 5.0
    dropout_enc_rate: float = 0.1
    dropout_dec_rate: float = 0.1
    dropout_attn_rate: float = 0.1
    weight_decay: float = 0.0
    accum_grad: int = 1
    lsm_prob: float = 0.0  # label smoothing
    loss_normalize_length: bool = False
    loss_normalize_batch: bool = True
    dropout_emb_rate: float = 0.0
    seed: int = 0

    # ---- knowledge distillation ----
    kd_weight: float = 0.0
    kd_type: str = "word"  # word | align (RNN-T)
    kd_ctc_soft_label_weight: float = 1.0
    kd_ctc_position: str = "all"  # all | left | mid | right ("middle" raises, as in JAX)
    reduce_main_loss_kd: bool = False
    distill_temperature: float = 1.0

    # ---- MTL ----
    mtl_phone_ctc_weight: float = 0.0
    hie_mtl_phone: bool = False
    inter_ctc_layer_id: int = 0
    mtl_inter_ctc_weight: float = 0.0
    inter_kd_weight: float = 0.0

    # ---- LM (BERT/ELECTRA family) ----
    embedding_size: Optional[int] = None
    hidden_size: int = 256
    num_attention_heads: int = 4
    num_layers: int = 12
    intermediate_size: int = 1024
    gen_embedding_size: Optional[int] = None
    gen_hidden_size: Optional[int] = None
    gen_intermediate_size: Optional[int] = None
    gen_num_attention_heads: Optional[int] = None
    gen_num_layers: Optional[int] = None
    disc_embedding_size: Optional[int] = None
    disc_hidden_size: Optional[int] = None
    disc_intermediate_size: Optional[int] = None
    disc_num_attention_heads: Optional[int] = None
    disc_num_layers: Optional[int] = None
    electra_disc_weight: float = 50.0
    num_to_mask: int = 0
    random_num_to_mask: bool = False
    mask_proportion: float = 0.0
    mask_insert_poisson_lam: float = 0.0  # deletable PC-MLM <mask> insertion
    text_augment: bool = False
    textaug_max_mask_prob: float = 0.0
    textaug_max_replace_prob: float = 0.0
    phone_mask_id: Optional[int] = None
    dropout_rate: float = 0.0  # RNNLM inter-layer dropout
    tie_weights: bool = False
    weight_tying: bool = False
    bucket_shuffle: bool = True
    max_plens_batch: int = 20000

    # ---- decode ----
    lm_conf: Optional[str] = None  # LM config path for shallow fusion
    lm_path: Optional[str] = None  # LM checkpoint path
    beam_width: int = 0
    len_weight: float = 0.0
    decode_ctc_weight: float = 0.0
    lm_weight: float = 0.0
    decode_phone: bool = False
    # CTC-length-informed per-utterance decode-step budget for the
    # attention beam (search/attention_beam.py `row_caps`): cap =
    # ratio * (collapsed CTC greedy length) + margin.  "auto" enables it
    # when joint CTC scoring is on (the estimate is free there); "on" /
    # "off" force.  Rows at budget force-finalize their surviving beams,
    # so every utterance yields a hypothesis.  A binding cap TRUNCATES
    # (best-effort, not exact) — the eval loop logs how many hypotheses
    # were force-finalized; "off" restores reference semantics.
    decode_len_cap: str = "auto"
    decode_cap_ratio: float = 1.5
    decode_cap_margin: int = 12

    # ---- error correction ----
    mask_th: float = 0.0
    lm_mix_weight: float = 0.0

    # ---- TPU-native additions (no reference equivalent) ----
    # static shape buckets: list of (max_frames, max_tokens) pairs; data is
    # padded up to the smallest fitting bucket to avoid XLA recompilation.
    buckets: Tuple[Tuple[int, int], ...] = ((1600, 128), (800, 96), (400, 64), (200, 48))
    # mixed precision: master params are always float32; when
    # compute_dtype == "bfloat16" the jitted steps run forward activations
    # in bf16 with f32 softmax/losses/norm-stats (utils/precision.py).
    param_dtype: str = "float32"
    compute_dtype: str = "float32"
    # PRNG implementation for the training step's dropout/SpecAugment
    # streams.  "unsafe_rbg" uses the XLA hardware RNG: measured 39.2 ->
    # 21.0 ms/step at L1 shapes (threefry mask generation costs ~half the
    # step) — but jax documents its split/fold_in as lacking independence
    # guarantees, so the default is jax's counter-based "threefry" (fully
    # reproducible streams); the production TPU configs under configs/ opt
    # into unsafe_rbg explicitly for the speed.  Model *initialization*
    # always uses threefry so parameter draws stay reproducible across
    # impls.
    rng_impl: str = "threefry2x32"  # threefry2x32 | rbg | unsafe_rbg
    # Pallas fused self-attention for Transformer encoder blocks
    # (ops/attention_pallas.py): softmax(QK^T)V with key-pad masking and
    # in-kernel dropout in one kernel, scores never in HBM.  Conformer
    # (rel-pos) layers ignore it.  Off-TPU the kernel interprets
    # (exact); with dropout active it falls back to an equivalent
    # pure-JAX path (same distribution, different realized bits).
    enc_fused_attn: bool = False
    mesh_shape: Tuple[int, ...] = (-1,)  # data-parallel axis; -1 = all ranks (parallel/mesh.py)
    mesh_axes: Tuple[str, ...] = ("data",)

    def replace(self, **kw) -> "ExpConfig":
        return dataclasses.replace(self, **kw)

    @property
    def is_conformer(self) -> bool:
        return self.encoder_type == "conformer"

    @property
    def input_size(self) -> int:
        return self.feat_dim * self.num_framestacks


_FIELD_NAMES = {f.name for f in fields(ExpConfig)}

# Keys that appear in reference YAMLs but are intentionally ignored here
# (handled differently in the TPU rebuild or purely torch-specific).
_IGNORED_KEYS = frozenset({})


def load_config(path: str, **overrides) -> ExpConfig:
    """Load a YAML experiment file into an ExpConfig.

    Mirrors `utils/configure.py:7` in role; unknown keys are an error (the
    reference silently carried them in the namedtuple).
    """
    with open(path) as f:
        raw = yaml.safe_load(f) or {}
    raw.update(overrides)
    return config_from_dict(raw)


def config_from_dict(raw: dict) -> ExpConfig:
    unknown = set(raw) - _FIELD_NAMES - _IGNORED_KEYS
    if unknown:
        raise ValueError(f"unknown config keys: {sorted(unknown)}")
    kw = {k: v for k, v in raw.items() if k in _FIELD_NAMES}
    if kw.get("rng_impl") == "threefry":  # alias for jax's registered name
        kw["rng_impl"] = "threefry2x32"
    for key in ("buckets", "mesh_shape", "mesh_axes"):
        if key in kw and isinstance(kw[key], list):
            kw[key] = tuple(tuple(x) if isinstance(x, list) else x for x in kw[key])
    return ExpConfig(**kw)
