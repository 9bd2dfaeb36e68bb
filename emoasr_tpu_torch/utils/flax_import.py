"""Carry the JAX package's flax parameters into the port's `state_dict`.

`asr_state_dict(params, cfg, batch_stats)` is the inverse of
`emoasr_tpu/utils/torch_import.py::asr_model` for every ASR model
(Transformer or Conformer encoder with the conv2d, embed or linear input
layer, or the RNN encoder with the conv2d one; CTC decoder with its
optional phone head, Transformer, RNN-T or LAS decoder, each with its
optional auxiliary CTC head), and
`lm_state_dict(params, lm_cfg)` that of `torch_import.py::bert_masked_lm`,
`rnnlm` and `electra_model` and of the encoder and decoder importers that
the phone-to-word models reuse, for every LM type.  It takes the flax parameter tree (and, for a
Conformer, the flax `batch_stats` collection) as nested dicts of numpy
arrays and needs neither JAX nor flax.  A flax gradient tree has the
parameters' structure, so it maps the same way and gradients can be
compared name by name:

- a Dense `kernel` (in, out) becomes `weight` = kernel.T;
- a 2-D Conv `kernel` (kh, kw, in, out) becomes `weight` (out, in, kh, kw);
- a 1-D Conv `kernel` (k, in/groups, out) becomes `weight` (out, in/groups, k);
- a LayerNorm or BatchNorm `scale`/`bias` becomes `weight`/`bias`, and the
  `batch_stats` `mean`/`var` become `running_mean`/`running_var`
  (`num_batches_tracked`, which flax does not keep, is written as 0);
- an Embed `embedding` becomes `weight`;
- an LSTM layer's `weight_ih`/`weight_hh`/`bias_ih`/`bias_hh` (already in
  torch's layout) become `nn.LSTM`'s `weight_ih_l0`, ... .
"""

from __future__ import annotations

from typing import Dict, Mapping, Optional

import numpy as np
import torch

SD = Dict[str, torch.Tensor]


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(np.asarray(a)))


def _dense(sd: SD, p: str, tree: Mapping) -> None:
    sd[f"{p}.weight"] = _t(np.asarray(tree["kernel"]).T)
    if "bias" in tree:
        sd[f"{p}.bias"] = _t(tree["bias"])


def _conv1d(sd: SD, p: str, tree: Mapping) -> None:
    sd[f"{p}.weight"] = _t(np.asarray(tree["kernel"]).transpose(2, 1, 0))
    sd[f"{p}.bias"] = _t(tree["bias"])


def _conv2d(sd: SD, p: str, tree: Mapping) -> None:
    sd[f"{p}.weight"] = _t(np.asarray(tree["kernel"]).transpose(3, 2, 0, 1))
    sd[f"{p}.bias"] = _t(tree["bias"])


def _layer_norm(sd: SD, p: str, tree: Mapping) -> None:
    sd[f"{p}.weight"] = _t(tree["scale"])
    sd[f"{p}.bias"] = _t(tree["bias"])


def _mha(sd: SD, p: str, tree: Mapping) -> None:
    for name in ("linear_q", "linear_k", "linear_v", "linear_out"):
        _dense(sd, f"{p}.{name}", tree[name])
    if "linear_pos" in tree:  # relative positions
        _dense(sd, f"{p}.linear_pos", tree["linear_pos"])
        sd[f"{p}.pos_bias_u"] = _t(tree["pos_bias_u"])
        sd[f"{p}.pos_bias_v"] = _t(tree["pos_bias_v"])


def _feed_forward(sd: SD, p: str, tree: Mapping) -> None:
    _dense(sd, f"{p}.w1", tree["w1"])
    _dense(sd, f"{p}.w2", tree["w2"])


def _conformer_layer(sd: SD, p: str, layer: Mapping, stats: Optional[Mapping]) -> None:
    for name in ("norm_ff_macaron", "norm_self_attn", "norm_conv", "norm_ff", "norm_final"):
        _layer_norm(sd, f"{p}.{name}", layer[name])
    _feed_forward(sd, f"{p}.feed_forward_macaron", layer["feed_forward_macaron"])
    _feed_forward(sd, f"{p}.feed_forward", layer["feed_forward"])
    _mha(sd, f"{p}.self_attn", layer["self_attn"])
    conv = layer["conv"]
    for name in ("pointwise_conv1", "depthwise_conv", "pointwise_conv2"):
        _conv1d(sd, f"{p}.conv.{name}", conv[name])
    _layer_norm(sd, f"{p}.conv.batch_norm", conv["batch_norm"])
    if stats is not None:  # a gradient tree has no statistics
        bn = stats["conv"]["batch_norm"]
        sd[f"{p}.conv.batch_norm.running_mean"] = _t(bn["mean"])
        sd[f"{p}.conv.batch_norm.running_var"] = _t(bn["var"])
        sd[f"{p}.conv.batch_norm.num_batches_tracked"] = torch.tensor(0, dtype=torch.int64)


def transformer_encoder_state_dict(enc: Mapping, num_layers: int, prefix: str = "",
                                   batch_stats: Optional[Mapping] = None) -> SD:
    """A Transformer encoder's tree, or a Conformer's (told by its layers'
    names) with its `batch_stats` subtree."""
    sd: SD = {}
    if "conv" in enc:
        conv = enc["conv"]
        _conv2d(sd, f"{prefix}conv.conv.0", conv["conv1"])
        _conv2d(sd, f"{prefix}conv.conv.2", conv["conv2"])
        _dense(sd, f"{prefix}conv.output", conv["output"])
    elif "embed" in enc:
        sd[f"{prefix}embed.weight"] = _t(enc["embed"]["embedding"])
    else:
        _dense(sd, f"{prefix}linear", enc["linear"])
    for i in range(num_layers):
        lp, layer = f"{prefix}transformers.{i}", enc[f"layers_{i}"]
        if "norm_final" in layer:
            _conformer_layer(sd, lp, layer,
                             None if batch_stats is None else batch_stats[f"layers_{i}"])
            continue
        _layer_norm(sd, f"{lp}.norm1", layer["norm1"])
        _layer_norm(sd, f"{lp}.norm2", layer["norm2"])
        _mha(sd, f"{lp}.self_attn", layer["self_attn"])
        _feed_forward(sd, f"{lp}.feed_forward", layer["feed_forward"])
    _layer_norm(sd, f"{prefix}norm", enc["norm"])
    return sd


def ctc_decoder_state_dict(dec: Mapping, prefix: str) -> SD:
    sd: SD = {}
    _dense(sd, f"{prefix}output", dec["output"])
    if "phone_output" in dec:
        _dense(sd, f"{prefix}phone_output", dec["phone_output"])
    return sd


def transformer_decoder_state_dict(dec: Mapping, num_layers: int, prefix: str = "") -> SD:
    sd: SD = {f"{prefix}embed.weight": _t(dec["embed"]["embedding"])}
    for i in range(num_layers):
        lp, layer = f"{prefix}transformers.{i}", dec[f"layers_{i}"]
        for name in ("norm1", "norm2", "norm3"):
            _layer_norm(sd, f"{lp}.{name}", layer[name])
        _mha(sd, f"{lp}.self_attn", layer["self_attn"])
        _mha(sd, f"{lp}.src_attn", layer["src_attn"])
        _feed_forward(sd, f"{lp}.feed_forward", layer["feed_forward"])
    _layer_norm(sd, f"{prefix}norm", dec["norm"])
    _dense(sd, f"{prefix}output", dec["output"])
    if "ctc" in dec:
        sd.update(ctc_decoder_state_dict(dec["ctc"], f"{prefix}ctc."))
    return sd


def rnnt_decoder_state_dict(dec: Mapping, num_layers: int, prefix: str = "") -> SD:
    """The RNN-T decoder: `embed`, `rnns/layer{i}`, `w_enc`, `w_dec`,
    `output` (an `ExplicitDense`, kernel (J, V)) and the optional `ctc`."""
    sd: SD = {f"{prefix}embed.weight": _t(dec["embed"]["embedding"])}
    for i in range(num_layers):
        layer = dec["rnns"][f"layer{i}"]
        for name in ("weight_ih", "weight_hh", "bias_ih", "bias_hh"):
            sd[f"{prefix}rnns.{i}.{name}_l0"] = _t(layer[name])
    for name in ("w_enc", "w_dec", "output"):
        _dense(sd, f"{prefix}{name}", dec[name])
    if "ctc" in dec:
        sd.update(ctc_decoder_state_dict(dec["ctc"], f"{prefix}ctc."))
    return sd


def rnn_encoder_state_dict(enc: Mapping, num_layers: int, prefix: str = "") -> SD:
    """The RNN encoder (inverse of `torch_import.py::rnn_encoder`): the
    conv2d subsampler and `rnns_{i}/{fwd,bwd}` -> `rnns.{i}.*_l0` and
    `rnns.{i}.*_l0_reverse`."""
    sd: SD = {}
    if "conv" in enc:
        conv = enc["conv"]
        _conv2d(sd, f"{prefix}conv.conv.0", conv["conv1"])
        _conv2d(sd, f"{prefix}conv.conv.2", conv["conv2"])
        _dense(sd, f"{prefix}conv.output", conv["output"])
    for i in range(num_layers):
        for direction, suffix in (("fwd", "_l0"), ("bwd", "_l0_reverse")):
            layer = enc[f"rnns_{i}"][direction]
            for name in ("weight_ih", "weight_hh", "bias_ih", "bias_hh"):
                sd[f"{prefix}rnns.{i}.{name}{suffix}"] = _t(layer[name])
    return sd


def las_decoder_state_dict(dec: Mapping, num_layers: int, prefix: str = "") -> SD:
    """The LAS decoder (inverse of `torch_import.py::las_decoder`): raw
    `w_*_kernel` (in, out) -> `score.w_*.weight`, `attn_conv_kernel`
    (k, 1, C) -> `score.conv.weight` (C, 1, k), `cell{i}_*` -> `rnns.{i}.*`
    (`nn.LSTMCell`'s names), `output` an `ExplicitDense`."""
    sd: SD = {f"{prefix}embed.weight": _t(dec["embed"]["embedding"])}
    for i in range(num_layers):
        for name, torch_name in zip(("w_ih", "w_hh", "b_ih", "b_hh"), ("weight_ih", "weight_hh", "bias_ih", "bias_hh")):
            sd[f"{prefix}rnns.{i}.{torch_name}"] = _t(dec[f"cell{i}_{name}"])
    for name in ("key", "query", "conv", "score"):
        sd[f"{prefix}score.w_{name}.weight"] = _t(np.asarray(dec[f"w_{name}_kernel"]).T)
        sd[f"{prefix}score.w_{name}.bias"] = _t(dec[f"w_{name}_bias"])
    sd[f"{prefix}score.conv.weight"] = _t(np.asarray(dec["attn_conv_kernel"]).transpose(2, 1, 0))
    sd[f"{prefix}intermed.weight"] = _t(np.asarray(dec["intermed_kernel"]).T)
    sd[f"{prefix}intermed.bias"] = _t(dec["intermed_bias"])
    _dense(sd, f"{prefix}output", dec["output"])
    if "ctc" in dec:
        sd.update(ctc_decoder_state_dict(dec["ctc"], f"{prefix}ctc."))
    return sd


def asr_state_dict(params: Mapping, cfg, batch_stats: Optional[Mapping] = None) -> SD:
    """flax `{"encoder": ..., "decoder": ...}` (+ the `batch_stats`
    collection of a Conformer) -> port `state_dict`."""
    if cfg.encoder_type == "rnn":
        sd = rnn_encoder_state_dict(params["encoder"], cfg.enc_num_layers, "encoder.")
    elif cfg.encoder_type in ("transformer", "conformer"):
        sd = transformer_encoder_state_dict(
            params["encoder"], cfg.enc_num_layers, "encoder.",
            None if batch_stats is None else batch_stats.get("encoder"),
        )
    else:
        raise ValueError(cfg.encoder_type)
    if cfg.decoder_type == "ctc":
        sd.update(ctc_decoder_state_dict(params["decoder"], "decoder."))
    elif cfg.decoder_type == "transformer":
        sd.update(transformer_decoder_state_dict(params["decoder"], cfg.dec_num_layers, "decoder."))
    elif cfg.decoder_type == "rnn_transducer":
        sd.update(rnnt_decoder_state_dict(params["decoder"], cfg.dec_num_layers, "decoder."))
    elif cfg.decoder_type == "las":
        sd.update(las_decoder_state_dict(params["decoder"], cfg.dec_num_layers, "decoder."))
    else:
        raise ValueError(cfg.decoder_type)
    return sd


def _bert_layer(sd: SD, p: str, layer: Mapping) -> None:
    for name in ("query", "key", "value"):
        _dense(sd, f"{p}.attention.self.{name}", layer["self_attn"][name])
    _dense(sd, f"{p}.attention.output.dense", layer["attn_output"])
    _layer_norm(sd, f"{p}.attention.output.LayerNorm", layer["attn_norm"])
    _dense(sd, f"{p}.intermediate.dense", layer["intermediate"])
    _dense(sd, f"{p}.output.dense", layer["output"])
    _layer_norm(sd, f"{p}.output.LayerNorm", layer["output_norm"])


def _bert_stack(sd: SD, p: str, stack: Mapping, num_layers: int) -> None:
    for name in ("word_embeddings", "position_embeddings", "token_type_embeddings"):
        sd[f"{p}embeddings.{name}.weight"] = _t(stack[name]["embedding"])
    _layer_norm(sd, f"{p}embeddings.LayerNorm", stack["emb_norm"])
    if "embeddings_project" in stack:
        _dense(sd, f"{p}embeddings_project", stack["embeddings_project"])
    for i in range(num_layers):
        _bert_layer(sd, f"{p}encoder.layer.{i}", stack[f"layers_{i}"])


def _bert_lm_state_dict(params: Mapping, num_layers: int, top: str) -> SD:
    stack, head = params["stack"], params["head"]
    sd: SD = {}
    _bert_stack(sd, f"{top}bert.", stack, num_layers)
    c = f"{top}cls.predictions."
    _dense(sd, f"{c}transform.dense", head["transform_dense"])
    _layer_norm(sd, f"{c}transform.LayerNorm", head["transform_norm"])
    _dense(sd, f"{c}decoder", head["decoder"])
    sd[f"{c}bias"] = sd[f"{c}decoder.bias"]
    return sd


def lm_state_dict(params: Mapping, lm_cfg) -> SD:
    """flax LM params (the inner module's tree, or the `LM` facade's
    `{"lm": {...}}`) -> the port's inner LM `state_dict`, in emoASR's names:

    - `transformer`: `transformer.bert.*`, `transformer.cls.*`;
    - `bert`: `bert.bert.*`, `bert.cls.*` (the MLM head's bias under both
      names the port's module gives it, `predictions.bias` and
      `predictions.decoder.bias`);
    - `rnn`: `embed.weight`, `rnns.{weight,bias}_{ih,hh}_l{k}` (one
      multi-layer `nn.LSTM`; flax's `rnns/layer{k}`), `output.*`;
    - `electra`, `electra-disc`: `gmodel.electra.*`,
      `gmodel.generator_predictions.{dense,LayerNorm}.*`,
      `gmodel.generator_lm_head.*`, `dmodel.electra.*`,
      `dmodel.discriminator_predictions.{dense,dense_prediction}.*`;
    - `ptransformer`, `pbert`, `pctc`: `encoder.*` (the embed input layer)
      and `decoder.*`, as an ASR model's;
    - `pelectra`, `pelectra-disc`: the P2W generator under `gmodel.` and
      the discriminator under `dmodel.`."""
    params = params.get("lm", params)
    t = lm_cfg.lm_type
    if t in ("transformer", "bert"):
        return _bert_lm_state_dict(params, lm_cfg.num_layers, f"{t}.")
    if t in ("electra", "electra-disc"):
        sd = {}
        _bert_stack(sd, "gmodel.electra.", params["gstack"], lm_cfg.gen_num_layers)
        _dense(sd, "gmodel.generator_predictions.dense", params["ghead"]["dense"])
        _layer_norm(sd, "gmodel.generator_predictions.LayerNorm", params["ghead"]["norm"])
        _dense(sd, "gmodel.generator_lm_head", params["ghead"]["lm_head"])
        sd.update(_discriminator_state_dict(params, lm_cfg))
        return sd
    if t in ("ptransformer", "pbert", "pctc"):
        return _p2w_state_dict(params, lm_cfg, t)
    if t in ("pelectra", "pelectra-disc"):
        sd = {f"gmodel.{k}": v for k, v in _p2w_state_dict(params["gmodel"], lm_cfg, "pbert").items()}
        sd.update(_discriminator_state_dict(params, lm_cfg))
        return sd
    if t == "rnn":
        sd: SD = {"embed.weight": _t(params["embed"]["embedding"])}
        for k in range(lm_cfg.num_layers):
            layer = params["rnns"][f"layer{k}"]
            for name in ("weight_ih", "weight_hh", "bias_ih", "bias_hh"):
                sd[f"rnns.{name}_l{k}"] = _t(layer[name])
        _dense(sd, "output", params["output"])
        return sd
    raise ValueError(f"lm_type={t!r}")


def _discriminator_state_dict(params: Mapping, lm_cfg) -> SD:
    sd: SD = {}
    _bert_stack(sd, "dmodel.electra.", params["dstack"], lm_cfg.disc_num_layers)
    _dense(sd, "dmodel.discriminator_predictions.dense", params["dhead"]["dense"])
    _dense(sd, "dmodel.discriminator_predictions.dense_prediction", params["dhead"]["dense_prediction"])
    return sd


def _p2w_state_dict(params: Mapping, lm_cfg, lm_type: str) -> SD:
    sd = transformer_encoder_state_dict(params["encoder"], lm_cfg.enc_num_layers, "encoder.")
    if lm_type == "pctc":
        sd.update(ctc_decoder_state_dict(params["decoder"], "decoder."))
    else:
        sd.update(transformer_decoder_state_dict(params["decoder"], lm_cfg.dec_num_layers, "decoder."))
    return sd
