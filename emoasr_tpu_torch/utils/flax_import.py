"""Carry the JAX package's flax parameters into the port's `state_dict`.

`asr_state_dict(params, cfg)` is the inverse of
`emoasr_tpu/utils/torch_import.py::asr_model` for the models ported so far
(Transformer encoder with the conv2d or linear input layer, CTC decoder
with its optional phone head).  It takes the flax parameter tree as nested
dicts of numpy arrays and needs neither JAX nor flax.  A flax gradient tree
has the parameters' structure, so it maps the same way and gradients can be
compared name by name:

- a Dense `kernel` (in, out) becomes `weight` = kernel.T;
- a Conv `kernel` (kh, kw, in, out) becomes `weight` (out, in, kh, kw);
- a LayerNorm `scale`/`bias` becomes `weight`/`bias`.
"""

from __future__ import annotations

from typing import Dict, Mapping

import numpy as np
import torch

SD = Dict[str, torch.Tensor]


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(np.asarray(a)))


def _dense(sd: SD, p: str, tree: Mapping) -> None:
    sd[f"{p}.weight"] = _t(np.asarray(tree["kernel"]).T)
    sd[f"{p}.bias"] = _t(tree["bias"])


def _conv2d(sd: SD, p: str, tree: Mapping) -> None:
    sd[f"{p}.weight"] = _t(np.asarray(tree["kernel"]).transpose(3, 2, 0, 1))
    sd[f"{p}.bias"] = _t(tree["bias"])


def _layer_norm(sd: SD, p: str, tree: Mapping) -> None:
    sd[f"{p}.weight"] = _t(tree["scale"])
    sd[f"{p}.bias"] = _t(tree["bias"])


def transformer_encoder_state_dict(enc: Mapping, num_layers: int, prefix: str = "") -> SD:
    sd: SD = {}
    if "conv" in enc:
        conv = enc["conv"]
        _conv2d(sd, f"{prefix}conv.conv.0", conv["conv1"])
        _conv2d(sd, f"{prefix}conv.conv.2", conv["conv2"])
        _dense(sd, f"{prefix}conv.output", conv["output"])
    else:
        _dense(sd, f"{prefix}linear", enc["linear"])
    for i in range(num_layers):
        lp, layer = f"{prefix}transformers.{i}", enc[f"layers_{i}"]
        _layer_norm(sd, f"{lp}.norm1", layer["norm1"])
        _layer_norm(sd, f"{lp}.norm2", layer["norm2"])
        for name in ("linear_q", "linear_k", "linear_v", "linear_out"):
            _dense(sd, f"{lp}.self_attn.{name}", layer["self_attn"][name])
        _dense(sd, f"{lp}.feed_forward.w1", layer["feed_forward"]["w1"])
        _dense(sd, f"{lp}.feed_forward.w2", layer["feed_forward"]["w2"])
    _layer_norm(sd, f"{prefix}norm", enc["norm"])
    return sd


def asr_state_dict(params: Mapping, cfg) -> SD:
    """flax `{"encoder": ..., "decoder": ...}` -> port `state_dict`."""
    if cfg.encoder_type != "transformer" or cfg.input_layer not in ("conv2d", "linear"):
        raise NotImplementedError(
            f"encoder {cfg.encoder_type}/{cfg.input_layer} is not ported yet (ROADMAP.md §1)"
        )
    if cfg.decoder_type != "ctc":
        raise NotImplementedError(
            f"decoder_type={cfg.decoder_type!r} is not ported yet (ROADMAP.md §1)"
        )
    sd = transformer_encoder_state_dict(params["encoder"], cfg.enc_num_layers, "encoder.")
    _dense(sd, "decoder.output", params["decoder"]["output"])
    if "phone_output" in params["decoder"]:
        _dense(sd, "decoder.phone_output", params["decoder"]["phone_output"])
    return sd
