"""Transformer encoder (PyTorch port of the Transformer branch of
`emoasr_tpu/models/encoders.py`).

Parity target: emoASR `asr/modeling/encoders/transformer.py:16-113`:
conv2d or linear input layer, absolute positional encoding, N pre-norm encoder
layers, final LayerNorm eps=1e-12, optional intermediate tap for
inter-CTC / hierarchical phone CTC.  `cfg.enc_fused_attn` sends every
layer's attention through the fused kernel (ops/attention.py).
"""

from __future__ import annotations

from torch import nn

from emoasr_tpu_torch.config import ExpConfig
from emoasr_tpu_torch.models.layers import (
    Conv2dSubsampler,
    PositionalEncoder,
    TransformerEncoderLayer,
    make_pad_mask,
)


class TransformerEncoder(nn.Module):
    def __init__(self, cfg: ExpConfig):
        super().__init__()
        if cfg.encoder_type != "transformer":
            raise NotImplementedError(
                f"encoder_type={cfg.encoder_type!r}: the Conformer and RNN "
                "encoders come in later slices (ROADMAP.md §1)"
            )
        self.cfg = cfg
        if cfg.input_layer == "conv2d":
            self.conv = Conv2dSubsampler(cfg.input_size, cfg.enc_hidden_size)
        elif cfg.input_layer == "linear":
            self.linear = nn.Linear(cfg.input_size, cfg.enc_hidden_size)
        else:
            raise NotImplementedError(
                f"input_layer={cfg.input_layer!r}: conv2d and linear are ported; "
                "embed comes with the LM slices (ROADMAP.md §1)"
            )
        self.pe = PositionalEncoder(cfg.enc_hidden_size, cfg.dropout_enc_rate)
        self.transformers = nn.ModuleList(
            TransformerEncoderLayer(
                cfg.enc_num_attention_heads,
                cfg.enc_hidden_size,
                cfg.enc_intermediate_size,
                cfg.dropout_enc_rate,
                cfg.dropout_attn_rate,
                fused_attn=cfg.enc_fused_attn,
            )
            for _ in range(cfg.enc_num_layers)
        )
        self.norm = nn.LayerNorm(cfg.enc_hidden_size, eps=1e-12)

    def forward(self, xs, xlens):
        """(B, T, F), (B,) -> (eouts (B, T', D), elens (B,), eouts_inter)."""
        cfg = self.cfg
        if cfg.input_layer == "conv2d":
            xs, elens = self.conv(xs, xlens)
        else:
            xs, elens = self.linear(xs), xlens
        mask = make_pad_mask(elens, xs.shape[1])[:, None, None, :]  # (B,1,1,T)
        xs = self.pe(xs)
        inter_layer_id = cfg.inter_ctc_layer_id if (
            cfg.mtl_inter_ctc_weight > 0 or cfg.mtl_phone_ctc_weight > 0
        ) else 0
        lens = elens if cfg.enc_fused_attn else None
        eouts_inter = None
        for layer_id, layer in enumerate(self.transformers):
            xs = layer(xs, mask, lens=lens)
            if (layer_id + 1) == inter_layer_id:
                # intermediate branches also get the pre-norm normalization
                eouts_inter = self.norm(xs)
        return self.norm(xs), elens, eouts_inter
