"""Transformer and Conformer encoders (PyTorch port of
`emoasr_tpu/models/encoders.py::TransformerEncoder`).

Parity target: emoASR `asr/modeling/encoders/transformer.py:16-113`:
conv2d, embed (the phone encoder of the phone-to-word LMs) or linear input
layer, absolute or relative positional encoding, N
pre-norm encoder layers, final LayerNorm eps=1e-12, optional intermediate tap
for inter-CTC / hierarchical phone CTC.  `cfg.enc_fused_attn` sends every
layer's attention through the fused kernel (ops/attention.py); in a
Conformer layer with relative positions the kernel takes the shifted
position term as its score bias.
"""

from __future__ import annotations

from torch import nn

from emoasr_tpu_torch.config import ExpConfig
from emoasr_tpu_torch.models.layers import (
    ConformerEncoderLayer,
    Conv2dSubsampler,
    PositionalEncoder,
    RelPositionalEncoder,
    TransformerEncoderLayer,
    make_pad_mask,
)


class TransformerEncoder(nn.Module):
    """Transformer encoder, also covering Conformer via `is_conformer`."""

    def __init__(self, cfg: ExpConfig, is_conformer: bool = False):
        super().__init__()
        self.cfg = cfg
        self.is_conformer = is_conformer
        self.pos_encode_type = cfg.pos_encode_type if is_conformer else "abs"
        if cfg.input_layer == "conv2d":
            self.conv = Conv2dSubsampler(cfg.input_size, cfg.enc_hidden_size)
        elif cfg.input_layer == "embed":
            self.embed = nn.Embedding(cfg.src_vocab_size, cfg.enc_hidden_size)
        elif cfg.input_layer == "linear":
            self.linear = nn.Linear(cfg.input_size, cfg.enc_hidden_size)
        else:
            raise ValueError(cfg.input_layer)
        PE = PositionalEncoder if self.pos_encode_type == "abs" else RelPositionalEncoder
        self.pe = PE(cfg.enc_hidden_size, cfg.dropout_enc_rate)
        kw = dict(
            num_heads=cfg.enc_num_attention_heads,
            hidden_size=cfg.enc_hidden_size,
            intermediate_size=cfg.enc_intermediate_size,
            dropout_rate=cfg.dropout_enc_rate,
            dropout_attn_rate=cfg.dropout_attn_rate,
            fused_attn=cfg.enc_fused_attn,
        )
        if is_conformer:
            kw.update(pos_encode_type=self.pos_encode_type, conv_kernel_size=cfg.conv_kernel_size)
        Layer = ConformerEncoderLayer if is_conformer else TransformerEncoderLayer
        self.transformers = nn.ModuleList(Layer(**kw) for _ in range(cfg.enc_num_layers))
        self.norm = nn.LayerNorm(cfg.enc_hidden_size, eps=1e-12)

    def forward(self, xs, xlens):
        """(B, T, F) features (or (B, T) token ids with the embed input
        layer), (B,) -> (eouts (B, T', D), elens (B,), eouts_inter)."""
        cfg = self.cfg
        if cfg.input_layer == "conv2d":
            xs, elens = self.conv(xs, xlens)
        elif cfg.input_layer == "embed":
            xs, elens = self.embed(xs.long()), xlens
        else:
            xs, elens = self.linear(xs), xlens
        mask = make_pad_mask(elens, xs.shape[1])[:, None, None, :]  # (B,1,1,T)
        if self.pos_encode_type == "abs":
            xs, pos_emb = self.pe(xs), None
        else:
            xs, pos_emb = self.pe(xs)
        inter_layer_id = cfg.inter_ctc_layer_id if (
            cfg.mtl_inter_ctc_weight > 0 or cfg.mtl_phone_ctc_weight > 0
        ) else 0
        lens = elens if cfg.enc_fused_attn else None
        eouts_inter = None
        for layer_id, layer in enumerate(self.transformers):
            if self.is_conformer:
                xs = layer(xs, mask, pos_emb, lens=lens)
            else:
                xs = layer(xs, mask, lens=lens)
            if (layer_id + 1) == inter_layer_id:
                # intermediate branches also get the pre-norm normalization
                eouts_inter = self.norm(xs)
        return self.norm(xs), elens, eouts_inter


def build_encoder(cfg: ExpConfig) -> nn.Module:
    """Encoder factory (`asr/modeling/asr.py:29-34`)."""
    if cfg.encoder_type in ("transformer", "conformer"):
        return TransformerEncoder(cfg, is_conformer=cfg.encoder_type == "conformer")
    raise NotImplementedError(
        f"encoder_type={cfg.encoder_type!r}: the RNN encoder comes with slice 5 (ROADMAP.md §1)"
    )
