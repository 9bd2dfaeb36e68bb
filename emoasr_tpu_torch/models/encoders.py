"""Transformer, Conformer and RNN encoders (PyTorch port of
`emoasr_tpu/models/encoders.py`).

Parity target: emoASR `asr/modeling/encoders/transformer.py:16-113`:
conv2d, embed (the phone encoder of the phone-to-word LMs) or linear input
layer, absolute or relative positional encoding, N
pre-norm encoder layers, final LayerNorm eps=1e-12, optional intermediate tap
for inter-CTC / hierarchical phone CTC.  `cfg.enc_fused_attn` sends every
layer's attention through the fused kernel (ops/attention.py); in a
Conformer layer with relative positions the kernel takes the shifted
position term as its score bias.

`RNNEncoder` (emoASR `asr/modeling/encoders/rnn.py:14-81`): the conv2d (or
no) input layer, then `enc_num_layers` one-layer bidirectional LSTMs
(`ops/lstm.py::BiLSTM`: each direction through `lstm_scan`, the LSTM kernel
on the card for 8 frames or more), the directions summed or concatenated
(`enc_hidden_sum_fwd_bwd`), dropout after every layer; outputs past each
length are zero.
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
from emoasr_tpu_torch.ops.lstm import BiLSTM
from emoasr_tpu_torch.parallel.mesh import dropout


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


class RNNEncoder(nn.Module):
    """Stacked one-layer biLSTMs (`rnns.{i}.*_l0`, `*_l0_reverse`), the
    directions summed or concatenated."""

    def __init__(self, cfg: ExpConfig):
        super().__init__()
        self.cfg = cfg
        if cfg.input_layer == "conv2d":
            self.conv = Conv2dSubsampler(cfg.input_size, cfg.enc_hidden_size)
            in_size = cfg.enc_hidden_size
        elif cfg.input_layer == "none":
            in_size = cfg.input_size
        else:
            raise ValueError(f"the RNN encoder's input_layer is conv2d or none, not {cfg.input_layer!r}")
        if cfg.enc_hidden_sum_fwd_bwd:
            self.hidden = cfg.enc_hidden_size
        else:
            if cfg.enc_hidden_size % 2:
                raise ValueError(f"enc_hidden_size={cfg.enc_hidden_size} must be even to concatenate directions")
            self.hidden = cfg.enc_hidden_size // 2
        layers = []
        for _ in range(cfg.enc_num_layers):
            layers.append(BiLSTM(in_size, self.hidden))
            in_size = self.hidden if cfg.enc_hidden_sum_fwd_bwd else 2 * self.hidden
        self.rnns = nn.ModuleList(layers)

    def forward(self, xs, xlens):
        """(B, T, F), (B,) -> (eouts (B, T', D), elens (B,), None)."""
        cfg = self.cfg
        if cfg.input_layer == "conv2d":
            xs, elens = self.conv(xs, xlens)
        else:
            elens = xlens
        H = self.hidden
        for rnn in self.rnns:
            out = rnn(xs, elens)
            xs = out[..., :H] + out[..., H:] if cfg.enc_hidden_sum_fwd_bwd else out
            xs = dropout(xs, cfg.dropout_enc_rate, self.training)
        return xs, elens, None


def build_encoder(cfg: ExpConfig) -> nn.Module:
    """Encoder factory (`asr/modeling/asr.py:29-34`)."""
    if cfg.encoder_type == "rnn":
        return RNNEncoder(cfg)
    if cfg.encoder_type in ("transformer", "conformer"):
        return TransformerEncoder(cfg, is_conformer=cfg.encoder_type == "conformer")
    raise ValueError(cfg.encoder_type)
