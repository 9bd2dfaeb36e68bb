"""Model operations of one batch's forward, from the configuration and the
real lengths (2 operations a multiply-add): the utilisation yardstick.

Counted: the subsampler's two convolutions and its linear layer, every
encoder layer's linears, the attention's score and value products (the
relative-position term's product and projection too), the Conformer's
convolution module, the CTC head, or the prediction network's LSTM, the
joint's two projections and its whole (frames x labels+1) output layer.
Elementwise work, norms and the lattices are left out.  A training step
is 3 forward passes; nothing recomputed is counted."""

from __future__ import annotations

from typing import Sequence


def subsampled(xlen: int) -> int:
    return ((xlen - 1) // 2 - 1) // 2


def encoder_forward(cfg: dict, xlen: int) -> float:
    d, f, L = cfg["enc_hidden_size"], cfg["enc_intermediate_size"], cfg["enc_num_layers"]
    fd = cfg["feat_dim"]
    t1, f1 = (xlen - 3) // 2 + 1, (fd - 3) // 2 + 1
    t2, f2 = (t1 - 3) // 2 + 1, (f1 - 3) // 2 + 1
    ops = 2.0 * 9 * d * t1 * f1 + 2.0 * 9 * d * d * t2 * f2 + 2.0 * d * f2 * d * t2
    T = t2
    per = 2.0 * 4 * d * d * T + 2.0 * 2 * T * T * d  # q, k, v, out; scores and values
    if cfg["encoder_type"] == "conformer":
        per += 2 * 2.0 * 2 * d * f * T  # two half-step feed-forwards
        per += 2.0 * (2 * T - 1) * d * d + 2.0 * T * (2 * T - 1) * d  # position projection and term
        per += 2.0 * d * 2 * d * T + 2.0 * d * cfg["conv_kernel_size"] * T + 2.0 * d * d * T  # conv module
    else:
        per += 2.0 * 2 * d * f * T
    return ops + L * per


def head_forward(cfg: dict, elen: int, ylen: int) -> float:
    d, V = cfg["enc_hidden_size"], cfg["vocab_size"]
    if cfg["decoder_type"] == "ctc":
        return 2.0 * d * V * elen
    if cfg["decoder_type"] == "rnn_transducer":
        e, h, j = cfg["embedding_size"], cfg["dec_hidden_size"], cfg["joint_hidden_size"]
        u1 = ylen + 1
        return (2.0 * (e + h) * 4 * h * u1 + 2.0 * d * j * elen + 2.0 * h * j * u1
                + 2.0 * j * V * elen * u1)
    raise ValueError(cfg["decoder_type"])


def batch_forward(cfg: dict, xlens: Sequence[int], ylens: Sequence[int]) -> float:
    return sum(encoder_forward(cfg, int(x)) + head_forward(cfg, subsampled(int(x)), int(y))
               for x, y in zip(xlens, ylens))


def decode_forward(cfg: dict, xlens: Sequence[int]) -> float:
    """Greedy CTC decoding: the encoder and the head over the frames."""
    return sum(encoder_forward(cfg, int(x)) + 2.0 * cfg["enc_hidden_size"] * cfg["vocab_size"] * subsampled(int(x))
               for x in xlens)
