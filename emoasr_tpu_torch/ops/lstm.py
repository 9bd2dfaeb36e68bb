"""LSTM layers over precomputed input projections (PyTorch port of
`emoasr_tpu/ops/lstm.py`).

Replaces cuDNN `nn.LSTM` in emoASR's prediction network
(`asr/modeling/decoders/rnn_transducer.py:45-52`) and RNN encoder
(`asr/modeling/encoders/rnn.py:43-50`).  The input projection x @ W_ih^T
for all time steps is one matrix product; the recurrence carries only the
(B, H) state.  Gate order is torch's (i, f, g, o) and the weights keep
`nn.LSTM`'s (4H, in) layout and `*_l{k}` names, so emoASR checkpoints load
as they are: `StackedLSTM` is the RNN-T prediction network's `ModuleList`
of one-layer LSTMs (`rnns.{i}.weight_ih_l0`), `MultiLayerLSTM` the RNN LM's
one multi-layer `nn.LSTM` (`rnns.weight_ih_l{k}`).

`lstm_scan` dispatches as the JAX package does on a TPU: a CUDA tensor
with at least `_PALLAS_MIN_STEPS` steps goes to the fused recurrence
kernel (`ops/lstm_scan.py`, K8: one launch forward, one backward, in
float32 or bfloat16); shorter sequences, the decoders' one-token steps
among them, and CPU tensors take the plain scan, one product and the gate
math a step, in the activations' dtype as the JAX scan computes.

The bidirectional layer reverses each utterance's valid prefix (in place of
`pack_padded_sequence`) and zeroes outputs past each length, as
`pad_packed_sequence` does.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
from torch import nn

from emoasr_tpu_torch.ops.lstm_scan import lstm_scan_fused
from emoasr_tpu_torch.parallel.mesh import dropout

_PALLAS_MIN_STEPS = 8  # the JAX package's threshold for the fused kernel


def lstm_scan_plain(
    x_proj: torch.Tensor, w_hh: torch.Tensor, h0: torch.Tensor, c0: torch.Tensor
) -> Tuple[torch.Tensor, Tuple[torch.Tensor, torch.Tensor]]:
    """The recurrence a step at a time (autograd through every step)."""
    h, c = h0, c0
    w_t = w_hh.t()
    ys = []
    for t in range(x_proj.shape[1]):
        gates = x_proj[:, t] + h @ w_t  # (B, 4H); two roundings in bf16, as the JAX scan
        i, f, g, o = gates.chunk(4, dim=-1)
        c = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(g)
        h = torch.sigmoid(o) * torch.tanh(c)
        ys.append(h)
    return torch.stack(ys, dim=1), (h, c)


def lstm_scan(
    x_proj: torch.Tensor, w_hh: torch.Tensor, h0: torch.Tensor, c0: torch.Tensor
) -> Tuple[torch.Tensor, Tuple[torch.Tensor, torch.Tensor]]:
    """x_proj (B, T, 4H) = x @ W_ih^T + b_ih + b_hh, w_hh (4H, H), h0 and
    c0 (B, H) -> (ys (B, T, H), (h_T, c_T))."""
    if x_proj.device.type == "cuda" and x_proj.shape[1] >= _PALLAS_MIN_STEPS:
        return lstm_scan_fused(x_proj, w_hh, h0, c0)
    return lstm_scan_plain(x_proj, w_hh, h0, c0)


def reverse_by_length(x: torch.Tensor, lens: torch.Tensor) -> torch.Tensor:
    """Reverse the valid prefix of axis 1; padding stays in place (callers
    mask it)."""
    T = x.shape[1]
    ar = torch.arange(T, device=x.device)[None, :]
    lens = lens.to(x.device)[:, None]
    idx = torch.where(ar < lens, lens - 1 - ar, ar)
    idx = idx.reshape(idx.shape + (1,) * (x.dim() - 2)).expand(x.shape)
    return torch.gather(x, 1, idx.long())


def _init_uniform(params, hidden_size: int) -> None:
    k = 1.0 / hidden_size ** 0.5  # nn.LSTM's default: U(-1/sqrt(H), 1/sqrt(H))
    for p in params:
        nn.init.uniform_(p, -k, k)


def _lstm_params(module: nn.Module, input_size: int, hidden_size: int, suffix: str) -> None:
    H = hidden_size
    for name, shape in (("weight_ih", (4 * H, input_size)), ("weight_hh", (4 * H, H)),
                        ("bias_ih", (4 * H,)), ("bias_hh", (4 * H,))):
        module.register_parameter(f"{name}{suffix}", nn.Parameter(torch.empty(shape)))
    _init_uniform([getattr(module, f"{n}{suffix}") for n in ("weight_ih", "weight_hh", "bias_ih", "bias_hh")], H)


def _run(module: nn.Module, suffix: str, xs: torch.Tensor, state):
    H = module.hidden_size
    w_ih, w_hh = getattr(module, f"weight_ih{suffix}"), getattr(module, f"weight_hh{suffix}")
    # x W_ih^T + b_ih + b_hh, rounded after each term in bf16 as in the JAX package
    x_proj = xs @ w_ih.t() + getattr(module, f"bias_ih{suffix}") + getattr(module, f"bias_hh{suffix}")
    if state is None:
        zeros = xs.new_zeros((xs.shape[0], H))
        state = (zeros, zeros)
    return lstm_scan(x_proj, w_hh, *state)


class UniLSTM(nn.Module):
    """Single-direction, single-layer LSTM with `nn.LSTM`'s parameter names
    (`weight_ih_l0`, `weight_hh_l0`, `bias_ih_l0`, `bias_hh_l0`)."""

    def __init__(self, input_size: int, hidden_size: int):
        super().__init__()
        self.hidden_size = hidden_size
        _lstm_params(self, input_size, hidden_size, "_l0")

    def forward(self, xs: torch.Tensor, state: Optional[Tuple[torch.Tensor, torch.Tensor]] = None):
        """xs (B, T, in), state (h0, c0) or None -> (ys (B, T, H), (h_T, c_T))."""
        return _run(self, "_l0", xs, state)


class BiLSTM(nn.Module):
    """Bidirectional single-layer LSTM with `nn.LSTM(bidirectional=True)`'s
    parameter names (`*_l0` forward, `*_l0_reverse` backward); output is
    forward and backward concatenated (B, T, 2H), zero past `lens`."""

    def __init__(self, input_size: int, hidden_size: int):
        super().__init__()
        self.hidden_size = hidden_size
        _lstm_params(self, input_size, hidden_size, "_l0")
        _lstm_params(self, input_size, hidden_size, "_l0_reverse")

    def forward(self, xs: torch.Tensor, lens: torch.Tensor) -> torch.Tensor:
        fwd, _ = _run(self, "_l0", xs, None)
        bwd_rev, _ = _run(self, "_l0_reverse", reverse_by_length(xs, lens), None)
        out = torch.cat([fwd, reverse_by_length(bwd_rev, lens)], dim=-1)
        mask = (torch.arange(xs.shape[1], device=xs.device)[None, :] < lens.to(xs.device)[:, None])[:, :, None]
        return torch.where(mask, out, torch.zeros_like(out))


class StackedLSTM(nn.ModuleList):
    """Unidirectional LSTM layers, each its own `UniLSTM` under its index
    (emoASR's `nn.ModuleList` of one-layer `nn.LSTM`s: `rnns.{i}.*_l0`),
    with per-layer state threading and dropout between layers."""

    def __init__(self, input_size: int, hidden_size: int, num_layers: int, dropout_rate: float = 0.0):
        super().__init__(
            [UniLSTM(input_size if i == 0 else hidden_size, hidden_size) for i in range(num_layers)]
        )
        self.dropout_rate = dropout_rate  # a float, not a child: children are the layers

    def forward(self, xs: torch.Tensor, states: Optional[torch.Tensor] = None):
        """states (layers, 2, B, H) or None -> (ys, new states (layers, 2, B, H))."""
        new_states = []
        h = xs
        n = len(self)
        for li, layer in enumerate(self):
            st = None if states is None else (states[li, 0], states[li, 1])
            h, (hn, cn) = layer(h, st)
            new_states.append(torch.stack([hn, cn]))
            if li < n - 1:
                h = dropout(h, self.dropout_rate, self.training)
        return h, torch.stack(new_states)


class MultiLayerLSTM(nn.Module):
    """One multi-layer unidirectional LSTM with `nn.LSTM(num_layers=N)`'s
    parameter names (layer k: `weight_ih_l{k}`, `weight_hh_l{k}`,
    `bias_ih_l{k}`, `bias_hh_l{k}`), the RNN LM's `rnns`
    (`lm/modeling/rnn.py:13-86`): each layer through `lstm_scan`, states
    threaded per layer, dropout between layers (the JAX package's
    `StackedLSTM` with layers named `layer{k}`)."""

    def __init__(self, input_size: int, hidden_size: int, num_layers: int, dropout_rate: float = 0.0):
        super().__init__()
        self.hidden_size = hidden_size
        self.num_layers = num_layers
        self.dropout_rate = dropout_rate
        for k in range(num_layers):
            _lstm_params(self, input_size if k == 0 else hidden_size, hidden_size, f"_l{k}")

    def forward(self, xs: torch.Tensor, states: Optional[torch.Tensor] = None):
        """xs (B, T, in), states (layers, 2, B, H) or None -> (ys (B, T, H),
        new states (layers, 2, B, H))."""
        new_states = []
        h = xs
        for k in range(self.num_layers):
            st = None if states is None else (states[k, 0], states[k, 1])
            h, (hn, cn) = _run(self, f"_l{k}", h, st)
            new_states.append(torch.stack([hn, cn]))
            if k < self.num_layers - 1:
                h = dropout(h, self.dropout_rate, self.training)
        return h, torch.stack(new_states)
