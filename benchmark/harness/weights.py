"""Weights from the seed, made on the device in one draw.

Both sides get the same tensors: the program's model has them copied into
its parameters, the reference builds its modules around them.  A
parameter's values depend only on its name, its shape and the seed: the
names are sorted, one standard normal vector of their total size is drawn
from a `torch.Generator` on the device, and each name takes its slice,
scaled by the rule below.

- LayerNorm and BatchNorm scales (a `norm` in the name, ending `weight`): 1;
  their shifts: 0.
- Other biases (names ending `bias`, LSTM `bias_ih_*` / `bias_hh_*`):
  N(0, 0.02^2); the vocabulary head's blank column gets `blank_bias` added,
  so that blank wins most frames, as it does in a trained CTC or
  transducer model.
- `pos_bias_u` / `pos_bias_v`: N(0, 0.1^2); embeddings: N(0, 1).
- Every other tensor: N(0, 1 / fan_in), fan_in the product of all but its
  first dimension (a linear's inputs, a convolution's inputs times its
  kernel).
"""

from __future__ import annotations

from typing import Dict, Iterable, Tuple

import torch

HEAD_BIAS = ("decoder.output.bias",)


def _rule(name: str, shape: Tuple[int, ...]) -> Tuple[float, float]:
    """(scale, shift) of the standard normal draw for one tensor."""
    leaf = name.rsplit(".", 1)[-1]
    if "norm" in name and leaf in ("weight", "bias"):
        return 0.0, 1.0 if leaf == "weight" else 0.0
    if leaf == "bias" or leaf.startswith(("bias_ih", "bias_hh")):
        return 0.02, 0.0
    if leaf in ("pos_bias_u", "pos_bias_v"):
        return 0.1, 0.0
    if "embed" in name:
        return 1.0, 0.0
    fan_in = 1
    for s in shape[1:]:
        fan_in *= int(s)
    return fan_in ** -0.5, 0.0


def make_weights(shapes: Iterable[Tuple[str, Tuple[int, ...]]], seed: int, device,
                 blank_id: int = 0, blank_bias: float = 0.0) -> Dict[str, torch.Tensor]:
    """{name: float32 tensor on `device`} for `shapes` ((name, shape) pairs)."""
    shapes = sorted((n, tuple(int(s) for s in shp)) for n, shp in shapes)
    sizes = [max(1, torch.Size(s).numel()) if s else 1 for _, s in shapes]
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed) % (2 ** 63))
    flat = torch.randn(sum(sizes), generator=gen, device=device, dtype=torch.float32)
    out, pos = {}, 0
    for (name, shp), n in zip(shapes, sizes):
        scale, shift = _rule(name, shp)
        t = flat[pos:pos + n].view(shp) * scale + shift
        if name in HEAD_BIAS and blank_bias:
            t[blank_id] += blank_bias
        out[name] = t
        pos += n
    return out


def load_into(model: torch.nn.Module, weights: Dict[str, torch.Tensor]) -> None:
    """Copy `weights` into `model`'s parameters of the same names; every
    parameter must have one."""
    params = dict(model.named_parameters())
    missing = set(params) - set(weights)
    if missing:
        raise KeyError(f"no weights for {sorted(missing)[:5]}")
    with torch.no_grad():
        for name, p in params.items():
            p.copy_(weights[name])
