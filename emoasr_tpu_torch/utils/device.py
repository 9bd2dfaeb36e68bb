"""Device selection and matmul precision for the port's entry points.

The port runs on the card unless the caller asks for the CPU.  There is no
silent fallback: asking for CUDA where there is none raises.
"""

from __future__ import annotations

from typing import Optional, Union

import torch


def resolve_device(device: Optional[Union[str, torch.device]] = None) -> torch.device:
    """`None` means the card (`cuda`); `"cpu"` must be asked for."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available: the port runs on the GPU by default; "
            "pass --cpu (or device='cpu') to run on the CPU"
        )
    return dev


def set_matmul_precision(compute_dtype: str = "float32") -> bool:
    """Set both TF32 switches in one place; returns whether TF32 is on.

    PyTorch's defaults differ (float32 matrix products run in full float32,
    float32 convolutions go through cuDNN in TF32, about three decimal
    digits).  While `compute_dtype` is float32 both are off, so the card
    computes what the CPU and the float32 checks compute; a half
    `compute_dtype` has given up those digits already and lets the float32
    remainder use TF32.  Every entry point calls this before it builds its
    model."""
    allow = compute_dtype != "float32"
    torch.backends.cuda.matmul.allow_tf32 = allow
    torch.backends.cudnn.allow_tf32 = allow
    return allow
