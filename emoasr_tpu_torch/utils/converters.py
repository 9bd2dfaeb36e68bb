"""Token conversion helpers (copy of the decode-side part and `get_utt_id_nosp` of
`emoasr_tpu/utils/converters.py`; parity target
emoASR `utils/converters.py:5-48`)."""

from __future__ import annotations

from typing import List, Sequence


def str2ints(s: str) -> List[int]:
    return list(map(int, s.split()))


def ints2str(ints: Sequence[int]) -> str:
    return " ".join(map(str, ints))


def get_utt_id_nosp(utt_id: str) -> str:
    """Strip a speed-perturbation prefix (`sp0.9-`, `sp1.0-`, `sp1.1-`)."""
    if utt_id.startswith(("sp0.9", "sp1.0", "sp1.1")):
        return "-".join(utt_id.split("-")[1:])
    return utt_id


def strip_eos(tokens: Sequence[int], eos_id: int) -> List[int]:
    return [t for t in tokens if t != eos_id]
