"""K1, the fused CTC vocabulary head (`csrc/ctc_head.cu`): operations and
bytes of one launch of each of its three launchers from the shapes and
the real lengths.

E real frames of width D, a head of V columns, S = 2 U + 1 path columns
of an utterance with U labels, float32.  Forward: the logits E D V
products (2 E D V operations; the normaliser and the gathered path
columns are E V and E S more, left out); reads the frames, the head and
its bias, writes the normaliser (E) and the path columns (E S).  grad-e:
the d-logits times the head, 2 E D V; reads the frames, the head, the
cotangents, writes d frames (E D).  grad-w: frames^T d-logits, 2 E D V;
reads the frames and the cotangents, writes d head (D V) and d bias (V).
The logits that the backward launchers recompute are not counted."""

from typing import Sequence, Tuple

NAMES = [r"ctc_head_fwd_kernel", r"ctc_head_grad_e_kernel", r"ctc_head_grad_w_kernel", r"lse_combine_kernel",
         r"path_first_kernel", r"path_sum_kernel", r"sum_parts_kernel", r"\bsplit_kernel\(float"]
LAUNCHERS = ("emo_ctc_head_fwd_f32", "emo_ctc_head_grad_e_f32", "emo_ctc_head_grad_w_f32")


def fwd(elens: Sequence[int], ylens: Sequence[int], D: int, V: int, elem: int = 4) -> Tuple[float, float]:
    E = float(sum(elens))
    S = sum(e * (2 * u + 1) for e, u in zip(elens, ylens))
    return 2 * E * D * V, (E * D + D * V + V) * elem + (E + S) * 4


def grad_e(elens: Sequence[int], ylens: Sequence[int], D: int, V: int, elem: int = 4) -> Tuple[float, float]:
    E = float(sum(elens))
    S = sum(e * (2 * u + 1) for e, u in zip(elens, ylens))
    return 2 * E * D * V, (2 * E * D + D * V + V) * elem + (E + S) * 4


def grad_w(elens: Sequence[int], ylens: Sequence[int], D: int, V: int, elem: int = 4) -> Tuple[float, float]:
    E = float(sum(elens))
    S = sum(e * (2 * u + 1) for e, u in zip(elens, ylens))
    return 2 * E * D * V, (E * D + D * V + V) * elem + (E + S) * 4
