"""K7, the fused RNN-T joint (`csrc/rnnt_joint.cu`, forward): operations
and bytes of one launch from the shapes and the real lengths.

An utterance of E real frames and U labels has E (U + 1) cells; a cell
is z = tanh(h_enc + h_dec) of width J, its V logits (2 J V operations),
their log-sum-exp, and the blank and label log-probabilities.  Reads
h_enc (E J), h_dec ((U + 1) J), the output weights (J V) and bias (V);
writes a blank value a cell and a label value for the cells u < U,
float32."""

from typing import Sequence, Tuple

NAMES = [r"rnnt_joint_kernel", r"split_w_kernel"]
LAUNCHERS = ("emo_rnnt_joint_f32",)


def fwd(elens: Sequence[int], ylens: Sequence[int], J: int, V: int, elem: int = 4) -> Tuple[float, float]:
    cells = sum(float(e) * (u + 1) for e, u in zip(elens, ylens))
    label = sum(float(e) * u for e, u in zip(elens, ylens))
    reads = (sum(elens) * J + sum(u + 1 for u in ylens) * J + J * V + V) * elem
    return 2.0 * J * V * cells, reads + (cells + label) * 4
