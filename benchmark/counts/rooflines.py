"""The least time of each measured kernel's work on the card, from the
pairs and rows that the reference counts on the traced inputs (never from
the program's outputs), at the published peaks of one H100 SXM (NVIDIA's
data sheet, dense, at the 700 W limit; ``utils/profiling.py::PEAKS_H100``
and ``chip_smoke.py::bound`` hold the same figures and arithmetic).

A kernel's least time is the larger of its operations at the peak of its
precision and its bytes at the memory's rate, each input byte read once
and each output byte written once. The bases follow ``PERF.md`` §6:

* B1 render: 30 f32 operations a nonzero-alpha pair;
* B2 adjoint: 2 (D + 1) operations a weighted pair in bf16; the features
  read, and for each weighted (tile, Gaussian) pair its geometry read
  and its (D + 1)-wide bf16 row written;
* B3 reduce: those rows read, one f32 row of sums written per Gaussian
  with a weight.

Pairs count only up to each pixel's own exit (its transmittance before
the pair above the threshold), so a kernel that walks past it is charged
for work the image does not need.
"""

from __future__ import annotations

PEAKS = {"bf16": 989e12, "f32": 67e12, "bytes": 3.35e12}
PAIR_OPS = 30
GEOMETRY_BYTES = 24  # mean, conic, opacity in f32


def least_s(bytes_: float, ops: float, precision: str) -> float:
    return max(bytes_ / PEAKS["bytes"], ops / PEAKS[precision])


def compute_s(ops: float, precision: str) -> float:
    return ops / PEAKS[precision]


def render(c: dict) -> float:
    return least_s(c["isects"] * (GEOMETRY_BYTES + 16) + c["pixels"] * 20,
                   PAIR_OPS * c["nonzero"], "f32")


def adjoint(c: dict, D: int) -> float:
    return least_s(c["pixels"] * D * 2 + c["isects"] * (GEOMETRY_BYTES + (D + 1) * 2),
                   2 * (D + 1) * c["weighted"], "bf16")


def reduce(c: dict, D: int) -> float:
    return least_s(c["isects"] * (D + 1) * 2 + c["gaussians"] * (D + 1) * 4,
                   c["isects"] * (D + 1), "f32")


def kernel_compute_s(c: dict, D: int) -> float:
    """The least compute time of the counted kernel work of the lift's
    views, at each kernel's precision (B1, B2, B3: the numerator of
    ``mfu`` beside the encoder's)."""
    return (compute_s(PAIR_OPS * c["nonzero"], "f32")
            + compute_s(2 * (D + 1) * c["weighted"], "bf16")
            + compute_s(c["isects"] * (D + 1), "f32"))
