"""B3's share of its roofline in the lift (`counts/rooflines.py::reduce`)."""

from benchmark import harness

LAYER = "kernels"
UNIT = "%"
SOURCE = "device_trace"
MOVES = "lift_views_per_s"


def read(ctx):
    return harness.roofline_pct(ctx, "lift", "reduce")
