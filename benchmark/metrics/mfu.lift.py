"""The traced lift job's counted work (encoder FLOPs at the bf16 peak, B1, B2, B3 operations at their precision's) as a share of the card's peak over the job's wall time."""

from benchmark import harness

LAYER = "whole step"
UNIT = "%"
SOURCE = "device_trace"
MOVES = "lift_views_per_s"


def read(ctx):
    return harness.mfu_pct(ctx, "lift")
