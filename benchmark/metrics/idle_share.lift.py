"""Share of the traced lift job in which the device ran nothing."""

from benchmark import harness

LAYER = "device"
UNIT = "%"
SOURCE = "device_trace"
MOVES = "lift_views_per_s"


def read(ctx):
    return harness.idle_pct(ctx, "lift")
