"""Milliseconds per view in the raster glue (`raster/projection.py`, `sh.py`, `plan.py`, `pack.py`): the "project+sh", "plan" and "pack" stage events; project+sh also holds the add of the previous view's sums."""

from benchmark import harness

LAYER = "raster glue"
UNIT = "ms"
SOURCE = "program_span"
MOVES = "lift_views_per_s"


def read(ctx):
    return harness.stage_ms_per_unit(ctx, "lift", ("project+sh", "plan", "pack"))
