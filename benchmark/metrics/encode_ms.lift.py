"""Milliseconds per view in the encoder (`encoders/lseg.py`, `dino.py`, `vit.py`): the program's "encode" stage events through the window."""

from benchmark import harness

LAYER = "encoders"
UNIT = "ms"
SOURCE = "program_span"
MOVES = "lift_views_per_s"


def read(ctx):
    return harness.stage_ms_per_unit(ctx, "lift", ("encode",))
