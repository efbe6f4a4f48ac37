"""Device milliseconds per view of the work launched under the program's `tpugs.lift.accumulate` span: `backproject_views`' weighting and `num += fs; den += ws` (`benchmark/spans.py`)."""

from benchmark import spans

LAYER = "lift entry"
UNIT = "ms"
SOURCE = "program_span"
MOVES = "lift_views_per_s"


def read(ctx):
    return spans.device_ms_per_view(ctx["events"], "tpugs.lift.accumulate")
