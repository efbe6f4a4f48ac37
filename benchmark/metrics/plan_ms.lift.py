"""Device milliseconds per view of the work launched under the program's `tpugs.lift.plan` span: the plan (`raster/plan.py`), its child spans `tpugs.plan.*` and syncs included (`benchmark/spans.py`)."""

from benchmark import spans

LAYER = "raster glue"
UNIT = "ms"
SOURCE = "program_span"
MOVES = "lift_views_per_s"


def read(ctx):
    return spans.device_ms_per_view(ctx["events"], "tpugs.lift.plan")
