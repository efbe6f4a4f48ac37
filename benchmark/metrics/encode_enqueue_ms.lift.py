"""Median host milliseconds of the program's `tpugs.lift.encode` span (from `tiles_to_image` to the features' cast: the encoder's enqueue, which the device may outrun) over the run's views with no profiler recording, as the program times them (`utils/profiling.py::HOST_TIMES`); a profiler's own cost per operation would swell them."""

import sys

LAYER = "encoders"
UNIT = "ms"
SOURCE = "program_span"
MOVES = "lift_views_per_s"


def read(ctx):
    times = getattr(sys.modules.get("tpugs_torch.utils.profiling"), "HOST_TIMES", None)
    if ctx["path"] != "lift" or times is None:
        return None
    return times.median_ms("tpugs.lift.encode")
