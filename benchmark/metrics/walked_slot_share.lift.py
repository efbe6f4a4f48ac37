"""Share of the padded slots that B2 writes (and B3 reads) which lie before their tile's early exit: 100 x `walked_slots` / `slots` of the program's `raster/kernels.py::WORK` over the run; every other slot is a zero row."""

import sys

LAYER = "kernels"
UNIT = "%"
SOURCE = "program_counter"
MOVES = "lift_views_per_s"


def read(ctx):
    work = getattr(sys.modules.get("tpugs_torch.raster.kernels"), "WORK", None)
    if ctx["path"] != "lift" or work is None:
        return None
    counts = work.snapshot()
    return 100.0 * counts["walked_slots"] / counts["slots"] if counts["slots"] else None
