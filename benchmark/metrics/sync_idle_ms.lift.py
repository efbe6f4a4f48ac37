"""Device idle milliseconds per view in the gaps held by a `tpugs.sync.*` span, a host read of the device: between the launches on either side of the gap the host passed through the span, so the device drained while it waited (`benchmark/spans.py`, on the host's clock alone)."""

from benchmark import spans

LAYER = "device"
UNIT = "ms"
SOURCE = "program_span"
MOVES = "lift_views_per_s"


def read(ctx):
    return spans.sync_idle_ms_per_view(ctx["events"])
