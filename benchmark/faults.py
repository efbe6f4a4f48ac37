"""Faults planted under the timed path, to show that the check catches
them: each replaces one function of the program for the length of a
``with planted(name):`` block. Used by the tests at a tiny size; the
benchmark's runs never plant one."""

from __future__ import annotations

import contextlib
import importlib


def _sums_off(orig):
    def fn(*a, **k):
        rows, sums = orig(*a, **k)
        return rows, sums * 1.05
    return fn


def _half_the_views(orig):
    def fn(scene, viewmats, Ks, *a, **k):
        return tuple(2 * t for t in orig(scene, viewmats[::2], Ks[::2], *a, **k))
    return fn


# name -> (module, function name, replacement)
FAULTS = {
    # an answer altered where it is produced: B3's sums of every view 5% off
    "answer_altered": ("tpugs_torch.lift.batch", "contribution_sums", _sums_off),
    # half of the batch left out, the mean taken over the rest: every other
    # view of the capture skipped and the rest counted twice
    "half_the_views": ("tpugs_torch.lift.batch", "backproject_views", _half_the_views),
}


@contextlib.contextmanager
def planted(name: str):
    module, attr, make = FAULTS[name]
    target = importlib.import_module(module)
    orig = getattr(target, attr)
    setattr(target, attr, make(orig))
    try:
        yield
    finally:
        setattr(target, attr, orig)
