"""The native scene reader is built once per test run, before the test
workers start (the repo-root ``conftest.py``), so every worker finds it
loadable. Where a C++ compiler exists, a worker that cannot load it means
the build raced or failed: ``tests/test_native.py`` would then skip as a
group."""

import shutil

import pytest

import tpugs.native as native


def test_native_library_loads_in_every_worker_with_a_compiler():
    if shutil.which("g++") is None:
        pytest.skip("no g++: the native reader falls back to Python")
    assert native.available(), "g++ is on the PATH but tpugs.native did not load"
