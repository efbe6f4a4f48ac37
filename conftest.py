"""Set-up shared by every test directory.

The native scene reader (``tpugs/native``) is compiled on first use into a
git-ignored library beside its source. Under pytest-xdist every worker
would try that first build at once, into the same temporary file, and the
losers would mark the library unavailable for the whole run. So the
controller builds it once, before any worker starts. The module is loaded
by path: it needs only the standard library, while importing the
``tpugs`` package would import JAX.
"""

import importlib.util
from pathlib import Path

NATIVE_INIT = Path(__file__).resolve().parent / "tpugs" / "native" / "__init__.py"


def pytest_configure(config):
    if hasattr(config, "workerinput"):  # an xdist worker: the controller built it
        return
    spec = importlib.util.spec_from_file_location("_tpugs_native_build", NATIVE_INIT)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    module.load()
