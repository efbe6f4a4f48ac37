"""The native (C++) COLMAP reader, loaded with ctypes. Counterpart:
``tpugs/native/__init__.py``; ``scene_io.cc`` here is a copy of tpugs'
source, its code unchanged.

The library is compiled by ``g++`` at first use into ``build/tpugs_torch/``
at the repo root (git-ignored), named by a hash of the source and flags,
as ``kernels/build.py`` names the CUDA library. The build runs under an
exclusive ``fcntl`` lock on a file beside it and writes a temporary name
that ``os.replace`` moves into place, so processes that start at once (the
test workers) wait for one build and all load it. Without ``g++`` the
readers use their pure-Python twins (``load`` returns None); a failed
build raises with the compiler's output.
"""

from __future__ import annotations

import ctypes
import fcntl
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Optional

SRC = Path(__file__).resolve().parent / "scene_io.cc"
BUILD_DIR = SRC.parent.parent.parent / "build" / "tpugs_torch"
CXX_FLAGS = ["-O3", "-shared", "-fPIC", "-std=c++17"]


def library_path() -> Path:
    h = hashlib.sha256(" ".join(CXX_FLAGS).encode())
    h.update(SRC.read_bytes())
    return BUILD_DIR / f"libscene_io_{h.hexdigest()[:16]}.so"


def build_library() -> Path:
    """Compile (if needed) and return the library's path."""
    so = library_path()
    if so.exists():
        return so
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with open(BUILD_DIR / "scene_io.lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)  # released when the file closes
        if so.exists():  # built by another process while this one waited
            return so
        tmp = so.with_name(f"{so.name}.{os.getpid()}.tmp")
        proc = subprocess.run(["g++", *CXX_FLAGS, "-o", str(tmp), str(SRC)],
                              capture_output=True, text=True, timeout=300)
        if proc.returncode != 0:
            tmp.unlink(missing_ok=True)
            raise RuntimeError(f"g++ failed on {SRC.name}:\n{proc.stdout}{proc.stderr}")
        os.replace(tmp, so)
    return so


@functools.lru_cache(maxsize=None)
def load() -> Optional[ctypes.CDLL]:
    """The scene_io library, built if needed; None where there is no g++."""
    if shutil.which("g++") is None:
        return None
    lib = ctypes.CDLL(str(build_library()))
    _decorate(lib)
    return lib


def available() -> bool:
    return load() is not None


def _decorate(lib) -> None:
    u8p = ctypes.POINTER(ctypes.c_uint8)
    u64p = ctypes.POINTER(ctypes.c_uint64)
    u64 = ctypes.c_uint64
    vp = ctypes.c_void_p
    # Every length crossing the boundary is declared c_uint64: ctypes'
    # default int conversion truncates to a 32-bit C int, which breaks
    # files of 2 GiB and more.
    lib.colmap_points3d_count.argtypes = [u8p, u64, u64p, u64p]
    lib.colmap_points3d_count.restype = ctypes.c_int
    lib.colmap_points3d_parse.argtypes = [u8p, u64, vp, vp, vp, vp, vp, vp, vp]
    lib.colmap_points3d_parse.restype = ctypes.c_int
    lib.colmap_images_count.argtypes = [u8p, u64, u64p, u64p, u64p]
    lib.colmap_images_count.restype = ctypes.c_int
    lib.colmap_images_parse.argtypes = [u8p, u64, vp, vp, vp, vp, ctypes.c_char_p, vp, vp, vp,
                                        vp]
    lib.colmap_images_parse.restype = ctypes.c_int
    lib.colmap_points3d_size.argtypes = [u64, u64]
    lib.colmap_points3d_size.restype = u64
    lib.colmap_points3d_write.argtypes = [u64, vp, vp, vp, vp, vp, vp, vp, vp]
    lib.colmap_points3d_write.restype = ctypes.c_int
