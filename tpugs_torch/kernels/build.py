"""Build and load the CUDA kernels in ``tpugs_torch/csrc`` (no counterpart
in ``tpugs``, whose kernels Mosaic compiles inside ``pallas_call``).

At first use every ``csrc/*.cu`` is compiled by its own ``nvcc`` process,
all started together, for ``sm_90a``; the objects are linked into one
shared library with a plain C interface, loaded with ``ctypes``. The
library lands in ``build/tpugs_torch/`` at the repo root (git-ignored),
named by a hash of the sources and flags, so a changed source rebuilds and
an unchanged one loads at once. A failed build raises with nvcc's output.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

PKG_DIR = Path(__file__).resolve().parent.parent
CSRC_DIR = PKG_DIR / "csrc"
BUILD_DIR = PKG_DIR.parent / "build" / "tpugs_torch"
ARCH_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a"]
NVCC_FLAGS = ARCH_FLAGS + ["-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
SIGNATURES = {
    # pack, starts, ends, padded_starts, out, blocks_done, n_tiles, ntx, ts, eps,
    # cull (0/1), cluster size, stream
    "tpugs_render": [_P] * 6 + [_I] * 3 + [_F, _I, _I, _P],
    # tile size, cull (0/1) -> resident clusters
    "tpugs_render_max_clusters": [_I, _I],
    # pack, starts, ends, padded_starts, feats, out, n_tiles, ntx, ts, W, H, D, DC, eps,
    # cluster size, grid x, stream
    "tpugs_adjoint_f32": [_P] * 6 + [_I] * 7 + [_F, _I, _I, _P],
    "tpugs_adjoint_bf16": [_P] * 6 + [_I] * 7 + [_F, _I, _I, _P],
    # bf16 (0/1), cluster size -> resident clusters
    "tpugs_adjoint_max_clusters": [_I, _I],
    # rows, offsets, pos, out, n, n_cols, row_stride, stream
    "tpugs_reduce_f32": [_P] * 4 + [_I] * 3 + [_P],
    "tpugs_reduce_bf16": [_P] * 4 + [_I] * 3 + [_P],
    # geom, cols, starts, ends, padded_starts, img, alpha, blocks_done,
    # n_tiles, ntx, ts, W, H, D, eps, cluster size, pixels per rank,
    # channel slices, slice width, stream
    "tpugs_train_fwd": [_P] * 8 + [_I] * 6 + [_F, _I, _I, _I, _I, _P],
    # the same without the cluster geometry: the wide kernel (one CTA per
    # tile and 32-channel slice), for tiles other than 16 and 32
    "tpugs_train_fwd_wide": [_P] * 8 + [_I] * 6 + [_F, _P],
    # tile size, D of one slice -> resident clusters
    "tpugs_train_fwd_max_clusters": [_I, _I],
    # geom, cols, g, hterm, grem0, starts, ends, padded_starts, blocks_done, out,
    # n_tiles, ntx, ts, W, H, D, row width, cluster size, pixels per rank, stream
    "tpugs_train_bwd_f32": [_P] * 10 + [_I] * 9 + [_P],
    "tpugs_train_bwd_bf16": [_P] * 10 + [_I] * 9 + [_P],
    # the same without the cluster geometry: the one-CTA kernel of wide rows
    "tpugs_train_bwd_wide_f32": [_P] * 10 + [_I] * 7 + [_P],
    "tpugs_train_bwd_wide_bf16": [_P] * 10 + [_I] * 7 + [_P],
    # the one-CTA kernel's geometry-only rows (row width 8, any D)
    "tpugs_train_bwd_geom_f32": [_P] * 10 + [_I] * 7 + [_P],
    # bf16 (0/1), tile size, D -> resident clusters
    "tpugs_train_bwd_max_clusters": [_I, _I, _I],
    # pack, starts, ends, padded_starts, feats, dest, out, n_tiles, ntx, ts, W, H, D, DC,
    # eps, cluster size, grid x, stream
    "tpugs_adjoint_scatter_f32": [_P] * 7 + [_I] * 7 + [_F, _I, _I, _P],
    "tpugs_adjoint_scatter_bf16": [_P] * 7 + [_I] * 7 + [_F, _I, _I, _P],
    # striped, base, culled, index (or null), out, n, n_cols, row_stride, stream
    "tpugs_stripe_sum_f32": [_P] * 5 + [_I] * 3 + [_P],
    "tpugs_stripe_sum_bf16": [_P] * 5 + [_I] * 3 + [_P],
    # pos (or null), out, nb, compute_iters, stream
    "tpugs_exp_scatter_write": [_P, _P, _I, _I, _P],
    # src, offset, out, stream
    "tpugs_exp_async_copy_probe": [_P, _I, _P, _P],
}


def nvcc_path() -> str:
    cuda_home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    candidates = [
        os.path.join(cuda_home, "bin", "nvcc") if cuda_home else None,
        shutil.which("nvcc"),
        "/usr/local/cuda/bin/nvcc",
    ]
    for c in candidates:
        if c and os.path.isfile(c):
            return c
    raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH")


def sources():
    return sorted(CSRC_DIR.glob("*.cu")), sorted(CSRC_DIR.glob("*.cuh"))


def library_path() -> Path:
    cus, headers = sources()
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for f in cus + headers:
        h.update(f.name.encode())
        h.update(f.read_bytes())
    return BUILD_DIR / f"libtpugs_torch_{h.hexdigest()[:16]}.so"


def build_library() -> Path:
    """Compile (if needed) and return the shared library's path. The
    compiler's output, with ptxas' register and shared-memory report, is
    kept beside it in ``<library>.log``."""
    so = library_path()
    if so.exists():
        return so
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = nvcc_path()
    cus, _ = sources()
    tag = f"{so.stem}.{os.getpid()}"
    objs = [BUILD_DIR / f"{tag}.{cu.stem}.o" for cu in cus]
    procs = [
        subprocess.Popen(
            [nvcc, *NVCC_FLAGS, "-I", str(CSRC_DIR), "-c", str(cu), "-o", str(o)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        )
        for cu, o in zip(cus, objs)
    ]
    logs, failed = [], []
    for cu, p in zip(cus, procs):
        out, _ = p.communicate()
        logs.append(f"== {cu.name}\n{out}")
        if p.returncode != 0:
            failed.append(cu.name)
    if failed:
        raise RuntimeError(f"nvcc failed on {failed}:\n" + "\n".join(logs))
    tmp = BUILD_DIR / f"{tag}.so"
    link = subprocess.run(
        [nvcc, *ARCH_FLAGS, "-shared", "-o", str(tmp), *map(str, objs)],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
    )
    for o in objs:
        o.unlink(missing_ok=True)
    if link.returncode != 0:
        raise RuntimeError(f"nvcc link failed:\n{link.stdout}")
    so.with_suffix(".log").write_text("\n".join(logs))
    os.replace(tmp, so)
    return so


@functools.lru_cache(maxsize=None)
def load_library() -> ctypes.CDLL:
    lib = ctypes.CDLL(str(build_library()))
    for name, argtypes in SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    return lib
