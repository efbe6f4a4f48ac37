"""S1 — do scattered row writes cost more than contiguous ones under
compute? Counterpart: ``scripts/exp_scatter_write.py`` (``run`` :120,
kernel ``make_kernel`` :49; ``smem_dma_legal`` :143), the experiment that
decided whether the adjoint could write its rows in slot order (the scatter
reduce engine, B6 + B7).

One block of 256 threads per 128-row block writes 128 rows of 1024 bf16
(2 KB, the reference's row) after a synthetic compute load of
``compute_iters`` dependent multiply-adds on each of 512 x 128 f32 values
(the reference's per-step load). ``contig`` writes block i's rows at
``i * 128 + r``; ``scatter`` at ``pos[i * 128 + r]``, a numpy seed-0
permutation. The kernel is ``csrc/exp_scatter_write.cu``; ``*_plain`` are
its plain twins, which the wrappers take for CPU tensors. The probe
``async_copy_probe`` is the counterpart of ``smem_dma_legal``: an
asynchronous copy (``cp.async``) of 8 int32 from a dynamic offset of a
global array into shared memory.

On the card::

    python -m tpugs_torch.experiments.scatter_write [--nb 15360]

prints, per variant and compute load, ms, M rows/s and GB/s, as the
reference does.
"""

from __future__ import annotations

import argparse
import ctypes
from typing import Optional

import numpy as np
import torch

BLOCK_ROWS = 128  # rows per block
ROW_ELEMS = 1024  # bf16 per row (2 KB)
COMPUTE_ELEMS = 512 * 128  # f32 values of one block's synthetic compute
THREADS = 256
NB_DEFAULT = 15360  # the reference's default: garden T_padded / 128
COMPUTE_ITERS = (0, 16, 48)
MULT = float(np.float32(1.000001))

# Kernel launches of this module (the plain twins do not count).
LAUNCHES = {"scatter_write": 0, "async_copy_probe": 0}


def reset_launches() -> None:
    LAUNCHES.update(dict.fromkeys(LAUNCHES, 0))


def permutation(n_rows: int, seed: int = 0) -> torch.Tensor:
    """The scatter destinations: a numpy permutation of the rows, int32."""
    return torch.from_numpy(np.random.default_rng(seed).permutation(n_rows).astype(np.int32))


def _block_sums(blocks: torch.Tensor, compute_iters: int) -> torch.Tensor:
    """(k, 1024) f32: each block's 1024 values, element t + 256 q the sum
    over k % 4 == q, in increasing k, of the chains of elements
    m = t + 256 k, started from the top 10 bits of a hash of
    block * 65536 + m. The start values are multiples of 1/64 below 16, so
    each step x * 1.000001f + 0.5 is exact in f64 (at most 53 significant bits
    while x < 64, i.e. compute_iters <= 64) and its one rounding to f32 is
    the kernel's fmaf."""
    m = torch.arange(COMPUTE_ELEMS, device=blocks.device)
    idx = (blocks[:, None] * 65536 + m[None, :]) & 0xFFFFFFFF
    x = (((idx * 2654435761) & 0xFFFFFFFF) >> 22).to(torch.float64) / 64.0
    for _ in range(compute_iters):
        x = (x * MULT + 0.5).to(torch.float32).to(torch.float64)
    x = x.to(torch.float32).view(-1, COMPUTE_ELEMS // THREADS, THREADS)
    sums = torch.zeros((blocks.shape[0], 4, THREADS), dtype=torch.float32,
                       device=blocks.device)
    for k in range(x.shape[1]):
        sums[:, k % 4] += x[:, k]
    return sums.reshape(-1, ROW_ELEMS)


def scatter_write_plain(
    out: torch.Tensor, pos: Optional[torch.Tensor], compute_iters: int, chunk: int = 256
) -> torch.Tensor:
    """The kernel's twin: fills ``out`` (nb * 128, 1024) bf16. Row r of
    block i holds the block's values rotated by r (element e is value
    (e + r) % 1024), at row i * 128 + r (``pos`` None) or pos[i * 128 + r]."""
    nb = out.shape[0] // BLOCK_ROWS
    dev = out.device
    rot = (torch.arange(ROW_ELEMS, device=dev)[None, :]
           + torch.arange(BLOCK_ROWS, device=dev)[:, None]) & (ROW_ELEMS - 1)
    for b0 in range(0, nb, chunk):
        blocks = torch.arange(b0, min(b0 + chunk, nb), device=dev)
        rows = _block_sums(blocks, compute_iters)[:, rot].reshape(-1, ROW_ELEMS)
        dst = torch.arange(b0 * BLOCK_ROWS, (b0 + blocks.shape[0]) * BLOCK_ROWS, device=dev)
        if pos is not None:
            dst = pos[dst].long()
        out[dst] = rows.to(torch.bfloat16)
    return out


def _check_rows(out: torch.Tensor, pos: Optional[torch.Tensor], compute_iters: int) -> None:
    if not isinstance(out, torch.Tensor) or out.dtype != torch.bfloat16:
        raise TypeError("out must be a bfloat16 tensor")
    if out.ndim != 2 or out.shape[1] != ROW_ELEMS or out.shape[0] % BLOCK_ROWS \
            or out.shape[0] == 0 or not out.is_contiguous():
        raise ValueError(f"out must be contiguous (nb * {BLOCK_ROWS}, {ROW_ELEMS}), "
                         f"got {tuple(out.shape)}")
    if pos is not None:
        if pos.dtype != torch.int32:
            raise TypeError(f"pos has dtype {pos.dtype}, expected torch.int32")
        if pos.device != out.device or tuple(pos.shape) != (out.shape[0],) \
                or not pos.is_contiguous():
            raise ValueError("pos must be a contiguous (rows,) permutation on out's device")
    if not 0 <= compute_iters <= 64:
        raise ValueError(f"compute_iters {compute_iters} must lie in [0, 64]")


def scatter_write(
    out: torch.Tensor, pos: Optional[torch.Tensor], compute_iters: int
) -> torch.Tensor:
    """S1's kernel into ``out`` (nb * 128, 1024) bf16: contig with ``pos``
    None, else scattered to the permutation ``pos`` (int32, one entry per
    row). A CPU tensor runs the twin."""
    _check_rows(out, pos, compute_iters)
    from tpugs_torch.raster.kernels import _dispatch, _launched, _ptr, _stream

    if not _dispatch(out.device):
        return scatter_write_plain(out, pos, compute_iters)
    from tpugs_torch.kernels.build import load_library

    rc = load_library().tpugs_exp_scatter_write(
        _ptr(pos) if pos is not None else ctypes.c_void_p(None), _ptr(out),
        out.shape[0] // BLOCK_ROWS, compute_iters, _stream())
    _launched(rc, "scatter_write")
    LAUNCHES["scatter_write"] += 1
    return out


def run_variant(
    pos: torch.Tensor, scatter: bool, compute_iters: int, out: Optional[torch.Tensor] = None
) -> torch.Tensor:
    """One variant on ``pos``'s device: ``scatter`` writes to ``pos``,
    contig in order. Returns the (rows, 1024) bf16 rows."""
    if out is None:
        out = torch.empty((pos.shape[0], ROW_ELEMS), dtype=torch.bfloat16, device=pos.device)
    return scatter_write(out, pos if scatter else None, compute_iters)


def async_copy_probe_plain(src: torch.Tensor, offset: int) -> torch.Tensor:
    return src[8 * offset + 3 : 8 * offset + 4].clone()


def async_copy_probe(src: torch.Tensor, offset: int) -> torch.Tensor:
    """(1,) int32: element 3 of the 8 int32 at ``src[8 * offset:]``, read
    through shared memory after an asynchronous copy at that dynamic
    offset. 19 for ``arange(64)`` at offset 2."""
    if src.dtype != torch.int32 or src.ndim != 1 or not src.is_contiguous():
        raise TypeError("src must be a contiguous 1-d int32 tensor")
    if offset < 0 or src.shape[0] < 8 * (offset + 1):
        raise ValueError(f"offset {offset} is outside src ({src.shape[0]} entries)")
    from tpugs_torch.raster.kernels import _dispatch, _launched, _ptr, _stream

    if not _dispatch(src.device):
        return async_copy_probe_plain(src, offset)
    from tpugs_torch.kernels.build import load_library

    out = torch.empty((1,), dtype=torch.int32, device=src.device)
    rc = load_library().tpugs_exp_async_copy_probe(_ptr(src), offset, _ptr(out), _stream())
    _launched(rc, "async_copy_probe")
    LAUNCHES["async_copy_probe"] += 1
    return out


def row_bytes(n_rows: int, scatter: bool) -> int:
    """Bytes a variant must move: its rows, and for scatter the int32
    destination of each."""
    return n_rows * (ROW_ELEMS * 2 + (4 if scatter else 0))


def multiply_adds(nb: int, compute_iters: int) -> int:
    return nb * COMPUTE_ELEMS * compute_iters


def measure(nb: int = NB_DEFAULT, compute_iters=COMPUTE_ITERS, iters: int = 5,
            device="cuda") -> list:
    """Each variant's time on the card: a list of dicts with ``variant``,
    ``compute_iters``, ``ms``, ``mrows_s`` and ``gb_s`` (rows' bytes over
    time)."""
    from tpugs_torch.utils.timing import time_cuda

    n_rows = nb * BLOCK_ROWS
    pos = permutation(n_rows).to(device)
    out = torch.empty((n_rows, ROW_ELEMS), dtype=torch.bfloat16, device=device)
    results = []
    for it in compute_iters:
        for scatter in (False, True):
            ms = time_cuda(lambda: run_variant(pos, scatter, it, out), iters)
            results.append({
                "variant": "scatter" if scatter else "contig", "compute_iters": it, "ms": ms,
                "mrows_s": n_rows / ms / 1e3, "gb_s": n_rows * ROW_ELEMS * 2 / ms / 1e6,
            })
    return results


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--nb", type=int, default=NB_DEFAULT, help="128-row blocks")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA card")
    print(f"device: {torch.cuda.get_device_name(0)}", flush=True)
    got = int(async_copy_probe(torch.arange(64, dtype=torch.int32, device="cuda"), 2))
    print(f"async copy at a dynamic offset into shared memory: {got} (legal: {got == 19})",
          flush=True)
    n_rows = args.nb * BLOCK_ROWS
    print(f"rows={n_rows} ({n_rows * ROW_ELEMS * 2 / 1e9:.2f} GB of 2-KB rows)", flush=True)
    for r in measure(args.nb):
        print(f"{r['variant']:8s}[it={r['compute_iters']}] -> {r['ms']:7.3f} ms  "
              f"{r['mrows_s']:7.1f} M rows/s  {r['gb_s']:7.1f} GB/s", flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
