"""Several gloo ranks on the CPU from one process, for tests and dry runs
(no counterpart in tpugs, whose CPU meshes are virtual devices of one
program).

``run_ranks(fn, world, args)`` starts ``world`` processes with the
``spawn`` method (never ``fork``: the caller may hold threads, JAX's among
them), each joining one gloo group on a ``file://`` store in a temporary
directory (no TCP port to race for), and calls ``fn(rank, world, *args)``
there. ``fn`` is pickled by name, so it must be a module-level function of
a module that the child can import without the caller's imports. Tensors in
its result come back as numpy arrays. A rank that raises, dies or outlasts
``timeout`` raises in the caller, and the other ranks are stopped; a
collective that a rank never enters fails after ``COLLECTIVE_TIMEOUT``.
"""

from __future__ import annotations

import os
import queue as queue_mod
import tempfile
import time
import traceback

import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from tpugs_torch.dist.mesh import COLLECTIVE_TIMEOUT


def to_numpy(tree):
    """Tensors in nested dicts, lists and tuples as numpy arrays."""
    if isinstance(tree, torch.Tensor):
        return tree.detach().cpu().numpy()
    if isinstance(tree, dict):
        return {k: to_numpy(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(to_numpy(v) for v in tree)
    return tree


def _rank_main(fn, rank, world, init_method, args, results):
    torch.set_num_threads(1)  # the ranks share the machine's cores
    try:
        dist.init_process_group("gloo", init_method=init_method, rank=rank, world_size=world,
                                timeout=COLLECTIVE_TIMEOUT)
        results.put((rank, True, to_numpy(fn(rank, world, *args))))
    except Exception:  # reported to the caller, which raises
        results.put((rank, False, traceback.format_exc()))
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def run_ranks(fn, world: int, args: tuple = (), timeout: float = 300.0) -> list:
    """``[fn(0, world, *args), ..., fn(world - 1, world, *args)]``, each
    run on its own gloo rank of one group."""
    ctx = mp.get_context("spawn")
    results = ctx.Queue()
    with tempfile.TemporaryDirectory() as td:
        init_method = f"file://{os.path.join(td, 'store')}"
        procs = [ctx.Process(target=_rank_main, args=(fn, r, world, init_method, args, results),
                             daemon=True) for r in range(world)]
        for p in procs:
            p.start()
        out = {}
        deadline = time.monotonic() + timeout
        try:
            while len(out) < world:
                left = deadline - time.monotonic()
                if left <= 0:
                    raise TimeoutError(f"ranks {sorted(set(range(world)) - set(out))} gave no "
                                       f"result within {timeout} s")
                try:
                    rank, ok, payload = results.get(timeout=min(left, 1.0))
                except queue_mod.Empty:
                    dead = [r for r, p in enumerate(procs) if r not in out
                            and p.exitcode is not None]
                    if dead:
                        raise RuntimeError(f"rank {dead[0]} exited with code "
                                           f"{procs[dead[0]].exitcode} and no result")
                    continue
                if not ok:
                    raise RuntimeError(f"rank {rank} raised:\n{payload}")
                out[rank] = payload
        finally:
            for p in procs:
                p.join(timeout=10 if len(out) == world else 0)
                if p.is_alive():
                    p.terminate()
                    p.join(timeout=10)
    return [out[r] for r in range(world)]
