"""Worlds of CPU processes for the port's parallelism tests.

``run_world(n, "module:function", *args)`` spawns ``n`` processes, joins
them in a gloo process group (``tcp://localhost:<free port>``), calls
``function(rank, n, *args)`` in each, and returns the results by rank. A
rank that raises fails the world with its traceback; a world that has not
finished after ``timeout`` seconds (180 by default) is killed and fails, so
a hang fails one test instead of the suite. Each process runs torch on one
thread. The workers live in modules that import no JAX
(``torch_dist_workers``), so a rank starts in a few seconds.
"""

from __future__ import annotations

import importlib
import os
import queue
import socket
import time
import traceback

JOIN_TIMEOUT_S = 180


def free_port() -> int:
    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        return sock.getsockname()[1]


def _entry(rank: int, world: int, port: int, target: str, args: tuple, out) -> None:
    try:
        import torch
        import torch.distributed as dist

        torch.set_num_threads(1)
        os.environ.update(RANK=str(rank), WORLD_SIZE=str(world), LOCAL_RANK=str(rank),
                          LOCAL_WORLD_SIZE=str(world), MASTER_ADDR="localhost", MASTER_PORT=str(port))
        dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}", world_size=world, rank=rank)
        module, name = target.split(":")
        result = getattr(importlib.import_module(module), name)(rank, world, *args)
        dist.barrier()
        dist.destroy_process_group()
        out.put((rank, True, result))
    except BaseException:  # noqa: BLE001 - reported to the parent
        out.put((rank, False, traceback.format_exc()))


def run_world(world: int, target: str, *args, timeout: float = JOIN_TIMEOUT_S) -> list:
    import torch.multiprocessing as mp

    ctx = mp.get_context("spawn")
    out = ctx.Queue()
    port = free_port()
    procs = [ctx.Process(target=_entry, args=(r, world, port, target, args, out), daemon=True) for r in range(world)]
    for p in procs:
        p.start()
    results, deadline = {}, time.monotonic() + timeout
    try:
        while len(results) < world:
            left = deadline - time.monotonic()
            if left <= 0:
                raise TimeoutError(f"world of {world} running {target} did not finish in {timeout:.0f} s")
            try:
                rank, ok, value = out.get(timeout=min(left, 5.0))
            except queue.Empty:
                dead = [p.exitcode for p in procs if p.exitcode not in (None, 0)]
                if dead:
                    raise RuntimeError(f"a rank of {target} died with exit code {dead[0]}") from None
                continue
            if not ok:
                errors = {rank: value}
                # The first error is often another rank's lost connection:
                # gather what the others report for a few seconds.
                try:
                    while len(errors) < world:
                        r, r_ok, v = out.get(timeout=5.0)
                        if not r_ok:
                            errors[r] = v
                except queue.Empty:
                    pass
                codes = [p.exitcode for p in procs]
                raise RuntimeError(f"exit codes {codes}\n" + "\n".join(
                    f"rank {r} of {target} failed:\n{v}" for r, v in sorted(errors.items())))
            results[rank] = value
        for p in procs:
            p.join(timeout=max(deadline - time.monotonic(), 1.0))
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join()
    return [results[r] for r in range(world)]
