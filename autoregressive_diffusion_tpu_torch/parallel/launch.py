"""Ranks of one host without torchrun.

`run_local_ranks` starts `world` processes (spawn), gives each the
environment torchrun would (RANK, LOCAL_RANK, WORLD_SIZE, MASTER_ADDR,
MASTER_PORT on a free localhost port) and returns what each rank's
function returned. chip_smoke.py uses it to run two ranks on one card, the
tests to run gloo ranks on the CPU. Every process it starts has ended when
it returns or raises. The function and its arguments reach the ranks
through a file in the temporary directory, not the spawn pipe, which would
hold each start until the rank before had imported its modules.
"""
from __future__ import annotations

import multiprocessing as mp
import os
import pickle
import queue
import socket
import tempfile
import time
import traceback


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _rank_main(job, rank, world, port, results):
    os.environ.update(RANK=str(rank), LOCAL_RANK=str(rank), WORLD_SIZE=str(world),
                      MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port))
    try:
        with open(job, "rb") as f:
            fn, args = pickle.load(f)
        # plain pickle: a tensor is sent by value, not as a shared-memory
        # handle that dies with this process
        results.put((rank, True, pickle.dumps(fn(*args))))
    except BaseException:  # reported to the parent, which raises
        results.put((rank, False, traceback.format_exc()))
        raise


def run_local_ranks(fn, world: int, args=(), timeout: float = 600.0) -> list:
    """fn(*args) on `world` ranks of this host, each in its own process;
    returns their results in rank order. fn and args are pickled (fn by
    its import path). Raises RuntimeError when a rank raises, dies or is
    not done after `timeout` seconds; the ranks still running are killed."""
    ctx = mp.get_context("spawn")
    results = ctx.Queue()
    port = free_port()
    fd, job = tempfile.mkstemp(suffix=".ranks.pkl")
    with os.fdopen(fd, "wb") as f:
        pickle.dump((fn, args), f)
    procs = [ctx.Process(target=_rank_main, args=(job, r, world, port, results), daemon=True)
             for r in range(world)]
    for p in procs:
        p.start()
    got, errors = {}, []
    deadline = time.monotonic() + timeout
    try:
        while len(got) + len(errors) < world:
            if time.monotonic() > deadline:
                errors.append(f"ranks {sorted(set(range(world)) - set(got))} not done "
                              f"after {timeout:.0f} s")
                break
            try:
                rank, ok, value = results.get(timeout=1.0)
            except queue.Empty:
                dead = [r for r, p in enumerate(procs)
                        if p.exitcode not in (None, 0) and r not in got]
                if dead:
                    errors.append(f"ranks {dead} exited with codes "
                                  f"{[procs[r].exitcode for r in dead]}")
                    break
                continue
            if not ok:  # the other ranks may wait on it in a collective
                errors.append(f"rank {rank} failed:\n{value}")
                break
            got[rank] = pickle.loads(value)
    finally:
        for p in procs:
            p.join(timeout=30 if not errors else 1)
            if p.is_alive():
                p.kill()
                p.join()
        results.close()
        os.unlink(job)
    if errors:
        raise RuntimeError("\n".join(errors))
    return [got[r] for r in range(world)]
