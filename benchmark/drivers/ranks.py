"""Ranks 1..n-1 of a run over n ranks, steered by rank 0, the harness's own
process.

Each other rank is a child process (the ``spawn`` start method: CUDA
cannot live in a forked child) that runs a driver's module-level entry,
``entry(rank, world, port, device, conn, job)``: it joins the process group
at ``localhost:port`` (:func:`join`) and takes its orders from rank 0 on
``conn``, its end of a pipe.  What it sends back on ``conn`` is a dict;
one with the key ``error`` holds its traceback.

A rank that raises, dies or outlives its deadline must not hang the run.
A watchdog thread in rank 0 sees a child end before it was told to stop,
or the deadline pass; it kills every child, which makes a collective that
rank 0 waits in fail (gloo), and if rank 0 is still stuck ``GRACE_S``
later (NCCL waits for a dead peer), it ends the process with
``EXIT_RANK_FAILED``.  Each child ends itself once rank 0's process has
ended.  A child takes the program's ``parallel.RANK_THREADS`` torch
threads, as the program's own spawned ranks do; no rank is held to
cores.
"""

from __future__ import annotations

import datetime
import multiprocessing
import multiprocessing.connection
import os
import sys
import threading
import time
import traceback
from typing import Callable, Dict, List, Optional

import torch

# Seconds a rank's set-up may take before its first step is done (a first
# run of a checkout builds the kernel library meanwhile).
SETUP_TIMEOUT_S = 900.0
# Seconds past the window's length that the ranks may take to finish, and
# that one collective may wait.
RANK_TIMEOUT_S = 120.0
# Seconds that rank 0 may stay stuck once the other ranks were killed.
GRACE_S = 20.0
EXIT_RANK_FAILED = 4


def rank_device(device, rank: int) -> torch.device:
    """Rank ``rank``'s device: card ``rank`` for "cuda", else the CPU."""
    dev = torch.device(device)
    if dev.type != "cuda":
        return torch.device("cpu")
    dev = torch.device("cuda", rank)
    torch.cuda.set_device(dev)
    return dev


def join(port: int, world: int, rank: int, device: torch.device):
    """Join the group of ``world`` ranks at ``localhost:port`` through the
    program's bring-up (NCCL between cards, gloo on the CPU); this rank's
    ``TileMesh``."""
    from bhx_torch import parallel

    parallel.init_distributed(f"localhost:{port}", world, rank,
                              parallel.default_backend(device, world),
                              timeout=datetime.timedelta(seconds=RANK_TIMEOUT_S))
    return parallel.tile_mesh(device=device)


def leave() -> None:
    import torch.distributed as dist

    if dist.is_initialized():
        dist.destroy_process_group()


def _end_with_parent() -> None:
    """In a child: end this process once rank 0's has ended."""
    parent = multiprocessing.parent_process()
    if parent is None:
        return

    def watch():
        multiprocessing.connection.wait([parent.sentinel])
        os._exit(EXIT_RANK_FAILED)
    threading.Thread(target=watch, daemon=True).start()


def _child(entry: Callable, rank: int, world: int, port: int, device: str, conn,
           job: Dict) -> None:
    """A child's body: ``entry`` with few threads, ended with its parent,
    its traceback sent to rank 0 before it exits non-zero."""
    from bhx_torch import parallel

    torch.set_num_threads(parallel.RANK_THREADS)
    _end_with_parent()
    try:
        entry(rank, world, port, device, conn, job)
    except BaseException:
        try:
            conn.send(dict(error=f"rank {rank}:\n{traceback.format_exc()}"))
        except OSError:
            pass
        raise
    finally:
        leave()


def _exit_code(proc, wait_s: float = 10.0):
    """The exit code of a process whose sentinel is ready: it closes its
    end before the system can reap it, so the code may lag a moment."""
    end = time.monotonic() + wait_s
    while proc.exitcode is None and time.monotonic() < end:
        time.sleep(0.01)
    return proc.exitcode


class Ranks:
    """The child ranks 1..world-1 of a run, each running
    ``entry(rank, world, port, device, conn, job)``, and the watchdog over
    them."""

    def __init__(self, world: int, entry: Callable, device, job: Dict):
        from bhx_torch import parallel

        ctx = multiprocessing.get_context("spawn")
        self.port = parallel.free_port()
        self.procs: List = []
        self.conns: List = []
        self.failure: Optional[str] = None
        self.stopping = False
        self.deadline = time.monotonic() + SETUP_TIMEOUT_S
        self._closed = threading.Event()
        for r in range(1, world):
            ours, theirs = ctx.Pipe()
            p = ctx.Process(target=_child, daemon=True,
                            args=(entry, r, world, self.port, str(device), theirs, job))
            p.start()
            theirs.close()
            self.procs.append(p)
            self.conns.append(ours)
        self._watch = threading.Thread(target=self._watchdog, daemon=True)
        self._watch.start()

    def _watchdog(self) -> None:
        sentinels = {p.sentinel: r for r, p in enumerate(self.procs, start=1)}
        # Until every child has ended as told, or rank 0 has its replies.
        while sentinels and not self._closed.is_set():
            ended = multiprocessing.connection.wait(list(sentinels), timeout=0.25)
            for s in ended:
                r = sentinels.pop(s)
                code = _exit_code(self.procs[r - 1])
                if code != 0 or not self.stopping:
                    self._fail(f"rank {r} ended with code {code}")
                    return
            if time.monotonic() > self.deadline:
                self._fail("the ranks are past their deadline")
                return

    def _fail(self, reason: str) -> None:
        self.failure = reason
        print(f"benchmark: {reason}; ending the other ranks", file=sys.stderr, flush=True)
        self._kill()
        if not self._closed.wait(GRACE_S):
            print(f"benchmark: rank 0 still waits {GRACE_S:.0f} s after {reason}; exiting",
                  file=sys.stderr, flush=True)
            os._exit(EXIT_RANK_FAILED)

    def _kill(self) -> None:
        for p in self.procs:
            if p.is_alive():
                p.kill()
        for p in self.procs:
            p.join(timeout=10.0)

    def window(self, seconds: float) -> None:
        """The window starts: the ranks have ``seconds`` plus
        RANK_TIMEOUT_S to finish."""
        self.deadline = time.monotonic() + seconds + RANK_TIMEOUT_S

    def check(self) -> None:
        """Raises if a rank failed."""
        if self.failure is not None:
            raise RuntimeError(f"a rank failed: {self.failure}")

    def reason(self) -> Optional[str]:
        """Why the ranks failed, if one did: what the watchdog saw, or the
        first traceback that a rank sent (it sends it before it leaves the
        group, which is what a collective of rank 0's fails on)."""
        for c in self.conns:
            try:
                if c.poll(0.1):
                    reply = c.recv()
                    if "error" in reply:
                        return reply["error"]
            except (EOFError, OSError):
                continue
        return self.failure

    def tell(self, message) -> None:
        """Send ``message`` to every other rank."""
        self.check()
        for c in self.conns:
            c.send(message)

    def stop(self, message) -> List[Dict]:
        """Send the last ``message``; take each rank's reply, by rank; then
        leave the group with them (NCCL's teardown waits for every rank)
        and wait for them to end."""
        self.stopping = True
        self.tell(message)
        replies = []
        for r, c in enumerate(self.conns, start=1):
            if not c.poll(max(self.deadline - time.monotonic(), 0.0)):
                raise TimeoutError(f"rank {r} sent no reply before its deadline")
            reply = c.recv()
            if "error" in reply:
                raise RuntimeError(reply["error"])
            replies.append(reply)
        self.check()
        leave()
        # The ranks' work is in: a rank that does not end now is killed.
        self._closed.set()
        for r, p in enumerate(self.procs, start=1):
            p.join(timeout=GRACE_S)
            if p.is_alive():
                print(f"benchmark: rank {r} did not end after its reply; killed",
                      file=sys.stderr, flush=True)
        return replies

    def close(self) -> None:
        """End every child and the watchdog."""
        self._closed.set()
        self._kill()
        for c in self.conns:
            c.close()
        self._watch.join(timeout=1.0)
