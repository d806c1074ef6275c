"""Process worlds on one machine: spawn and drain the ranks, and free ports.

``spawn_world`` is the JAX package's ``utils/worlds.py:spawn_world``: one
process a ``(argv, env)``, every pipe drained at once (a rank blocked on a
full pipe stops taking part in collectives and would hang the world), the
failed ranks reported before the ones that timed out.
"""

from __future__ import annotations

import socket
import subprocess
import threading


def free_ports(count: int) -> list[int]:
    """``count`` distinct TCP ports free on this host now (each bound to
    port 0 and released), for rendezvous that must not collide with other
    worlds on the host."""
    sockets = []
    try:
        for _ in range(count):
            s = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
            s.bind(("127.0.0.1", 0))
            sockets.append(s)
        return [s.getsockname()[1] for s in sockets]
    finally:
        for s in sockets:
            s.close()


def spawn_world(rank_cmds, *, timeout: float | None = 600.0, cwd=None, capture: bool = True,
                check: bool = True):
    """Run one process per ``(argv, env)`` of ``rank_cmds``; returns
    ``[(returncode, stdout, stderr)]`` in rank order (the outputs None
    where ``capture`` is off: the ranks then write to this process's
    streams).  With ``check`` it raises if a rank fails; it always raises
    if one outlives ``timeout`` seconds (None: no limit; it is then
    killed)."""
    pipe = subprocess.PIPE if capture else None
    procs = [subprocess.Popen(argv, env=env, cwd=cwd, stdout=pipe, stderr=pipe, text=True)
             for argv, env in rank_cmds]
    results = [None] * len(procs)
    errors = [None] * len(procs)

    def drain(rank, proc):
        try:
            out, err = proc.communicate(timeout=timeout)
            results[rank] = (proc.returncode, out, err)
        except subprocess.TimeoutExpired as e:
            errors[rank] = e
            proc.kill()
            proc.communicate()

    threads = [threading.Thread(target=drain, args=(rank, proc))
               for rank, proc in enumerate(procs)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    failed = [(rank, (res[2] or "")[-2000:]) for rank, res in enumerate(results)
              if res is not None and res[0] != 0]
    if failed and check:
        raise RuntimeError(f"world ranks failed: {failed}")
    timed_out = [rank for rank, e in enumerate(errors) if e is not None]
    if timed_out:
        raise RuntimeError(f"world ranks timed out after {timeout}s: {timed_out}")
    return results
