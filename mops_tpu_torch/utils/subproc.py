"""Child processes that import this package: their environment, a free
port on localhost for a process group, and a group of workers run
together with a timeout."""

from __future__ import annotations

import contextlib
import os
import socket
import subprocess
import time


def package_env() -> dict:
    """This process's environment with the package's parent directory first
    on PYTHONPATH, so that a child started anywhere imports
    mops_tpu_torch."""
    env = dict(os.environ)
    root = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    env["PYTHONPATH"] = os.pathsep.join(
        [root] + [p for p in [env.get("PYTHONPATH")] if p])
    return env


def free_port() -> int:
    """A TCP port on localhost that is free now."""
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def run_workers(cmds, timeout: float, workdir: str, env=None):
    """Start ``cmds`` together (``env`` default ``package_env()``), each
    writing its output to files under ``workdir``; stop at the first
    worker that fails (the others would wait for it in a collective) or at
    ``timeout`` seconds, killing every worker still running.  Returns
    ([(returncode, stdout, stderr)], whether the timeout was hit)."""
    env = package_env() if env is None else env
    procs = []
    with contextlib.ExitStack() as stack:
        files = [(stack.enter_context(open(os.path.join(
                      workdir, f"worker{i}.out"), "w+")),
                  stack.enter_context(open(os.path.join(
                      workdir, f"worker{i}.err"), "w+")))
                 for i in range(len(cmds))]
        try:
            for cmd, (out, err) in zip(cmds, files):
                procs.append(subprocess.Popen(cmd, stdout=out, stderr=err,
                                              env=env))
            deadline = time.monotonic() + timeout
            timed_out = False
            while any(p.poll() is None for p in procs) \
                    and not any(p.poll() for p in procs):
                if time.monotonic() > deadline:
                    timed_out = True
                    break
                time.sleep(0.05)
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                p.wait()
        results = []
        for p, (out, err) in zip(procs, files):
            out.seek(0)
            err.seek(0)
            results.append((p.returncode, out.read(), err.read()))
    return results, timed_out
