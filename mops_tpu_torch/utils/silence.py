"""stderr silencing during noisy IO (mops_tpu.utils.silence; reference
ScopedStderrSilence, src/Utils/ScopedStderrSilence.hpp:3-14: RAII stderr ->
/dev/null during NetCDF reads)."""

from __future__ import annotations

import contextlib
import os
import sys


@contextlib.contextmanager
def scoped_stderr_silence():
    """Redirect fd-level stderr to /dev/null for the scope (captures
    C-library noise, not just Python's sys.stderr)."""
    fd = sys.stderr.fileno()
    saved = os.dup(fd)
    devnull = os.open(os.devnull, os.O_WRONLY)
    try:
        sys.stderr.flush()
        os.dup2(devnull, fd)
        yield
    finally:
        sys.stderr.flush()
        os.dup2(saved, fd)
        os.close(saved)
        os.close(devnull)
