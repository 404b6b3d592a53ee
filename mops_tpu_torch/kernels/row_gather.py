"""The row-gather probe (K5): the CUDA kernel (csrc/row_gather.cu), its build
and ctypes binding, and its plain PyTorch version.

Port of the TPU kernel prof_dma.py::kern: gather table rows by id, B rows
to a block, and keep the first 1,024 values of each block's concatenated
rows.  It measures how fast the card brings table rows on chip by id, the
most that staging rows can buy the step kernels.  The wrapper launches the
kernel for CUDA tensors and runs the plain version for CPU tensors; a CUDA
tensor never falls back.  Importing this module builds nothing.
"""

from __future__ import annotations

import ctypes
import weakref
from pathlib import Path

import torch

from .nvcc_build import build_library

SOURCE = Path(__file__).resolve().parents[1] / "csrc" / "row_gather.cu"
HEAD = 1024                    # values of the head kept per block
BLOCK_ROWS = 512               # prof_dma.py's B

_lib = None
BUILD_LOG = ""
_checked_ids = None            # (weakref to ids, its version, nR)


def build() -> Path:
    """Compile the probe's library (cached by source and flags); return its
    path.  BUILD_LOG holds the build's log with ptxas's register/spill
    report."""
    global BUILD_LOG
    path, BUILD_LOG = build_library(SOURCE, "row_gather", 1)
    return path


def _library() -> ctypes.CDLL:
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(str(build()))
        P, I = ctypes.c_void_p, ctypes.c_int
        for tag in ("f32", "f64"):
            fn = getattr(lib, f"row_gather_{tag}")
            fn.argtypes = [P, P, I, I, I, P, P, P]
            fn.restype = I
        lib.row_gather_head.argtypes = []
        lib.row_gather_head.restype = I
        if lib.row_gather_head() != HEAD:
            raise RuntimeError("the kernel's head length disagrees with the "
                               "wrapper")
        _lib = lib
    return _lib


def _check(table, ids, block_rows):
    """Raise on what the kernel does not take; returns (N, F)."""
    name = "row_gather_probe"
    if table.dtype not in (torch.float32, torch.float64):
        raise TypeError(f"{name}: unsupported table dtype {table.dtype}")
    if ids.dtype != torch.int32:
        raise TypeError(f"{name}: ids must be int32")
    if table.ndim != 2 or ids.ndim != 1:
        raise ValueError(f"{name}: table (nR, F) and ids (N,) expected; got "
                         f"{tuple(table.shape)} and {tuple(ids.shape)}")
    n, (n_rows, F) = ids.shape[0], table.shape
    if block_rows < 1 or n % block_rows != 0:
        raise ValueError(f"{name}: N={n} is not a multiple of the block's "
                         f"{block_rows} rows")
    if block_rows * F < HEAD:
        raise ValueError(f"{name}: a block's {block_rows} rows of {F} hold "
                         f"fewer than the head's {HEAD} values")
    if F * table.element_size() % 16 != 0:
        raise ValueError(f"{name}: a row of {F} x {table.element_size()} B "
                         "is not a multiple of 16 B")
    if not (table.is_contiguous() and ids.is_contiguous()):
        raise ValueError(f"{name}: table and ids must be contiguous")
    if table.device != ids.device:
        raise ValueError(f"{name}: table on {table.device}, ids on "
                         f"{ids.device}")
    global _checked_ids
    seen = _checked_ids is not None and _checked_ids[0]() is ids \
        and _checked_ids[1:] == (ids._version, n_rows)
    if n and not seen:
        # a host sync; the last tensor checked is remembered (unmodified, it
        # is not checked again), so that timed launches do not sync
        if int(ids.min()) < 0 or int(ids.max()) >= n_rows:
            raise ValueError(f"{name}: ids outside [0, {n_rows})")
        _checked_ids = (weakref.ref(ids), ids._version, n_rows)
    return n, F


def row_gather_probe(table, ids, block_rows: int = BLOCK_ROWS):
    """Gather the rows ``table[ids]``, ``block_rows`` (B) to a block.

    Args: table (nR, F) float32 or float64 with F * itemsize a multiple of
    16 B, ids (N,) int32 in [0, nR) with N a multiple of B.
    Returns (head (N/B, 1024) in the table's dtype: the first 1,024 values
    of each block's B rows laid end to end; sums (N/B,) float64: the sum of
    all B * F values of each block).

    CUDA tensors launch the kernel (counted in
    ``row_gather_probe.launches``); CPU tensors run row_gather_plain.
    """
    n, F = _check(table, ids, block_rows)
    if table.device.type == "cpu":
        return row_gather_plain(table, ids, block_rows)
    if table.device.type != "cuda":
        raise ValueError(f"row_gather_probe: no kernel for {table.device}")
    if table.data_ptr() % 16:
        raise ValueError("row_gather_probe: the table is not 16-byte aligned")
    n_blocks = n // block_rows
    head = torch.empty((n_blocks, HEAD), dtype=table.dtype,
                       device=table.device)
    sums = torch.empty(n_blocks, dtype=torch.float64, device=table.device)
    lib = _library()
    fn = lib.row_gather_f32 if table.dtype == torch.float32 \
        else lib.row_gather_f64
    with torch.cuda.device(table.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(table.data_ptr(), ids.data_ptr(), n_blocks, F, block_rows,
                 head.data_ptr(), sums.data_ptr(), stream)
    if err != 0:
        raise RuntimeError(f"row_gather_probe: launch failed, "
                           f"cudaGetLastError() = {err}")
    row_gather_probe.launches += 1
    return head, sums


row_gather_probe.launches = 0


def row_gather_plain(table, ids, block_rows: int = BLOCK_ROWS,
                     chunk_rows: int = 1 << 16):
    """The same function as torch ops, ``chunk_rows`` gathered rows at a
    time: t = table[ids].reshape(N/B, B*F), head = t[:, :1024],
    sums = t.double().sum(1)."""
    n, F = ids.shape[0], table.shape[1]
    step = max(block_rows, chunk_rows // block_rows * block_rows)
    heads, sums = [], []
    for i in range(0, n, step):
        t = table[ids[i:i + step].long()].reshape(-1, block_rows * F)
        heads.append(t[:, :HEAD].clone())
        sums.append(t.double().sum(1))
    if not heads:
        return (torch.empty((0, HEAD), dtype=table.dtype,
                            device=table.device),
                torch.empty(0, dtype=torch.float64, device=table.device))
    return torch.cat(heads), torch.cat(sums)
