"""Fused streamline and pathline steps: the CUDA kernels
(csrc/stage_kernel.cu), their build and ctypes binding, and their plain
PyTorch versions.

Ports of the TPU kernels mops_tpu/pallas/stage_kernel.py::_kernel as reached
through ``fused_streamline_step`` (K1) and ``fused_pathline_step`` (K2), and
mops_tpu/pallas/window_kernel.py::_wkernel as reached through
``fused_window_streamline_step`` (K3) and ``fused_window_pathline_step``
(K4): the same steps with each stage reading only a W-layer window of the
columns.  Each wrapper launches its kernel for CUDA tensors and runs the
plain version for CPU tensors; a CUDA tensor never falls back to the plain
version.

All four kernels are compiled with nvcc for sm_90a into
``mops_tpu_torch/_build/`` at first use (one shared library with a plain C
entry point per kernel and dtype, loaded with ctypes; see nvcc_build).
Importing this module builds nothing.
"""

from __future__ import annotations

import contextlib
import ctypes
import threading
from pathlib import Path

import torch

from .nvcc_build import build_library
from ..utils.timer import TimerManager
from ..step import (cell_rise, first_rise, pathline_step, start_layer,
                    streamline_step, window_cols, window_pathline_step,
                    window_streamline_step)

_PKG = Path(__file__).resolve().parents[1]
SOURCE = _PKG / "csrc" / "stage_kernel.cu"
# The source's entries are compiled as this many translation units at once
# (STAGE_PART in the source), then linked into one library.
BUILD_PARTS = 8
# Compile-time ceilings of the kernels (K_MAX, L_MAX, A_MAX, W_MAX in the
# source).
K_MAX = 20
L_MAX = 128
A_MAX = 2
W_MAX = 32
# The full-column kernels (K1, K2, and the window kernels' repairs) have two
# instances a dtype and form: one for columns of at most COLUMN_LT layers
# (fewer registers a lane) and the generic one up to L_MAX.
COLUMN_LT = 64

_lib = None
BUILD_LOG = ""


def pack_vertex_table(vertex_xyz, vertex_ztop, vertex_velocity,
                      vertex_vert_velocity, vertex_attrs=None) -> torch.Tensor:
    """Fuse the per-vertex tables into one contiguous (nV, F) row table with
    layout [xyz(3) | ztop(L) | vel(L*3, layer-major) | wvel(L+1)
    | attrs(L*A, layer-major: A*l + ai)], F = 3 + 4L + (L+1) + L*A: one row
    per vertex serves the whole fused step.  ``vertex_attrs`` is the
    optional (nV, L, A) stack of advect.stacked_vertex_attrs."""
    n_vert, L = vertex_ztop.shape
    parts = [vertex_xyz, vertex_ztop, vertex_velocity.reshape(n_vert, 3 * L),
             vertex_vert_velocity]
    if vertex_attrs is not None:
        parts.append(vertex_attrs.reshape(n_vert, -1))
    return torch.cat(parts, dim=1).contiguous()


def table_width(n_layers: int, n_attrs: int = 0) -> int:
    """F of pack_vertex_table for L layers and A attributes."""
    return 3 + 4 * n_layers + n_layers + 1 + n_layers * n_attrs


def column_instance(n_layers: int) -> str:
    """The instance of K1/K2 that a column of ``n_layers`` layers launches:
    "64" for L <= COLUMN_LT, else "generic" (launch_column in the source
    picks by the same rule)."""
    return "64" if n_layers <= COLUMN_LT else "generic"


def build() -> Path:
    """Compile the kernel library (cached by source and flags) and return its
    path: one nvcc process per part of the source, all started together,
    then one link.  BUILD_LOG holds the build's log with ptxas's
    register/spill report."""
    global BUILD_LOG
    path, BUILD_LOG = build_library(SOURCE, "stage_kernel", BUILD_PARTS)
    return path


# Each C entry's parameters in order (P a pointer, I an int, R the real of
# its _f32 or _f64 instance); every entry returns cudaGetLastError().
_ENTRIES = {
    "streamline_step": "PPPPP IIII R I PPPPPPPP",
    "pathline_step": "PPPPPP IIIII RRRR I PPPPPPPPP",
    "window_streamline_step": "PPPPPPP IIIII R I PPPPPPPPPP",
    "window_pathline_step": "PPPPPPPPP IIIIII RRRR I PPPPPPPPPPP",
}


def _library() -> ctypes.CDLL:
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(str(build()))
        P, I = ctypes.c_void_p, ctypes.c_int
        for tag, real in (("f32", ctypes.c_float), ("f64", ctypes.c_double)):
            types = {"P": P, "I": I, "R": real}
            for entry, codes in _ENTRIES.items():
                fn = getattr(lib, f"{entry}_{tag}")
                fn.argtypes = [types[c] for c in codes.replace(" ", "")]
                fn.restype = I
        for name in ("stage_kernel_k_max", "stage_kernel_l_max",
                     "stage_kernel_a_max", "stage_kernel_w_max"):
            getattr(lib, name).argtypes = []
            getattr(lib, name).restype = I
        for name in ("streamline_step_layout", "pathline_step_layout"):
            getattr(lib, name).argtypes = [I, I, I, ctypes.POINTER(I),
                                           ctypes.POINTER(I)]
            getattr(lib, name).restype = None
        if (lib.stage_kernel_k_max(), lib.stage_kernel_l_max(),
                lib.stage_kernel_a_max(), lib.stage_kernel_w_max()) \
                != (K_MAX, L_MAX, A_MAX, W_MAX):
            raise RuntimeError("kernel ceilings disagree with the wrapper")
        _lib = lib
    return _lib


def _check(name, pos, depth_neg, nv, vids, tables, n_layers, n_attrs,
           window=None):
    """Device, dtype, shape and contiguity checks of a wrapper's inputs,
    and with ``window`` = (s, rises, W) of the window starts and width and
    of each table's first rises (table_rise); returns (N, K, F)."""
    if not 0 <= n_attrs <= A_MAX:
        raise ValueError(f"{name}: n_attrs={n_attrs} outside 0..{A_MAX}")
    F = table_width(n_layers, n_attrs)
    n, K = vids.shape
    real = pos.dtype
    if real not in (torch.float32, torch.float64):
        raise TypeError(f"{name}: unsupported dtype {real}")
    if tuple(pos.shape) != (n, 3) or tuple(depth_neg.shape) != (n,) \
            or tuple(nv.shape) != (n,) \
            or any(t.ndim != 2 or t.shape[1] != F for t in tables):
        raise ValueError(
            f"{name}: shapes pos (N,3), depth_neg (N,), nv (N,), vids (N,K), "
            f"tables (nV,{F}) expected; got {tuple(pos.shape)}, "
            f"{tuple(depth_neg.shape)}, {tuple(nv.shape)}, {tuple(vids.shape)}, "
            f"{[tuple(t.shape) for t in tables]}")
    if depth_neg.dtype != real or any(t.dtype != real for t in tables):
        raise TypeError(f"{name}: pos, depth_neg and the tables must share "
                        "one float dtype")
    if nv.dtype != torch.int32 or vids.dtype != torch.int32:
        raise TypeError(f"{name}: nv and vids must be int32")
    tensors = (pos, depth_neg, nv, vids, *tables)
    devices = {t.device for t in tensors}
    if len(devices) != 1:
        raise ValueError(f"{name}: tensors on {devices}")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError(f"{name}: inputs must be contiguous")
    if window is None:
        return n, K, F
    s, rises, n_window = window
    device = pos.device
    if tuple(s.shape) != (n,) or s.dtype != torch.int32 \
            or not s.is_contiguous() or s.device != device:
        raise ValueError(f"{name}: s must be a contiguous (N,) int32 tensor "
                         f"on {device}")
    for t, r in zip(tables, rises):
        if tuple(r.shape) != (t.shape[0],) or r.dtype != torch.int32 \
                or not r.is_contiguous() or r.device != device:
            raise ValueError(f"{name}: each table's rise must be a "
                             f"contiguous (nV,) int32 tensor on {device}")
    if not 2 <= n_window <= min(n_layers, W_MAX):
        raise ValueError(f"{name}: window W={n_window} outside 2 <= W <= "
                         f"min(L={n_layers}, {W_MAX})")
    return n, K, F


def _raise_on(name, err):
    if err != 0:
        raise RuntimeError(f"{name}: launch failed, cudaGetLastError() = {err}")


# The recorder's counter of each step kernel's launches is this prefix and
# the kernel's key in COUNT_KEYS; a launch of the double instance counts
# under F64_LAUNCHES and the same key as well.
LAUNCHES = "kernels.launches."
F64_LAUNCHES = "kernels.f64_launches."


# The tally of held_counts on this thread, or None: launches count at once.
_held = threading.local()


def count_launch(key: str, real: torch.dtype) -> None:
    """Count one launch of the step kernel ``key`` (COUNT_KEYS) of dtype
    ``real``: in the recorder, or in held_counts' tally inside one.  The
    one place a launch is counted; a stand-in for a wrapper counts here."""
    names = [LAUNCHES + key]
    if real == torch.float64:
        names.append(F64_LAUNCHES + key)
    tally = getattr(_held, "tally", None)
    mgr = TimerManager.instance()
    for name in names:
        if tally is None:
            mgr.add(name)
        else:
            tally[name] = tally.get(name, 0) + 1


@contextlib.contextmanager
def held_counts():
    """Launches made inside on this thread are not counted but tallied in
    the dict yielded (counter name: launches): a CUDA graph's capture
    launches nothing, and its replays count with count_launches."""
    tally = {}
    _held.tally = tally
    try:
        yield tally
    finally:
        _held.tally = None


def count_launches(tally: dict, times: int) -> None:
    """Count each of held_counts' ``tally`` ``times`` over."""
    mgr = TimerManager.instance()
    for name, n in tally.items():
        mgr.add(name, n * times)


# The step kernels' launch counters: K1-K4 and the window paths' masked
# K1/K2 repairs.
COUNT_KEYS = ("k1", "k2", "k3", "k3 repair", "k4", "k4 repair")


def launch_counts() -> dict:
    """The step kernels' launch counts (the recorder's counters
    kernels.launches.<key>), keyed as COUNT_KEYS.  The K1/K2 instance a
    count launched is column_instance(L) of its run."""
    mgr = TimerManager.instance()
    return {key: mgr.counter(LAUNCHES + key) for key in COUNT_KEYS}


def reset_counts():
    """Every step kernel's launch count, and its double instance's, to 0."""
    mgr = TimerManager.instance()
    for key in COUNT_KEYS:
        mgr.reset_counter(LAUNCHES + key)
        mgr.reset_counter(F64_LAUNCHES + key)


# Each wrapper's name (in its errors) and C entry, by kernel key.
_WRAPPERS = {"k1": ("fused_streamline_step", "streamline_step"),
             "k2": ("fused_pathline_step", "pathline_step"),
             "k3": ("fused_window_streamline_step", "window_streamline_step"),
             "k4": ("fused_window_pathline_step", "window_pathline_step")}


def _ptrs(tensors):
    return [None if t is None else t.data_ptr() for t in tensors]


def _launch(key, plain, pos, depth_neg, nv, vids, tables, n_layers, dt,
            euler, alphas=(), n_attrs=0, window=None):
    """The body of the four step wrappers: check the inputs, return
    ``plain()`` for CPU tensors, else launch kernel ``key`` on the current
    stream and count it; a window kernel (``window`` = (s, rises, W))
    appends its miss lanes to a list, and the full-column kernel of its
    form (K1 or K2) then steps that list on the same stream.  One packed
    table is a streamline, two a pathline with ``alphas`` (a1, a2, a4).
    Returns (new_pos, hvel, wvel, ok), then (layer, miss, clamp) with a
    window, then attr (or None) on a pathline."""
    name, entry = _WRAPPERS[key]
    n, K, F = _check(name, pos, depth_neg, nv, vids, tables, n_layers,
                     n_attrs, window)
    if pos.device.type == "cpu":
        return plain()
    if pos.device.type != "cuda":
        raise ValueError(f"{name}: no kernel for {pos.device}")
    if K > K_MAX or n_layers > L_MAX or n_layers < 2:
        raise ValueError(f"{name}: K={K}, L={n_layers} outside the kernel's "
                         f"ceilings K <= {K_MAX}, 2 <= L <= {L_MAX}")
    real, dev = pos.dtype, pos.device
    pathline = len(tables) == 2
    flag = lambda: torch.empty(n, dtype=torch.bool, device=dev)
    ints = lambda k: torch.empty(k, dtype=torch.int32, device=dev)
    step = [torch.empty_like(pos), torch.empty_like(pos),
            torch.empty_like(depth_neg), flag()]
    attr = [torch.empty_like(pos) if n_attrs else None] if pathline else []
    sizes = [n, K, F, n_layers]
    scalars = ([n_attrs] if pathline else []) + [float(dt)] + [
        float(a) for a in alphas] + [int(bool(euler))]
    lib = _library()
    tag = "_f32" if real == torch.float32 else "_f64"
    full = getattr(lib, ("pathline" if pathline else "streamline")
                   + "_step" + tag)
    head = _ptrs([pos, depth_neg, nv, vids])
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        if window is None:
            _raise_on(name, full(*head, *_ptrs(tables), *sizes, *scalars,
                                 *_ptrs(step + attr), None, None, None,
                                 stream))
            count_launch(key, real)
            return (*step, *attr)
        s, rises, n_window = window
        found = [ints(n), flag(), flag()]            # layer, miss, clamp
        lst, cnt = ints(n), ints(1)
        _raise_on(name, getattr(lib, entry + tag)(
            *head, s.data_ptr(), *_ptrs(tables), *_ptrs(rises), *sizes,
            n_window, *scalars, *_ptrs(step + found + [lst, cnt] + attr),
            stream))
        count_launch(key, real)
        # the miss lanes' full-column step over their list
        _raise_on(f"{name} (repair)", full(
            *head, *_ptrs(tables), *sizes, *scalars,
            *_ptrs(step + attr + [lst, cnt, found[0]]), stream))
        count_launch(f"{key} repair", real)
    return (*step, *found, *attr)


def fused_streamline_step(pos, depth_neg, nv, vids, table, n_layers: int,
                          dt: float, euler: bool = False):
    """One fused streamline step (RK4, or Euler) for every particle.

    Args:
      pos (N, 3), depth_neg (N,) negative-down depth, nv (N,) int32 vertex
      counts and vids (N, K) int32 vertex ids (clipped to >= 0) of each
      particle's frozen cell, table (nV, F) from pack_vertex_table,
      n_layers L, dt signed seconds.
    Returns (new_pos (N, 3), hvel (N, 3), wvel (N,), ok (N,) bool).

    CUDA tensors launch the kernel (counted under "k1", launch_counts);
    CPU tensors run ``fused_streamline_step_plain``.
    """
    return _launch("k1", lambda: fused_streamline_step_plain(
        pos, depth_neg, nv, vids, table, n_layers, dt, euler),
        pos, depth_neg, nv, vids, (table,), n_layers, dt, euler)


def fused_streamline_step_plain(pos, depth_neg, nv, vids, table,
                                n_layers: int, dt: float, euler: bool = False,
                                exact_clamp: bool = True):
    """The same step as torch ops (the kernel's signature, plus the clamp
    form): gather the (N, K, F) rows, split them into the column tables and
    run step.streamline_step.  The kernel is the ``exact_clamp`` form.
    Invalid vertex ids are not the kernel's business (the caller masks
    them)."""
    vpos, (ztop, vel, wvel, _) = _split_rows(table, vids, n_layers, 0)
    return streamline_step(ztop, vel, wvel, pos, depth_neg, nv, vpos, dt,
                           euler, exact_clamp)


def fused_pathline_step(pos, depth_neg, nv, vids, table_f, table_b,
                        n_layers: int, dt: float, alphas, euler: bool = False,
                        n_attrs: int = 0):
    """One fused pathline step (RK4, or Euler) for every particle, against
    the front and back snapshots blended by the stage alphas.

    Args as fused_streamline_step, with one packed table per snapshot
    (pack_vertex_table with the first ``n_attrs`` <= 2 attributes stacked in
    both) and ``alphas`` = (a1, a2, a4), the time weights of stage 1,
    stages 2-3 and stage 4 (floats holding run-dtype values).
    Returns (new_pos (N, 3), hvel (N, 3), wvel (N,), ok (N,) bool,
    attr (N, 3) with slots >= n_attrs zero, or None when n_attrs == 0).

    CUDA tensors launch the kernel (counted under "k2", launch_counts);
    CPU tensors run ``fused_pathline_step_plain``.
    """
    return _launch("k2", lambda: fused_pathline_step_plain(
        pos, depth_neg, nv, vids, table_f, table_b, n_layers, dt, alphas,
        euler, n_attrs),
        pos, depth_neg, nv, vids, (table_f, table_b), n_layers, dt, euler,
        alphas, n_attrs)


def layout(entry: str, n_vertices: int, n_layers: int,
           dtype) -> tuple[int, int]:
    """Shared memory a particle (bytes) and particles a block of K1
    (``entry`` = "streamline") or K2 ("pathline"), as its launch sizes them
    for cells of ``n_vertices`` (K) vertices, ``n_layers`` layers and
    ``dtype``.  Builds the library at first use."""
    slot, particles = ctypes.c_int(), ctypes.c_int()
    getattr(_library(), f"{entry}_step_layout")(
        n_vertices, n_layers, torch.empty((), dtype=dtype).element_size(),
        ctypes.byref(slot), ctypes.byref(particles))
    return slot.value, particles.value


def _split_rows(table, vids, n_layers, n_attrs):
    """Gather the (N, K, F) rows of a packed table and split them into
    (vpos, (ztop, vel, wvel, attrs or None))."""
    L = n_layers
    n, K = vids.shape
    cols = table[vids.long()]                           # (N, K, F)
    o_w = 3 + 4 * L
    o_a = o_w + L + 1
    attrs = cols[..., o_a:].reshape(n, K, L, n_attrs) if n_attrs else None
    return cols[..., :3], (cols[..., 3:3 + L],
                           cols[..., 3 + L:o_w].reshape(n, K, L, 3),
                           cols[..., o_w:o_a], attrs)


def fused_pathline_step_plain(pos, depth_neg, nv, vids, table_f, table_b,
                              n_layers: int, dt: float, alphas,
                              euler: bool = False, n_attrs: int = 0,
                              exact_clamp: bool = True):
    """The same step as torch ops (the kernel's signature, plus the clamp
    form): gather the (N, K, F) rows of both tables and run
    step.pathline_step.  Vertex positions come from the front table.  The
    alphas are cast to the run dtype."""
    vpos, cols_f = _split_rows(table_f, vids, n_layers, n_attrs)
    _, cols_b = _split_rows(table_b, vids, n_layers, n_attrs)
    a = tuple(torch.as_tensor(x, dtype=pos.dtype, device=pos.device)
              for x in alphas)
    new_pos, hvel, wvel, ok, attr = pathline_step(
        cols_f, cols_b, pos, depth_neg, nv, vpos, dt, a, euler, n_attrs,
        exact_clamp)
    return new_pos, hvel, wvel, ok, attr if n_attrs else None


# ---------------------------------------------------------------------------
# the layer-window steps (K3, K4)
# ---------------------------------------------------------------------------

def table_rise(table: torch.Tensor, n_layers: int) -> torch.Tensor:
    """step.first_rise of a packed table's ztop columns: (nV,) int32, the
    window kernels' clamp-miss input, computed once per table."""
    return first_rise(table[:, 3:3 + n_layers]).contiguous()


def fused_window_streamline_step(pos, depth_neg, nv, vids, s, table, rise,
                                 n_layers: int, n_window: int, dt: float,
                                 euler: bool = False):
    """One streamline step (RK4, or Euler) whose stages read only the
    layers s..s+W-1 of each vertex column.

    Args as fused_streamline_step, plus s (N,) int32 window starts in
    [0, L - W] (step.window_starts), the table's first rises ``rise``
    (table_rise) and the window width W = ``n_window``.
    Returns (new_pos (N, 3), hvel (N, 3), wvel (N,), ok (N,) bool,
    layer (N,) int32, miss (N,) bool, clamp (N,) bool).  A lane is a miss
    when some stage may not resolve as on the full column (step.py, "the
    layer-window step"): its depth lay within EPS_LAYER of an inner window
    edge (an edge miss), or the window's clamp or its surface and bottom
    tests may depart from the full column's (a clamp miss; ``clamp`` flags
    the lanes that only this test flagged).  A miss lane's step is
    recomputed on the full column (K1's arithmetic), and a lane that does
    not miss computes what the full column computes, so every lane's
    outputs are the full step's.  layer is the layer at the start position
    (the next window's centre).

    CUDA tensors launch the window kernel (counted under "k3",
    launch_counts), which appends the miss lanes to a list, then K1 over
    that list on the same stream, which recomputes them (counted under "k3
    repair", not under K1's "k1"); CPU tensors run
    ``fused_window_streamline_step_plain``.
    """
    return _launch("k3", lambda: fused_window_streamline_step_plain(
        pos, depth_neg, nv, vids, s, table, rise, n_layers, n_window, dt,
        euler),
        pos, depth_neg, nv, vids, (table,), n_layers, dt, euler,
        window=(s, (rise,), n_window))


def _window_inputs(table, vids, s, n_layers, n_window, n_attrs):
    """(vpos, full columns, window columns, (surface, bottom) ztop)."""
    vpos, cols = _split_rows(table, vids, n_layers, n_attrs)
    cols_w = tuple(window_cols(c, s, n_window) for c in cols)
    return vpos, cols, cols_w, (cols[0][..., 0], cols[0][..., -1])


def fused_window_streamline_step_plain(pos, depth_neg, nv, vids, s, table,
                                       rise, n_layers: int, n_window: int,
                                       dt: float, euler: bool = False):
    """The same step as torch ops: step.window_streamline_step, then the
    miss lanes again through fused_streamline_step_plain with their start
    layer from the full column."""
    vpos, cols, cols_w, ends = _window_inputs(table, vids, s, n_layers,
                                              n_window, 0)
    new_pos, hvel, wvel, ok, layer, miss, clamp = window_streamline_step(
        cols_w, ends, s, n_layers, pos, depth_neg, nv, vpos, dt, euler,
        cell_rise(rise, vids, nv))
    idx = torch.nonzero(miss)[:, 0]
    if idx.numel():
        full = fused_streamline_step_plain(pos[idx], depth_neg[idx], nv[idx],
                                           vids[idx], table, n_layers, dt,
                                           euler)
        for dst, src in zip((new_pos, hvel, wvel, ok), full):
            dst[idx] = src
        layer[idx] = start_layer(cols[0][idx], pos[idx], depth_neg[idx],
                                 nv[idx], vpos[idx], False)
    return (new_pos, hvel, wvel, ok,
            torch.clamp(layer, 1, n_layers - 1).to(torch.int32), miss, clamp)


def fused_window_pathline_step(pos, depth_neg, nv, vids, s, table_f, table_b,
                               rise_f, rise_b, n_layers: int, n_window: int,
                               dt: float, alphas, euler: bool = False,
                               n_attrs: int = 0):
    """One pathline step (RK4, or Euler) whose stages read only the layers
    s..s+W-1 of both snapshots' columns (one start for both).

    Args as fused_pathline_step, plus s and W as in
    fused_window_streamline_step and each table's first rises (table_rise;
    each snapshot's window is tested with its own).  Returns (new_pos,
    hvel, wvel, ok, layer, miss, clamp, attr (N, 3) or None), miss and
    clamp as fused_window_streamline_step's, the OR over both snapshots;
    miss lanes are recomputed on the full columns (K2's arithmetic), and
    layer is the front snapshot's at the start position.

    CUDA tensors launch the window kernel (counted under "k4",
    launch_counts), then K2 over its list of miss lanes (counted under "k4
    repair"); CPU tensors run ``fused_window_pathline_step_plain``.
    """
    return _launch("k4", lambda: fused_window_pathline_step_plain(
        pos, depth_neg, nv, vids, s, table_f, table_b, rise_f, rise_b,
        n_layers, n_window, dt, alphas, euler, n_attrs),
        pos, depth_neg, nv, vids, (table_f, table_b), n_layers, dt, euler,
        alphas, n_attrs, (s, (rise_f, rise_b), n_window))


def fused_window_pathline_step_plain(pos, depth_neg, nv, vids, s, table_f,
                                     table_b, rise_f, rise_b, n_layers: int,
                                     n_window: int, dt: float, alphas,
                                     euler: bool = False, n_attrs: int = 0):
    """The same step as torch ops: step.window_pathline_step, then the miss
    lanes again through fused_pathline_step_plain with their start layer
    from the front snapshot's full column."""
    vpos, cols_f, cols_fw, ends = _window_inputs(table_f, vids, s, n_layers,
                                                 n_window, n_attrs)
    _, _, cols_bw, _ = _window_inputs(table_b, vids, s, n_layers, n_window,
                                      n_attrs)
    a = tuple(torch.as_tensor(x, dtype=pos.dtype, device=pos.device)
              for x in alphas)
    new_pos, hvel, wvel, ok, attr, layer, miss, clamp = window_pathline_step(
        cols_fw, cols_bw, ends, s, n_layers, pos, depth_neg, nv, vpos, dt, a,
        euler, (cell_rise(rise_f, vids, nv), cell_rise(rise_b, vids, nv)),
        n_attrs)
    idx = torch.nonzero(miss)[:, 0]
    if idx.numel():
        full = fused_pathline_step_plain(
            pos[idx], depth_neg[idx], nv[idx], vids[idx], table_f, table_b,
            n_layers, dt, alphas, euler, n_attrs)
        for dst, src in zip((new_pos, hvel, wvel, ok), full):
            dst[idx] = src
        if n_attrs:
            attr[idx] = full[4]
        layer[idx] = start_layer(cols_f[0][idx], pos[idx], depth_neg[idx],
                                 nv[idx], vpos[idx], True)
    return (new_pos, hvel, wvel, ok,
            torch.clamp(layer, 1, n_layers - 1).to(torch.int32), miss, clamp,
            attr if n_attrs else None)
