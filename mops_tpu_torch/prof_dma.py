"""Row-gather probe on the card: how fast K5 brings table rows on chip by id.

    python -m mops_tpu_torch.prof_dma                     # prof_dma.py's shape
    python -m mops_tpu_torch.prof_dma --table streamline  # the slice's tables
    python -m mops_tpu_torch.prof_dma --table pathline

The counterpart of the TPU probe prof_dma.py: gather N rows of a table by
id, B = 512 rows to a block (kernels/row_gather.py), and print the time per
call and the rate of gathered bytes.  The default shape is prof_dma.py's:
a (20,000, 3,072) float32 table from ``numpy.random.default_rng(0)`` and
65,536 ids from ``default_rng(1)`` (805 MB gathered from 246 MB).  With
``--table`` the table is a main path's packed vertex table at the slice's
shape (a synthetic 236,853-cell mesh with 60 layers; ``streamline``: the
crossing-regime field, F = 304; ``pathline``: the front snapshot with two
attributes, F = 424), and the ids are the valid vertex slots of the cells of
a 400x400 global seed grid, trimmed to a multiple of B: what one step costs
to bring every particle's rows on chip once.  Needs a card.
"""

from __future__ import annotations

import argparse
import json

import numpy as np
import torch

from . import advect, seeding, synth
from .cellsearch import CellSearch
from .kernels.row_gather import BLOCK_ROWS, row_gather_probe
from .kernels.stage_kernel import pack_vertex_table
from .settings import SamplingSettings
from .solution import preprocess

# prof_dma.py's constants: table rows, row width, ids.
N_TABLE_ROWS, ROW_WIDTH, N_IDS = 20000, 3072, 65536
PEAK_BYTES_PER_S = 3.35e12     # H100 SXM HBM3 (NVIDIA data sheet)
# The slice that chip_smoke.py's main paths run: EC30to60E2r2's cell count
# and level count on a jittered synthetic Voronoi sphere, a 400x400 global
# seed grid; the crossing-regime streamline field; the pathline tutorial's
# two snapshots at ocean speeds (3e-7 rad/s is 1.9 m/s at the equator, a
# strong current), the back one 1.2 times faster, as the second snapshot of
# scripts/bench_refscale.py:189-191.
SLICE_CELLS, SLICE_LAYERS, SEED_SIDE = 236853, 60, 400
MESH_KW = dict(jitter=0.05, seed=0)
FIELD_KW = dict(w_scale=1e-3, bathymetry_amp=0.5, shelf_lon=0.3,
                omega_decay=1.0)
PATH_OMEGA, BACK_OMEGA = 3e-7, 3.6e-7


def slice_mesh():
    """The slice's host mesh."""
    return synth.build_voronoi_mesh(SLICE_CELLS, n_layers=SLICE_LAYERS,
                                    **MESH_KW)


def slice_seeds():
    """The slice's global seed grid, (SEED_SIDE + 1)^2 points."""
    return seeding.generate_sample_points(SamplingSettings(
        sample_range=(SEED_SIDE + 1, SEED_SIDE + 1), lat_range=(-90, 90),
        lon_range=(-180, 180)))


def prof_dma_inputs(device):
    """prof_dma.py's table (as (nC, KF)) and ids, from its seeds."""
    tab = np.random.default_rng(0).normal(size=(N_TABLE_ROWS * ROW_WIDTH,))
    cid = np.random.default_rng(1).integers(0, N_TABLE_ROWS, size=(N_IDS,))
    table = torch.as_tensor(tab.astype(np.float32).reshape(N_TABLE_ROWS,
                                                           ROW_WIDTH))
    return (table.to(device),
            torch.as_tensor(cid.astype(np.int32)).to(device))


def vertex_slot_ids(vids, nv, block_rows: int = BLOCK_ROWS):
    """The valid vertex slots (k < nv) of (N, K) cell vertex ids, particle
    by particle, trimmed to a multiple of ``block_rows``: (ids, dropped)."""
    valid = torch.arange(vids.shape[1], device=vids.device)[None, :] \
        < nv[:, None]
    ids = vids[valid]
    keep = ids.numel() // block_rows * block_rows
    return ids[:keep].to(torch.int32).contiguous(), int(ids.numel() - keep)


def slice_inputs(kind: str, device):
    """A main path's packed vertex table and the valid vertex slots of the
    seeds' cells: (table, ids, dropped)."""
    mesh_h = slice_mesh()
    omega = {} if kind == "streamline" else {"omega": PATH_OMEGA}
    raw = synth.solid_body_fields(mesh_h, n_layers=SLICE_LAYERS, **FIELD_KW,
                                  **omega)
    mesh = mesh_h.to(device, torch.float32)
    sol = preprocess(mesh, raw, dtype=torch.float32, device=device)
    attrs = advect.stacked_vertex_attrs(sol)[..., :2] \
        if kind == "pathline" else None
    table = pack_vertex_table(mesh.vertex_xyz, sol.vertex_ztop,
                              sol.vertex_velocity, sol.vertex_vert_velocity,
                              attrs)
    seeds = slice_seeds()
    cells = CellSearch(mesh_h).query(seeds)
    vids, nv, _ = advect._gather_cell_vertices(
        mesh, torch.as_tensor(cells, device=device).clamp(min=0))
    return (table, *vertex_slot_ids(vids, nv))


def event_ms(fn, reps: int) -> float:
    """Milliseconds per call of ``fn`` over ``reps`` calls after one warm-up
    call (CUDA events)."""
    fn()
    torch.cuda.synchronize()
    a, b = torch.cuda.Event(True), torch.cuda.Event(True)
    a.record()
    for _ in range(reps):
        fn()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / reps


def bound(table, ids, block_rows: int = BLOCK_ROWS):
    """The least time one probe call could take on the card: each unique row
    read once, the ids read and the outputs written once, over the memory
    rate (ms, bytes); and the gathered bytes over the same rate (ms), the
    bound where no row is found in L2."""
    size = table.element_size()
    F = table.shape[1]
    n = ids.numel()
    unique = int(torch.unique(ids).numel())
    nbytes = unique * F * size + 4 * n + n // block_rows * (1024 * size + 8)
    gathered = n * F * size
    return (nbytes / PEAK_BYTES_PER_S * 1e3, nbytes, unique,
            gathered / PEAK_BYTES_PER_S * 1e3)


def measure(table, ids, block_rows: int = BLOCK_ROWS, reps: int = 20):
    """Time the probe (``reps`` launches after one warm-up) and check block
    0's head against its first rows (prof_dma.py:38-40).  Returns a dict of
    the shape, ms, GB/s of gathered bytes and the bound."""
    n, F = ids.numel(), table.shape[1]
    head, _ = row_gather_probe(table, ids, block_rows)
    torch.cuda.synchronize()
    want = table[ids[:block_rows].long()].reshape(-1)[:1024]
    if not torch.equal(head[0], want):
        raise RuntimeError("row_gather_probe: block 0's head is not its rows")
    ms = event_ms(lambda: row_gather_probe(table, ids, block_rows), reps)
    gathered = n * F * table.element_size()
    b_ms, b_bytes, unique, g_ms = bound(table, ids, block_rows)
    return {"rows": n, "row_bytes": F * table.element_size(),
            "table_bytes": table.numel() * table.element_size(),
            "gathered_bytes": gathered, "ms": ms,
            "gb_per_s": gathered / (ms * 1e-3) / 1e9,
            "unique_rows": unique, "bound_ms": b_ms, "bound_bytes": b_bytes,
            "gathered_bound_ms": g_ms}


def main(argv=None):
    """Run the probe as the command line asks; returns (the measured dict,
    the table, the ids), so that a caller can check and compare the kernel
    on the same inputs."""
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--table", choices=["prof_dma", "streamline",
                                            "pathline"], default="prof_dma")
    parser.add_argument("--reps", type=int, default=20)
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("prof_dma: no CUDA card; the probe runs on the card")
    dev = torch.device("cuda")
    dropped = 0
    if args.table == "prof_dma":
        table, ids = prof_dma_inputs(dev)
    else:
        table, ids, dropped = slice_inputs(args.table, dev)
    res = measure(table, ids, BLOCK_ROWS, args.reps)
    res.update(table=args.table, dropped_ids=dropped,
               device=torch.cuda.get_device_name(0))
    print(f"row gather {res['rows']} rows x {res['row_bytes']}B: "
          f"{res['ms']:.3f} ms ({res['gb_per_s']:.0f} GB/s); bound "
          f"{res['bound_ms']:.4f} ms ({res['unique_rows']} unique rows), "
          f"gathered bytes over the memory rate {res['gathered_bound_ms']:.4f}"
          f" ms", flush=True)
    print(json.dumps(res), flush=True)
    return res, table, ids


if __name__ == "__main__":
    main()
