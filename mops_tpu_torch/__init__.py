"""mops_tpu_torch: MPAS-Ocean particle advection on PyTorch and CUDA.

The PyTorch port of mops_tpu (which stays the JAX reference).  It imports
torch, numpy and scipy only (no jax, yaml, matplotlib, PIL or h5py; h5py
only to open a NetCDF-4 file, matplotlib only for the task classes' plot).
It covers the single-device paths: synthetic meshes and fields, NetCDF and
stream-YAML ingest (io), preprocessing on the device, seed cell search and
seeding, RK4/Euler streamline and pathline advection through the fused
step kernels (csrc/stage_kernel.cu, built with nvcc at first use on a CUDA
card: K1 for a streamline, K2 for a pathline between two snapshots with up
to two named attributes, and their layer-window forms K3 and K4, which a
run on the card takes by default), trajectory finalization, fixed-depth,
fixed-layer and fixed-latitude remap (remap, torch ops over pixel chunks
on the device), the Field binding, the MOPS_* API and MOPSApp, the pymops
task classes, the PNG/VTI/VTP/text writers and the CLI
(``python -m mops_tpu_torch.cli``), the multi-device and multi-process
engines (parallel; ``python -m mops_tpu_torch.parallel.dist_smoke``), the
native host cell search (native, built with g++), the task agent (agent)
and the web front end (``python -m mops_tpu_torch.frontend.server``).

The entry points (``preprocess``, ``run_advection``, ``Field``,
``MOPS_Init``, the task classes, the CLI) run on the card; the CPU runs
only when the caller passes ``device="cpu"`` (then each kernel's plain
torch version stands in), and without a card a CUDA run raises.

Quick start on the card (synthetic mesh, no data files needed):

    import mops_tpu_torch as mtt
    mesh = mtt.synth.build_voronoi_mesh(2000, jitter=0.05, n_layers=8)
    raw = mtt.synth.solid_body_fields(mesh, n_layers=8)
    front = mtt.preprocess(mesh, raw)
    back = mtt.preprocess(mesh, mtt.synth.solid_body_fields(
        mesh, n_layers=8, omega=1.2e-5))
    seeds = mtt.seeding.generate_sample_points(
        mtt.SamplingSettings(sample_range=(10, 10), lat_range=(-40, 40),
                             lon_range=(-40, 40), depth=10.0))
    cells = mtt.CellSearch(mesh).query(seeds)
    cfg = mtt.TrajectorySettings(delta_t=600, simulation_duration=86400,
                                 record_t=3600)
    stream = mtt.run_advection(mesh, front, seeds, cells, cfg)
    path = mtt.run_advection(mesh, front, seeds, cells, cfg, back=back)
    lines = mtt.finalize_trajectories(
        seeds, path.points.cpu().numpy(), path.velocities.cpu().numpy(), cfg,
        attrs=path.attrs.cpu().numpy(), with_attrs=True)

The same on the CPU: pass ``device="cpu"`` to ``preprocess`` and
``run_advection``.  Through the API (remap, then a streamline):

    mtt.MOPS_Init("cuda", "fp64")
    mtt.MOPS_Begin()
    mtt.MOPS_AddGridMesh(mesh)
    mtt.MOPS_AddAttribute(1, raw)
    mtt.MOPS_End()
    mtt.MOPS_ActiveAttribute(1)
    imgs = mtt.MOPS_RunRemapping(mtt.VisualizationSettings(
        image_width=360, image_height=180, fixed_depth=10.0))
    lines = mtt.MOPS_RunStreamLine(cfg, seeds.copy())
"""

import torch

# Float32 matrix products (preprocessing's einsums) must stay full float32
# on the card: TF32 keeps about three decimal digits.
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

from . import (advect, api, cellsearch, config, field, geo,  # noqa: E402
               interp, mesh, parallel, remap, seeding, settings, solution,
               step, synth, trajectory)
from .advect import RawTrajectories, run_advection  # noqa: E402
from .api import (MOPS_ActiveAttribute, MOPS_AddAttribute,  # noqa: E402
                  MOPS_AddGridMesh, MOPS_Begin, MOPS_End,
                  MOPS_GenerateSamplePoints, MOPS_GetCategoryTime,
                  MOPS_GetFieldSnapshots, MOPS_GetTotalTime, MOPS_Init,
                  MOPS_PrintTimingDetailed, MOPS_PrintTimingSummary,
                  MOPS_ResetTiming, MOPS_RunPathLine, MOPS_RunReGrid,
                  MOPS_RunRemapping, MOPS_RunStreamLine, MOPSApp, solution_id)
from .cellsearch import BucketGrid, CellSearch  # noqa: E402
from .config import EARTH_RADIUS, precision  # noqa: E402
from .field import Field  # noqa: E402
from .mesh import MPASMesh  # noqa: E402
from .settings import (ONE_DAY, ONE_HOUR, ONE_MINUTE, ONE_MONTH,  # noqa: E402
                       ONE_SECOND, ONE_WEEK, ONE_YEAR, CalcDirection,
                       CalcMethod, FailMode, SamplingSettings, SaveType,
                       TrajectoryLine, TrajectorySettings,
                       VisualizationSettings, VisualizeType)
from .solution import SolutionFields, preprocess  # noqa: E402
from .trajectory import (finalize_trajectories,  # noqa: E402
                         remove_nan_trajectories_and_reindex)

__version__ = "0.5.0"


def _git_revision() -> str:
    """The checkout's short git SHA, or "unknown" outside a git checkout
    (the reference bakes it at configure time, CMakeLists.txt:77-100)."""
    import os
    import subprocess
    try:
        out = subprocess.run(
            ["git", "rev-parse", "--short", "HEAD"],
            cwd=os.path.dirname(os.path.abspath(__file__)),
            capture_output=True, text=True, timeout=5)
    except (OSError, subprocess.SubprocessError):
        return "unknown"
    return out.stdout.strip() or "unknown"


def version_string() -> str:
    """'<semver>+g<sha>' like the reference's MOPS_VERSION_FULL
    (mops_tpu.version_string)."""
    return f"{__version__}+g{_git_revision()}"
