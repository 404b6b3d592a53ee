"""Public MOPS-compatible API over the port (mirror of mops_tpu.api).

Mirrors include/api/MOPS.h (reference :20-148) and the MOPSApp state
machine (src/Core/MOPSApp.h:24: Uninitialized -> Configuring -> Ready).
Function names keep the reference's MOPS_* spelling so reference scripts
port mechanically.  An app runs on the card unless ``init`` is given
device="cpu"; without a card a CUDA app raises.  ``precision`` ("fp64" or
"fp32") is the dtype of the preprocessing, the field and the advection.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional

import numpy as np
import torch

from . import advect, config, remap as remap_mod, seeding, trajectory
from .field import Field
from .mesh import MPASMesh, resolve_device
from .parallel.sharding import device_list
from .settings import (SamplingSettings, SaveType, TrajectoryLine,
                       TrajectorySettings, VisualizationSettings,
                       VisualizeType)
from .solution import SolutionFields, preprocess
from .utils import TimerManager, timer

def solution_id(time_stamp: str, timestep: int) -> int:
    """32-bit FNV-1a hash of "<timeStamp>_<timestep>" as a signed int
    (reference MPASOSolution::getID, src/Core/MPASOSolution.h:74-82)."""
    key = f"{time_stamp}_{timestep}"
    h = 2166136261
    for c in key.encode():
        h = ((h ^ c) * 16777619) & 0xFFFFFFFF
    return h - (1 << 32) if h >= (1 << 31) else h


class _State:
    UNINITIALIZED = "uninitialized"
    CONFIGURING = "configuring"
    READY = "ready"


@dataclasses.dataclass
class MOPSApp:
    """Orchestration object (reference src/Core/MOPSApp.{h,cpp})."""

    device: object = "cuda"
    state: str = _State.UNINITIALIZED
    mesh: Optional[MPASMesh] = None
    solutions: Dict[int, SolutionFields] = dataclasses.field(default_factory=dict)
    field: Optional[Field] = None
    precision: str = "fp64"
    devices: list = dataclasses.field(default_factory=list)

    # -- lifecycle ----------------------------------------------------------
    def init(self, device="cuda", precision: str = "fp64",
             devices: int = 1) -> None:
        """Select the device (the card unless device="cpu") and the
        precision.  ``devices`` > 1 splits the particles of every trajectory
        run over that many devices (run_advection's ``devices``): cards
        0..n-1, or n CPU shards with device="cpu"; more than the machine's
        cards raises."""
        config.precision(precision)          # raises on an unknown mode
        self.device = resolve_device(device)
        self.devices = self._devices_for(devices)
        self.precision = precision
        name = torch.cuda.get_device_name(self.device) \
            if self.device.type == "cuda" else "cpu"
        print(" [ system information ]")
        print(f"Device selected : {self.device.type}:{name} "
              f"x{len(self.devices)}")
        print(f"Precision mode  : {precision}")
        self.state = _State.UNINITIALIZED

    def _devices_for(self, n: int) -> list:
        """The devices of a run split over ``n``: cards 0..n-1 (or n CPU
        shards) for n > 1, raising where the machine has fewer; else the
        app's device."""
        return device_list(n, self.device.type) if int(n) > 1 \
            else [self.device]

    def begin(self) -> None:
        self.state = _State.CONFIGURING

    def end(self) -> None:
        if self.state != _State.CONFIGURING:
            raise RuntimeError("MOPS_End called outside Configuring state "
                               "(reference src/Core/MOPS.cpp:31-44)")
        if self.mesh is None or not self.solutions:
            raise RuntimeError("grid/solution missing at MOPS_End")
        first = next(iter(self.solutions.values()))
        self.field = self._field(first)
        self.state = _State.READY

    # -- ingestion ----------------------------------------------------------
    def add_grid(self, mesh: MPASMesh) -> None:
        with timer("Preprocessing::addGrid", "Preprocessing"):
            self.mesh = mesh
            # KD structure built lazily by Field.search

    def add_solution(self, sol_id: int, raw_or_fields, timestamp: str = "",
                     timestep: int = 0) -> None:
        """Register a timestep.  Accepts either raw NetCDF-named arrays
        (dict), preprocessed on the app's device in its precision, or an
        already-preprocessed SolutionFields (reference MOPSApp::addSol,
        src/Core/MOPSApp.cpp:77-137, including the skip-if-present check)."""
        if sol_id in self.solutions:
            return
        with timer("Preprocessing::addSol", "Preprocessing"):
            if isinstance(raw_or_fields, SolutionFields):
                fields = raw_or_fields
            else:
                if self.mesh is None:
                    raise RuntimeError("add grid before solutions")
                fields = preprocess(
                    self.mesh.to(self.device, self._dtype()), raw_or_fields,
                    timestamp=timestamp, timestep=timestep,
                    dtype=self._dtype(), device=self.device)
            self.solutions[sol_id] = fields

    def active_attribute(self, id1: int, id2: Optional[int] = None) -> None:
        if id1 not in self.solutions or (id2 is not None and id2 not in self.solutions):
            raise KeyError(f"solution id not found: {id1}/{id2}")
        back = self.solutions[id2] if id2 is not None else None
        self.field = self._field(self.solutions[id1], back,
                                 self.field._search if self.field else None)

    # -- runs ---------------------------------------------------------------
    def generate_sample_points(self, cfg: SamplingSettings) -> np.ndarray:
        if cfg.at_cell_center:
            return seeding.generate_sample_points_at_centers(self.mesh)
        return seeding.generate_sample_points(cfg)

    def _advect(self, sample_points, cfg, back=None,
                devices: Optional[int] = None):
        """One trajectory run from the field's tables (moved to the app's
        device once), its particles split over the app's devices, or for
        this run only over ``devices`` of them (as ``init``'s: more than
        the machine's cards raises)."""
        run_devices = self.devices if devices is None \
            else self._devices_for(devices)
        cells = self.field.calc_in_which_cells(sample_points)
        mesh, front = self.field.device_tables()
        return advect.run_advection(mesh, front, sample_points, cells, cfg,
                                    back=back, dtype=self._dtype(),
                                    devices=run_devices)

    def run_streamline(self, cfg: TrajectorySettings,
                       sample_points: np.ndarray,
                       devices: Optional[int] = None) -> List[TrajectoryLine]:
        """Streamline; ``devices`` (None: init's) splits this run's
        particles over that many devices."""
        self._require_ready()
        with timer("GPUKernel::StreamLine", "GPUKernel"):
            raw = self._advect(sample_points, cfg, devices=devices)
            lines = trajectory.finalize_trajectories(
                sample_points, raw.points.cpu().numpy(),
                raw.velocities.cpu().numpy(), cfg)
        return lines

    def run_pathline(self, cfg: TrajectorySettings,
                     sample_points: np.ndarray,
                     devices: Optional[int] = None) -> List[TrajectoryLine]:
        """Pathline; like the reference, advances ``sample_points`` in place
        to each line's lastPoint for month-pair chaining (reference
        src/Core/MOPSApp.cpp:287-291).  ``devices`` as run_streamline's."""
        self._require_ready()
        if self.field.back is None:
            raise RuntimeError("pathline needs two active solutions "
                               "(reference src/Core/MOPSApp.cpp:266-271)")
        with timer("GPUKernel::PathLine", "GPUKernel"):
            raw = self._advect(sample_points, cfg, back=self.field.back,
                               devices=devices)
            lines = trajectory.finalize_trajectories(
                sample_points, raw.points.cpu().numpy(),
                raw.velocities.cpu().numpy(), cfg,
                attrs=None if raw.attrs is None else raw.attrs.cpu().numpy(),
                with_attrs=raw.attrs is not None)
        for i, line in enumerate(lines):
            sample_points[i] = line.last_point
        return lines

    def run_remapping(self, cfg: VisualizationSettings) -> List[np.ndarray]:
        """Rasterize per cfg.visualize_type: kFixedDepth -> depth remap
        (reference MOPSApp::runRemapping), kFixedLayer -> direct layer map
        (reference MPASOVisualizer::VisualizeFixedLayer)."""
        self._require_ready()
        with timer("GPUKernel::Remapping", "GPUKernel"):
            if cfg.visualize_type == VisualizeType.FIXED_LAYER:
                imgs = [remap_mod.run_fixed_layer(self.field, cfg)]
            else:
                imgs = remap_mod.run_remapping(self.field, cfg)
        if cfg.save_type != SaveType.NONE:
            from .io import image as imgio
            base = f"remap_t{cfg.time_step}"
            with timer("IO::saveRemap", "IO_Write"):
                if cfg.save_type == SaveType.VTI:
                    names = ["velocity"] + [f"attrs{g}" for g
                                            in range(len(imgs) - 1)]
                    imgio.save_vti(base + ".vti", imgs, names)
                elif cfg.save_type == SaveType.PNG:
                    imgio.save_image_channels_png(
                        base, imgs[0], ("east", "north", "speed"))
        return imgs

    def run_regrid(self, cfg: VisualizationSettings) -> np.ndarray:
        self._require_ready()
        with timer("GPUKernel::ReGrid", "GPUKernel"):
            return remap_mod.run_regrid(self.field, cfg)

    def _require_ready(self) -> None:
        if self.state != _State.READY or self.field is None:
            raise RuntimeError("MOPS app not Ready (call MOPS_End first)")

    def _dtype(self) -> torch.dtype:
        return config.precision(self.precision).real

    def _field(self, front, back=None, search=None) -> Field:
        return Field(self.mesh, front, back, device=self.device,
                     dtype=self._dtype(), _search=search)


# ---------------------------------------------------------------------------
# global-app free functions (reference src/Core/MOPS.cpp:10-127)
# ---------------------------------------------------------------------------

app = MOPSApp()


def MOPS_Init(device="cuda", precision: str = "fp64",
              devices: int = 1) -> None:
    app.init(device, precision, devices=devices)


def MOPS_Begin() -> None:
    app.begin()


def MOPS_End() -> None:
    app.end()


def MOPS_AddGridMesh(mesh: MPASMesh) -> None:
    app.add_grid(mesh)


def MOPS_AddAttribute(sol_id: int, raw_or_fields, timestamp: str = "",
                      timestep: int = 0) -> None:
    app.add_solution(sol_id, raw_or_fields, timestamp, timestep)


def MOPS_ActiveAttribute(t1: int, t2: Optional[int] = None) -> None:
    app.active_attribute(t1, t2)


def MOPS_RunRemapping(cfg: VisualizationSettings) -> List[np.ndarray]:
    return app.run_remapping(cfg)


def MOPS_RunReGrid(cfg: VisualizationSettings) -> np.ndarray:
    return app.run_regrid(cfg)


def MOPS_RunStreamLine(cfg: TrajectorySettings,
                       sample_points: np.ndarray) -> List[TrajectoryLine]:
    return app.run_streamline(cfg, sample_points)


def MOPS_RunPathLine(cfg: TrajectorySettings,
                     sample_points: np.ndarray) -> List[TrajectoryLine]:
    return app.run_pathline(cfg, sample_points)


def MOPS_GenerateSamplePoints(cfg: SamplingSettings) -> np.ndarray:
    return app.generate_sample_points(cfg)


def MOPS_GetFieldSnapshots() -> Optional[Field]:
    return app.field


def MOPS_ResetTiming() -> None:
    TimerManager.instance().reset()


def MOPS_PrintTimingSummary() -> None:
    TimerManager.instance().print_summary()


def MOPS_PrintTimingDetailed() -> None:
    TimerManager.instance().print_detailed()


def MOPS_GetCategoryTime(category: str) -> float:
    return TimerManager.instance().category_time(category)


def MOPS_GetTotalTime() -> float:
    return TimerManager.instance().total_time()
