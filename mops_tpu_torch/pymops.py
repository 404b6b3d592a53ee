"""High-level task classes: MOPSRemapping / MOPSReGrid / MOPSStreamline /
MOPSPathline (mirror of mops_tpu.pymops).

Re-design of the reference pyMOPSAPI layer (reference
tutorial/pyMOPSAPI.py:292,637,886,1179): each class owns the full pipeline --
ingest (YAML dataset or synthetic), preprocessing, run, save, and a
matplotlib rendering (the reference uses cartopy).  A task runs on
``device``, the card unless the caller passes "cpu", in ``precision``;
only ``plot`` needs matplotlib, imported when it is called.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from . import api, geo, seeding, synth
from .io import MPASOReader, StreamConfig, image as imgio
from .mesh import resolve_device
from .settings import (CalcMethod, FailMode, SamplingSettings,
                       TrajectoryLine, TrajectorySettings,
                       VisualizationSettings, ONE_DAY, ONE_HOUR, ONE_MINUTE)


@dataclasses.dataclass
class _TaskBase:
    """Shared ingest/configure plumbing."""

    yaml_path: Optional[str] = None
    synthetic_cells: int = 5000
    synthetic_layers: int = 20
    timestep: int = 0
    precision: str = "fp64"
    output_dir: str = "outputs"
    device: str = "cuda"

    def __post_init__(self):
        resolve_device(self.device)       # no card and no "cpu": raise now
        self.app = api.MOPSApp()
        self._reader: Optional[MPASOReader] = None
        self._prepared = False

    def _load_raw(self, timestep: int) -> Dict:
        if self.yaml_path:
            if self._reader is None:
                self._reader = MPASOReader(StreamConfig.parse(self.yaml_path))
            raw = self._reader.read_solution(timestep)
            raw.pop("_timestamp", None)
            return raw
        raw = synth.solid_body_fields(self._mesh,
                                      n_layers=self.synthetic_layers)
        return raw

    def _prepare(self, timesteps: Sequence[int] = (0,)):
        if self._prepared:
            return
        os.makedirs(self.output_dir, exist_ok=True)
        self.app.init(self.device, precision=self.precision)
        self.app.begin()
        if self.yaml_path:
            self._reader = MPASOReader(StreamConfig.parse(self.yaml_path))
            self._mesh = self._reader.read_mesh()
        else:
            self._mesh = synth.build_voronoi_mesh(
                self.synthetic_cells, jitter=0.05,
                n_layers=self.synthetic_layers)
        self.app.add_grid(self._mesh)
        for t in timesteps:
            self.app.add_solution(t, self._load_raw(t), timestep=t)
        self.app.end()
        self._prepared = True


@dataclasses.dataclass
class MOPSRemapping(_TaskBase):
    """Fixed-depth global remap (reference pyMOPSAPI.MOPSRemapping:292)."""

    width: int = 1201
    height: int = 601
    fixed_depth: float = 10.0
    lat_range: Tuple[float, float] = (-90.0, 90.0)
    lon_range: Tuple[float, float] = (-180.0, 180.0)

    def run(self) -> List[np.ndarray]:
        self._prepare([self.timestep])
        self.app.active_attribute(self.timestep)
        cfg = VisualizationSettings(
            image_width=self.width, image_height=self.height,
            lat_range=self.lat_range, lon_range=self.lon_range,
            fixed_depth=self.fixed_depth)
        self.images = self.app.run_remapping(cfg)
        return self.images

    def save(self, prefix: str = "remap") -> List[str]:
        base = os.path.join(self.output_dir, prefix)
        paths = imgio.save_image_channels_png(
            base, self.images[0], ("east", "north", "speed"))
        imgio.save_vti(base + ".vti", self.images,
                       ["velocity", "attrs"][:len(self.images)])
        return paths + [base + ".vti"]

    def plot(self, path: Optional[str] = None, channel: int = 2):
        import matplotlib
        matplotlib.use("Agg")
        import matplotlib.pyplot as plt
        fig, ax = plt.subplots(figsize=(10, 5))
        im = ax.imshow(self.images[0][..., channel],
                       extent=(*self.lon_range, *self.lat_range),
                       origin="upper", cmap="viridis")
        fig.colorbar(im, ax=ax, label=["east", "north", "speed"][channel])
        ax.set_xlabel("lon"), ax.set_ylabel("lat")
        out = path or os.path.join(self.output_dir, "remap_plot.png")
        fig.savefig(out, dpi=120, bbox_inches="tight")
        plt.close(fig)
        return out


@dataclasses.dataclass
class MOPSReGrid(_TaskBase):
    """Fixed-latitude section (reference pyMOPSAPI.MOPSReGrid:637)."""

    fixed_latitude: float = 45.0
    width: int = 720
    lon_range: Tuple[float, float] = (-180.0, 180.0)

    def run(self) -> np.ndarray:
        self._prepare([self.timestep])
        self.app.active_attribute(self.timestep)
        height = self.app.field.front.n_layers
        cfg = VisualizationSettings(
            image_width=self.width, image_height=height,
            lon_range=self.lon_range, fixed_latitude=self.fixed_latitude)
        self.image = self.app.run_regrid(cfg)
        return self.image

    def save(self, prefix: str = "regrid") -> List[str]:
        base = os.path.join(self.output_dir, prefix)
        return imgio.save_image_channels_png(base, self.image,
                                             ("east", "north"))


@dataclasses.dataclass
class MOPSStreamline(_TaskBase):
    """Steady-field trajectories (reference pyMOPSAPI.MOPSStreamline:886)."""

    lat_range: Tuple[float, float] = (20.0, 50.0)
    lon_range: Tuple[float, float] = (-80.0, -50.0)
    grid: Tuple[int, int] = (8, 8)
    depth: float = 10.0
    delta_t: int = ONE_MINUTE
    record_t: int = 6 * ONE_MINUTE
    duration: int = 5 * ONE_DAY
    method: CalcMethod = CalcMethod.RK4
    fail_mode: FailMode = FailMode.ZERO

    def run(self) -> List[TrajectoryLine]:
        self._prepare([self.timestep])
        self.app.active_attribute(self.timestep)
        seeds = self.app.generate_sample_points(SamplingSettings(
            sample_range=self.grid, lat_range=self.lat_range,
            lon_range=self.lon_range, depth=self.depth))
        cfg = TrajectorySettings(
            delta_t=self.delta_t, record_t=self.record_t,
            simulation_duration=self.duration, depth=self.depth,
            method=self.method, fail_mode=self.fail_mode)
        self.lines = self.app.run_streamline(cfg, seeds)
        return self.lines

    def save(self, name: str = "streamline") -> List[str]:
        base = os.path.join(self.output_dir, name)
        imgio.save_trajectories_vtp(base + ".vtp", self.lines)
        imgio.save_trajectories_text(base + ".txt", self.lines)
        return [base + ".vtp", base + ".txt"]

    def plot(self, path: Optional[str] = None):
        import matplotlib
        matplotlib.use("Agg")
        import matplotlib.pyplot as plt
        fig, ax = plt.subplots(figsize=(10, 6))
        for line in self.lines:
            lat, lon = geo.xyz_to_latlon_rad(torch.as_tensor(line.points))
            ax.plot(np.rad2deg(lon.numpy()), np.rad2deg(lat.numpy()), lw=0.7)
        ax.set_xlabel("lon"), ax.set_ylabel("lat")
        out = path or os.path.join(self.output_dir, "streamline_plot.png")
        fig.savefig(out, dpi=120, bbox_inches="tight")
        plt.close(fig)
        return out


@dataclasses.dataclass
class MOPSPathline(_TaskBase):
    """Time-varying trajectories chained over snapshot pairs
    (reference pyMOPSAPI.MOPSPathline:1179 + tutorial/pathLine.cpp)."""

    timesteps: Sequence[int] = (0, 1)
    lat_range: Tuple[float, float] = (-60.0, 60.0)
    lon_range: Tuple[float, float] = (-180.0, 180.0)
    grid: Tuple[int, int] = (20, 20)
    depth_min: float = 10.0
    depth_max: float = 500.0
    delta_t: int = 10 * ONE_MINUTE
    record_t: int = 6 * ONE_HOUR
    duration_per_pair: int = ONE_DAY
    method: CalcMethod = CalcMethod.RK4
    fail_mode: FailMode = FailMode.ZERO

    def run(self) -> List[TrajectoryLine]:
        self._prepare(list(self.timesteps))
        seeds = self.app.generate_sample_points(SamplingSettings(
            sample_range=self.grid, lat_range=self.lat_range,
            lon_range=self.lon_range, depth=self.depth_min))
        depths = seeding.linear_depth_profile(len(seeds), self.depth_min,
                                              self.depth_max)
        all_lines: Optional[List[TrajectoryLine]] = None
        for t0, t1 in zip(self.timesteps[:-1], self.timesteps[1:]):
            self.app.active_attribute(t0, t1)
            cfg = TrajectorySettings(
                delta_t=self.delta_t, record_t=self.record_t,
                simulation_duration=self.duration_per_pair,
                particle_depths=depths, method=self.method,
                fail_mode=self.fail_mode)
            lines = self.app.run_pathline(cfg, seeds)
            if all_lines is None:
                all_lines = lines
            else:
                for full, seg in zip(all_lines, lines):
                    full.points = np.concatenate([full.points, seg.points[1:]])
                    full.velocity = np.concatenate(
                        [full.velocity, seg.velocity[1:]])
                    full.temperature = np.concatenate(
                        [full.temperature, seg.temperature[1:]])
                    full.salinity = np.concatenate(
                        [full.salinity, seg.salinity[1:]])
                    full.last_point = seg.last_point
        self.lines = all_lines
        return self.lines

    def save(self, name: str = "pathline") -> List[str]:
        base = os.path.join(self.output_dir, name)
        imgio.save_trajectories_vtp(base + ".vtp", self.lines)
        imgio.export_pathline_binary(base + ".bin", self.lines)
        return [base + ".vtp", base + ".bin"]
