"""Particle seeding: uniform lat-lon grids, cell centers, Gaussian clouds and
per-particle depth profiles (mirror of mops_tpu.seeding; reference
src/Core/MPASOVisualizer.cpp:120-193)."""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from . import geo
from .config import EARTH_RADIUS
from .mesh import MPASMesh
from .settings import SamplingSettings


def generate_sample_points(config: SamplingSettings) -> np.ndarray:
    """Uniform lat-lon grid seeds -> (N, 3) float64 XYZ at Earth radius.

    Replicates the reference's float-accumulation loop
    (MPASOVisualizer.cpp:125-135): ``for (i = minLat; i < maxLat; i += step)``
    with step = range/(n-1), which generally yields n-1 points per axis (the
    endpoint is excluded) -- including its floating-point stopping behavior.
    """
    min_lat, max_lat = config.lat_range
    min_lon, max_lon = config.lon_range
    n_lat, n_lon = config.sample_range
    i_step = (max_lat - min_lat) / float(n_lat - 1)
    j_step = (max_lon - min_lon) / float(n_lon - 1)

    lats = []
    i = min_lat
    while i < max_lat:
        lats.append(i)
        i += i_step
    lons = []
    j = min_lon
    while j < max_lon:
        lons.append(j)
        j += j_step

    lat_g, lon_g = np.meshgrid(np.asarray(lats), np.asarray(lons), indexing="ij")
    lat_r = torch.from_numpy(np.deg2rad(lat_g.ravel()))
    lon_r = torch.from_numpy(np.deg2rad(lon_g.ravel()))
    return geo.latlon_rad_to_xyz(lat_r, lon_r, EARTH_RADIUS).numpy()


def generate_sample_points_at_centers(mesh: MPASMesh) -> np.ndarray:
    """All cell centers as seeds (reference MOPSApp::generateSamplePointsAtCenter,
    src/Core/MOPSApp.cpp:218-229)."""
    return mesh.cell_xyz.detach().cpu().double().numpy().copy()


def generate_gaussian_points(config: SamplingSettings, n_points: int,
                             mean_lat: float, mean_lon: float, std_dev: float,
                             seed: Optional[int] = 0) -> np.ndarray:
    """Gaussian lat/lon cloud clipped to the sampling box by rejection,
    mirroring MPASOVisualizer::GenerateGaussianSpherePoints
    (reference src/Core/MPASOVisualizer.cpp:161-193), drawn from a
    numpy.random.Generator made from ``seed``."""
    min_lat, max_lat = config.lat_range
    min_lon, max_lon = config.lon_range
    rng = np.random.default_rng(seed)
    lats = np.empty(n_points)
    lons = np.empty(n_points)
    for i in range(n_points):
        lat = rng.normal(mean_lat, std_dev)
        while lat < min_lat or lat > max_lat:
            lat = rng.normal(mean_lat, std_dev)
        lon = rng.normal(mean_lon, std_dev)
        while lon < min_lon or lon > max_lon:
            lon = rng.normal(mean_lon, std_dev)
        lats[i], lons[i] = lat, lon
    return geo.latlon_rad_to_xyz(torch.from_numpy(np.deg2rad(lats)),
                                 torch.from_numpy(np.deg2rad(lons)),
                                 EARTH_RADIUS).numpy()


def linear_depth_profile(n_particles: int, depth_min: float,
                         depth_max: float) -> np.ndarray:
    """Per-particle depths spread linearly (reference tutorial/pathLine.cpp:106-127)."""
    return np.linspace(depth_min, depth_max, n_particles).astype(np.float32)
