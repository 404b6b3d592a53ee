"""Geodetic conversions on tensors (mirror of mops_tpu.geo).

All functions accept arbitrary leading batch dims.  Conventions as the
reference GeoConverter (src/Utils/GeoConverter.hpp): XYZ on the sphere with
z = r*sin(lat), lon measured from +x toward +y; ENU velocity is
(zonal/east, meridional/north) with the pole singularity mapped to zeros.
"""

from __future__ import annotations

import torch

from .config import EARTH_RADIUS


def pixel_to_latlon_deg(i, j, width, height, min_lat, max_lat, min_lon,
                        max_lon):
    """Image pixel (row i, col j) -> (lat, lon) degrees.

    Mirrors GeoConverter::convertPixelToLatLonToDegrees
    (reference src/Utils/GeoConverter.hpp:35-58): row 0 is max_lat, and the
    divisor is the full height/width (not height-1), matching the
    reference's half-open pixel grid.
    """
    lat = max_lat - (i / height) * (max_lat - min_lat)
    lon = (j / width) * (max_lon - min_lon) + min_lon
    return lat, lon


def pixel_to_latlon_rad(i: torch.Tensor, j: torch.Tensor, width, height,
                        min_lat, max_lat, min_lon, max_lon):
    lat, lon = pixel_to_latlon_deg(i, j, width, height, min_lat, max_lat,
                                   min_lon, max_lon)
    return torch.deg2rad(lat), torch.deg2rad(lon)


def latlon_rad_to_xyz(lat: torch.Tensor, lon: torch.Tensor,
                      r: float = EARTH_RADIUS) -> torch.Tensor:
    """(lat, lon) radians -> XYZ (reference GeoConverter.hpp:107-125)."""
    clat = torch.cos(lat)
    x = r * clat * torch.cos(lon)
    y = r * clat * torch.sin(lon)
    z = r * torch.sin(lat)
    return torch.stack([x, y, z], dim=-1)


def xyz_to_latlon_rad(p: torch.Tensor):
    """XYZ -> (lat, lon) radians (reference GeoConverter.hpp:127-150)."""
    r = torch.linalg.vector_norm(p, dim=-1)
    lat = torch.arcsin(p[..., 2] / r)
    lon = torch.atan2(p[..., 1], p[..., 0])
    return lat, lon


def _enu_coeffs(p: torch.Tensor):
    """(slon, clon, slat, clat, at_pole) geometric coefficients at point p."""
    x, y, z = p[..., 0], p[..., 1], p[..., 2]
    rxy = torch.sqrt(x * x + y * y)
    rxyz = torch.sqrt(x * x + y * y + z * z)
    at_pole = (x == 0.0) & (y == 0.0)
    safe_rxy = torch.where(at_pole, torch.ones_like(rxy), rxy)
    safe_rxyz = torch.where(rxyz == 0.0, torch.ones_like(rxyz), rxyz)
    slon = y / safe_rxy
    clon = x / safe_rxy
    slat = z / safe_rxyz
    clat = rxy / safe_rxyz
    return slon, clon, slat, clat, at_pole


def xyz_velocity_to_enu(p: torch.Tensor, vel: torch.Tensor):
    """XYZ velocity -> (zonal, meridional) (reference GeoConverter.hpp:200-223)."""
    slon, clon, slat, clat, at_pole = _enu_coeffs(p)
    vx, vy, vz = vel[..., 0], vel[..., 1], vel[..., 2]
    uzon = -slon * vx + clon * vy
    umer = -slat * (clon * vx + slon * vy) + clat * vz
    zero = torch.zeros_like(uzon)
    return torch.where(at_pole, zero, uzon), torch.where(at_pole, zero, umer)


def enu_velocity_to_xyz(p: torch.Tensor, uzon: torch.Tensor,
                        umer: torch.Tensor, uup=0.0) -> torch.Tensor:
    """(zonal, meridional, up) -> XYZ velocity (reference GeoConverter.hpp:225-250)."""
    slon, clon, slat, clat, at_pole = _enu_coeffs(p)
    uup = torch.as_tensor(uup, dtype=p.dtype, device=p.device)
    vx = -slon * uzon - slat * clon * umer + clon * clat * uup
    vy = clon * uzon - slat * slon * umer + slon * clat * uup
    vz = clat * umer + slat * uup
    zero = torch.zeros_like(vx)
    vx = torch.where(at_pole, zero, vx)
    vy = torch.where(at_pole, zero, vy)
    vz = torch.where(at_pole, uup.expand_as(vz), vz)
    return torch.stack([vx, vy, vz], dim=-1)


def rotation_axis(pos: torch.Tensor, vel: torch.Tensor) -> torch.Tensor:
    """pos x vel (reference SYCLKernel::CalcRotationAxis)."""
    return torch.linalg.cross(pos, vel, dim=-1)


def rotate_around_axis(point: torch.Tensor, axis: torch.Tensor,
                       theta: torch.Tensor) -> torch.Tensor:
    """Rodrigues rotation of `point` about normalized `axis` by `theta` radians.

    Mirrors SYCLKernel::CalcPositionAfterRotation (reference
    src/GPU/SYCL/Kernel/SYCLKernel.cpp:181-209): the axis is normalized by its
    length WITHOUT a zero guard, so a zero axis yields NaN -- deliberate, the
    reference relies on downstream NaN cleanup.
    """
    ct = torch.cos(theta)
    st = torch.sin(theta)
    u = axis / torch.linalg.vector_norm(axis, dim=-1, keepdim=True)
    ux, uy, uz = u[..., 0], u[..., 1], u[..., 2]
    px, py, pz = point[..., 0], point[..., 1], point[..., 2]
    omc = 1.0 - ct
    rx = (ct + ux * ux * omc) * px + (ux * uy * omc - uz * st) * py + (ux * uz * omc + uy * st) * pz
    ry = (uy * ux * omc + uz * st) * px + (ct + uy * uy * omc) * py + (uy * uz * omc - ux * st) * pz
    rz = (uz * ux * omc - uy * st) * px + (uz * uy * omc + ux * st) * py + (ct + uz * uz * omc) * pz
    return torch.stack([rx, ry, rz], dim=-1)
