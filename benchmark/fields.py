"""A snapshot's raw cell fields, made on the device from the mesh and the
parameters a traffic mix draws from the seed.

A frozen copy, in torch ops, of the analytic solid-body generator the port
ships: zonal flow u = omega * decay**k * r cos(lat) in layer k, no
meridional flow, a vertical velocity w_scale * sin(2 lon + lat) where the
bathymetry varies, a bottom modulated by ``bathymetry_amp`` and collapsed to
a tenth inside the shelves (sin(2 lon) > shelf_lon), uniform layers in each
column, temperature 20 - 15 k / (L - 1) + 5 cos(lat) and salinity
34 + sin(lat).  The arrays carry MPAS NetCDF names, in float64.
"""

from __future__ import annotations

import numpy as np
import torch

# Keys of a traffic mix's snapshot entry, with the defaults of the port's
# generator.
DEFAULTS = {"omega": 1e-5, "omega_decay": 0.5, "w_scale": 0.0,
            "bathymetry_amp": 0.0, "shelf_lon": None, "bottom_depth": 4000.0}


def draw(spec: dict, rng: np.random.Generator) -> dict:
    """A snapshot's parameters: each [lo, hi] pair of ``spec`` drawn
    uniformly from ``rng``, each scalar taken as it is."""
    out = dict(DEFAULTS)
    for key, value in spec.items():
        if key not in DEFAULTS:
            raise KeyError(f"unknown field parameter {key!r}")
        if isinstance(value, (list, tuple)):
            value = float(rng.uniform(value[0], value[1]))
        out[key] = value
    return out


def solid_body(cell_xyz: torch.Tensor, n_layers: int, params: dict) -> dict:
    """Raw (nCells, L) / (nCells, L + 1) / (nCells,) float64 fields on the
    device of ``cell_xyz`` (float64, metres)."""
    p = dict(DEFAULTS, **params)
    cell = cell_xyz.to(torch.float64)
    r = torch.linalg.vector_norm(cell, dim=-1)
    lat = torch.arcsin(cell[:, 2] / r)
    lon = torch.atan2(cell[:, 1], cell[:, 0])
    bottom = torch.full_like(r, float(p["bottom_depth"]))
    amp = float(p["bathymetry_amp"])
    if amp:
        shape = 0.5 + 0.5 * torch.sin(3.0 * lon) * torch.cos(2.0 * lat)
        bottom = float(p["bottom_depth"]) * (1.0 - amp * shape)
    if p["shelf_lon"] is not None:
        bottom = torch.where(torch.sin(2.0 * lon) > float(p["shelf_lon"]),
                             0.1 * bottom, bottom)
    thickness = (bottom / n_layers)[:, None].expand(-1, n_layers).contiguous()
    k = torch.arange(n_layers, dtype=torch.float64, device=cell.device)
    omega_k = float(p["omega"]) * float(p["omega_decay"]) ** k
    u_zonal = omega_k[None, :] * (r * torch.cos(lat))[:, None]
    w = torch.full((cell.shape[0], n_layers + 1), float(p["w_scale"]),
                   dtype=torch.float64, device=cell.device)
    if amp and float(p["w_scale"]):
        w = w * torch.sin(2.0 * lon + lat)[:, None]
    temperature = 20.0 - 15.0 * (k / max(1, n_layers - 1))[None, :] \
        + 5.0 * torch.cos(lat)[:, None]
    salinity = (34.0 + torch.sin(lat))[:, None].expand(-1, n_layers)
    return {"bottomDepth": bottom, "layerThickness": thickness,
            "velocityZonal": u_zonal,
            "velocityMeridional": torch.zeros_like(u_zonal),
            "vertVelocityTop": w, "temperature": temperature,
            "salinity": salinity.contiguous()}
