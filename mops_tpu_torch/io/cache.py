"""Derived-field + particle-state checkpointing (mirror of
mops_tpu.io.cache over the port's types).

Mirrors the reference's two persistence mechanisms (SURVEY.md section 5):
1. preprocessed-field disk caches keyed by mesh name + timestep
   (reference src/Core/MPASOSolution.cpp:22-39,622-650 writes
   ``./.data/<mesh>/cellVertex*_vec_<t>.bin``) -- here one compressed npz per
   (mesh, timestep) holding every derived vertex table;
2. trajectory chaining state (lastPoint / per-particle depths,
   reference tutorial/pathLine.cpp:74-75,201-237) -- here a particle-state
   checkpoint {positions, depths, cells, alive} for exact resume.
"""

from __future__ import annotations

import os
from typing import Dict, Optional

import numpy as np
import torch

from ..mesh import MPASMesh
from ..solution import SolutionFields
from ..utils import timer


def _cache_dir(root: str, mesh_name: str) -> str:
    d = os.path.join(root, ".data", mesh_name)
    os.makedirs(d, exist_ok=True)
    return d


def _host(a) -> np.ndarray:
    """A tensor on any device, or an array, as a host numpy array."""
    if isinstance(a, torch.Tensor):
        return a.detach().cpu().numpy()
    return np.asarray(a)


def save_solution_cache(root: str, mesh: MPASMesh, sol: SolutionFields) -> str:
    """Persist derived vertex fields for (mesh, timestep)."""
    path = os.path.join(_cache_dir(root, mesh.name),
                        f"solution_{sol.timestep}.npz")
    with timer("IO::writeSolutionCache", "IO_Write"):
        payload = {
            "cell_ztop": _host(sol.cell_ztop),
            "vertex_ztop": _host(sol.vertex_ztop),
            "cell_velocity": _host(sol.cell_velocity),
            "vertex_velocity": _host(sol.vertex_velocity),
            "vertex_vert_velocity": _host(sol.vertex_vert_velocity),
            "_timestamp": np.array(sol.timestamp),
        }
        for k, v in sol.vertex_attrs.items():
            payload[f"vattr_{k}"] = _host(v)
        for k, v in sol.cell_attrs.items():
            payload[f"cattr_{k}"] = _host(v)
        np.savez_compressed(path, **payload)
    return path


def load_solution_cache(root: str, mesh: MPASMesh,
                        timestep: int) -> Optional[SolutionFields]:
    """Load a cached solution if present (else None), as CPU tensors."""
    path = os.path.join(root, ".data", mesh.name, f"solution_{timestep}.npz")
    if not os.path.exists(path):
        return None
    with timer("IO::readSolutionCache", "IO_Read"):
        z = np.load(path, allow_pickle=False)
        t = lambda k: torch.from_numpy(z[k])
        vertex_attrs = {k[len("vattr_"):]: t(k) for k in z.files
                        if k.startswith("vattr_")}
        cell_attrs = {k[len("cattr_"):]: t(k) for k in z.files
                      if k.startswith("cattr_")}
        return SolutionFields(
            cell_ztop=t("cell_ztop"), vertex_ztop=t("vertex_ztop"),
            cell_velocity=t("cell_velocity"),
            vertex_velocity=t("vertex_velocity"),
            vertex_vert_velocity=t("vertex_vert_velocity"),
            vertex_attrs=vertex_attrs, cell_attrs=cell_attrs,
            timestamp=str(z["_timestamp"]), timestep=timestep)


def save_particle_checkpoint(path: str, positions: np.ndarray,
                             depths: np.ndarray, cells: np.ndarray,
                             alive: np.ndarray,
                             meta: Optional[Dict] = None) -> None:
    """Checkpoint particle state for exact run resumption / pair chaining."""
    np.savez_compressed(path, positions=_host(positions),
                        depths=_host(depths), cells=_host(cells),
                        alive=_host(alive),
                        **({f"meta_{k}": np.asarray(v)
                            for k, v in (meta or {}).items()}))


def load_particle_checkpoint(path: str):
    z = np.load(path, allow_pickle=False)
    meta = {k[len("meta_"):]: z[k] for k in z.files if k.startswith("meta_")}
    return z["positions"], z["depths"], z["cells"], z["alive"], meta
