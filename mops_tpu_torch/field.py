"""Field binding: mesh + front (+ optional back) solution (mirror of
mops_tpu.field).

Mirrors the reference MPASOField (src/Core/MPASOField.{h,cpp}): bind the
active solutions and provide host-side particle->cell assignment and the
point-on-ocean test.  A Field lives on ``device`` (the card unless the
caller passes device="cpu"; without a card a CUDA field raises) in
``dtype`` (default the mesh's).
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from .cellsearch import CellSearch
from .mesh import MPASMesh, resolve_device
from .solution import SolutionFields
from .utils.timer import timed


@dataclasses.dataclass
class Field:
    mesh: MPASMesh
    front: SolutionFields
    back: Optional[SolutionFields] = None
    device: object = "cuda"
    dtype: Optional[torch.dtype] = None
    _search: Optional[CellSearch] = dataclasses.field(default=None, repr=False)

    _device: Optional[tuple] = dataclasses.field(default=None, repr=False)

    def __post_init__(self):
        self.device = resolve_device(self.device)
        if self.dtype is None:
            self.dtype = self.mesh.dtype

    @property
    def search(self) -> CellSearch:
        if self._search is None:
            self._search = CellSearch(self.mesh)
        return self._search

    def device_tables(self):
        """(mesh, front) on the field's device in its dtype, moved once and
        memoised: the remap entries are called repeatedly on one field."""
        if self._device is None:
            self._device = (self.mesh.to(self.device, self.dtype),
                            self.front.to(self.device, self.dtype))
        return self._device

    @timed("cellsearch.query", "CPUCompute")
    def calc_in_which_cells(self, points: np.ndarray) -> np.ndarray:
        """Nearest-cell-center assignment (reference
        MPASOField::calcInWhichCells, src/Core/MPASOField.cpp:23-34)."""
        return self.search.query(points)

    def is_on_land(self, point: np.ndarray) -> bool:
        """Edge-normal sign-consistency test at the nearest cell (reference
        MPASOField::isOnOcean, src/Core/MPASOField.cpp:36-81 -- which,
        despite its name, returns true when the point is ON LAND)."""
        from .remap import _is_land_sign_test
        p = np.asarray(point, dtype=np.float64).reshape(1, 3)
        cell = torch.as_tensor(self.search.query(p), device=self.mesh.device)
        pos = torch.as_tensor(p, device=self.mesh.device, dtype=self.mesh.dtype)
        return bool(_is_land_sign_test(self.mesh, pos, cell)[0])
