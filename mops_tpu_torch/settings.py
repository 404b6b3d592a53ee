"""Run-configuration dataclasses (jax-free copy of mops_tpu.settings).

Reference: src/Core/MPASOVisualizer.h:20-103 (VisualizationSettings,
SamplingSettings, TrajectorySettings, TrajectoryLine) and the time-unit
macros (:83-88).
"""

from __future__ import annotations

import dataclasses
import enum
from typing import Optional, Tuple

import numpy as np

# Time macros (reference src/Core/MPASOVisualizer.h:83-88)
ONE_SECOND = 1
ONE_MINUTE = 60
ONE_HOUR = 3600
ONE_DAY = 86400
ONE_WEEK = 7 * ONE_DAY
ONE_MONTH = 30 * ONE_DAY
ONE_YEAR = 365 * ONE_DAY


class CalcDirection(enum.Enum):
    FORWARD = 1
    BACKWARD = -1


class CalcMethod(enum.Enum):
    RK4 = "rk4"
    EULER = "euler"


class FailMode(enum.Enum):
    """What happens when the velocity evaluation fails mid-trajectory.

    FREEZE mirrors the reference CPU/TBB backend (the golden baseline): the
    particle stops, leaving later record slots zero-filled.  ZERO mirrors the
    SYCL backend's RET0 zero-velocity continuation.
    """

    FREEZE = "freeze"
    ZERO = "zero"


class VisualizeType(enum.Enum):
    FIXED_LAYER = "fixed_layer"
    FIXED_DEPTH = "fixed_depth"


class SaveType(enum.Enum):
    VTI = "vti"
    PNG = "png"
    NONE = "none"


class PositionType(enum.Enum):
    CENTER = "center"
    VERTEX = "vertex"


@dataclasses.dataclass
class TrajectorySettings:
    """Mirrors reference TrajectorySettings (src/Core/MPASOVisualizer.h:90-103).

    All times in seconds; ``depth`` in metres positive-down, or per-particle
    ``particle_depths``.
    """

    delta_t: int = 120
    simulation_duration: int = ONE_DAY
    record_t: int = 60
    depth: float = 10.0
    particle_depths: Optional[np.ndarray] = None
    direction: CalcDirection = CalcDirection.FORWARD
    method: CalcMethod = CalcMethod.RK4
    fail_mode: FailMode = FailMode.FREEZE
    file_name: str = "trajectory"

    @property
    def n_steps(self) -> int:
        return int(self.simulation_duration // self.delta_t)

    @property
    def n_records(self) -> int:
        return int(self.simulation_duration // self.record_t)

    def effective_depths(self, n_particles: int) -> np.ndarray:
        """Per-particle float32 depths (reference Common::BuildEffectiveDepths,
        src/Common/TrajectoryCommon.h:29-41)."""
        if (self.particle_depths is not None
                and len(self.particle_depths) == n_particles):
            return np.asarray(self.particle_depths, dtype=np.float32)
        return np.full(n_particles, self.depth, dtype=np.float32)


@dataclasses.dataclass
class VisualizationSettings:
    """Mirrors reference VisualizationSettings (src/Core/MPASOVisualizer.h:20-42)."""

    image_width: int = 360
    image_height: int = 180
    lat_range: Tuple[float, float] = (-90.0, 90.0)
    lon_range: Tuple[float, float] = (-180.0, 180.0)
    depth_range: Tuple[float, float] = (0.0, 5000.0)
    fixed_latitude: float = 0.0
    fixed_depth: float = 10.0
    fixed_layer: int = 0
    visualize_type: VisualizeType = VisualizeType.FIXED_DEPTH
    save_type: SaveType = SaveType.NONE
    time_step: int = 0


@dataclasses.dataclass
class SamplingSettings:
    """Mirrors reference SamplingSettings (src/Core/MPASOVisualizer.h:44-68)."""

    sample_range: Tuple[int, int] = (10, 10)      # (n_lat, n_lon)
    lat_range: Tuple[float, float] = (-90.0, 90.0)
    lon_range: Tuple[float, float] = (-180.0, 180.0)
    depth: float = 10.0
    at_cell_center: bool = False


@dataclasses.dataclass
class TrajectoryLine:
    """One finalized trajectory (reference src/Core/MPASOVisualizer.h:70-81)."""

    line_id: int
    points: np.ndarray        # (R+1, 3)
    velocity: np.ndarray      # (R+1, 3)
    temperature: np.ndarray   # (R+1,)
    salinity: np.ndarray      # (R+1,)
    last_point: np.ndarray    # (3,)
    duration: float
    timestamp: float
    depth: float
    attrs: Optional[np.ndarray] = None   # (R+1, 3) true attribute samples
