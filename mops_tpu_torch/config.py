"""Global numerics configuration (jax-free mirror of mops_tpu.config).

Two precision modes (``precision``): "fp64", the parity mode held against
the reference's double-precision trajectories, and "fp32", the fast mode
(positions to ~0.4 m at Earth radius).  Particle depth is float32 in both,
as in the reference's effective_depths.

Constants mirror the reference:
- EARTH_RADIUS: 6,371,010 m (reference src/Utils/GeoConverter.hpp:107)
- EPS_LAYER / EPS_ZERO / ZTOP_CLAMP: the kernels' numerical guards.

Float32 matrix products on the card must not drop to TF32 (about three
decimal digits): preprocessing's einsums feed every vertex field.  Importing
the package turns TF32 off for matmuls and cuDNN (see ``__init__``).
"""

from __future__ import annotations

import dataclasses

import torch

EARTH_RADIUS = 6371010.0

# Numerical guards copied from the reference kernels.
EPS_LAYER = 1e-8        # layer-search tolerance   (MPASOVisualizerSYCL.cpp:869)
EPS_ZERO = 1e-12        # zero-velocity / zero-denominator guard (:845,:833)
ZTOP_CLAMP = 1e-9       # monotonic ztop clamp     (:865)


@dataclasses.dataclass(frozen=True)
class Precision:
    """Dtype bundle for one precision mode."""

    name: str
    real: torch.dtype      # positions / fields
    depth: torch.dtype     # particle depth carry (the reference's float32)
    index: torch.dtype

    @property
    def is_x64(self) -> bool:
        return self.real == torch.float64


def precision(mode: str = "fp64") -> Precision:
    """The dtypes of mode "fp64" or "fp32" (mops_tpu.config.precision; torch
    needs no x64 switch)."""
    if mode == "fp64":
        return Precision("fp64", torch.float64, torch.float32, torch.int32)
    if mode == "fp32":
        return Precision("fp32", torch.float32, torch.float32, torch.int32)
    raise ValueError(f"unknown precision mode: {mode!r}")
