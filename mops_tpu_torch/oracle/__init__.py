"""The port's own copy of mops_tpu.oracle: the scalar NumPy transcription
of the reference TBB backend (oracle) and the harness around the reference's
compiled C++ (refbin).  NumPy only: nothing here imports jax or mops_tpu."""

from .oracle import (oracle_pathline, oracle_preprocess,
                     oracle_rbf_cell_velocity, oracle_streamline,
                     oracle_velocity_at)

__all__ = ["oracle_preprocess", "oracle_streamline", "oracle_pathline",
           "oracle_velocity_at", "oracle_rbf_cell_velocity"]
