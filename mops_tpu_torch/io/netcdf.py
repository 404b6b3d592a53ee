"""Minimal NetCDF reader: classic (NetCDF-3) via scipy, NetCDF-4/HDF5 via h5py
(copy of mops_tpu.io.netcdf).

The reference reads MPAS files through the external ftk::ndarray NetCDF
stream (reference src/IO/MPASOReader.cpp); without netCDF4/xarray this
module provides the minimal uniform interface the ingest layer needs:
variable lookup, shapes, dims, and eager reads with float->double
promotion.  h5py is imported only when an HDF5 file is opened, so without
it only NetCDF-4 files fail (ImportError).
"""

from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np


class NetCDFFile:
    """Uniform read-only view over a NetCDF-3 (scipy) or NetCDF-4 (h5py) file."""

    def __init__(self, path: str):
        self.path = path
        self._h5 = None
        self._sp = None
        magic = open(path, "rb").read(8)
        if magic[:3] == b"CDF":
            from scipy.io import netcdf_file
            self._sp = netcdf_file(path, "r", mmap=True)
        elif magic[:8] == b"\x89HDF\r\n\x1a\n":
            import h5py
            self._h5 = h5py.File(path, "r")
        else:
            raise ValueError(f"{path}: not a NetCDF file (magic {magic!r})")

    # -- introspection ------------------------------------------------------
    def variables(self) -> List[str]:
        if self._sp is not None:
            return list(self._sp.variables)
        return [k for k in self._h5.keys()
                if isinstance(self._h5[k], __import__("h5py").Dataset)]

    def has(self, name: str) -> bool:
        return name in self.variables()

    def dims(self, name: str):
        if self._sp is not None:
            return tuple(self._sp.variables[name].dimensions)
        ds = self._h5[name]
        out = []
        for i, d in enumerate(ds.dims):
            label = d.label or (d[0].name.split("/")[-1] if len(d) else f"dim{i}")
            out.append(label)
        return tuple(out)

    def shape(self, name: str):
        if self._sp is not None:
            return tuple(self._sp.variables[name].shape)
        return tuple(self._h5[name].shape)

    def dimension_size(self, dim: str) -> Optional[int]:
        if self._sp is not None:
            return self._sp.dimensions.get(dim)
        # h5py: scan datasets for a matching dim label
        for name in self.variables():
            for label, size in zip(self.dims(name), self.shape(name)):
                if label == dim:
                    return size
        return None

    # -- reads --------------------------------------------------------------
    @staticmethod
    def _normalize(arr: np.ndarray, promote: bool) -> np.ndarray:
        """Native byte order (scipy mmaps big-endian) + float->double."""
        if arr.dtype.byteorder not in ("=", "|"):
            arr = arr.astype(arr.dtype.newbyteorder("="))
        if promote and arr.dtype.kind == "f" and arr.dtype.itemsize < 8:
            arr = arr.astype(np.float64)
        return arr

    def read(self, name: str, promote: bool = True) -> np.ndarray:
        if self._sp is not None:
            arr = np.array(self._sp.variables[name][...])
        else:
            arr = np.array(self._h5[name][...])
        return self._normalize(arr, promote)

    def read_timestep(self, name: str, t: int, time_dim: str = "Time",
                      promote: bool = True) -> np.ndarray:
        """Read one index along the Time dimension (if the variable has one)."""
        dims = self.dims(name)
        if dims and dims[0] in (time_dim, "time", "nTime"):
            if self._sp is not None:
                arr = np.array(self._sp.variables[name][t, ...])
            else:
                arr = np.array(self._h5[name][t, ...])
        else:
            arr = self.read(name, promote=False)
        return self._normalize(arr, promote)

    def close(self) -> None:
        if self._sp is not None:
            self._sp.close()
        if self._h5 is not None:
            self._h5.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
