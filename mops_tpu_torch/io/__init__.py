from .netcdf import NetCDFFile
from .reader import MPASOReader, StreamConfig
from .image import save_png, save_vti, save_trajectories_vtp, save_trajectories_text

__all__ = ["NetCDFFile", "MPASOReader", "StreamConfig", "save_png", "save_vti",
           "save_trajectories_vtp", "save_trajectories_text"]
