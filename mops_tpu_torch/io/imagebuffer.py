"""ImageBuffer: reference-compatible RGBA-double image container (copy of
mops_tpu.io.imagebuffer).

Mirrors reference src/Common/ImageBuffer.hpp:10-137: width x height x 4
doubles, set_pixel/get_pixel with (row, col) addressing, and SaveToPNG's
min-max normalize -> Viridis with NaN -> transparent.  The engine itself works
on plain (h, w, 3) arrays; this class is the drop-in surface for code ported
from the reference API.
"""

from __future__ import annotations

import numpy as np


class ImageBuffer:
    def __init__(self, width: int, height: int):
        self.width = int(width)
        self.height = int(height)
        self.pixels = np.zeros((self.height, self.width, 4), dtype=np.float64)

    def set_pixel(self, i: int, j: int, rgb) -> None:
        """(row i, col j) <- rgb (3,) with alpha 1 (reference SetPixel)."""
        self.pixels[i, j, :3] = rgb
        self.pixels[i, j, 3] = 1.0

    def get_pixel(self, i: int, j: int) -> np.ndarray:
        return self.pixels[i, j, :3].copy()

    @classmethod
    def from_array(cls, img: np.ndarray) -> "ImageBuffer":
        """Wrap an (h, w, 3) engine image; NaN pixels get alpha 0."""
        h, w = img.shape[:2]
        buf = cls(w, h)
        buf.pixels[..., :3] = img
        buf.pixels[..., 3] = np.where(np.isfinite(img).all(axis=-1), 1.0, 0.0)
        return buf

    def save_png(self, path: str, channel: int = 0) -> None:
        """Min-max normalized Viridis PNG of one channel, NaN transparent
        (reference ImageBuffer::SaveToPNG)."""
        from .image import save_png
        save_png(path, self.pixels[..., channel])
