"""Coordinate conversions: meters <-> pixels <-> normalized.

reference: include/core/coordinates.hpp:16-93, src/core/coordinates.cpp:10-38.
Pure arithmetic over floats or arrays (works on host scalars and torch
tensors alike), configured from SharedSystemConfig exactly like the
reference. A copy of ``lpe_tpu/core/coordinates.py``, docstrings apart.
"""
from __future__ import annotations

from .config import SharedSystemConfig
from .constants import SCREEN_LENGTH


class Coordinates:
    def __init__(self, config: SharedSystemConfig,
                 screen_size: int = SCREEN_LENGTH):
        self.screen_size = screen_size
        self.update_config(config)

    def update_config(self, config: SharedSystemConfig) -> None:
        self.meters_per_pixel = config.meters_per_pixel
        self.universe_size_m = config.universe_size_m

    # -- meters <-> pixels --------------------------------------------------
    def pixels_to_meters(self, pixels):
        return pixels * self.meters_per_pixel

    def meters_to_pixels(self, meters):
        return meters / self.meters_per_pixel

    # -- meters <-> normalized (0..1 over the universe) ----------------------
    def normalized_to_meters(self, normalized):
        return normalized * self.universe_size_m

    def meters_to_normalized(self, meters):
        return meters / self.universe_size_m

    @property
    def pixels_per_meter(self):
        return 1.0 / self.meters_per_pixel
