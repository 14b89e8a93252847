"""Video-mode domain model: standard display timings and nearest-mode lookup.

Re-design of the reference's video-mode database
(``/root/reference/src/VideoConfigurations.jl:1-146``).  A ``VideoMode`` holds the
*total* pixel geometry of a display timing — ``width`` is pixels per line
including horizontal blanking, ``height`` is lines per frame including vertical
blanking, ``refresh`` is the vertical refresh rate in Hz — because the TEMPEST
emanation contains the blanking intervals too.

Unlike the reference (a Julia ``Dict{String,VideoMode}`` searched with
``findmin`` + ``filter``), the table here is also materialised as flat numpy
arrays so the nearest-mode search can run *inside* a jitted pipeline (pure
``argmin`` over a constant array) and candidate modes can be vmapped/sharded as
hypotheses across devices.
"""

from __future__ import annotations

import dataclasses

import numpy as np

__all__ = [
    "VideoMode",
    "ALL_VIDEO_MODES",
    "find_closest_mode",
    "find_closest_configuration",
    "find_configuration",
    "get_refresh_rates",
    "mode_table_arrays",
    "candidate_modes",
]


@dataclasses.dataclass(frozen=True)
class VideoMode:
    """One display timing.  Mirrors reference ``VideoMode``
    (``VideoConfigurations.jl:5-9``) but immutable + hashable so it can key
    jit caches."""

    width: int      # total pixels per line, incl. horizontal blanking
    height: int     # total lines per frame, incl. vertical blanking
    refresh: float  # vertical refresh rate [Hz]

    @property
    def pixels_per_frame(self) -> int:
        return self.width * self.height

    @property
    def pixel_clock(self) -> float:
        """Pixel rate in Hz implied by the timing."""
        return self.width * self.height * self.refresh

    @property
    def line_rate(self) -> float:
        """Horizontal line rate in Hz."""
        return self.height * self.refresh


# Standard timing database.  Same 80 display modes as the reference table
# (``VideoConfigurations.jl:12-93``): name -> (total width, total height, refresh).
_MODE_ROWS: tuple[tuple[str, int, int, float], ...] = (
    ("PAL TV", 576, 625, 25),
    ("640x400 @ 85Hz", 832, 445, 85),
    ("720x400 @ 85Hz", 936, 446, 85),
    ("640x480 @ 60Hz", 800, 525, 60),
    ("640x480 @ 100Hz", 848, 509, 100),
    ("640x480 @ 72Hz", 832, 520, 72),
    ("640x480 @ 75Hz", 840, 500, 75),
    ("640x480 @ 85Hz", 832, 509, 85),
    ("768x576 @ 60 Hz", 976, 597, 60),
    ("768x576 @ 72 Hz", 992, 601, 72),
    ("768x576 @ 75 Hz", 1008, 602, 75),
    ("768x576 @ 85 Hz", 1008, 605, 85),
    ("768x576 @ 100 Hz", 1024, 611, 100),
    ("800x600 @ 56Hz", 1024, 625, 56),
    ("800x600 @ 60Hz", 1056, 628, 60),
    ("800x600 @ 72Hz", 1040, 666, 72),
    ("800x600 @ 75Hz", 1056, 625, 75),
    ("800x600 @ 85Hz", 1048, 631, 85),
    ("800x600 @ 100Hz", 1072, 636, 100),
    ("1024x600 @ 60 Hz", 1312, 622, 60),
    ("1024x768i @ 43Hz", 1264, 817, 43),
    ("1024x768 @ 60Hz", 1344, 806, 60),
    ("1024x768 @ 70Hz", 1328, 806, 70),
    ("1024x768 @ 75Hz", 1312, 800, 75),
    ("1024x768 @ 85Hz", 1376, 808, 85),
    ("1024x768 @ 100Hz", 1392, 814, 100),
    ("1024x768 @ 120Hz", 1408, 823, 120),
    ("1152x864 @ 60Hz", 1520, 895, 60),
    ("1152x864 @ 75Hz", 1600, 900, 75),
    ("1152x864 @ 85Hz", 1552, 907, 85),
    ("1152x864 @ 100Hz", 1568, 915, 100),
    ("1280x768 @ 60 Hz", 1680, 795, 60),
    ("1280x800 @ 60 Hz", 1680, 828, 60),
    ("1280x960 @ 60Hz", 1800, 1000, 60),
    ("1280x960 @ 75Hz", 1728, 1002, 75),
    ("1280x960 @ 85Hz", 1728, 1011, 85),
    ("1280x960 @ 100Hz", 1760, 1017, 100),
    ("1280x1024 @ 60Hz", 1688, 1066, 60),
    ("1280x1024 @ 75Hz", 1688, 1066, 75),
    ("1280x1024 @ 85Hz", 1728, 1072, 85),
    ("1280x1024 @ 100Hz", 1760, 1085, 100),
    ("1280x1024 @ 120Hz", 1776, 1097, 120),
    ("1368x768 @ 60 Hz", 1800, 795, 60),
    ("1400x1050 @ 60Hz", 1880, 1082, 60),
    ("1400x1050 @ 72 Hz", 1896, 1094, 72),
    ("1400x1050 @ 75 Hz", 1896, 1096, 75),
    ("1400x1050 @ 85 Hz", 1912, 1103, 85),
    ("1400x1050 @ 100 Hz", 1928, 1112, 100),
    ("1440x900 @ 60 Hz", 1904, 932, 60),
    ("1440x1050 @ 60 Hz", 1936, 1087, 60),
    ("1600x1000 @ 60Hz", 2144, 1035, 60),
    ("1600x1000 @ 75Hz", 2160, 1044, 75),
    ("1600x1000 @ 85Hz", 2176, 1050, 85),
    ("1600x1000 @ 100Hz", 2192, 1059, 100),
    ("1600x1024 @ 60Hz", 2144, 1060, 60),
    ("1600x1024 @ 75Hz", 2176, 1069, 75),
    ("1600x1024 @ 76Hz", 2096, 1070, 76),
    ("1600x1024 @ 85Hz", 2176, 1075, 85),
    ("1600x1200 @ 60Hz", 2160, 1250, 60),
    ("1600x1200 @ 65Hz", 2160, 1250, 65),
    ("1600x1200 @ 70Hz", 2160, 1250, 70),
    ("1600x1200 @ 75Hz", 2160, 1250, 75),
    ("1600x1200 @ 85Hz", 2160, 1250, 85),
    ("1600x1200 @ 100 Hz", 2208, 1271, 100),
    ("1680x1050 @ 60Hz (reduced blanking)", 1840, 1080, 60),
    ("1680x1050 @ 60Hz (non-interlaced)", 2240, 1089, 60),
    ("1680x1050 @ 60 Hz", 2256, 1087, 60),
    ("1792x1344 @ 60Hz", 2448, 1394, 60),
    ("1792x1344 @ 75Hz", 2456, 1417, 75),
    ("1856x1392 @ 60Hz", 2528, 1439, 60),
    ("1856x1392 @ 75Hz", 2560, 1500, 75),
    ("1920x1080 @ 60Hz", 2576, 1125, 60),
    ("1920x1080 @ 75Hz", 2608, 1126, 75),
    ("1920x1200 @ 60Hz", 2592, 1242, 60),
    ("1920x1200 @ 75Hz", 2624, 1253, 75),
    ("1920x1440 @ 60Hz", 2600, 1500, 60),
    ("1920x1440 @ 75Hz", 2640, 1500, 75),
    ("1920x2400 @ 25Hz", 2048, 2434, 25),
    ("1920x2400 @ 30Hz", 2044, 2434, 30),
    ("2048x1536 @ 60Hz", 2800, 1589, 60),
)

ALL_VIDEO_MODES: dict[str, VideoMode] = {
    name: VideoMode(w, h, float(r)) for name, w, h, r in _MODE_ROWS
}

_NAMES: tuple[str, ...] = tuple(ALL_VIDEO_MODES.keys())
_WIDTHS = np.array([m.width for m in ALL_VIDEO_MODES.values()], np.int32)
_HEIGHTS = np.array([m.height for m in ALL_VIDEO_MODES.values()], np.int32)
_REFRESH = np.array([m.refresh for m in ALL_VIDEO_MODES.values()], np.float64)


def mode_table_arrays() -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Return (widths, heights, refresh) flat arrays — the device-friendly
    mode table, suitable for use as constants inside jitted code."""
    return _WIDTHS, _HEIGHTS, _REFRESH


def get_refresh_rates() -> list[float]:
    """All distinct refresh rates in the table
    (reference ``get_refresh_rates``, ``VideoConfigurations.jl:128-130``)."""
    out: list[float] = []
    for r in _REFRESH:
        if r not in out:
            out.append(float(r))
    return out


def find_closest_mode(y_t: float, refresh: float) -> tuple[str, VideoMode]:
    """Nearest known mode for an estimated total line count ``y_t`` and refresh
    rate.  Two-stage search like the reference ``find_closest_configuration``
    (``VideoConfigurations.jl:117-124``): snap to the closest known refresh
    rate first, then the closest height among modes at that rate."""
    rates = np.array(get_refresh_rates())
    chosen_rate = rates[np.argmin((refresh - rates) ** 2)]
    best_name, best_mode, best_d = None, None, np.inf
    for name, mode in ALL_VIDEO_MODES.items():
        if mode.refresh != chosen_rate:
            continue
        d = (float(y_t) - mode.height) ** 2
        if d < best_d:
            best_name, best_mode, best_d = name, mode, d
    assert best_name is not None and best_mode is not None
    return best_name, best_mode


def find_closest_configuration(y_t: float, refresh: float) -> dict[str, VideoMode]:
    """Reference-API-shaped wrapper: returns a {name: mode} dict like the
    Julia function returns a filtered sub-dict."""
    name, mode = find_closest_mode(y_t, refresh)
    return {name: mode}


def find_configuration(video: VideoMode) -> str | None:
    """Inverse lookup: name of an exact mode, or None
    (reference ``find_configuration``, ``VideoConfigurations.jl:136-142``)."""
    for name, mode in ALL_VIDEO_MODES.items():
        if mode == video:
            return name
    return None


def candidate_modes(refresh: float, tol_hz: float = 2.0) -> list[tuple[str, VideoMode]]:
    """All modes whose refresh rate is within ``tol_hz`` of ``refresh`` —
    the hypothesis set for the sharded multi-mode search (no reference
    equivalent; the reference requires the user to click the right peak)."""
    return [
        (name, mode)
        for name, mode in ALL_VIDEO_MODES.items()
        if abs(mode.refresh - refresh) <= tol_hz
    ]
