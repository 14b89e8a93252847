"""Screen rendering backends: terminal ANSI, PNG/PGM files, live text HUD.

Capability parity with the reference's ``ScreenRenderer`` module
(``/root/reference/src/ScreenRenderer.jl``): pluggable renderers behind one
interface, min-max normalisation (``fullScale!`` ``:35-39``), a terminal
grayscale view (``TerminalRendererScreen`` ``:45-58``), and the vsync
crosshair overlay (``displayScreen_vsync!`` ``:182-187``).  The reference's
GLMakie GUI (an OpenGL window) is deliberately *not* ported — headless
accelerator hosts have no display; the live surfaces here are the terminal renderer and
file sinks (PNG via zlib, no external imaging dependency), plus the CLI's
status HUD.
"""

from __future__ import annotations

import struct
import zlib

import numpy as np

__all__ = [
    "full_scale",
    "overlay_sync",
    "to_uint8",
    "write_pgm",
    "png_bytes",
    "write_png",
    "read_png",
    "psnr",
    "aligned_psnr",
    "TerminalRenderer",
    "FileRenderer",
]


def psnr(reference: np.ndarray, image: np.ndarray) -> float:
    """Peak signal-to-noise ratio between two images after min-max
    normalisation of each (reconstruction amplitude is arbitrary)."""
    a = full_scale(reference)
    b = full_scale(image)
    mse = float(np.mean((a - b) ** 2))
    if mse == 0:
        return float("inf")
    return -10.0 * np.log10(mse)


def aligned_psnr(reference: np.ndarray, image: np.ndarray) -> tuple[float, tuple[int, int]]:
    """PSNR after the best circular alignment (a reconstruction is defined up
    to a circular shift of the blanking position).  Returns (psnr_db, shift).
    The fidelity metric used by the test suite / BASELINE comparisons."""
    a = full_scale(reference) - 0.5
    b = full_scale(image) - 0.5
    xc = np.fft.ifft2(np.fft.fft2(a) * np.conj(np.fft.fft2(b))).real
    shift = np.unravel_index(int(xc.argmax()), xc.shape)
    rolled = np.roll(image, shift, axis=(0, 1))
    return psnr(reference, rolled), (int(shift[0]), int(shift[1]))


def full_scale(img: np.ndarray) -> np.ndarray:
    """Min-max normalise to [0, 1] (reference ``fullScale!``,
    ``ScreenRenderer.jl:35-39``)."""
    lo, hi = float(np.min(img)), float(np.max(img))
    if hi <= lo:
        return np.zeros_like(img, np.float32)
    return ((img - lo) / (hi - lo)).astype(np.float32)


def overlay_sync(img: np.ndarray, s_y: int, s_x: int, half: int = 10) -> np.ndarray:
    """White crosshair at the detected blanking position (reference
    ``displayScreen_vsync!``, ``ScreenRenderer.jl:182-187``)."""
    out = full_scale(img).copy()
    h, w = out.shape
    rows = (np.arange(-half, half + 1) + int(s_y)) % h
    cols = (np.arange(-half, half + 1) + int(s_x)) % w
    out[rows, :] = 1.0
    out[:, cols] = 1.0
    return out


def to_uint8(img: np.ndarray, invert: bool = False) -> np.ndarray:
    x = full_scale(img)
    if invert:
        x = 1.0 - x
    return (x * 255.0 + 0.5).astype(np.uint8)


def write_pgm(img: np.ndarray, path: str, invert: bool = False) -> None:
    """Binary PGM — zero-dependency grayscale dump."""
    u8 = to_uint8(img, invert)
    h, w = u8.shape
    with open(path, "wb") as f:
        f.write(f"P5\n{w} {h}\n255\n".encode())
        f.write(u8.tobytes())


def png_bytes(img: np.ndarray, invert: bool = False) -> bytes:
    """Encode a grayscale image as PNG bytes (zlib + struct, no imaging
    library) — the in-memory form behind :func:`write_png` and the live web
    view's frame endpoint."""
    u8 = to_uint8(img, invert)
    h, w = u8.shape
    raw = b"".join(b"\x00" + u8[r].tobytes() for r in range(h))

    def chunk(tag: bytes, data: bytes) -> bytes:
        return (
            struct.pack(">I", len(data))
            + tag
            + data
            + struct.pack(">I", zlib.crc32(tag + data) & 0xFFFFFFFF)
        )

    ihdr = struct.pack(">IIBBBBB", w, h, 8, 0, 0, 0, 0)  # 8-bit grayscale
    return (
        b"\x89PNG\r\n\x1a\n"
        + chunk(b"IHDR", ihdr)
        + chunk(b"IDAT", zlib.compress(raw, 6))
        + chunk(b"IEND", b"")
    )


def write_png(img: np.ndarray, path: str, invert: bool = False) -> None:
    """Minimal grayscale PNG writer (zlib + struct, no imaging library)."""
    with open(path, "wb") as f:
        f.write(png_bytes(img, invert))


def read_png(path: str) -> np.ndarray:
    """Read back a PNG as :func:`write_png` writes it (8-bit grayscale,
    unfiltered rows) into a ``uint8`` (h, w) array; other PNGs raise."""
    with open(path, "rb") as f:
        data = f.read()
    if data[:8] != b"\x89PNG\r\n\x1a\n":
        raise ValueError(f"{path}: not a PNG")
    pos, idat, hdr = 8, [], None
    while pos < len(data):
        (n,) = struct.unpack(">I", data[pos:pos + 4])
        tag, body = data[pos + 4:pos + 8], data[pos + 8:pos + 8 + n]
        if tag == b"IHDR":
            hdr = struct.unpack(">IIBBBBB", body)
        elif tag == b"IDAT":
            idat.append(body)
        pos += 12 + n
    if hdr is None or hdr[2:] != (8, 0, 0, 0, 0):
        raise ValueError(f"{path}: only 8-bit grayscale PNGs are supported")
    w, h = hdr[0], hdr[1]
    rows = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8)
    rows = rows.reshape(h, w + 1)
    if rows[:, 0].any():
        raise ValueError(f"{path}: filtered PNG rows are not supported")
    return rows[:, 1:].copy()


def _maybe_crosshair(img: np.ndarray, info: dict | None, on: bool) -> np.ndarray:
    """Overlay the last frame's detected sync position when enabled and
    present in the sink info (live displayScreen_vsync! parity)."""
    if not on or not info:
        return img
    sync = info.get("sync")
    if sync is None or not len(sync):
        return img
    s_y, s_x = np.asarray(sync)[-1]
    return overlay_sync(img, int(s_y), int(s_x))


class TerminalRenderer:
    """ANSI grayscale in the terminal: home-cursor + 256-color background
    cells, downsampled to the terminal grid (reference
    ``TerminalRendererScreen``, ``ScreenRenderer.jl:45-58``)."""

    def __init__(self, rows: int = 40, cols: int = 120, invert: bool = False,
                 crosshair: bool = False) -> None:
        self.rows = rows
        self.cols = cols
        self.invert = invert
        # Live sync crosshair (the reference's displayScreen_vsync!,
        # ScreenRenderer.jl:182-187, on the live view).
        self.crosshair = crosshair

    def render(self, img: np.ndarray, info: dict | None = None) -> str:
        img = _maybe_crosshair(img, info, self.crosshair)
        u8 = to_uint8(img, self.invert)
        h, w = u8.shape
        ys = (np.arange(self.rows) * h) // self.rows
        xs = (np.arange(self.cols) * w) // self.cols
        small = u8[np.ix_(ys, xs)]
        # 24 grayscale steps of the xterm-256 ramp (232..255).
        levels = 232 + (small.astype(np.int32) * 23) // 255
        lines = ["\x1b[H"]  # cursor home (reference prints \33[H)
        for r in range(self.rows):
            cells = "".join(f"\x1b[48;5;{v}m " for v in levels[r])
            lines.append(cells + "\x1b[0m")
        if info:
            lines.append(
                f"\x1b[0m mode={info.get('mode')} frames={info.get('frames_out')}"
            )
            if info.get("spark"):
                # Live correlation evidence (the reference GUI's correlation
                # panels, GUI.jl:296-356, as a one-line sparkline).
                lines.append(f"\x1b[0m {info['spark']}")
        return "\n".join(lines)

    def __call__(self, img: np.ndarray, info: dict | None = None) -> None:
        print(self.render(img, info), flush=True)


class FileRenderer:
    """Sink that writes every Nth frame to numbered PNG files."""

    def __init__(self, prefix: str = "frame", every: int = 1, invert: bool = False,
                 crosshair: bool = False):
        self.prefix = prefix
        self.every = every
        self.invert = invert
        self.crosshair = crosshair
        self._n = 0

    def __call__(self, img: np.ndarray, info: dict | None = None) -> None:
        if self._n % self.every == 0:
            img = _maybe_crosshair(img, info, self.crosshair)
            write_png(img, f"{self.prefix}_{self._n:05d}.png", self.invert)
        self._n += 1
