"""Image output: PPM (P3 text / P6 binary) and PNG.

The reference emits PPM P3 text to stdout (src/render_io.rs:3-31,
src/books/*/color.rs:14-32).  We reproduce P3 byte-compatibly (same
gamma/clamp/scale pipeline — see ``render.finalize_image``) plus a binary P6
fast path and PNG via PIL when available.
"""

from __future__ import annotations

import io
import sys
from typing import Optional

import numpy as np


def ppm_p3_bytes(img_u8: np.ndarray) -> bytes:
    """P3 text PPM; img_u8: [H,W,3] uint8."""
    h, w, _ = img_u8.shape
    out = io.StringIO()
    out.write(f"P3\n{w} {h}\n255\n")
    flat = img_u8.reshape(-1, 3)
    # one "r g b" line per pixel, like color.rs write_color
    np.savetxt(out, flat, fmt="%d", delimiter=" ")
    return out.getvalue().encode()


def ppm_p6_bytes(img_u8: np.ndarray) -> bytes:
    h, w, _ = img_u8.shape
    return f"P6\n{w} {h}\n255\n".encode() + img_u8.tobytes()


def _p3_fast(img_u8: np.ndarray) -> bytes:
    """P3 text via the native C++ formatter when built (native/src/ppm.cpp),
    else the NumPy path (same output, ~30x slower)."""
    from ..native import ppm_p3_from_u8

    return ppm_p3_from_u8(img_u8)


def write_image(img_u8: np.ndarray, path: Optional[str] = None, fmt: str = "auto"):
    """Write image to ``path`` (or stdout if None, like the reference)."""
    if path is None:
        sys.stdout.buffer.write(_p3_fast(img_u8))
        return
    if fmt == "auto":
        fmt = path.rsplit(".", 1)[-1].lower()
    if fmt in ("ppm", "p3"):
        data = _p3_fast(img_u8) if fmt == "p3" else ppm_p6_bytes(img_u8)
        with open(path, "wb") as f:
            f.write(data)
    elif fmt == "png":
        try:
            from PIL import Image  # pillow is optional

            Image.fromarray(img_u8).save(path)
        except ImportError:
            ppm = path.rsplit(".", 1)[0] + ".ppm"
            print(f"PNG output needs Pillow, which is not installed; "
                  f"wrote {ppm} instead", file=sys.stderr)
            with open(ppm, "wb") as f:
                f.write(ppm_p6_bytes(img_u8))
    else:
        raise ValueError(f"unknown image format: {fmt}")


def read_ppm(path: str) -> np.ndarray:
    """Read P3/P6 PPM into [H,W,3] uint8 (for golden-image tests)."""
    with open(path, "rb") as f:
        data = f.read()
    if data.startswith(b"P6"):
        header, rest = data.split(b"\n", 1)
        fields = []
        while len(fields) < 3:
            line, rest = rest.split(b"\n", 1)
            if line.startswith(b"#"):
                continue
            fields += line.split()
        w, h = int(fields[0]), int(fields[1])
        return np.frombuffer(rest, np.uint8, w * h * 3).reshape(h, w, 3).copy()
    toks = data.split()
    assert toks[0] == b"P3"
    w, h = int(toks[1]), int(toks[2])
    vals = np.asarray(toks[4: 4 + w * h * 3], dtype=np.int64)
    return vals.reshape(h, w, 3).astype(np.uint8)
