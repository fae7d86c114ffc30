"""2D landmark visualization (vhap/util/visualization.py equivalent).

Counterpart of vhap_tpu/util/visualization.py (a copy): 68-landmark
connectivity + overlay drawing in numpy (no torchvision).
"""

from __future__ import annotations

from typing import Sequence

import numpy as np

# iBUG-68 connectivity (semantic groups; same structure as
# vhap/util/visualization.py:15-29)
LANDMARK_CONNECTIVITY = (
    [(i, i + 1) for i in range(16)]               # jawline
    + [(i, i + 1) for i in range(17, 21)]         # right eyebrow
    + [(i, i + 1) for i in range(22, 26)]         # left eyebrow
    + [(i, i + 1) for i in range(27, 30)]         # nose bridge
    + [(i, i + 1) for i in range(31, 35)]         # nose bottom
    + [(i, i + 1) for i in range(36, 41)] + [(41, 36)]  # right eye
    + [(i, i + 1) for i in range(42, 47)] + [(47, 42)]  # left eye
    + [(i, i + 1) for i in range(48, 59)] + [(59, 48)]  # outer lips
    + [(i, i + 1) for i in range(60, 67)] + [(67, 60)]  # inner lips
)

_COLORS = {"green": (0, 255, 0), "red": (255, 0, 0), "blue": (0, 128, 255),
           "yellow": (255, 255, 0)}


def _draw_line(img: np.ndarray, p0, p1, color):
    """Integer Bresenham-ish line via dense sampling."""
    n = int(max(abs(p1[0] - p0[0]), abs(p1[1] - p0[1]), 1))
    xs = np.linspace(p0[0], p1[0], n + 1).round().astype(int)
    ys = np.linspace(p0[1], p1[1], n + 1).round().astype(int)
    H, W = img.shape[:2]
    ok = (xs >= 0) & (xs < W) & (ys >= 0) & (ys < H)
    img[ys[ok], xs[ok]] = color


def plot_landmarks_2d(img: np.ndarray, lmks: np.ndarray, colors="green",
                      unit: float = 1.0, input_float: bool = False,
                      connectivity=True) -> np.ndarray:
    """Overlay landmarks (L, 2) in pixel coords on img (H, W, 3).

    Accepts float [0,1] or uint8 images; returns the same kind.
    """
    was_float = input_float or img.dtype.kind == "f"
    out = (np.clip(img, 0, 1) * 255).astype(np.uint8) if was_float \
        else img.copy()
    color = _COLORS.get(colors, colors)
    lmks = np.asarray(lmks).reshape(-1, lmks.shape[-1])[:, :2]

    if connectivity:
        for a, b in LANDMARK_CONNECTIVITY:
            if a < len(lmks) and b < len(lmks):
                if np.isfinite(lmks[a]).all() and np.isfinite(lmks[b]).all():
                    _draw_line(out, lmks[a], lmks[b], color)

    r = max(1, int(round(unit)))
    H, W = out.shape[:2]
    for x, y in lmks:
        if not (np.isfinite(x) and np.isfinite(y)):
            continue
        xi, yi = int(round(x)), int(round(y))
        if 0 <= xi < W and 0 <= yi < H:
            out[max(0, yi - r):yi + r + 1, max(0, xi - r):xi + r + 1] = color

    return out.astype(np.float32) / 255.0 if was_float else out
