"""Adversarial inputs for the fused trilinear sampler (K3 and its backward
K4, csrc/texture_fetch.cu and csrc/texture_scatter.cu), built from a numpy
seed.

Every pixel takes one of these cases, in turn along the pixel index:

  random       uvs in [-0.3, 1.3] (wrap addressing) and footprints whose
               lod spans every level;
  integer_lod  a footprint of exactly 2^k texels (k < L - 1): lod = k, so
               the upper level's taps have weight 0 but carry the lod's
               gradient;
  top_level    a footprint of 2^(L-1) texels or more: lod at or clamped to
               L - 1, both levels the top one;
  tie          du/dx = du/dy and dv/dx = dv/dy: fx2 == fy2, where the max
               splits its gradient;
  texel_exact  an integer lod k and a uv on a texel centre of level k:
               bilinear fractions of exactly 0 (zero-weight corners that
               carry the fractions' gradient);
  edge_uv      uv on 0, 1 or -1 exactly and beyond: the wrap of x0 = -1.

A mask leaves out about 30 % of the pixels, and the cotangent is 0 on every
7th pixel (a composited-away albedo).
"""

from __future__ import annotations

from typing import Dict

import numpy as np

CASES = ("random", "integer_lod", "top_level", "tie", "texel_exact", "edge_uv")


def n_levels(T: int) -> int:
    """build_mip_pyramid's level count for a T x T texture."""
    L, t = 1, T
    while t > 1:
        t //= 2
        L += 1
    return L


def build(B: int, Hi: int, Wi: int, T: int, seed: int = 0) -> Dict[str, np.ndarray]:
    """-> dict(tex (1, T, T, 3), uv (B, Hi, Wi, 2), uv_da (B, Hi, Wi, 4),
    mask (B, Hi, Wi) bool, g (B, Hi * Wi, 3), case (B, Hi, Wi) int: the
    index into CASES), float32. The texture is quantized to 1/4096 (exact
    in the JAX kernels' bf16 hi + lo split)."""
    rng = np.random.default_rng(seed)
    L = n_levels(T)
    P = Hi * Wi
    tex = (np.round(rng.uniform(size=(1, T, T, 3)) * 4096) / 4096).astype(np.float32)
    uv = rng.uniform(-0.3, 1.3, (B, P, 2))
    da = rng.normal(size=(B, P, 4)) * 10.0 ** rng.uniform(-4, 0.5, (B, P, 1))
    case = np.arange(B * P).reshape(B, P) % len(CASES)

    def pick(name):
        return case == CASES.index(name)

    def footprint(sel, k):
        """da of exactly 2^k texels along x, less along y."""
        n = int(sel.sum())
        da[sel] = 0.0
        da[sel, 0] = 2.0 ** k / T
        da[sel, 3] = 2.0 ** (k - 1) / T * rng.uniform(0.0, 1.0, n)

    sel = pick("integer_lod")
    footprint(sel, rng.integers(0, L - 1, int(sel.sum())))
    sel = pick("top_level")
    footprint(sel, rng.integers(L - 1, L + 2, int(sel.sum())))
    sel = pick("tie")
    da[sel, 1] = da[sel, 0]
    da[sel, 3] = da[sel, 2]
    sel = pick("texel_exact")
    k = rng.integers(0, L - 1, int(sel.sum()))
    footprint(sel, k)
    w = np.maximum(T >> k, 1)[:, None]
    uv[sel] = (rng.integers(-w, 2 * w, (len(k), 2)) + 0.5) / w
    sel = pick("edge_uv")
    uv[sel] = rng.choice([-1.0, 0.0, 1.0, 1.0 + 2.0 ** -12, -2.0 ** -12],
                         (int(sel.sum()), 2))
    mask = rng.uniform(size=(B, P)) < 0.7
    g = rng.normal(size=(B, P, 3))
    g[:, ::7] = 0.0
    return {"tex": tex, "uv": uv.reshape(B, Hi, Wi, 2).astype(np.float32),
            "uv_da": da.reshape(B, Hi, Wi, 4).astype(np.float32),
            "mask": mask.reshape(B, Hi, Wi), "g": g.astype(np.float32),
            "case": case.reshape(B, Hi, Wi)}
