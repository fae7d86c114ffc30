"""The work of a tracking step, counted from its shapes and live pixels.

Frozen here so that no change to the program can move the yardstick. The
per-kernel counts are chip_smoke.py's (:266-296 and its check_k* bounds),
counted from each kernel's source: bytes read once and written once, and
float32 operations. A bound is the least time the chip could take:
max(bytes / peak bytes/s, operations / peak float32 FLOP/s), NVIDIA's H100
SXM data-sheet peaks at the full 700 W.

`counts` is the live work of a step as the reference measures it on its
first step (reference/check.py `live_counts`): B frames of H x W, F faces,
the valid faces and the candidate pixels their bounding boxes cover, the
foreground pixels and their visible faces, the texture's covered pixels,
live taps and the texels they touch, and the mip pyramid's texel count.
"""

from __future__ import annotations

from typing import Dict, Tuple

PEAK_BYTES_S = 3.35e12       # HBM3
PEAK_F32_FLOP_S = 67e12      # float32 outside the tensor cores

K1_FLOPS_PER_CANDIDATE = 23  # pixel center, 3 edge planes, z plane, signs
K1_ROW_FIELDS_READ = 17      # setup row fields visibility.cu reads (A0X..VALID)
K2_FLOPS_PER_FG_PIXEL = 118  # csrc/interp.cu, one foreground pixel
K2B_FLOPS_PER_FG_PIXEL = 320  # csrc/interp_bwd.cu: recompute 85, adjoint ~197, row adds 38
K3_FLOPS_PER_PIXEL = 59      # lod 18, level share 1, two levels' corners 32, tap weights 8
K3_FLOPS_PER_LIVE_TAP = 6    # 3 channels x (mul + add)
K4_FLOPS_PER_LIVE_PIXEL = 185
K4_FLOPS_PER_LIVE_TAP = 6    # dflat: 3 channels x (mul + atomic add)

N_FIXED_IN = 36              # face-table rows besides the flag rows
N_FIXED_OUT = 20             # interpolated channels besides the flag rows
N_FLAGS_TRAIN = 2            # a training stage's rows: texture mask, cluster id
K2B_COTANGENT_CHANNELS = 15  # texc 2, texd 4, normal 3, antialias planes 6

# per-pixel float channels the render and the energies need besides the
# kernels' own buffers, each read once and written once, in the forward and
# again in the backward: the target image and background, the coverage
# mask, albedo, normal, diffuse and its normal-detached twin, the shaded
# rgba, the disturbed and the antialiased rgba, the cluster ids and the
# photometric residual
PIXEL_CHANNELS = {"target": 3, "background": 3, "mask": 1, "albedo": 3,
                  "normal": 3, "diffuse": 3, "diffuse_detach": 3, "rgba": 4,
                  "rgba_disturbed": 4, "rgba_aa": 4, "cluster": 1, "residual": 3}

# leaf-lr Adam, per element: p, g, m, v read, p, m, v written; ~12 flops
ADAM_WORDS_PER_ELEMENT = 7
ADAM_FLOPS_PER_ELEMENT = 12
# FLAME: J joints, 36 pose correctives (4 joints x 9)
FLAME_JOINTS = 5
FLAME_POSE_BASIS = 36


def bound_s(n_bytes: float, n_flops: float) -> Tuple[float, str]:
    t_bytes, t_ops = n_bytes / PEAK_BYTES_S, n_flops / PEAK_F32_FLOP_S
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def k1(c: Dict) -> Tuple[float, float]:
    """Visibility (csrc/visibility.cu): the fields of a valid face's setup
    row, VALID of the others, the id map written."""
    n_rows = c["B"] * c["F"]
    n_bytes = (c["n_valid"] * K1_ROW_FIELDS_READ + (n_rows - c["n_valid"])) * 4 \
        + c["B"] * c["H"] * c["W"] * 4
    return n_bytes, c["n_cand"] * K1_FLOPS_PER_CANDIDATE


def k2f(c: Dict, nf: int = N_FLAGS_TRAIN) -> Tuple[float, float]:
    """Fused interpolation forward (csrc/interp.cu): tri_id read, the
    channels written, each visible face's row read once."""
    P = c["B"] * c["H"] * c["W"]
    n_bytes = P * 4 + P * (N_FIXED_OUT + nf) * 4 \
        + c["n_faces_visible"] * (N_FIXED_IN + nf) * 4
    return n_bytes, c["n_fg"] * K2_FLOPS_PER_FG_PIXEL


def k2b(c: Dict, nf: int = N_FLAGS_TRAIN) -> Tuple[float, float]:
    """Its backward (csrc/interp_bwd.cu): tri_id, the cotangent channels of
    each foreground pixel, each visible face's rows read, the whole
    gradient table written."""
    P = c["B"] * c["H"] * c["W"]
    C = N_FIXED_IN + nf
    n_bytes = P * 4 + c["n_fg"] * K2B_COTANGENT_CHANNELS * 4 \
        + c["n_faces_visible"] * C * 4 + c["B"] * c["F"] * C * 4
    return n_bytes, c["n_fg"] * K2B_FLOPS_PER_FG_PIXEL


def k3(c: Dict) -> Tuple[float, float]:
    """Trilinear texture sample (csrc/texture_fetch.cu): the mask of every
    pixel, uv and uv_da of a covered one, each live texel once, out written."""
    P = c["B"] * c["H"] * c["W"]
    n_bytes = P + c["n_cov"] * 24 + c["n_texels"] * 12 + P * 12
    return n_bytes, c["n_cov"] * K3_FLOPS_PER_PIXEL + c["n_taps"] * K3_FLOPS_PER_LIVE_TAP


def k4(c: Dict) -> Tuple[float, float]:
    """Its backward (csrc/texture_scatter.cu): the mask and cotangent of
    every pixel, uv, uv_da and the texels of a live pixel's taps once,
    d_uv and d_uv_da of every pixel and the whole pyramid gradient written."""
    P = c["B"] * c["H"] * c["W"]
    n_bytes = P + P * 12 + c["n_cov"] * 24 + c["n_texels_k4"] * 12 + P * 24 \
        + c["n_texels_pyramid"] * 12
    return n_bytes, c["n_cov"] * K4_FLOPS_PER_LIVE_PIXEL + c["n_taps"] * K4_FLOPS_PER_LIVE_TAP


KERNELS = {"K1": k1, "K2f": k2f, "K2b": k2b, "K3": k3, "K4": k4}


def kernel_bound_s(names, c: Dict) -> float:
    """The summed bound of the named kernels (one launch each a step)."""
    return sum(bound_s(*KERNELS[n](c))[0] for n in names)


def flame(c: Dict) -> Tuple[float, float]:
    """The FLAME forward with LBS and its backward (about twice the
    forward): blendshapes, pose correctives, joint regression and skinning
    of V vertices for B frames; the bases read once each way."""
    B, V, nb = c["B"], c["V"], c["n_basis"]
    fwd = B * (2 * V * 3 * nb + 2 * V * 3 * FLAME_POSE_BASIS
               + 2 * FLAME_JOINTS * V * 3 + 2 * V * FLAME_JOINTS * 12 + 2 * V * 12)
    n_bytes = 2 * (V * 3 * (nb + FLAME_POSE_BASIS) * 4) + 4 * B * V * 3 * 4
    return n_bytes, 3 * fwd


def pixels(c: Dict) -> Tuple[float, float]:
    """The render's and energies' per-pixel tensors, forward and backward."""
    P = c["B"] * c["H"] * c["W"]
    return 2 * 2 * P * sum(PIXEL_CHANNELS.values()) * 4, 0.0


def texture_maps(c: Dict) -> Tuple[float, float]:
    """The albedo (base + residual at T x T) and its mip pyramid, forward
    and backward."""
    T2 = c["tex_res"] ** 2 * 3
    return 2 * (3 * T2 + c["n_texels_pyramid"] * 3) * 4, 0.0


def adam(c: Dict) -> Tuple[float, float]:
    n = sum(c["leaf_numel"].values())
    return n * ADAM_WORDS_PER_ELEMENT * 4, n * ADAM_FLOPS_PER_ELEMENT


def step(c: Dict) -> Tuple[float, float]:
    """(bytes, operations) of one step: the five kernels, FLAME, the
    per-pixel tensors, the texture maps and Adam."""
    parts = [f(c) for f in KERNELS.values()] + [flame(c), pixels(c),
                                                 texture_maps(c), adam(c)]
    return sum(p[0] for p in parts), sum(p[1] for p in parts)
