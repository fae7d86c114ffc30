"""Cheung-2004 polynomial color correction + sRGB transfer functions.

A copy of vhap_tpu/util/color_correction.py: numpy versions of the
colour-science pieces used by the NeRSemble
datasets (vhap/util/color_correction.py, vhap/data/nersemble_v2_dataset.py:
55-68): `matrix_augmented_Cheung2004` polynomial expansion, precomputed-CCM
application, and the sRGB cctf encode/decode pair.
"""

from __future__ import annotations

import numpy as np


def cctf_decoding(x: np.ndarray) -> np.ndarray:
    """sRGB electro-optical transfer (gamma decode), colour.cctf_decoding default."""
    x = np.asarray(x, np.float64)
    return np.where(x <= 0.04045, x / 12.92, ((x + 0.055) / 1.055) ** 2.4)


def cctf_encoding(x: np.ndarray) -> np.ndarray:
    """Inverse sRGB transfer (gamma encode)."""
    x = np.asarray(x, np.float64)
    x = np.clip(x, 0.0, None)
    return np.where(x <= 0.0031308, x * 12.92, 1.055 * x ** (1 / 2.4) - 0.055)


def matrix_augmented_Cheung2004(RGB: np.ndarray, terms: int) -> np.ndarray:
    """Polynomial expansion of RGB triplets per Cheung et al. (2004).

    Matches colour.characterisation.matrix_augmented_Cheung2004 for the
    term counts used in practice.
    """
    RGB = np.reshape(np.asarray(RGB, np.float64), (-1, 3))
    R, G, B = RGB[:, 0], RGB[:, 1], RGB[:, 2]
    ones = np.ones_like(R)
    t = {
        3: [R, G, B],
        5: [R, G, B, R * G * B, ones],
        7: [R, G, B, R * G, R * B, G * B, ones],
        8: [R, G, B, R * G, R * B, G * B, R * G * B, ones],
        10: [R, G, B, R * G, R * B, G * B, R ** 2, G ** 2, B ** 2, ones],
        11: [R, G, B, R * G, R * B, G * B, R ** 2, G ** 2, B ** 2,
             R * G * B, ones],
        14: [R, G, B, R * G, R * B, G * B, R ** 2, G ** 2, B ** 2,
             R * G * B, R ** 3, G ** 3, B ** 3, ones],
        16: [R, G, B, R * G, R * B, G * B, R ** 2, G ** 2, B ** 2,
             R * G * B, R ** 2 * G, G ** 2 * B, B ** 2 * R,
             R ** 3, G ** 3, B ** 3],
        17: [R, G, B, R * G, R * B, G * B, R ** 2, G ** 2, B ** 2,
             R * G * B, R ** 2 * G, G ** 2 * B, B ** 2 * R,
             R ** 3, G ** 3, B ** 3, ones],
        19: [R, G, B, R * G, R * B, G * B, R ** 2, G ** 2, B ** 2,
             R * G * B, R ** 2 * G, G ** 2 * B, B ** 2 * R,
             R ** 2 * B, G ** 2 * R, B ** 2 * G, R ** 3, G ** 3, B ** 3],
        20: [R, G, B, R * G, R * B, G * B, R ** 2, G ** 2, B ** 2,
             R * G * B, R ** 2 * G, G ** 2 * B, B ** 2 * R,
             R ** 2 * B, G ** 2 * R, B ** 2 * G, R ** 3, G ** 3, B ** 3,
             ones],
        22: [R, G, B, R * G, R * B, G * B, R ** 2, G ** 2, B ** 2,
             R * G * B, R ** 2 * G, G ** 2 * B, B ** 2 * R,
             R ** 2 * B, G ** 2 * R, B ** 2 * G, R ** 3, G ** 3, B ** 3,
             R ** 2 * G * B, R * G ** 2 * B, R * G * B ** 2],
    }
    if terms not in t:
        raise ValueError(f"unsupported Cheung2004 term count: {terms}")
    return np.stack(t[terms], axis=-1)


def color_correction_Cheung2004_precomputed(image: np.ndarray,
                                            CCM: np.ndarray) -> np.ndarray:
    """Apply a precomputed (3, terms) CCM (vhap/util/color_correction.py:9-21)."""
    terms = CCM.shape[-1]
    shape = image.shape
    RGB_e = matrix_augmented_Cheung2004(image, terms)
    return np.reshape(RGB_e @ CCM.T, shape)


def correct_color(image: np.ndarray, ccm: np.ndarray) -> np.ndarray:
    """uint8/float wrapper: decode -> CCM in linear light -> encode
    (vhap/util/color_correction.py:24-34)."""
    is_uint8 = image.dtype == np.uint8
    if is_uint8:
        image = image / 255.0
    out = cctf_encoding(color_correction_Cheung2004_precomputed(
        cctf_decoding(image), ccm))
    if is_uint8:
        out = np.clip(out * 255, 0, 255).astype(np.uint8)
    return out
