"""ctypes bindings for the native frame loader (vhap_tpu_torch/native).

Counterpart of vhap_tpu/data/native_loader.py: the same three entry points
(`decode_batch`, `decode_composite_batch`, `load_batch`) with the same
signatures and conventions (None on failure, a partial batch logged and
reported as a failure).

The library is built at first use by g++ from native/frameloader.cpp into
build/native/libframeloader-<hash>.so at the repository root (the hash
covers the source, the headers, the flags and the libjpeg it links), via an
object named by pid and an atomic rename, so processes that build at once
each load a whole library. It compiles against the libjpeg-turbo
JPEG_LIB_VERSION 62 headers in native/include and links the libjpeg that
Pillow's wheel bundles (pillow.libs/libjpeg-*.so.62*): the loader decodes
with the library the PIL path decodes with, and needs no system libjpeg.

`get_lib` returns None, with a warning, when the library cannot be built;
the dataset then decodes with PIL and counts the batch as a PIL batch.
`build` raises instead, for callers that must not fall back. The calls go
through `ctypes.CDLL`, which releases the GIL while the C++ threads work.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from pathlib import Path
from typing import List, Optional, Tuple

import numpy as np

from vhap_tpu_torch.util.log import get_logger

logger = get_logger(__name__)

NATIVE_DIR = Path(__file__).resolve().parents[1] / "native"
SOURCE = NATIVE_DIR / "frameloader.cpp"
INCLUDE = NATIVE_DIR / "include"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "native"
CXXFLAGS = ["-O3", "-shared", "-fPIC", "-std=c++17"]

_LOCK = threading.Lock()
_LIB: Optional[ctypes.CDLL] = None
_TRIED = False


def pillow_libjpeg() -> Path:
    """The libjpeg (ABI 62) bundled with the installed Pillow wheel."""
    import PIL
    libs = Path(PIL.__file__).resolve().parent.parent / "pillow.libs"
    found = sorted(libs.glob("libjpeg*.so.62*")) if libs.is_dir() else []
    if not found:
        raise RuntimeError(f"no libjpeg.so.62 bundled with Pillow under {libs}: "
                           "the native loader links the libjpeg Pillow ships")
    return found[0]


def library_path(jpeg: Path) -> Path:
    h = hashlib.sha256()
    for f in [SOURCE] + sorted(INCLUDE.glob("*.h")):
        h.update(f.name.encode())
        h.update(f.read_bytes())
    h.update(" ".join(CXXFLAGS).encode())
    h.update(str(jpeg).encode())
    return BUILD_DIR / f"libframeloader-{h.hexdigest()[:16]}.so"


def build() -> Path:
    """Compile the loader unless an up-to-date library exists; its path.
    Raises RuntimeError when Pillow's libjpeg or g++ is missing or the
    compile fails."""
    jpeg = pillow_libjpeg()
    path = library_path(jpeg)
    if path.exists():
        return path
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = path.with_suffix(f".{os.getpid()}.tmp")
    cmd = ["g++", *CXXFLAGS, "-I", str(INCLUDE), "-o", str(tmp), str(SOURCE),
           str(jpeg), f"-Wl,-rpath,{jpeg.parent}", "-lpthread"]
    try:
        out = subprocess.run(cmd, stdout=subprocess.PIPE,
                             stderr=subprocess.STDOUT, text=True)
    except OSError as e:                      # no g++
        raise RuntimeError(f"cannot run g++ for the native loader: {e}") from e
    if out.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"building the native loader failed:\n{out.stdout}")
    os.replace(tmp, path)   # atomic: a concurrent loader sees all or nothing
    return path


def _bind(so: Path) -> ctypes.CDLL:
    lib = ctypes.CDLL(str(so))
    lib.fl_decode_batch.restype = ctypes.c_int
    lib.fl_decode_batch.argtypes = [
        ctypes.POINTER(ctypes.c_char_p), ctypes.c_int,
        ctypes.POINTER(ctypes.c_uint8), ctypes.c_int, ctypes.c_int,
        ctypes.c_int]
    lib.fl_decode_composite_batch.restype = ctypes.c_int
    lib.fl_decode_composite_batch.argtypes = [
        ctypes.POINTER(ctypes.c_char_p), ctypes.POINTER(ctypes.c_char_p),
        ctypes.c_int, ctypes.POINTER(ctypes.c_float),
        ctypes.POINTER(ctypes.c_float), ctypes.c_int, ctypes.c_int,
        ctypes.c_float, ctypes.c_float, ctypes.c_float, ctypes.c_int]
    lib.fl_load_batch.restype = ctypes.c_int
    lib.fl_load_batch.argtypes = [
        ctypes.POINTER(ctypes.c_char_p), ctypes.POINTER(ctypes.c_char_p),
        ctypes.c_int, ctypes.POINTER(ctypes.c_double),
        ctypes.POINTER(ctypes.c_float), ctypes.POINTER(ctypes.c_float),
        ctypes.c_int, ctypes.c_int,
        ctypes.c_float, ctypes.c_float, ctypes.c_float, ctypes.c_int]
    return lib


def get_lib() -> Optional[ctypes.CDLL]:
    """The loaded library, built at first use; None (warned once) when it
    cannot be built."""
    global _LIB, _TRIED
    with _LOCK:
        if not _TRIED:
            _TRIED = True
            try:
                _LIB = _bind(build())
            except (RuntimeError, OSError) as e:
                logger.warning(f"native frameloader unavailable ({e}); "
                               "falling back to PIL decoding")
        return _LIB


def _paths_array(paths: List[Optional[str]]):
    arr = (ctypes.c_char_p * len(paths))()
    for i, p in enumerate(paths):
        arr[i] = None if p is None else str(p).encode()
    return arr


def _alpha_array(alpha_paths: Optional[List[Optional[str]]]):
    return (_paths_array(alpha_paths) if alpha_paths is not None
            else ctypes.cast(None, ctypes.POINTER(ctypes.c_char_p)))


def _f32(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_float))


def decode_batch(paths: List[str], oh: int, ow: int,
                 n_threads: int = 4) -> Optional[np.ndarray]:
    """Decode+resize a batch of JPEGs to (n, oh, ow, 3) uint8."""
    lib = get_lib()
    if lib is None:
        return None
    n = len(paths)
    out = np.empty((n, oh, ow, 3), np.uint8)
    ok = lib.fl_decode_batch(
        _paths_array(paths), n,
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)), oh, ow, n_threads)
    if ok != n:
        logger.warning(f"native decode: {ok}/{n} frames decoded")
        return None
    return out


def decode_composite_batch(
    rgb_paths: List[str], alpha_paths: Optional[List[Optional[str]]],
    oh: int, ow: int, background: Optional[Tuple[float, float, float]],
    n_threads: int = 4,
) -> Optional[Tuple[np.ndarray, np.ndarray]]:
    """Decode rgb (+ alpha) pairs -> float32 rgb [0,1] composited onto a
    constant background, plus float32 alpha. background=None skips
    compositing."""
    lib = get_lib()
    if lib is None:
        return None
    n = len(rgb_paths)
    out_rgb = np.empty((n, oh, ow, 3), np.float32)
    out_alpha = np.empty((n, oh, ow), np.float32)
    bg = background if background is not None else (-1.0, -1.0, -1.0)
    ok = lib.fl_decode_composite_batch(
        _paths_array(rgb_paths), _alpha_array(alpha_paths), n,
        _f32(out_rgb), _f32(out_alpha), oh, ow, bg[0], bg[1], bg[2], n_threads)
    if ok != n:
        logger.warning(f"native decode+composite: {ok}/{n} frames decoded")
        return None
    return out_rgb, out_alpha


def load_batch(
    rgb_paths: List[str], alpha_paths: Optional[List[Optional[str]]],
    oh: int, ow: int, background: Optional[Tuple[float, float, float]],
    color_correction: Optional[np.ndarray] = None,
    n_threads: int = 4,
) -> Optional[Tuple[np.ndarray, np.ndarray]]:
    """The dataset's transform chain in C++: decode, optional per-frame 3x4
    affine colour correction (the reference's truncating re-quantization),
    PIL-BILINEAR resize to (oh, ow), optional background composite ->
    float32 rgb [0,1] + float32 alpha. Replicates apply_color_correction +
    apply_scale_factor + apply_background_color + apply_to_tensor
    (vhap/data/nersemble_dataset.py:165-171, video_dataset.py:272-323)."""
    lib = get_lib()
    if lib is None:
        return None
    n = len(rgb_paths)
    out_rgb = np.empty((n, oh, ow, 3), np.float32)
    out_alpha = np.empty((n, oh, ow), np.float32)
    bg = background if background is not None else (-1.0, -1.0, -1.0)
    if color_correction is not None:
        cc = np.ascontiguousarray(color_correction, np.float64)
        if cc.shape != (n, 3, 4):
            raise ValueError(f"color_correction must be ({n}, 3, 4), got {cc.shape}")
        cc_ptr = cc.ctypes.data_as(ctypes.POINTER(ctypes.c_double))
    else:
        cc_ptr = ctypes.cast(None, ctypes.POINTER(ctypes.c_double))
    ok = lib.fl_load_batch(
        _paths_array(rgb_paths), _alpha_array(alpha_paths), n, cc_ptr,
        _f32(out_rgb), _f32(out_alpha), oh, ow, bg[0], bg[1], bg[2], n_threads)
    if ok != n:
        logger.warning(f"native load_batch: {ok}/{n} frames loaded")
        return None
    return out_rgb, out_alpha
