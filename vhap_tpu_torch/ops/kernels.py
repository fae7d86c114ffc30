"""Build, load and launch the port's hand-written CUDA kernels.

All sources under vhap_tpu_torch/csrc are compiled for Hopper
(``sm_90a``) by ``nvcc`` into one shared library with a plain C interface,
loaded with ctypes. The build runs at first use, one ``nvcc`` process per
source started together, into ``build/kernels/`` at the repository root;
the library's file name carries a hash of the sources and flags, so an
edited source is rebuilt and an unchanged one is loaded as it is.

Each C entry point launches on the stream it is given, allocates nothing
and returns the CUDA error code of its launches (0 = success). `Kernel`
wraps one entry point: it passes PyTorch's current stream, raises on a
nonzero code and counts its launches, so a run can show that its path went
through the kernel. A replayed CUDA graph calls no entry point; the graphed
train step (tracker/step_graph.py) adds the launches it recorded at capture
to these counts on every replay.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import time
from dataclasses import dataclass
from pathlib import Path
from typing import Dict, List, Sequence

import torch

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "kernels"

ARCH_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a"]
COMMON_FLAGS = ["-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]
# visibility, interp and the trilinear sampler must round every product
# and sum on its own, as PyTorch's elementwise ops do, so that they
# reproduce the plain versions bit for bit (the sampler's lod and texel
# coordinates are floored: one ulp moves a tap to the next level or
# texel); interp's backward too, because its plane and 1/w rows are
# ill-conditioned on sliver faces (contracting to FMA moves them by ~3e-4
# of a row's largest gradient at the bench's shapes). The plane gather
# only copies and adds.
SOURCES: Dict[str, List[str]] = {
    "errors.cu": [],
    "visibility.cu": ["--fmad=false"],
    "interp.cu": ["--fmad=false"],
    "interp_bwd.cu": ["--fmad=false"],
    "texture_fetch.cu": ["--fmad=false"],
    "texture_scatter.cu": ["--fmad=false"],
    "plane_gather.cu": [],
}

c_ptr, c_int, c_float = ctypes.c_void_p, ctypes.c_int, ctypes.c_float


@dataclass
class BuildReport:
    path: Path
    built: bool        # False: an up-to-date library was already there
    seconds: float
    log: str           # nvcc's output, incl. -Xptxas -v register lines


def _nvcc() -> str:
    for cand in (shutil.which("nvcc"),
                 os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                              "bin", "nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the port's CUDA kernels are built "
                       "with the CUDA toolkit (set CUDA_HOME or PATH)")


def _library_path() -> Path:
    h = hashlib.sha256()
    for name, flags in sorted(SOURCES.items()):
        h.update(name.encode())
        h.update(" ".join(ARCH_FLAGS + COMMON_FLAGS + flags).encode())
        h.update((CSRC / name).read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):      # included by the sources
        h.update(header.name.encode())
        h.update(header.read_bytes())
    return BUILD_DIR / f"libvhap_kernels-{h.hexdigest()[:16]}.so"


def build() -> BuildReport:
    """Compile the kernels unless an up-to-date library exists."""
    path = _library_path()
    if path.exists():
        return BuildReport(path, False, 0.0, "")
    nvcc = _nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    t0 = time.perf_counter()
    objs, procs = [], []
    for name, flags in SOURCES.items():
        obj = BUILD_DIR / f"{Path(name).stem}-{os.getpid()}.o"
        cmd = [nvcc, *ARCH_FLAGS, *COMMON_FLAGS, *flags, "-c",
               str(CSRC / name), "-o", str(obj)]
        procs.append((name, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
        objs.append(obj)
    logs, failed = [], []
    for name, proc in procs:
        out, _ = proc.communicate()
        logs.append(f"== {name}\n{out}")
        if proc.returncode != 0:
            failed.append(name)
    if failed:
        raise RuntimeError(f"nvcc failed on {failed}:\n" + "\n".join(logs))
    tmp = path.with_suffix(f".{os.getpid()}.tmp")
    link = subprocess.run(
        [nvcc, *ARCH_FLAGS, "-shared", *map(str, objs), "-o", str(tmp)],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    for obj in objs:
        obj.unlink(missing_ok=True)
    if link.returncode != 0:
        raise RuntimeError(f"linking the kernel library failed:\n{link.stdout}")
    os.replace(tmp, path)   # atomic: a concurrent loader sees all or nothing
    return BuildReport(path, True, time.perf_counter() - t0, "\n".join(logs))


@functools.lru_cache(maxsize=1)
def library() -> ctypes.CDLL:
    """The kernel library, built at first use."""
    lib = ctypes.CDLL(str(build().path))
    lib.vhap_error_string.argtypes = [c_int]
    lib.vhap_error_string.restype = ctypes.c_char_p
    return lib


class Kernel:
    """One C entry point of the kernel library, with its launch count.
    `Kernel.made` lists every entry point wrapped so far."""

    made: List["Kernel"] = []

    def __init__(self, name: str, symbol: str, argtypes: Sequence):
        self.name = name
        self.symbol = symbol
        self.argtypes = list(argtypes) + [c_ptr]   # + the stream
        self.launches = 0
        Kernel.made.append(self)

    def __call__(self, *args) -> None:
        lib = library()
        fn = getattr(lib, self.symbol)   # ctypes caches it with its types
        fn.argtypes, fn.restype = self.argtypes, c_int
        err = fn(*args, torch.cuda.current_stream().cuda_stream)
        if err != 0:
            msg = lib.vhap_error_string(err).decode()
            raise RuntimeError(f"{self.symbol} failed: CUDA error {err} ({msg})")
        self.launches += 1


def check_cuda_tensor(name: str, t: torch.Tensor, dtype: torch.dtype,
                      ndim: int) -> None:
    """Raise unless `t` is a contiguous CUDA tensor of this dtype and rank."""
    if not t.is_cuda:
        raise ValueError(f"{name} must be a CUDA tensor, got {t.device}")
    if t.dtype != dtype:
        raise ValueError(f"{name} must be {dtype}, got {t.dtype}")
    if t.dim() != ndim:
        raise ValueError(f"{name} must have {ndim} dims, got {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")
