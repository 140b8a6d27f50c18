"""Shared kernel plumbing: ``cdiv``, the lane-word planes, the kernel build
and the launch counts.

The CUDA sources in ``repro_torch/csrc/*.cu`` have a plain C interface. On
first use they are compiled for ``sm_90a`` by ``nvcc``, one process per
source, all started together, and linked into one shared library that is
loaded with ``ctypes``. The library is cached under ``repro_torch/_build/``
by a hash of the sources and flags. Nothing here runs when the module is
imported, so the package imports on a machine without ``nvcc`` or a GPU.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

import torch

_PKG = Path(__file__).resolve().parent.parent
CSRC_DIR = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
LIB_NAME = "librepro_torch_kernels.so"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xcompiler", "-fPIC")

# Launch count of each kernel wrapper: one per kernel launch, nowhere else.
LAUNCHES: dict[str, int] = {"bottom_up_probe": 0, "topdown_scan": 0,
                            "msbfs_probe": 0, "segment_or": 0,
                            "semiring_relax": 0, "relax_fallback": 0,
                            "ell_spmm": 0, "spmm_residue": 0,
                            "derive_parents": 0}

_lib: ctypes.CDLL | None = None
build_info: dict = {}


def cdiv(a: int, b: int) -> int:
    return (a + b - 1) // b


def word_planes(words: torch.Tensor) -> torch.Tensor:
    """Lane words as the int32 word planes the lane-word kernels read.

    int32 words are their own planes. int64 words [..., W] become their
    int32 view [..., 2W], which is the reference's ``split_u64_words``
    layout: plane 2k is word k's low half and plane 2k + 1 its high half
    (the card and the host are little-endian). The view needs a contiguous
    last dimension; ``.view(torch.int64)`` of a result undoes it."""
    return words.view(torch.int32) if words.dtype == torch.int64 else words


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def _nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    nvcc = shutil.which("nvcc") or os.path.join(cuda_home, "bin", "nvcc")
    if not os.path.exists(nvcc):
        raise RuntimeError(f"nvcc not found (looked on PATH and at {nvcc})")
    return nvcc


def build_kernels() -> Path:
    """Compile every ``csrc/*.cu`` and link them into one shared library.

    Returns its path. ``build_info`` records the seconds taken, the sources
    and ptxas's register, shared-memory and spill report.
    """
    sources = sorted(CSRC_DIR.glob("*.cu"))
    key = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in sorted(CSRC_DIR.glob("*.cu*")):  # sources and headers
        key.update(path.name.encode() + path.read_bytes())
    out_dir = BUILD_DIR / key.hexdigest()[:16]
    lib_path = out_dir / LIB_NAME
    if lib_path.exists():
        build_info.update(path=str(lib_path), cached=True, seconds=0.0,
                          sources=[s.name for s in sources])
        return lib_path
    nvcc = _nvcc()
    out_dir.mkdir(parents=True, exist_ok=True)
    t0 = time.perf_counter()
    objs = [out_dir / (src.stem + ".o") for src in sources]
    procs = [subprocess.Popen(
        [nvcc, *NVCC_FLAGS, "-Xptxas", "-v", "-c", str(src), "-o", str(obj)],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for src, obj in zip(sources, objs)]
    logs = [p.communicate()[0] for p in procs]  # wait for every process
    for src, p, log in zip(sources, procs, logs):
        if p.returncode != 0:
            raise RuntimeError(f"nvcc failed on {src.name}:\n{log}")
    tmp = out_dir / f"{LIB_NAME}.{os.getpid()}.tmp"
    link = subprocess.run([nvcc, "-shared", "-o", str(tmp), *map(str, objs)],
                          stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                          text=True)
    if link.returncode != 0:
        raise RuntimeError(f"nvcc link failed:\n{link.stdout}")
    os.replace(tmp, lib_path)
    build_info.update(path=str(lib_path), cached=False,
                      seconds=time.perf_counter() - t0,
                      sources=[s.name for s in sources],
                      ptxas=[line.strip() for log in logs
                             for line in log.splitlines()
                             if "ptxas" in line or "spill" in line])
    return lib_path


def load_library() -> ctypes.CDLL:
    """The kernels' shared library, built on first use."""
    global _lib
    if _lib is None:
        _lib = ctypes.CDLL(str(build_kernels()))
    return _lib


def sm_count(device: torch.device) -> int:
    """The number of SMs of CUDA ``device``, which sizes the kernels' grids."""
    return torch.cuda.get_device_properties(device).multi_processor_count


def check_cuda_tensor(name: str, t: torch.Tensor, numel: int | None = None,
                      device: torch.device | None = None,
                      width: int | None = None, dtype=torch.int32):
    """Raise unless ``t`` is a contiguous CUDA tensor of ``dtype`` (int32
    unless given): 1-D, or 2-D with ``width`` columns when ``width`` is
    given (of ``numel`` elements, and on ``device``, when given)."""
    if t.device.type != "cuda":
        raise ValueError(f"{name} must be a CUDA tensor, got {t.device}")
    if device is not None and t.device != device:
        raise ValueError(f"{name} must be on {device}, got {t.device}")
    if t.dtype != dtype:
        raise ValueError(f"{name} must be {dtype}, got {t.dtype}")
    if width is None and (t.dim() != 1 or not t.is_contiguous()):
        raise ValueError(f"{name} must be 1-D and contiguous")
    if width is not None and (t.dim() != 2 or t.shape[1] != width
                              or not t.is_contiguous()):
        raise ValueError(f"{name} must be 2-D, contiguous, with {width} "
                         f"columns, got {tuple(t.shape)}")
    if numel is not None and t.numel() != numel:
        raise ValueError(f"{name} must have {numel} elements, got {t.numel()}")


def check_launch(name: str, err: int) -> None:
    """Raise if the C entry reported a CUDA error for the launch."""
    if err != 0:
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {err}")
