"""Build and load the port's CUDA kernels.

Each ``csrc/<name>.cu`` is compiled with ``nvcc`` for Hopper (``sm_90a``)
into a shared library with a plain C interface and loaded with ``ctypes``.
The build happens at first use, from the sources in the checkout, into
``attackfl_tpu_torch/_build/`` (git-ignored).  The library's file name
carries a hash of its source, of every shared header ``csrc/*.cuh`` and of
the flags, so an edited source or header is rebuilt and a stale library is
never loaded.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path

PKG_DIR = Path(__file__).resolve().parent.parent
SRC_DIR = PKG_DIR / "csrc"
BUILD_DIR = PKG_DIR / "_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")


class MaskSpec(ctypes.Structure):
    """One mask tensor of K3's arena, as ``csrc/dropout_mask.cu:MaskSpec``."""
    _fields_ = [("first_quad", ctypes.c_int64), ("per_client", ctypes.c_uint32),
                ("tensor_id", ctypes.c_uint32), ("thr", ctypes.c_uint32),
                ("scale", ctypes.c_float)]


# C signatures of each library's exported functions: (restype, argtypes)
_P, _I, _U, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_uint32, ctypes.c_float
SIGNATURES = {
    "fused_step": {
        "fused_step_scratch_floats": (ctypes.c_int, [_I]),
        "fused_step_run_epoch": (ctypes.c_int, [
            ctypes.POINTER(ctypes.c_void_p), _P, _P, _P,   # ptrs, batches, loss, scratch
            _I, _I, _I, _P, _I, _I,                        # C nb B seed seed_offset t_offset
            _I, _F, _F,                                    # client_base lr clip
            _U, _F, _U, _F, _U, _F,                        # dropout thr/scale x3
            _P]),                                          # stream
    },
    "dropout_mask": {
        "dropout_masks_fill": (ctypes.c_int, [
            _P, _P, _I,                                    # keys, arena, C
            ctypes.POINTER(MaskSpec), _I,                  # specs, count
            _P]),                                          # stream
    },
}


def find_nvcc() -> str:
    nvcc = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(nvcc):
        raise RuntimeError("nvcc not found: the CUDA kernels build only where "
                           "the CUDA toolkit is installed")
    return nvcc


def library_path(name: str) -> Path:
    h = hashlib.sha256((SRC_DIR / f"{name}.cu").read_bytes())
    for header in sorted(SRC_DIR.glob("*.cuh")):
        h.update(header.name.encode() + b"\0" + header.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:16]}.so"


def build_all(names) -> dict[str, tuple[Path, str]]:
    """Compile each ``csrc/<name>.cu`` whose library does not exist, one
    ``nvcc`` per source, all started together.  Returns each library's
    path and the compiler's output (``-Xptxas -v`` lists each kernel's
    registers, shared memory and spills; empty if not built)."""
    out: dict[str, tuple[Path, str]] = {}
    jobs = []
    try:
        for name in names:
            path = library_path(name)
            if path.exists():
                out[name] = (path, "")
                continue
            BUILD_DIR.mkdir(parents=True, exist_ok=True)
            fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
            os.close(fd)
            jobs.append((name, path, tmp, subprocess.Popen(
                [find_nvcc(), *NVCC_FLAGS, "-o", tmp, str(SRC_DIR / f"{name}.cu")],
                stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)))
        failed = []
        for name, path, tmp, proc in jobs:
            stdout, stderr = proc.communicate()
            if proc.returncode != 0:
                failed.append(f"nvcc failed on {name}.cu:\n{stderr}")
                continue
            os.replace(tmp, path)
            out[name] = (path, stdout + stderr)
        if failed:
            raise RuntimeError("\n".join(failed))
    finally:
        for _, _, tmp, proc in jobs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
            if os.path.exists(tmp):
                os.unlink(tmp)
    return out


def build(name: str) -> tuple[Path, str]:
    """Compile ``csrc/<name>.cu`` unless its library exists (see
    :func:`build_all`)."""
    return build_all([name])[name]


@functools.cache
def load_library(name: str) -> ctypes.CDLL:
    """The built library of ``csrc/<name>.cu`` with its C signatures set."""
    path, _ = build(name)
    lib = ctypes.CDLL(str(path))
    for fn, (restype, argtypes) in SIGNATURES[name].items():
        getattr(lib, fn).restype = restype
        getattr(lib, fn).argtypes = argtypes
    return lib
