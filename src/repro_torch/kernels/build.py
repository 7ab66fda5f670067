"""Build the CUDA kernels at first use and bind them with ctypes.

The sources in ``csrc/`` have a plain C interface and include no PyTorch
header, so each compiles in seconds.  ``nvcc`` compiles every ``.cu`` file
at once, one process each, for ``sm_90a`` (Hopper), and links the objects
into one shared library under ``_build/<digest of sources and flags>/``
(listed in ``.gitignore``).  A build made from the same sources is reused.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

CSRC = Path(__file__).with_name("csrc")
BUILD_ROOT = Path(__file__).with_name("_build")
ARCH = ["-gencode", "arch=compute_90a,code=sm_90a"]
CFLAGS = ["-O3", "-std=c++17", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]
LIB_NAME = "libfetchsgd_kernels.so"

_lock = threading.Lock()
_lib: ctypes.CDLL | None = None

_P = ctypes.c_void_p
_I = ctypes.c_int
_LL = ctypes.c_longlong
_ULL = ctypes.c_ulonglong
_SEEDS = ctypes.POINTER(ctypes.c_uint32)
_SIGNATURES = {
    "fs_encode": [_P, _I, _LL, _ULL, _P, _I, _I, _SEEDS, _SEEDS, _ULL, _P,
                  _P, _P, _LL, _P],
    "fs_estimate": [_P, _I, _I, _ULL, _LL, _P, _SEEDS, _SEEDS, _ULL, _P],
    "fs_estimate_select": [_P, _I, _I, _ULL, _LL, _LL, _P, _P, _P, _P, _P,
                           ctypes.c_uint, _P, _P, _SEEDS, _SEEDS, _ULL, _P],
    "fs_momentum_error": [_P, _P, _P, _P, ctypes.c_float, _P, _P, _LL, _P],
    "fs_topk_mask": [_P, _P, _LL, _P, _P, _I, _I, _SEEDS, _SEEDS, _ULL, _I,
                     _I, _P],
    "fs_encode_bin_cols": [],
    "fs_encode_max_bins": [],
    "fs_select_tile": [],
    "fs_select_group_tiles": [],
    "fs_select_state_words": [],
}


class KernelError(RuntimeError):
    """A kernel failed to build or to launch."""


def nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME
    found = shutil.which("nvcc")
    if found:
        return found
    if CUDA_HOME and os.path.exists(os.path.join(CUDA_HOME, "bin", "nvcc")):
        return os.path.join(CUDA_HOME, "bin", "nvcc")
    raise KernelError("nvcc not found: the CUDA kernels cannot be built")


def sources() -> list[Path]:
    return sorted(CSRC.glob("*.cu"))


def _digest() -> str:
    h = hashlib.sha256(" ".join(ARCH + CFLAGS).encode())
    for p in sorted(CSRC.iterdir()):
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return h.hexdigest()[:16]


def build() -> Path:
    """Compile the kernels (if this digest has no library yet); the path."""
    out_dir = BUILD_ROOT / _digest()
    lib = out_dir / LIB_NAME
    if lib.exists():
        return lib
    out_dir.mkdir(parents=True, exist_ok=True)
    cc = nvcc()
    procs = []
    for src in sources():
        obj = out_dir / (src.stem + ".o")
        cmd = [cc, *ARCH, *CFLAGS, "-I", str(CSRC), "-c", str(src),
               "-o", str(obj)]
        procs.append((src, obj, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True)))
    logs, failed = [], []
    for src, _, proc in procs:
        out, _ = proc.communicate()
        logs.append(f"== {src.name}\n{out}")
        if proc.returncode != 0:
            failed.append(src.name)
    (out_dir / "build.log").write_text("\n".join(logs))
    if failed:
        raise KernelError(f"nvcc failed on {failed}:\n" + "\n".join(logs))
    tmp = out_dir / f"{LIB_NAME}.{os.getpid()}.tmp"
    link = subprocess.run(
        [cc, *ARCH, "-shared", "-o", str(tmp),
         *(str(obj) for _, obj, _ in procs)],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    if link.returncode != 0:
        raise KernelError(f"linking the kernels failed:\n{link.stdout}")
    os.replace(tmp, lib)
    return lib


def build_log() -> str:
    """nvcc's output (ptxas registers, spills) of the current build."""
    return (BUILD_ROOT / _digest() / "build.log").read_text()


def library() -> ctypes.CDLL:
    """The loaded kernel library, built on first use."""
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build()))
            for name, argtypes in _SIGNATURES.items():
                fn = getattr(lib, name)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
            lib.fs_error_string.argtypes = [ctypes.c_int]
            lib.fs_error_string.restype = ctypes.c_char_p
            _lib = lib
        return _lib


def check(code: int, kernel: str) -> None:
    """Raise if a launch returned a CUDA error (cudaGetLastError != 0)."""
    if code != 0:
        msg = library().fs_error_string(code).decode()
        raise KernelError(f"{kernel} kernel launch failed: {msg} ({code})")


def seeds(values) -> ctypes.Array:
    """A uint32 array of per-row hash seeds for a launch."""
    values = list(values)
    return (ctypes.c_uint32 * len(values))(*values)
