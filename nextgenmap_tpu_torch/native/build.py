"""Build and load the port's CUDA kernels.

All of ``nextgenmap_tpu_torch/csrc/*.cu`` is compiled by ``nvcc`` for
Hopper (``sm_90a``) into ONE shared library with a plain C interface, which
is loaded with ``ctypes``.  No PyTorch header is compiled, so a build takes
seconds.  The build runs at first use, into ``nextgenmap_tpu_torch/_build/``
(listed in .gitignore), keyed by a hash of the sources and the flags; a
failed build raises with nvcc's stderr.

Every C entry point takes device pointers and the CUDA stream as
``c_void_p``, launches on that stream without synchronising, and returns
``cudaGetLastError()``; ``check`` turns a non-zero code into an exception.
"""

from __future__ import annotations

import ctypes
import glob
import hashlib
import os
import shutil
import subprocess
import tempfile

PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC_DIR = os.path.join(PKG_DIR, "csrc")
BUILD_DIR = os.path.join(PKG_DIR, "_build")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC",
)

P, I32, I64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong

# C signatures: (name, argtypes); every entry point returns cudaError_t
SIGNATURES = {
    "ngm_gather_windows": (P, I64, P, I64, I32, P, P),
    "ngm_sw_score": (P, P, P, P, P, I32, I32, I32, I32, I32, I32, I32,
                     P, P, P, P),
}

_lib: ctypes.CDLL | None = None


def find_nvcc() -> str:
    for cand in (shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")


def sources() -> list[str]:
    return sorted(glob.glob(os.path.join(CSRC_DIR, "*.cu")))


def library_path() -> str:
    h = hashlib.sha256()
    for path in sources():
        h.update(os.path.basename(path).encode())
        with open(path, "rb") as f:
            h.update(f.read())
    h.update(" ".join(NVCC_FLAGS).encode())
    return os.path.join(BUILD_DIR, f"ngm_kernels-{h.hexdigest()[:16]}.so")


def build() -> str:
    """Compile the kernels unless the keyed library exists; returns its path."""
    so = library_path()
    if os.path.exists(so):
        return so
    os.makedirs(BUILD_DIR, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as td:
        tmp = os.path.join(td, "lib.so")
        proc = subprocess.run(
            [find_nvcc(), *NVCC_FLAGS, "-o", tmp, *sources()],
            capture_output=True, text=True,
        )
        if proc.returncode != 0:
            raise RuntimeError(
                f"nvcc failed ({proc.returncode}):\n{proc.stderr}{proc.stdout}"
            )
        os.replace(tmp, so)
    return so


def load() -> ctypes.CDLL:
    """The kernel library, built on first use and loaded once per process."""
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(build())
        for name, argtypes in SIGNATURES.items():
            fn = getattr(lib, name)
            fn.argtypes = list(argtypes)
            fn.restype = ctypes.c_int
        lib.ngm_error_string.argtypes = [I32]
        lib.ngm_error_string.restype = ctypes.c_char_p
        _lib = lib
    return _lib


def check(code: int, what: str) -> None:
    """Raise if a launch returned a CUDA error (a refused launch never runs,
    and a later synchronize would not report it)."""
    if code != 0:
        msg = load().ngm_error_string(code).decode()
        raise RuntimeError(f"{what}: CUDA error {code} at launch: {msg}")
