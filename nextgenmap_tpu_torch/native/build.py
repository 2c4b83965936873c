"""Build and load the port's CUDA kernels.

All of ``nextgenmap_tpu_torch/csrc/*.cu`` is compiled by ``nvcc`` for
Hopper (``sm_90a``), one ``nvcc`` per source, all started together, and
linked into ONE shared library with a plain C interface, which is loaded
with ``ctypes``.  No PyTorch header is compiled, so a build takes seconds.  The build runs at first use, into ``nextgenmap_tpu_torch/_build/``
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
    "-Xcompiler", "-fPIC",
)

P, I32, I64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong

# C signatures: (name, argtypes); every entry point returns cudaError_t
SIGNATURES = {
    "ngm_gather_windows": (P, I64, P, I64, I32, P, P),
    "ngm_sw_score": (P, P, P, P, P, I32, I32, I32, I32, I32, I32, I32, I32,
                     P, P, P, P),
    "ngm_row_gather": (P, P, I32, I32, I32, I32, P, P),
}

_lib: ctypes.CDLL | None = None


def find_nvcc() -> str:
    for cand in (shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")


def sources(srcdir: str = CSRC_DIR) -> list[str]:
    return sorted(glob.glob(os.path.join(srcdir, "*.cu")))


def library_path(srcdir: str = CSRC_DIR) -> str:
    h = hashlib.sha256()
    for path in sources(srcdir):
        h.update(os.path.basename(path).encode())
        with open(path, "rb") as f:
            h.update(f.read())
    h.update(" ".join(NVCC_FLAGS).encode())
    return os.path.join(BUILD_DIR, f"ngm_kernels-{h.hexdigest()[:16]}.so")


def _run(procs: list[subprocess.Popen], what: list[str]) -> None:
    """Wait for every process; raise with the stderr of the first failure."""
    outs = [p.communicate() for p in procs]
    for p, (out, err), name in zip(procs, outs, what):
        if p.returncode != 0:
            raise RuntimeError(
                f"nvcc failed on {name} ({p.returncode}):\n{err}{out}"
            )


def build(srcdir: str = CSRC_DIR) -> str:
    """Compile the kernels of `srcdir` (the port's csrc/, or another copy of
    it to compare with) unless the keyed library exists; returns its path."""
    so = library_path(srcdir)
    if os.path.exists(so):
        return so
    os.makedirs(BUILD_DIR, exist_ok=True)
    nvcc = find_nvcc()
    srcs = sources(srcdir)
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as td:
        objs = [os.path.join(td, f"{i}.o") for i in range(len(srcs))]
        _run([subprocess.Popen([nvcc, *NVCC_FLAGS, "-c", src, "-o", obj],
                               stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                               text=True)
              for src, obj in zip(srcs, objs)],
             [os.path.basename(src) for src in srcs])
        tmp = os.path.join(td, "lib.so")
        _run([subprocess.Popen([nvcc, *NVCC_FLAGS, "-shared", "-o", tmp, *objs],
                               stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                               text=True)], ["the link"])
        os.replace(tmp, so)
    return so


def bind(path: str) -> ctypes.CDLL:
    """Load a kernel library and declare its C signatures."""
    lib = ctypes.CDLL(path)
    for name, argtypes in SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = list(argtypes)
        fn.restype = ctypes.c_int
    lib.ngm_error_string.argtypes = [I32]
    lib.ngm_error_string.restype = ctypes.c_char_p
    return lib


def load() -> ctypes.CDLL:
    """The kernel library, built on first use and loaded once per process."""
    global _lib
    if _lib is None:
        _lib = bind(build())
    return _lib


def check(code: int, what: str) -> None:
    """Raise if a launch returned a CUDA error (a refused launch never runs,
    and a later synchronize would not report it)."""
    if code != 0:
        msg = load().ngm_error_string(code).decode()
        raise RuntimeError(f"{what}: CUDA error {code} at launch: {msg}")
