"""Build the package's CUDA sources into one shared library, at first use.

Every ``csrc/*.cu`` file is compiled by ``nvcc`` into a shared library with
a plain C interface, which :func:`load` opens with ``ctypes``. The library
goes to ``build/ocdp_tpu_torch/`` at the root of the checkout, named by a
hash of the sources and flags, so a second run (or a second process) reuses
it. Nothing is downloaded: only the sources in the repository are built.
There is no fallback: without ``nvcc``, or when the build fails, this raises.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import subprocess
import tempfile
from pathlib import Path

__all__ = ["BUILD_DIR", "NVCC_FLAGS", "library_path", "load"]

_PKG = Path(__file__).resolve().parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG.parent / "build" / "ocdp_tpu_torch"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-O3",
              "-std=c++17", "-shared", "-Xcompiler", "-fPIC",
              "-Xptxas", "-v")

_P, _I = ctypes.c_void_p, ctypes.c_int
# name -> (restype, argtypes); every pointer and the stream are c_void_p
_SIGNATURES = {
    "fused_backup2d_f32": (_I, [_P] * 12 + [_I] * 4 + [_P]),
    "fused_backup2d_error_string": (ctypes.c_char_p, [_I]),
}


def _sources() -> list[Path]:
    return sorted(CSRC.glob("*.cu"))


def library_path() -> Path:
    """Where the library for the current sources and flags lives."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in _sources():
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_DIR / f"ocdp_kernels-{h.hexdigest()[:16]}.so"


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME

    nvcc = Path(CUDA_HOME or "", "bin", "nvcc")
    if not CUDA_HOME or not nvcc.is_file():
        raise RuntimeError(
            "nvcc not found (set CUDA_HOME to the CUDA toolkit); the CUDA "
            "kernels of ocdp_tpu_torch cannot be built")
    return str(nvcc)


def _compile(out: Path) -> None:
    out.parent.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=out.parent)
    os.close(fd)
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", tmp, *map(str, _sources())]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        os.unlink(tmp)
        raise RuntimeError(f"nvcc failed ({proc.returncode}):\n"
                           f"{' '.join(cmd)}\n{proc.stdout}{proc.stderr}")
    # the compiler's report (-Xptxas -v: registers, shared memory, spills)
    out.with_suffix(".log").write_text(proc.stdout + proc.stderr)
    os.replace(tmp, out)   # atomic: a concurrent process sees all or nothing


@functools.cache
def load() -> ctypes.CDLL:
    """Build the library if needed, open it and declare its C signatures."""
    path = library_path()
    if not path.is_file():
        _compile(path)
    lib = ctypes.CDLL(str(path))
    for name, (restype, argtypes) in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.restype = restype
        fn.argtypes = argtypes
    return lib
