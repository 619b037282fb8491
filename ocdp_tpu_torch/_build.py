"""Build the package's CUDA sources into one shared library, at first use.

Every ``csrc/*.cu`` file is compiled by its own ``nvcc`` process, all of
them at once, and the objects are linked into one shared library with a
plain C interface, which :func:`load` opens with ``ctypes``. The library
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
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

__all__ = ["BUILD_DIR", "NVCC_FLAGS", "library_path", "load"]

_PKG = Path(__file__).resolve().parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG.parent / "build" / "ocdp_tpu_torch"
_ARCH = ("-gencode", "arch=compute_90a,code=sm_90a")
NVCC_FLAGS = (*_ARCH, "-O3", "-std=c++17", "-Xcompiler", "-fPIC",
              "-Xptxas", "-v")

_P, _I = ctypes.c_void_p, ctypes.c_int
# name -> (restype, argtypes); every pointer and the stream are c_void_p
_SIGNATURES = {
    "band_backup2d_f32": (_I, [_P] * 3),
    "band_backup2d_blocks_per_sm": (_I, [_I]),
    "band_backup2d_error_string": (ctypes.c_char_p, [_I]),
    "fused_backup2d_f32": (_I, [_P] * 12 + [_I] * 4 + [_P]),
    "fused_backup2d_error_string": (ctypes.c_char_p, [_I]),
    "fused_backup2d_affine_f32": (_I, [_P] * 4 + [_I, _P]),
    "fused_backup2d_affine_configure": (_I, [_P]),
    "fused_backup2d_affine_params_size": (_I, []),
    "fused_backup2d_affine_blocks_per_sm": (_I, [_P]),
    "rowlane_backup_f32": (_I, [_I] + [_P] * 5),
    "rowlane_backup_configure": (_I, [_I] * 2),
    "rowlane_backup_blocks_per_sm": (_I, [_I] * 2),
    "rowlane_backup_error_string": (ctypes.c_char_p, [_I]),
    "backup6d_f32": (_I, [_P] * 29 + [_I] * 18 + [_P]),
    "backup6d_smem_limit": (_I, []),
    "backup6d_blocks_per_sm": (_I, [_I] * 6),
    "backup6d_error_string": (ctypes.c_char_p, [_I]),
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


def _run(cmd: list[str]) -> str:
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed ({proc.returncode}):\n"
                           f"{' '.join(cmd)}\n{proc.stdout}{proc.stderr}")
    return proc.stdout + proc.stderr


def _compile(out: Path) -> None:
    out.parent.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    with tempfile.TemporaryDirectory(dir=out.parent) as tmp:
        objs = [str(Path(tmp, src.stem + ".o")) for src in _sources()]
        cmds = [[nvcc, *NVCC_FLAGS, "-c", "-o", obj, str(src)]
                for obj, src in zip(objs, _sources())]
        with ThreadPoolExecutor(max_workers=len(cmds)) as pool:
            logs = list(pool.map(_run, cmds))
        lib = str(Path(tmp, out.name))
        _run([nvcc, *_ARCH, "-shared", "-o", lib, *objs])
        # the compiler's report (-Xptxas -v: registers, shared memory, spills)
        out.with_suffix(".log").write_text("".join(logs))
        os.replace(lib, out)   # atomic: a concurrent process sees all or nothing


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
