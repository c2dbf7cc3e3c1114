"""Build and load the port's hand-written CUDA kernels.

Each kernel is a ``.cu`` file under ``src/repro_torch/csrc/`` with a plain C
interface.  At first use it is compiled with ``nvcc`` for Hopper
(``sm_90a``) into a shared library under ``build/kernels/`` of the
checkout, keyed by a hash of the source and the compiler flags, and loaded
with :mod:`ctypes`.  Nothing is compiled or loaded when a module is
imported: the CPU tests import every module on a machine without ``nvcc``.

A failed build raises :class:`KernelBuildError` carrying nvcc's output;
there is no fallback.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import pathlib
import shutil
import subprocess
import tempfile
from typing import Dict, Tuple

CSRC = pathlib.Path(__file__).resolve().parents[1] / "csrc"
# <checkout>/build/kernels (the package lives at <checkout>/src/repro_torch).
BUILD_DIR = pathlib.Path(__file__).resolve().parents[3] / "build" / "kernels"

NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")


class KernelBuildError(RuntimeError):
    """nvcc is missing or refused a kernel source."""


def find_nvcc() -> str:
    """The nvcc of ``$CUDA_HOME`` (or PyTorch's idea of it), else PATH's."""
    from torch.utils.cpp_extension import CUDA_HOME
    for home in (os.environ.get("CUDA_HOME"), CUDA_HOME, "/usr/local/cuda"):
        if home:
            cand = pathlib.Path(home) / "bin" / "nvcc"
            if cand.is_file():
                return str(cand)
    found = shutil.which("nvcc")
    if found is None:
        raise KernelBuildError("nvcc not found: set CUDA_HOME or put the "
                               "CUDA toolkit's bin/ on PATH")
    return found


class KernelLibrary:
    """One compiled source: its ctypes handle and nvcc's ``-Xptxas -v``
    report (registers, shared memory and spills per kernel)."""

    def __init__(self, path: pathlib.Path, ptxas_log: str, built: bool):
        self.path = path
        self.ptxas_log = ptxas_log
        self.built = built          # False when the cached build was reused
        self.lib = ctypes.CDLL(str(path))


_LOADED: Dict[str, KernelLibrary] = {}


def _key(source: pathlib.Path) -> str:
    h = hashlib.sha256(source.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return h.hexdigest()[:16]


def load_library(name: str) -> KernelLibrary:
    """Compile ``csrc/<name>.cu`` unless a build of the same source and
    flags exists, and load it (once per process)."""
    if name in _LOADED:
        return _LOADED[name]
    source = CSRC / f"{name}.cu"
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    stem = f"lib{name}-{_key(source)}"
    so, log = BUILD_DIR / f"{stem}.so", BUILD_DIR / f"{stem}.ptxas.txt"
    built = False
    if not so.is_file():
        so_tmp, log_text = _compile(source, BUILD_DIR)
        log.write_text(log_text)
        # Atomic publish: concurrent first uses never load a torn library.
        os.replace(so_tmp, so)
        built = True
    _LOADED[name] = KernelLibrary(
        so, log.read_text() if log.is_file() else "", built)
    return _LOADED[name]


def _compile(source: pathlib.Path, out_dir: pathlib.Path) -> Tuple[str, str]:
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=out_dir)
    os.close(fd)
    cmd = [find_nvcc(), *NVCC_FLAGS, "-o", tmp, str(source)]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        os.unlink(tmp)
        raise KernelBuildError(
            f"nvcc failed ({proc.returncode}) on {source}:\n"
            f"$ {' '.join(cmd)}\n{proc.stdout}{proc.stderr}")
    return tmp, proc.stdout + proc.stderr
