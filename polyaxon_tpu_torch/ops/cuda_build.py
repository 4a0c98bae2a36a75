"""Build the port's CUDA sources into shared libraries with a plain C
interface, loaded with ``ctypes``.

Each library is compiled by ``nvcc`` for ``sm_90a`` at first use, from the
sources under ``polyaxon_tpu_torch/csrc/`` alone, into
``polyaxon_tpu_torch/_build/`` (git-ignored). The file name carries a hash
of the sources and flags, so an edited source rebuilds and an unchanged one
loads the cached library. Nothing here runs at import time.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
from pathlib import Path
from typing import Optional

PACKAGE_DIR = Path(__file__).resolve().parents[1]
CSRC_DIR = PACKAGE_DIR / "csrc"
BUILD_DIR = PACKAGE_DIR / "_build"

NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)


class KernelBuildError(RuntimeError):
    """nvcc is missing or refused a source."""


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME")
    if home and (Path(home) / "bin" / "nvcc").exists():
        return str(Path(home) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found:
        return found
    default = Path("/usr/local/cuda/bin/nvcc")  # the toolkit's default prefix
    if default.exists():
        return str(default)
    raise KernelBuildError(
        "nvcc not found (set CUDA_HOME or put nvcc on PATH); the port's "
        "CUDA kernels build only where the CUDA toolkit is installed")


class _Library:
    """One shared library: sources, its cached path, and the loaded
    handle. ``load()`` builds on first use, sets each exported function's
    ``(argtypes, restype)`` from ``signatures`` once, and is thread-safe."""

    def __init__(self, name: str, sources: tuple[str, ...],
                 signatures: Optional[dict] = None,
                 headers: tuple[str, ...] = ()):
        self.name = name
        self.sources = tuple(CSRC_DIR / s for s in sources)
        #: headers the sources include: part of the hash, not of the command
        self.headers = tuple(CSRC_DIR / h for h in headers)
        self.signatures = dict(signatures or {})
        self._lock = threading.Lock()
        self._handle = None
        #: nvcc's output of the build this process ran (ptxas register and
        #: shared-memory report); empty when the cached library was loaded
        self.build_log = ""

    def digest(self) -> str:
        h = hashlib.sha256()
        for flag in NVCC_FLAGS:
            h.update(flag.encode())
        for src in self.sources + self.headers:
            h.update(src.name.encode())
            h.update(src.read_bytes())
        return h.hexdigest()[:16]

    def path(self) -> Path:
        return BUILD_DIR / f"lib{self.name}-{self.digest()}.so"

    def build(self) -> Path:
        out = self.path()
        if out.exists():
            return out
        nvcc = _nvcc()  # before the temporary file, which a missing nvcc would leave
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
        os.close(fd)
        cmd = [nvcc, *NVCC_FLAGS, "-o", tmp, *map(str, self.sources)]
        proc = subprocess.run(cmd, capture_output=True, text=True)
        if proc.returncode != 0:
            os.unlink(tmp)
            raise KernelBuildError(
                f"nvcc failed for {self.name} ({proc.returncode}):\n"
                f"{proc.stdout}{proc.stderr}")
        self.build_log = proc.stdout + proc.stderr
        os.replace(tmp, out)  # atomic: a concurrent loader sees all or none
        return out

    def load(self) -> ctypes.CDLL:
        with self._lock:
            if self._handle is None:
                handle = ctypes.CDLL(str(self.build()))
                for fn_name, (argtypes, restype) in self.signatures.items():
                    fn = getattr(handle, fn_name)
                    fn.argtypes = argtypes
                    fn.restype = restype
                self._handle = handle
            return self._handle
