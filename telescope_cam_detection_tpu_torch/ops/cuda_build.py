"""Build and load the port's CUDA C++ kernels: nvcc by hand, ctypes to bind.

Each kernel source under ``csrc/`` has a plain C interface. It is compiled
with ``nvcc`` for ``sm_90a`` into a shared library at first use, under
``_build/`` beside this package (listed in ``.gitignore``), and loaded with
``ctypes``. The library's name carries a digest of the source and the flags,
so an edited source is rebuilt and an unchanged one is reused. Importing this
module, or a binding that uses it, needs no ``nvcc`` and no card.
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
from typing import Callable, Optional, Sequence

PACKAGE_DIR = Path(__file__).resolve().parents[1]
CSRC_DIR = PACKAGE_DIR / "csrc"
BUILD_DIR = PACKAGE_DIR / "_build"
# -Xptxas -v prints each kernel's registers and shared memory into the log
BASE_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xptxas", "-v", "-shared", "-Xcompiler", "-fPIC")


def _nvcc(source: Path) -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError(f"nvcc not found: {source.name} is built from "
                           f"{source} on a host with the CUDA toolkit")
    return path


class CudaLibrary:
    """One ``csrc/*.cu`` source, built on demand and loaded once.

    ``declare(lib)`` sets the ``argtypes``/``restype`` of the library's
    functions; without them ctypes would cut pointers to 32 bits."""

    def __init__(self, source_name: str, extra_flags: Sequence[str] = (),
                 declare: Optional[Callable[[ctypes.CDLL], None]] = None):
        self.source = CSRC_DIR / source_name
        self.flags = (*BASE_FLAGS, *extra_flags)
        self.log = ""              # nvcc's output (ptxas lines) of the build
        self._declare = declare
        self._lib: Optional[ctypes.CDLL] = None
        self._lock = threading.Lock()

    def build(self) -> Path:
        """Compile the source into ``_build/`` unless a library built from
        the same source and flags is there; return its path."""
        digest = hashlib.sha256(self.source.read_bytes()
                                + " ".join(self.flags).encode()).hexdigest()[:12]
        target = BUILD_DIR / f"lib{self.source.stem}-{digest}.so"
        if target.exists():
            return target
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
        os.close(fd)
        try:
            proc = subprocess.run(
                [_nvcc(self.source), *self.flags, "-o", tmp, str(self.source)],
                capture_output=True, text=True)
            self.log = proc.stdout + proc.stderr
            if proc.returncode != 0:
                raise RuntimeError(
                    f"nvcc failed on {self.source}:\n{self.log}")
            os.replace(tmp, target)
        finally:
            if os.path.exists(tmp):
                os.unlink(tmp)
        return target

    def load(self) -> ctypes.CDLL:
        with self._lock:
            if self._lib is None:
                lib = ctypes.CDLL(str(self.build()))
                if self._declare is not None:
                    self._declare(lib)
                self._lib = lib
            return self._lib
