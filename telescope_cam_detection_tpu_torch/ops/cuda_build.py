"""Build and load the port's native libraries: a compiler by hand, ctypes to bind.

Each source under ``csrc/`` has a plain C interface. It is compiled at first
use into a shared library under ``_build/`` beside this package (listed in
``.gitignore``) and loaded with ``ctypes``: the CUDA kernels with ``nvcc``
for ``sm_90a`` (``CudaLibrary``), the host frame code with ``g++``
(``HostLibrary``). The library's name carries a digest of the source, the
compiler and the flags (and, for the host code, the CPU that
``-march=native`` resolves to), so an edited source is rebuilt and an
unchanged one is reused. A build writes a temporary file and renames it into place, so
processes that build the same library at once each load a whole file.
Importing this module, or a binding that uses it, needs no compiler and no
card.
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
# -march=native: a library built here runs on this host's CPU only; its name
# carries what that resolves to (HostLibrary.host_key)
HOST_FLAGS = ("-O3", "-march=native", "-fPIC", "-shared", "-std=c++17",
              "-pthread")


class SharedLibrary:
    """One ``csrc/`` source, built on demand and loaded once.

    ``declare(lib)`` sets the ``argtypes``/``restype`` of the library's
    functions; without them ctypes would cut pointers to 32 bits."""

    compiler = ""

    def __init__(self, source_name: str, flags: Sequence[str],
                 declare: Optional[Callable[[ctypes.CDLL], None]] = None):
        self.source = CSRC_DIR / source_name
        self.flags = tuple(flags)
        self.log = ""              # the compiler's output of the build
        self._declare = declare
        self._lib: Optional[ctypes.CDLL] = None
        self._lock = threading.Lock()

    def compiler_path(self) -> str:
        path = shutil.which(self.compiler)
        if path is None:
            raise RuntimeError(f"{self.compiler} not found: {self.source.name} "
                               f"is built from {self.source} at first use")
        return path

    def host_key(self) -> bytes:
        """What, beyond source, compiler and flags, decides the library."""
        return b""

    def build(self) -> Path:
        """Compile the source into ``_build/`` unless a library built from
        the same source, compiler, flags and ``host_key`` is there; return
        its path."""
        digest = hashlib.sha256(
            self.source.read_bytes()
            + " ".join((self.compiler, *self.flags)).encode()
            + self.host_key()).hexdigest()[:12]
        target = BUILD_DIR / f"lib{self.source.stem}-{digest}.so"
        if target.exists():
            return target
        compiler = self.compiler_path()
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
        os.close(fd)
        try:
            proc = subprocess.run(
                [compiler, *self.flags, "-o", tmp, str(self.source)],
                capture_output=True, text=True)
            self.log = proc.stdout + proc.stderr
            if proc.returncode != 0:
                raise RuntimeError(
                    f"{self.compiler} failed on {self.source}:\n{self.log}")
            os.replace(tmp, target)
        finally:
            if os.path.exists(tmp):
                os.unlink(tmp)
        return target

    def load(self) -> ctypes.CDLL:
        lib = self._lib
        if lib is not None:
            return lib
        with self._lock:
            if self._lib is None:
                lib = ctypes.CDLL(str(self.build()))
                if self._declare is not None:
                    self._declare(lib)
                self._lib = lib
            return self._lib


class CudaLibrary(SharedLibrary):
    """A ``csrc/*.cu`` kernel source, built with ``nvcc`` for sm_90a."""

    compiler = "nvcc"

    def __init__(self, source_name: str, extra_flags: Sequence[str] = (),
                 declare: Optional[Callable[[ctypes.CDLL], None]] = None):
        super().__init__(source_name, (*BASE_FLAGS, *extra_flags), declare)

    def compiler_path(self) -> str:
        if shutil.which("nvcc") is None and \
                os.path.exists("/usr/local/cuda/bin/nvcc"):
            return "/usr/local/cuda/bin/nvcc"
        return super().compiler_path()


class HostLibrary(SharedLibrary):
    """A ``csrc/*.cpp`` host source, built with ``g++``."""

    compiler = "g++"

    def __init__(self, source_name: str,
                 declare: Optional[Callable[[ctypes.CDLL], None]] = None):
        super().__init__(source_name, HOST_FLAGS, declare)

    def host_key(self) -> bytes:
        """The target options -march=native resolves to on this host, so a
        library built for another CPU (a copied checkout) is never loaded."""
        return subprocess.run(
            [self.compiler_path(), "-march=native", "-Q", "--help=target"],
            capture_output=True, check=True, timeout=60).stdout
