"""Building and loading the port's CUDA sources (``pfpn_torch/csrc``).

Each source is a plain C interface compiled into a shared library and
loaded with ctypes, with no PyTorch headers (nvcc then takes seconds, not
minutes):

* ``host=False``: ``nvcc`` for ``sm_90a``, the kernel;
* ``host=True``: g++ builds the same source as plain C++ (``-x c++``), so
  the CPU tests run the kernel's arithmetic without a card.

Outputs go into ``build/`` (listed in ``.gitignore``), named by a hash of
the source and the headers it includes, so a changed source is rebuilt and
an unchanged one is built once.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
from typing import Callable, Optional, Sequence, Tuple

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(os.path.dirname(_PKG), "build")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
HOST_FLAGS = ("-x", "c++", "-std=c++17", "-O2", "-shared", "-fPIC")


def nvcc() -> str:
    for cand in (shutil.which("nvcc"),
                 os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                              "bin", "nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the port's kernels are built from "
                       "pfpn_torch/csrc with the CUDA toolkit")


class CudaSource:
    """One ``csrc/<name>.cu`` and the libraries built from it.

    ``declare(lib, host)`` sets ``argtypes`` and ``restype`` on the loaded
    library's functions (and may check its layouts)."""

    def __init__(self, name: str, declare: Callable[[ctypes.CDLL, bool], None],
                 headers: Sequence[str] = ()):
        self.name = name
        self.source = os.path.join(CSRC, f"{name}.cu")
        self.headers = tuple(os.path.join(CSRC, h) for h in headers)
        self._declare = declare
        self._libs: dict = {}

    def _output(self, host: bool) -> str:
        digest = hashlib.sha256()
        for path in (self.source,) + self.headers:
            with open(path, "rb") as fh:
                digest.update(fh.read())
        kind = "host" if host else "sm90a"
        return os.path.join(
            BUILD_DIR, f"libpfpn_{self.name}_{kind}_{digest.hexdigest()[:12]}.so")

    def build(self, host: bool = False) -> Tuple[str, str]:
        """Compile into build/ unless this source text is built already.
        Returns (library path, compiler output)."""
        out = self._output(host)
        if os.path.exists(out):
            return out, ""
        os.makedirs(BUILD_DIR, exist_ok=True)
        fd, tmp = tempfile.mkstemp(dir=BUILD_DIR, suffix=".so.tmp")
        os.close(fd)
        if host:
            cxx = shutil.which("g++") or shutil.which("c++")
            if cxx is None:
                raise RuntimeError("no C++ compiler for the host build")
            cmd = [cxx, *HOST_FLAGS, self.source, "-o", tmp]
        else:
            cmd = [nvcc(), *NVCC_FLAGS, self.source, "-o", tmp]
        proc = subprocess.run(cmd, capture_output=True, text=True)
        if proc.returncode != 0:
            os.unlink(tmp)
            raise RuntimeError(f"building {self.source} failed:\n{' '.join(cmd)}\n"
                               f"{proc.stdout}{proc.stderr}")
        os.replace(tmp, out)
        return out, proc.stdout + proc.stderr

    def load(self, host: bool = False) -> ctypes.CDLL:
        """The built library, loaded and declared once per process."""
        lib: Optional[ctypes.CDLL] = self._libs.get(host)
        if lib is None:
            lib = ctypes.CDLL(self.build(host)[0])
            self._declare(lib, host)
            self._libs[host] = lib
        return lib
