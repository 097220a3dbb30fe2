"""Build and load the port's hand-written CUDA kernels.

Each kernel is one source ``csrc/<name>.cu`` with a plain C interface.  At
first use it is compiled by ``nvcc`` for ``sm_90a`` into a shared library
``build/kernels/<name>_<source hash>.so`` at the repository root and loaded
with ``ctypes``; a library built from the same source is reused.  Nothing
here runs at import: a build starts only when a wrapper first launches its
kernel on a CUDA tensor (or when a caller asks for it), and it raises if
``nvcc`` is missing or refuses the source.  Builds of different kernels
may run at the same time (``nvcc`` runs in a subprocess, and each library
is renamed into place whole).
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")


def nvcc() -> Path:
    """``$CUDA_HOME/bin/nvcc``, else the ``nvcc`` on the PATH, else the
    toolkit's default place."""
    if "CUDA_HOME" in os.environ:
        return Path(os.environ["CUDA_HOME"]) / "bin" / "nvcc"
    found = shutil.which("nvcc")
    return Path(found) if found else Path("/usr/local/cuda/bin/nvcc")


def compile_source(source: Path, build_dir: Path) -> dict:
    """Compile ``source`` into ``build_dir`` unless a library built from the
    same bytes is already there.  Returns ``{"seconds", "log", "path"}``:
    the compile time (0.0 when reused) and what ``nvcc`` printed."""
    src = source.read_bytes()
    out = build_dir / f"{source.stem}_{hashlib.sha256(src).hexdigest()[:16]}.so"
    if out.exists():
        return {"seconds": 0.0, "log": "", "path": str(out)}
    compiler = nvcc()
    if not compiler.is_file():
        raise RuntimeError(f"nvcc not found at {compiler}: the {source.stem} "
                           f"kernel needs the CUDA toolkit (set CUDA_HOME)")
    build_dir.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.stem}.{os.getpid()}.{threading.get_ident()}"
                        f".tmp.so")
    t0 = time.perf_counter()
    proc = subprocess.run([str(compiler), *NVCC_FLAGS, "-o", str(tmp),
                           str(source)], capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed to build {source}:\n"
                           f"{proc.stdout}{proc.stderr}")
    os.replace(tmp, out)  # atomic: concurrent builders never see half a file
    return {"seconds": time.perf_counter() - t0,
            "log": proc.stdout + proc.stderr, "path": str(out)}


class KernelLibrary:
    """One kernel's shared library: built at first use, loaded once, with
    ``argtypes`` and an ``int`` (the CUDA error code) ``restype`` set on each
    C entry named in ``entries``."""

    def __init__(self, name: str, entries: dict[str, list]):
        self.source = CSRC / f"{name}.cu"
        self.entries = entries
        # What the last build printed and took; None until it is built.
        self.build_info: dict | None = None
        self._lib: ctypes.CDLL | None = None
        self._lock = threading.Lock()

    def build(self, build_dir: Path = BUILD_DIR) -> Path:
        self.build_info = compile_source(self.source, build_dir)
        return Path(self.build_info["path"])

    def entry(self, name: str):
        """The C entry ``name``, loading the library (and building it, unless
        this object built it already) at the first call."""
        with self._lock:
            if self._lib is None:
                path = (Path(self.build_info["path"]) if self.build_info
                        else self.build())
                lib = ctypes.CDLL(str(path))
                for fn, argtypes in self.entries.items():
                    getattr(lib, fn).argtypes = argtypes
                    getattr(lib, fn).restype = ctypes.c_int
                self._lib = lib
        return getattr(self._lib, name)
