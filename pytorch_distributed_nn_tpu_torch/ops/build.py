"""Build a CUDA source of ``csrc/`` into a shared library, at first use.

``nvcc`` compiles one ``.cu`` with a plain C interface for ``sm_90a`` into
``<package>/_build/`` (listed in ``.gitignore``), named by a hash of the
source, the shared headers and the flags, so an edited source or header
rebuilds and an unchanged one loads what is there. The library is bound with ``ctypes``. Nothing here
runs at import time. Each source has its own lock, so different sources
build in parallel (:func:`load_libraries`).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

PACKAGE_DIR = Path(__file__).resolve().parent.parent
CSRC_DIR = PACKAGE_DIR / "csrc"
BUILD_DIR = PACKAGE_DIR / "_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_lock = threading.Lock()  # guards _locks
_locks: dict[str, threading.Lock] = {}
_loaded: dict[str, ctypes.CDLL] = {}
# source name -> (seconds spent building, 0.0 when already built; the
# compiler's report of registers, shared memory and spills)
build_info: dict[str, tuple[float, str]] = {}


def nvcc_path() -> str:
    for cand in (os.environ.get("CUDA_HOME", ""),
                 os.environ.get("CUDA_PATH", "")):
        if cand and (Path(cand) / "bin" / "nvcc").exists():
            return str(Path(cand) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found:
        return found
    default = Path("/usr/local/cuda/bin/nvcc")
    if default.exists():
        return str(default)
    raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH")


def library_path(source: str) -> Path:
    """Where ``csrc/<source>`` builds to: named by a hash of the source,
    the headers of ``csrc/`` (which a source may include) and the flags."""
    src = (CSRC_DIR / source).read_bytes()
    src += b"".join(p.read_bytes() for p in sorted(CSRC_DIR.glob("*.cuh")))
    digest = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()
    return BUILD_DIR / f"lib{Path(source).stem}-{digest[:16]}.so"


def load_library(source: str) -> ctypes.CDLL:
    """The ctypes handle for ``csrc/<source>``, built on first use."""
    with _lock:
        lock = _locks.setdefault(source, threading.Lock())
    with lock:
        lib = _loaded.get(source)
        if lib is not None:
            return lib
        out = library_path(source)
        t0 = time.monotonic()
        report = ""
        if not out.exists():
            BUILD_DIR.mkdir(parents=True, exist_ok=True)
            # build under a temporary name, then rename: a concurrent build
            # or a cut-off one never leaves a torn library
            fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
            os.close(fd)
            try:
                proc = subprocess.run(
                    [nvcc_path(), *NVCC_FLAGS, "-o", tmp,
                     str(CSRC_DIR / source)],
                    capture_output=True, text=True)
                if proc.returncode != 0:
                    raise RuntimeError(
                        f"nvcc failed on {source} (exit {proc.returncode}):"
                        f"\n{proc.stdout}\n{proc.stderr}")
                report = proc.stdout + proc.stderr
                os.replace(tmp, out)
            finally:
                if os.path.exists(tmp):
                    os.unlink(tmp)
        build_info[source] = (time.monotonic() - t0 if report else 0.0,
                              report)
        lib = ctypes.CDLL(str(out))
        _loaded[source] = lib
        return lib


def load_libraries(*sources: str) -> list[ctypes.CDLL]:
    """:func:`load_library` for every source, one ``nvcc`` each, all
    started together."""
    with ThreadPoolExecutor(max_workers=max(len(sources), 1)) as pool:
        futures = [pool.submit(load_library, s) for s in sources]
        return [f.result() for f in futures]
