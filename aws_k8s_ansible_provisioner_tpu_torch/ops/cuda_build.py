"""Build and load the port's CUDA kernels (nvcc + ctypes).

Each ``csrc/*.cu`` source compiles on first use into its own shared library
with a plain C interface, under ``_build/`` in the package (listed in
``.gitignore``). The library's file name carries a hash of the source, of
the shared headers ``csrc/*.cuh`` and of the flags, so an edited source or
header rebuilds. :func:`build_kernels` starts one nvcc per
source, all at once, and waits for them together; :func:`load` builds what is
missing and opens the library with ``ctypes``.

Nothing here runs at import time, and nothing falls back: without nvcc a
build raises, and the caller's CUDA tensor never reaches a plain version.
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
from typing import Dict, Iterable, Optional

_PKG = Path(__file__).resolve().parents[1]
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"

# kernel library name -> source file under csrc/
SOURCES = {
    "paged_attention": "paged_attention.cu",
    "cache_write": "cache_write.cu",
    "dense_attention": "dense_attention.cu",
    "split_merge": "split_merge.cu",
    "moe_route": "moe_route.cu",
    "moe_grouped": "moe_grouped.cu",
}

NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}
# library name -> nvcc's stderr of the build done in this process (ptxas
# register/shared-memory/spill report)
build_logs: Dict[str, str] = {}


def nvcc_path() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = "/usr/local/cuda/bin/nvcc"
    if os.path.exists(default):
        return default
    raise RuntimeError("nvcc not found (PATH or /usr/local/cuda/bin): the "
                       "CUDA kernels cannot be built")


def library_path(name: str) -> Path:
    src = (CSRC / SOURCES[name]).read_bytes()
    src += b"".join(p.read_bytes() for p in sorted(CSRC.glob("*.cuh")))
    digest = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()
    return BUILD_DIR / f"lib{name}_{digest[:16]}.so"


def build_kernels(names: Optional[Iterable[str]] = None) -> Dict[str, float]:
    """Compile every named kernel library that is missing, one nvcc process
    per source, all started together. Returns {name: seconds} for the ones
    built (0.0 when already present); raises with nvcc's output on failure."""
    names = list(SOURCES if names is None else names)
    with _lock:
        return _build_locked(names)


def _build_locked(names) -> Dict[str, float]:
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = nvcc_path()
    procs = {}
    t0 = time.monotonic()
    for name in names:
        out = library_path(name)
        if out.exists():
            continue
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / SOURCES[name])]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       tmp, out)
    seconds = {name: 0.0 for name in names}
    failed = []
    for name, (proc, tmp, out) in procs.items():
        log, _ = proc.communicate()
        seconds[name] = time.monotonic() - t0
        build_logs[name] = log
        if proc.returncode != 0:
            failed.append(f"{name} (nvcc exit {proc.returncode}):\n{log}")
            continue
        os.replace(tmp, out)
    if failed:
        raise RuntimeError("CUDA kernel build failed: " + "\n".join(failed))
    return seconds


def load(name: str) -> ctypes.CDLL:
    """The kernel library ``name``, built on first use."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            path = library_path(name)
            if not path.exists():
                _build_locked([name])
            lib = _libs[name] = ctypes.CDLL(str(path))
        return lib
