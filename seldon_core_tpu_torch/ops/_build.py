"""Build and load the port's CUDA kernels.

Each kernel source under ``ops/csrc/`` is compiled by ``nvcc`` into a
shared library with a plain C interface, at first use, for ``sm_90a``
(Hopper with its architecture-specific instructions). The library lands
in ``build/kernels/`` at the repository root, named by a hash of the
source, every header beside it (``csrc/*.cuh``) and the compiler flags,
so an edited source or header rebuilds and an unchanged one loads the
cached library. The libraries link libcuda (``-lcuda``, after
the source) for ``cuTensorMapEncodeTiled``, which builds TMA
descriptors on the host. Concurrent first uses (a server process
beside the script that built it) serialise on a lock file, and the
finished library appears by atomic rename.

The library is loaded with ``ctypes``; the caller declares argument
types. Nothing here runs at import time: the CPU tests import every
module of the package on a machine without ``nvcc``.
"""

from __future__ import annotations

import ctypes
import fcntl
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Dict

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "kernels"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
    "-Xptxas", "-v",
)
LINK_FLAGS = ("-lcuda",)

_loaded: Dict[str, ctypes.CDLL] = {}
_lock = threading.Lock()


def nvcc_path() -> str:
    """The CUDA compiler: ``$CUDA_HOME/bin/nvcc``, else ``nvcc`` on PATH,
    else the toolkit's default install location."""
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    if home and os.path.exists(os.path.join(home, "bin", "nvcc")):
        return os.path.join(home, "bin", "nvcc")
    found = shutil.which("nvcc")
    if found:
        return found
    default = "/usr/local/cuda/bin/nvcc"
    if os.path.exists(default):
        return default
    raise RuntimeError(
        "nvcc not found (set CUDA_HOME or put nvcc on PATH): the port's "
        "CUDA kernels are compiled at first use"
    )


def library_path(source: str) -> Path:
    """Where the library built from ``csrc/<source>`` lives: named by a
    hash of the source, the bytes of every ``csrc/*.cuh`` and the flags."""
    h = hashlib.sha256((CSRC / source).read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):
        h.update(header.name.encode() + b"\0" + header.read_bytes())
    h.update(" ".join(NVCC_FLAGS + LINK_FLAGS).encode())
    digest = h.hexdigest()[:16]
    return BUILD_DIR / f"{Path(source).stem}-{digest}.so"


def build(source: str) -> Path:
    """Compile ``csrc/<source>`` unless the library for its current hash
    exists; returns the library path. Raises with the compiler's output
    when ``nvcc`` fails."""
    out = library_path(source)
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with open(BUILD_DIR / f"{out.stem}.lock", "w") as lockf:
        fcntl.flock(lockf, fcntl.LOCK_EX)
        if out.exists():  # another process finished the build meanwhile
            return out
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc_path(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / source), *LINK_FLAGS]
        proc = subprocess.run(cmd, capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(
                f"nvcc failed for {source} (exit {proc.returncode}):\n"
                f"{proc.stdout}\n{proc.stderr}"
            )
        (BUILD_DIR / f"{out.stem}.ptxas.txt").write_text(proc.stdout + proc.stderr)
        os.replace(tmp, out)
    return out


def load(source: str) -> ctypes.CDLL:
    """Build (if needed) and load the library for ``csrc/<source>``;
    one handle per process."""
    with _lock:
        lib = _loaded.get(source)
        if lib is None:
            lib = ctypes.CDLL(str(build(source)))
            _loaded[source] = lib
        return lib
