"""ctypes bindings for the native C++ engine (native/engine.cpp).

Counterpart of ``seldon_core_tpu/native_engine.py``. The native engine
is a data plane of its own: an epoll HTTP/1.1 orchestrator serving
inference graphs with in-process builtin units and keep-alive forwarding
to remote units (e.g. the port's microservice serving a model on the
card). The Python EngineApp (graph/service.py) remains the full-featured
implementation (gRPC front, micro-batching, request logging); this
wrapper lets a process run the C++ data plane in-process.

The library is compiled from the repository's ``native/`` sources with
the port's own copy of the wire contract (``protos/prediction.proto``)
into ``build/native/`` at the repository root, never into ``native/``:
``make`` runs with ``OUT``, ``GEN`` and ``PROTO_DIR`` pointing there and
builds only the shared library the bindings load. A file lock
serialises processes that build at once. Building needs ``make``,
``g++``, ``protoc`` and the protobuf headers and library.
"""

from __future__ import annotations

import ctypes
import fcntl
import json
import os
import subprocess
from typing import Optional

_PKG_DIR = os.path.dirname(os.path.abspath(__file__))
_REPO = os.path.dirname(_PKG_DIR)
_NATIVE_DIR = os.path.join(_REPO, "native")
PROTO_DIR = os.path.join(_PKG_DIR, "protos")
BUILD_DIR = os.path.join(_REPO, "build", "native")
GEN_DIR = os.path.join(BUILD_DIR, "gen")
LIB_PATH = os.path.join(BUILD_DIR, "libseldon_engine.so")

_SOURCES = (
    os.path.join(_NATIVE_DIR, "engine.cpp"),
    os.path.join(_NATIVE_DIR, "grpc_front.inc"),
    os.path.join(_NATIVE_DIR, "hpack_tables.inc"),
    os.path.join(_NATIVE_DIR, "Makefile"),
    os.path.join(PROTO_DIR, "prediction.proto"),
)


_PROTOBUF_HEADER = os.path.join("google", "protobuf", "message.h")


def missing_toolchain() -> list:
    """What the build needs and this machine lacks (empty: it can build):
    the tools on PATH and the protobuf headers in the compiler's default
    include directories. Decides before a build, never by a failed one."""
    import shutil

    missing = [tool for tool in ("make", "g++", "protoc") if shutil.which(tool) is None]
    include_dirs = ("/usr/include", "/usr/local/include")
    if not any(os.path.exists(os.path.join(d, _PROTOBUF_HEADER)) for d in include_dirs):
        missing.append("protobuf headers")
    return missing


def _stale() -> bool:
    if not os.path.exists(LIB_PATH):
        return True
    newest = max(os.path.getmtime(f) for f in _SOURCES if os.path.exists(f))
    return newest > os.path.getmtime(LIB_PATH)


def make_argv(force: bool = False) -> list:
    """The ``make`` command that builds the library: every output under
    ``BUILD_DIR``, the contract from ``PROTO_DIR``, only the library."""
    return (["make", "-C", _NATIVE_DIR, f"-j{os.cpu_count() or 1}",
             f"OUT={BUILD_DIR}", f"GEN={GEN_DIR}", f"PROTO_DIR={PROTO_DIR}", LIB_PATH]
            + (["-B"] if force else []))


def build(force: bool = False) -> str:
    """Build the native engine's shared library; returns its path.

    Rebuilds when any source is newer than the library — a stale
    pre-change .so would be missing newer ABI symbols (sce_start_grpc)
    and break ctypes binding."""
    if not force and not _stale():
        return LIB_PATH
    os.makedirs(BUILD_DIR, exist_ok=True)
    with open(os.path.join(BUILD_DIR, ".lock"), "w") as lockf:
        fcntl.flock(lockf, fcntl.LOCK_EX)
        if force or _stale():  # another process may have finished meanwhile
            proc = subprocess.run(make_argv(force), capture_output=True, text=True)
            if proc.returncode != 0:
                raise RuntimeError(
                    f"native engine build failed (make exit {proc.returncode}):\n"
                    + (proc.stdout + proc.stderr)[-4000:]
                )
    return LIB_PATH


_lib = None


def _isolated_handle(path: str):
    """``dlmopen(LM_ID_NEWLM, path)``: the library and its dependencies
    (libprotobuf, libstdc++) in a link-map namespace of their own, so
    their protobuf descriptor pool is private. Another engine built from
    the same ``prediction.proto`` in this process (the JAX package's)
    registers the same file in the shared libprotobuf's pool, and the
    second registration aborts the process. None where the C library
    has no ``dlmopen``."""
    libc = ctypes.CDLL(None)
    dlmopen = getattr(libc, "dlmopen", None)
    if dlmopen is None:
        return None
    dlmopen.restype = ctypes.c_void_p
    dlmopen.argtypes = [ctypes.c_long, ctypes.c_char_p, ctypes.c_int]
    handle = dlmopen(-1, path.encode(), os.RTLD_NOW | os.RTLD_LOCAL)  # -1: LM_ID_NEWLM
    if not handle:
        libc.dlerror.restype = ctypes.c_char_p
        raise OSError(f"dlmopen {path}: {(libc.dlerror() or b'').decode()}")
    return handle


def _load():
    global _lib
    if _lib is None:
        path = build()
        handle = _isolated_handle(path)
        if handle is not None:
            lib = ctypes.CDLL(path, handle=handle)
        else:
            # RTLD_DEEPBIND: the engine must bind ITS libprotobuf symbols
            # even though torch (which bundles incompatible protobuf
            # symbols) is loaded in this process
            mode = ctypes.RTLD_LOCAL | getattr(os, "RTLD_DEEPBIND", 0)
            lib = ctypes.CDLL(path, mode=mode)
        lib.sce_start.restype = ctypes.c_void_p
        lib.sce_start.argtypes = [ctypes.c_char_p, ctypes.c_int, ctypes.c_int]
        lib.sce_start_grpc.restype = ctypes.c_void_p
        lib.sce_start_grpc.argtypes = [
            ctypes.c_char_p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ]
        lib.sce_stop.argtypes = [ctypes.c_void_p]
        lib.sce_version.restype = ctypes.c_char_p
        _lib = lib
    return _lib


def version() -> str:
    return _load().sce_version().decode()


class NativeEngine:
    """In-process native engine bound to a predictor spec.

    >>> eng = NativeEngine(spec_dict, port=8000)
    >>> eng.start()
    ... # serve; e.g. curl :8000/api/v0.1/predictions
    >>> eng.stop()
    """

    def __init__(self, spec, port: int = 8000, threads: int = 1,
                 grpc_port: int = 0):
        self.spec = spec.to_dict() if hasattr(spec, "to_dict") else spec
        self.port = port
        self.threads = threads
        # 0 = REST only; >0 additionally serves the hand-rolled h2c gRPC
        # front (grpc_front.inc) on that port
        self.grpc_port = grpc_port
        self._handle: Optional[int] = None

    def start(self) -> "NativeEngine":
        lib = _load()
        blob = json.dumps(self.spec).encode()
        if self.grpc_port:
            self._handle = lib.sce_start_grpc(
                blob, self.port, self.grpc_port, self.threads
            )
        else:
            self._handle = lib.sce_start(blob, self.port, self.threads)
        if not self._handle:
            raise RuntimeError(f"native engine failed to start on :{self.port} (bad spec or bind failure)")
        return self

    def stop(self) -> None:
        if self._handle:
            _load().sce_stop(self._handle)
            self._handle = None

    def __enter__(self):
        return self.start()

    def __exit__(self, *exc):
        self.stop()
