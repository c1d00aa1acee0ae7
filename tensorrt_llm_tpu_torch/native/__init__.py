"""Native (C++) host extensions of the port: the paged-KV block bookkeeping
(`kv_bookkeeping.cc`, a copy of the JAX package's source).

The library is compiled with ``g++`` at first use and loaded through
``ctypes`` (the same zero-dependency route as the JAX package: no pybind11,
no PyTorch headers).  It lands in ``build/native/<hash>/`` at the
repository root, the hash taken over the source and the flags, so a changed
source rebuilds and an unchanged one loads the existing file.  The build
holds an `fcntl` lock and writes under a temporary name that is
`os.replace`d into place (as `ops/cuda_build.py` builds the CUDA kernels):
concurrent processes -- pytest-xdist workers, say -- never see a
half-written library and never build it twice.  A missing compiler or a
failed build raises with the compiler's output; there is no fallback here.
"""

from __future__ import annotations

import ctypes
import fcntl
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
from pathlib import Path
from typing import Optional

_HERE = Path(__file__).resolve().parent
SOURCE = _HERE / "kv_bookkeeping.cc"
BUILD_DIR = _HERE.parent.parent / "build" / "native"
CXX_FLAGS = ["-O2", "-std=c++17", "-shared", "-fPIC"]

_LOCK = threading.Lock()
_LIB: Optional[ctypes.CDLL] = None


def library_path() -> Path:
    """Where the library of the current source and flags is built."""
    h = hashlib.sha256(SOURCE.read_bytes())
    h.update(" ".join(CXX_FLAGS).encode())
    return BUILD_DIR / h.hexdigest()[:16] / "libtllm_kvbm.so"


def _build(out: Path) -> None:
    cxx = os.environ.get("CXX") or shutil.which("g++")
    if not cxx:
        raise RuntimeError("g++ not found: the native KV bookkeeping cannot "
                           "be built (set CXX, or ask for the Python "
                           "backend with kv_bookkeeping='python')")
    tmp = Path(tempfile.mkdtemp(prefix="kvbm_", dir=out.parent))
    try:
        part = tmp / out.name
        cmd = [cxx, *CXX_FLAGS, str(SOURCE), "-o", str(part)]
        r = subprocess.run(cmd, capture_output=True, text=True, timeout=300)
        if r.returncode != 0:
            raise RuntimeError("native KV bookkeeping build failed:\n$ "
                               + " ".join(cmd) + "\n" + r.stdout + r.stderr)
        os.replace(part, out)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def _declare(lib: ctypes.CDLL) -> ctypes.CDLL:
    c = ctypes
    p, i32, i64, u64 = c.c_void_p, c.c_int32, c.c_int64, c.c_uint64
    pi32, pi64 = c.POINTER(i32), c.POINTER(i64)
    lib.tllm_kvbm_create.restype = p
    lib.tllm_kvbm_create.argtypes = [i32, i32, i32]
    lib.tllm_kvbm_destroy.restype = None
    lib.tllm_kvbm_destroy.argtypes = [p]
    lib.tllm_kvbm_add_sequence.restype = i64
    lib.tllm_kvbm_add_sequence.argtypes = [p, i64, pi32, i64, u64, i32]
    lib.tllm_kvbm_grow.restype = i32
    lib.tllm_kvbm_grow.argtypes = [p, i64, i64]
    lib.tllm_kvbm_seq_num_blocks.restype = i64
    lib.tllm_kvbm_seq_num_blocks.argtypes = [p, i64]
    lib.tllm_kvbm_seal.restype = None
    lib.tllm_kvbm_seal.argtypes = [p, i64, pi32, i64]
    lib.tllm_kvbm_fork.restype = i64
    lib.tllm_kvbm_fork.argtypes = [p, i64, i64, pi32, pi32, i64]
    lib.tllm_kvbm_free_seq.restype = None
    lib.tllm_kvbm_free_seq.argtypes = [p, i64]
    lib.tllm_kvbm_block_table.restype = None
    lib.tllm_kvbm_block_table.argtypes = [p, i64, pi32, i64]
    lib.tllm_kvbm_slot_mapping.restype = i32
    lib.tllm_kvbm_slot_mapping.argtypes = [p, i64, i64, i64, pi32]
    lib.tllm_kvbm_num_free.restype = i64
    lib.tllm_kvbm_num_free.argtypes = [p]
    lib.tllm_kvbm_match.restype = i64
    lib.tllm_kvbm_match.argtypes = [p, pi32, i64, u64, i32]
    lib.tllm_kvbm_match_partial.restype = i64
    lib.tllm_kvbm_match_partial.argtypes = [p, pi32, i64, u64, i32]
    lib.tllm_kvbm_partial_match.restype = None
    lib.tllm_kvbm_partial_match.argtypes = [p, i64, pi32, i64, i32, pi64]
    lib.tllm_kvbm_stats.restype = None
    lib.tllm_kvbm_stats.argtypes = [p, pi64]
    lib.tllm_kvbm_set_priority.restype = None
    lib.tllm_kvbm_set_priority.argtypes = [p, i64, i32]
    lib.tllm_kvbm_drop_cached.restype = None
    lib.tllm_kvbm_drop_cached.argtypes = [p]
    lib.tllm_kvbm_drain_evictions.restype = i64
    lib.tllm_kvbm_drain_evictions.argtypes = [p, pi32, i64]
    return lib


def load_native() -> ctypes.CDLL:
    """The bookkeeping library, built on first use (see module
    docstring)."""
    global _LIB
    with _LOCK:
        if _LIB is None:
            out = library_path()
            out.parent.mkdir(parents=True, exist_ok=True)
            with open(BUILD_DIR / ".lock", "w") as lk:
                fcntl.flock(lk, fcntl.LOCK_EX)
                try:
                    if not out.exists():
                        _build(out)
                finally:
                    fcntl.flock(lk, fcntl.LOCK_UN)
            _LIB = _declare(ctypes.CDLL(str(out)))
    return _LIB
