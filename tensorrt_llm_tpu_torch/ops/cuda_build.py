"""Build and bind the port's CUDA kernels (`tensorrt_llm_tpu_torch/csrc`).

The kernels are compiled with `nvcc` for `sm_90a` into one shared library
with a plain C interface and loaded with ctypes, at first use.  The library
lands in ``build/torch_kernels/<hash>/`` at the repository root, the hash
taken over the sources and flags (`kernel_dir`), so a changed source
rebuilds and an unchanged one loads the existing file; the engine keeps its
tuned tactics in the same directory (`ModelEngine.tactic_file`).  The build holds
an `fcntl` lock and writes under a temporary name that is `os.replace`d
into place: concurrent processes never see a half-written library.  A missing `nvcc` or a failed build raises; there
is no CPU fallback at this level.  Each source's compiler output is kept
beside the library (`<source>.log`), so that a run that loads an existing
build still reads what ptxas said (`build_logs`, `serialized_wgmma`).

Every wrapper that launches one of these kernels adds one to its entry in
`launch_counts` (`count_launch`, under a lock, also into the launching
thread's own counter in `launch_counts_by_thread`: two engines of one
process, each on its executor thread, are counted apart); the chip check
reads the counts to prove the main path ran through the kernels.
"""

from __future__ import annotations

import collections
import ctypes
import fcntl
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
import time
from pathlib import Path
from typing import Optional

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG.parent / "build" / "torch_kernels"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xcompiler", "-fPIC", "-lineinfo"]

# kernel name -> launches through its wrapper since the last reset
launch_counts: "collections.Counter[str]" = collections.Counter()
# thread ident -> kernel name -> launches from that thread
launch_counts_by_thread: "collections.defaultdict" = \
    collections.defaultdict(collections.Counter)
_count_lock = threading.Lock()

_lib: Optional[ctypes.CDLL] = None
last_build_seconds: Optional[float] = None
last_build_log: str = ""

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
_SIGNATURES = {
    # x, qweight, scales, zeros, bias, workspace, out, M, N, K, group,
    # block_n, act, ntok, n_mb, n_ct, slice starts (host int array),
    # n_slices, grid, variant, stream
    "tllm_w4a16_gemm": [_P, _P, _P, _P, _P, _P, _P] + [_I] * 9
    + [ctypes.POINTER(_I), _I, _I, _I, _P],
    # x, qweight, scales, zeros, bias, out, M, N, K, group, block_n, act,
    # ctw (16-column tiles a warp), slices (a cluster), stream
    "tllm_w4a16_gemv": [_P] * 6 + [_I] * 8 + [_P],
    # q, k, v, block_table, sinks, out, T, Hq, Hkv, D, NB, BS, MB, kv_len,
    # q_offset, scale, window, logit_cap, stream
    "tllm_flash_prefill": [_P] * 6 + [_I] * 9 + [_F, _I, _F, _P],
    # q, k, v, tables, kv_lens, sinks, workspace, counters, out, B, Hq, Hkv,
    # D, NB, BS, MB, scale, window, logit_cap, n_splits, split_len, grid_x,
    # stream
    "tllm_paged_decode": [_P] * 9 + [_I] * 7 + [_F, _I, _F, _I, _I, _I, _P],
    # q, k_data, k_scale, v_data, v_scale, block_table, sinks, out, T, Hq,
    # Hkv, D, BS, MB, kv_len, q_offset, scale, window, logit_cap, stream
    "tllm_flash_prefill_int8": [_P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I,
                                _I, _I, _I, _I, _I, _F, _I, _F, _P],
    # q, k_data, k_scale, v_data, v_scale, tables, kv_lens, sinks,
    # workspace, counters, out, B, Hq, Hkv, D, NB, BS, MB, scale, window,
    # logit_cap, n_splits, split_len, grid_x, stream
    "tllm_paged_decode_int8": [_P] * 11 + [_I] * 7 + [_F, _I, _F, _I, _I,
                                                      _I, _P],
    # xq, s_act, qweight, scales, zeros, bias, workspace, out, M, N, K,
    # group, block_n, pack_group, act, ntok, n_mb, n_ct, slice starts (host
    # int array), n_slices, grid, stream
    "tllm_w4a8_gemm": [_P] * 8 + [_I] * 10 + [ctypes.POINTER(_I), _I, _I,
                                              _P],
    # group_sizes, units, M, E, ntok, bound, stream
    "tllm_moe_gmm_units": [_P, _P, _I, _I, _I, _I, _P],
    # x, qweight, scales, zeros, units, out, M, N, K, group, E, block_n,
    # ntok, n_ct, grid, stream
    "tllm_moe_gmm": [_P] * 6 + [_I] * 9 + [_P],
    # q, pool, tables, kv_lens, out, B, H, L, DK, NB, BS, MB, scale,
    # n_splits, split_len, stream
    "tllm_mla_decode": [_P] * 5 + [_I] * 7 + [_F, _I, _I, _P],
    # q, pool, table, workspace, out, T, H, L, DK, NB, BS, MB, kv_len,
    # q_offset, scale, n_splits, split_len, stream
    "tllm_mla_prefill": [_P, _P, _P, _P, _P] + [_I] * 9 + [_F, _I, _I, _P],
    # q, w, pool, tables, kv_lens, out, B, Hi, Di, NB, BS, MB,
    # tiles_per_block, stream
    "tllm_dsa_score": [_P] * 6 + [_I] * 7 + [_P],
    # x, qweight, scales, zeros, bias, workspace, out, M, N, K, group,
    # pack_group, act, ntok, n_mb, n_ct, slice starts (host int array),
    # n_slices, grid, stream
    "tllm_w4a16_kpaired": [_P, _P, _P, _P, _P, _P, _P] + [_I] * 9
    + [ctypes.POINTER(_I), _I, _I, _P],
    # x, qweight, scales, zeros, bias, workspace, out, M, N, K, group,
    # block_n, act, ntok, n_mb, n_ct, slice starts (host int array),
    # n_slices, grid, stream
    "tllm_w4a16_ramp": [_P, _P, _P, _P, _P, _P, _P] + [_I] * 9
    + [ctypes.POINTER(_I), _I, _I, _P],
    # x, gu_qweight, gu_scales, gu_zeros, gu_bias, down_qweight,
    # down_scales, down_zeros, down_bias, h workspace, barrier buffer,
    # barrier stats, out, M, K, I, gu_group, down_group, gu_row_stride,
    # down_row_stride, gu_block_n, down_block_n, act, ctw, ntt, cluster,
    # sa, sb, grid, stream
    "tllm_w4a16_fused_mlp": [_P] * 13 + [_I] * 16 + [_P],
    # ctw, ntt, cluster, smem, clusters (int out)
    "tllm_w4a16_fused_mlp_clusters": [_I] * 4 + [ctypes.POINTER(_I)],
    # ctw, ntt, K, I, gu_group, down_group, sa, sb, zeros
    "tllm_w4a16_fused_mlp_smem": [_I] * 9,
}


def count_launch(name: str) -> None:
    """One launch of kernel `name`, by the calling thread."""
    with _count_lock:
        launch_counts[name] += 1
        launch_counts_by_thread[threading.get_ident()][name] += 1


def reset_launch_counts() -> None:
    with _count_lock:
        launch_counts.clear()
        launch_counts_by_thread.clear()


def find_nvcc() -> str:
    cands = [os.environ.get("NVCC"), shutil.which("nvcc")]
    for home in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if home:
            cands.append(os.path.join(home, "bin", "nvcc"))
    for c in cands:
        if c and os.path.isfile(c) and os.access(c, os.X_OK):
            return c
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built "
                       "(set NVCC or CUDA_HOME)")


def _sources():
    srcs = sorted(CSRC.glob("*.cu"))
    if not srcs:
        raise RuntimeError(f"no CUDA sources under {CSRC}")
    return srcs


def _digest(flags) -> str:
    h = hashlib.sha256()
    for p in sorted(CSRC.glob("*.cu")) + sorted(CSRC.glob("*.cuh")):
        h.update(p.name.encode())
        h.update(p.read_bytes())
    h.update(" ".join(flags).encode())
    return h.hexdigest()[:16]


def _flags():
    flags = list(NVCC_FLAGS)
    if os.environ.get("TLLM_NVCC_VERBOSE") == "1":
        flags += ["-Xptxas", "-v"]
    return flags


def kernel_dir() -> Path:
    """The build directory of the current sources and flags."""
    return BUILD_DIR / _digest(_flags())


def _compile(out: Path, flags) -> str:
    """Compile every source in parallel (one nvcc each), then link; each
    source's output lands beside `out` as ``<stem>.log``."""
    nvcc = find_nvcc()
    tmp = Path(tempfile.mkdtemp(prefix="obj_", dir=BUILD_DIR))
    try:
        procs = []
        for src in _sources():
            obj = tmp / (src.stem + ".o")
            cmd = [nvcc, *flags, "-c", str(src), "-o", str(obj)]
            procs.append((cmd, obj, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True)))
        log, objs, failed = [], [], []
        for cmd, obj, p in procs:
            text, _ = p.communicate()
            log.append(f"$ {' '.join(cmd)}\n{text}")
            (out.parent / (obj.stem + ".log")).write_text(text)
            if p.returncode != 0:
                failed.append(cmd[-3])
            objs.append(str(obj))
        if failed:
            raise RuntimeError("nvcc failed for " + ", ".join(failed) + "\n"
                               + "\n".join(log))
        part = tmp / out.name
        cmd = [nvcc, *flags, "-shared", *objs, "-o", str(part)]
        r = subprocess.run(cmd, capture_output=True, text=True)
        log.append(f"$ {' '.join(cmd)}\n{r.stdout}{r.stderr}")
        if r.returncode != 0:
            raise RuntimeError("nvcc link failed\n" + "\n".join(log))
        os.replace(part, out)
        return "\n".join(log)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def load_library() -> ctypes.CDLL:
    """The kernel library, built on first use (see module docstring)."""
    global _lib, last_build_seconds, last_build_log
    if _lib is not None:
        return _lib
    flags = _flags()
    out = kernel_dir() / "libtllm_torch.so"
    out.parent.mkdir(parents=True, exist_ok=True)
    t0 = time.perf_counter()
    with open(BUILD_DIR / ".lock", "w") as lk:
        fcntl.flock(lk, fcntl.LOCK_EX)
        try:
            if not out.exists():
                last_build_log = _compile(out, flags)
        finally:
            fcntl.flock(lk, fcntl.LOCK_UN)
    last_build_seconds = time.perf_counter() - t0
    lib = ctypes.CDLL(str(out))
    for name, argtypes in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    _lib = lib
    return lib


def build_logs() -> dict:
    """Each source's compiler output from the build of the current
    sources and flags, by source file name (empty before a build)."""
    return {p.stem + ".cu": p.read_text()
            for p in sorted(kernel_dir().glob("*.log"))}


def serialized_wgmma(logs: Optional[dict] = None) -> list:
    """(source, line) of every ptxas warning that it serialized wgmma
    instructions (C7513/C7514/C7518...: a register operand or accumulator
    touched while a wgmma is in flight, which costs a kernel 20-35%)."""
    logs = build_logs() if logs is None else logs
    return [(src, line.strip()) for src, text in sorted(logs.items())
            for line in text.splitlines()
            if "wgmma" in line and "serializ" in line]


def check(err: int, name: str) -> None:
    """Raise if a C entry point reported a CUDA error."""
    if err != 0:
        raise RuntimeError(f"{name}: CUDA error {err} at launch")


def ptr(t) -> Optional[int]:
    """Device pointer of a tensor (None for an absent optional operand)."""
    return None if t is None else t.data_ptr()


def counters(device, n: int):
    """At least `n` zeroed int32 counters on `device`, kept for the process:
    the paged-decode kernel (K4/K6), which merges its split-KV partials
    inside the launch, counts finished blocks in them, and the last block
    of each (sequence, KV head) resets its counter, so they are zero again
    after every launch.  Launches on one stream run one after another and
    may share them."""
    import torch
    dev = torch.device(device)
    buf = _COUNTERS.get(dev)
    if buf is None or buf.numel() < n:
        buf = torch.zeros((max(n, 4096),), dtype=torch.int32, device=dev)
        _COUNTERS[dev] = buf
    return buf


_COUNTERS = {}


def grid_barrier(device):
    """The grid barrier's words of the fused MLP kernel (K14) on `device`:
    128 int32, a generation at 0 and the arrival counters of even and odd
    generations at 32 and 64 (each on its own 128-byte line), zeroed once
    and kept for the process.  The kernel zeroes the next launch's counter
    and advances the generation itself, so no call writes them from the
    host; the buffer is never reallocated, so a CUDA graph that captures a
    launch keeps a live pointer.  Launches on one device must not run
    concurrently (they share the counters)."""
    import torch
    dev = torch.device(device)
    if dev.index is None:
        dev = torch.device(dev.type, torch.cuda.current_device())
    buf = _BARRIERS.get(dev)
    if buf is None:
        buf = torch.zeros((128,), dtype=torch.int32, device=dev)
        _BARRIERS[dev] = buf
    return buf


_BARRIERS = {}


def num_sms(device) -> int:
    """Streaming multiprocessors of a CUDA device (cached per device)."""
    import torch
    idx = torch.device(device).index
    idx = torch.cuda.current_device() if idx is None else idx
    if idx not in _SMS_BY_DEVICE:
        _SMS_BY_DEVICE[idx] = torch.cuda.get_device_properties(
            idx).multi_processor_count
    return _SMS_BY_DEVICE[idx]


_SMS_BY_DEVICE = {}


def stream_of(t) -> int:
    import torch
    return torch.cuda.current_stream(t.device).cuda_stream
