"""Build and bind the CUDA kernels: nvcc into a shared library, loaded with ctypes.

The library is compiled at first use, never at import, from the sources in
csrc/ into `condmdi_tpu_torch/build/` (git-ignored), named by a hash of the
source and flags so an edited source is rebuilt. It has a plain C interface:
pointers and the stream are `void*`, and every entry point returns the
launch's `cudaGetLastError()`.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

PKG_DIR = Path(__file__).resolve().parent.parent
CSRC_DIR = PKG_DIR / "csrc"
BUILD_DIR = PKG_DIR / "build"
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
]

_lock = threading.Lock()
_libs: dict[str, ctypes.CDLL] = {}
build_log: dict[str, str] = {}  # source name -> nvcc's output (register/smem report)
build_seconds: dict[str, float] = {}


def find_nvcc() -> str:
    for cand in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if cand and (Path(cand) / "bin" / "nvcc").is_file():
            return str(Path(cand) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")
    return found


def build(source: str) -> Path:
    """Compile csrc/<source> to a shared library (cached by content hash)."""
    src = CSRC_DIR / source
    digest = hashlib.sha256(src.read_bytes() + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    out = BUILD_DIR / f"{src.stem}_{digest}.so"
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    t0 = time.perf_counter()
    proc = subprocess.run(
        [find_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(src)],
        capture_output=True, text=True,
    )
    build_seconds[source] = time.perf_counter() - t0
    build_log[source] = proc.stdout + proc.stderr
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed on {src}:\n{proc.stdout}{proc.stderr}")
    os.replace(tmp, out)
    return out


def build_all(sources: list[str]) -> list[Path]:
    """Compile several sources at once: one nvcc process each, all started together."""
    with ThreadPoolExecutor(max_workers=len(sources)) as pool:
        return list(pool.map(build, sources))


def _load(source: str, bind) -> ctypes.CDLL:
    lib = _libs.get(source)
    if lib is not None:  # the usual case, without the lock
        return lib
    with _lock:
        if source not in _libs:
            lib = ctypes.CDLL(str(build(source)))
            bind(lib)
            _libs[source] = lib
        return _libs[source]


def _bind_resblock(lib: ctypes.CDLL) -> None:
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.condmdi_resblock_forward.argtypes = [
        p, p, p, p, p,           # x, w (packed for bf16), b, gamma, beta
        p, p, ctypes.c_longlong,  # scale, shift, their row stride
        p, p,                    # res, out
        i, i, i, i, i, i, i,     # B, T, x's row pitch, Cin (padded for bf16), Cout, k, n_groups
        ctypes.c_float, i, p,    # eps, dtype code, stream
    ]
    lib.condmdi_resblock_forward.restype = i
    lib.condmdi_error_string.argtypes = [i]
    lib.condmdi_error_string.restype = ctypes.c_char_p


def load_resblock() -> ctypes.CDLL:
    """The fused resblock kernel's library, built on first call."""
    return _load("resblock.cu", _bind_resblock)


def _bind_attention(lib: ctypes.CDLL) -> None:
    p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.condmdi_attention_forward.argtypes = [
        p, p, p, p,   # q, k, v, out
        i, i, i, i,   # B, T, heads, head_dim
        ll, ll,       # batch and row strides of q/k/v, in elements
        i, i,         # dtype code, the route the caller expects
        p,            # stream
    ]
    lib.condmdi_attention_forward.restype = i
    lib.condmdi_attention_route.argtypes = [i, i, i]  # T, head_dim, dtype code
    lib.condmdi_attention_route.restype = i
    lib.condmdi_error_string.argtypes = [i]
    lib.condmdi_error_string.restype = ctypes.c_char_p


def load_attention() -> ctypes.CDLL:
    """The fused self-attention kernel's library, built on first call."""
    return _load("attention.cu", _bind_attention)


def _bind_quant(lib: ctypes.CDLL) -> None:
    p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.condmdi_int8_conv1d.argtypes = [
        p, i, ll, ll,   # x, dtype code, x's batch and row strides in elements
        p, i,           # a_scale ([1] or [Cin] float32), per-channel flag
        p, p, p,        # packed int8 weight, w_scale, bias (or null)
        p, p,           # the codes' scratch [B, T, Cin padded to 64] int8, out
        i, i, i, i, i,  # B, T, Cin, Cin padded to 64, Cout
        i, i, i, i,     # k, stride, padding, T out
        p,              # stream
    ]
    lib.condmdi_int8_conv1d.restype = i
    lib.condmdi_error_string.argtypes = [i]
    lib.condmdi_error_string.restype = ctypes.c_char_p


def load_quant() -> ctypes.CDLL:
    """The int8 conv1d/matmul kernel's library, built on first call."""
    return _load("quant.cu", _bind_quant)


def error_string(lib: ctypes.CDLL, err: int) -> str:
    return f"{err} ({lib.condmdi_error_string(err).decode()})"
