"""Build and load the port's CUDA kernels (``mudpt_torch/csrc/*.cu``).

Each source is compiled by ``nvcc`` into its own shared library with a plain
C interface, all sources at once in parallel, and loaded with ``ctypes``.
No PyTorch header is included, so a build takes seconds.  Libraries land in
``<checkout>/build/mudpt_torch_kernels/`` (listed in ``.gitignore``), under
a name keyed by a hash of the source and the flags, so an edited source is
rebuilt and an unchanged one is loaded as it is.

Nothing here runs at import: the first wrapper that launches a kernel calls
:func:`load`.  Every C entry point returns ``cudaGetLastError()`` after its
launch; :func:`check` raises on anything but 0.
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
from typing import Dict, Optional

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG.parent / "build" / "mudpt_torch_kernels"

NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
# C signature of every entry point: (argtypes, restype)
SIGNATURES = {
    "layernorm_fwd": {
        "layernorm_fwd": ([_P, _P, _P, _P, _I, _I, _F, _I, _P], _I),
    },
    "gemm_bf16_epilogue": {
        "gemm_bf16_epilogue": ([_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _P], _I),
    },
    "attention_fwd": {
        "attention_fwd": ([_P, _P, _I, _I, _I, _I, _I, _I, _F, _I, _P], _I),
    },
    "layernorm_bwd": {
        "layernorm_bwd": ([_P, _I, _P, _P, _P, _P, _I, _I, _F, _I, _P], _I),
    },
    "attention_bwd": {
        "attention_bwd": ([_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _F, _P], _I),
    },
    "layernorm_q8": {
        "layernorm_q8": ([_P, _P, _P, _P, _P, _P, _I, _I, _F, _I, _P], _I),
        "layernorm_q8_mode": ([_P, _P, _P, _P, _P, _I, _I, _F, _I, _P], _I),
    },
    "gemm_s8_epilogue": {
        "gemm_s8_epilogue": ([_P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _P], _I),
        "gemm_s8_epilogue_f32": ([_P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _P], _I),
    },
    "quant_rows": {
        "quant_rows": ([_P, _P, _P, _P, _I, _I, _P], _I),
        "quant_rows_mode": ([_P, _P, _P, _P, _I, _I, _I, _P], _I),
    },
    # fp32 activations (the LayerNorms and the int8 tiers take them through
    # the sources above)
    "gemm_f32_epilogue": {
        "gemm_f32_epilogue": ([_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _P], _I),
    },
    "attention_f32": {
        "attention_fwd_f32": ([_P, _P, _I, _I, _I, _I, _I, _I, _F, _P], _I),
        "attention_bwd_f32": ([_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _F, _P], _I),
    },
    # the tensor-core rate probe (ops/probe.py; the probes' quantizer
    # ablations are the *_mode entry points above)
    "probe_mma": {
        "probe_mma": ([_P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _P], _I),
    },
}

_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}
# ptxas report (registers, shared memory, spills) of each source's last build
build_logs: Dict[str, str] = {}
build_seconds: Optional[float] = None


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    for root in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if root and os.path.exists(os.path.join(root, "bin", "nvcc")):
            return os.path.join(root, "bin", "nvcc")
    raise RuntimeError("nvcc not found (looked on PATH, $CUDA_HOME, /usr/local/cuda)")


def _lib_path(name: str) -> Path:
    h = hashlib.sha256()
    h.update((CSRC / f"{name}.cu").read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:16]}.so"


def _bind(name: str, path: Path) -> ctypes.CDLL:
    lib = ctypes.CDLL(str(path))
    for fn, (argtypes, restype) in SIGNATURES[name].items():
        f = getattr(lib, fn)
        f.argtypes = argtypes
        f.restype = restype
    return lib


def load() -> Dict[str, ctypes.CDLL]:
    """Build whatever is missing or stale, in parallel, and bind every
    library.  Returns ``{source name: CDLL}``; raises with the compiler's
    output if a build fails."""
    global build_seconds
    with _lock:
        if len(_libs) == len(SIGNATURES):
            return _libs
        t0 = time.perf_counter()
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        nvcc = _nvcc()
        procs = {}
        for name in SIGNATURES:
            path = _lib_path(name)
            if path.exists():
                continue
            tmp = path.with_suffix(f".{os.getpid()}.tmp")
            cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
            procs[name] = (subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True
            ), tmp, path)
        failed = []
        for name, (proc, tmp, path) in procs.items():
            out, _ = proc.communicate()
            build_logs[name] = out
            if proc.returncode != 0:
                failed.append(f"--- {name}.cu (nvcc exit {proc.returncode})\n{out}")
                continue
            os.replace(tmp, path)  # atomic: a reader never sees half a library
        if failed:
            raise RuntimeError("kernel build failed:\n" + "\n".join(failed))
        for name in SIGNATURES:
            _libs[name] = _bind(name, _lib_path(name))
        build_seconds = time.perf_counter() - t0
        return _libs


def check(err: int, kernel: str) -> None:
    """Raise if a launch returned a CUDA error code (cudaError_t)."""
    if err != 0:
        raise RuntimeError(f"{kernel}: CUDA error {err} at launch (cudaError_t)")
