"""Build the CUDA sources under ``csrc/`` and load them with ctypes.

Each ``csrc/<name>.cu`` is compiled on its own by ``nvcc`` for ``sm_90a``
into a shared library with a plain C interface (no PyTorch headers, so a
build takes seconds), under ``build/torch_kernels/`` at the repo root.
The library's name carries a hash of its sources, so an edited kernel is
rebuilt and a stale one never loaded.  ``build_all`` starts one ``nvcc``
per source, all together, and waits for them.

Nothing is built at import: the first launch of a kernel builds what it
needs.  A failed build raises with the compiler's output; there is no
fallback.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "torch_kernels"
SOURCES = ("codec", "frame_decode", "gemm_bias", "gru_gates",
           "gru_sequence", "lstm_gates", "lstm_sequence", "roofline")
ARCH_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a")

_LIBS: dict[str, ctypes.CDLL] = {}
_LOCK = threading.Lock()


def nvcc_path() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    candidate = Path(cuda_home) / "bin" / "nvcc"
    if candidate.exists():
        return str(candidate)
    raise RuntimeError("nvcc not found: the CUDA kernels of "
                       "samplernn_pase_tpu_torch need the CUDA toolkit")


def _lib_path(name: str) -> Path:
    digest = hashlib.sha256()
    for path in sorted(CSRC.glob("*.cuh")) + [CSRC / f"{name}.cu"]:
        digest.update(path.read_bytes())
    digest.update(" ".join(ARCH_FLAGS).encode())
    return BUILD_DIR / f"lib{name}-{digest.hexdigest()[:12]}.so"


def _command(name: str, out: Path) -> list[str]:
    return [nvcc_path(), *ARCH_FLAGS, "-std=c++17", "-O3", "-shared",
            "-Xcompiler", "-fPIC", "-Xptxas", "-v", "-o", str(out),
            str(CSRC / f"{name}.cu")]


def build_all(names=SOURCES) -> dict[str, str]:
    """Compile every missing library in parallel.  Returns each source's
    compiler output (with ``-Xptxas -v``: registers, shared memory and
    spills per kernel); raises if any build fails."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    logs = {}
    for name in names:
        out = _lib_path(name)
        if out.exists():
            logs[name] = "(cached)"
            continue
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        procs[name] = (subprocess.Popen(
            _command(name, tmp), stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True), tmp, out)
    failed = []
    for name, (proc, tmp, out) in procs.items():
        text, _ = proc.communicate()
        logs[name] = text
        if proc.returncode != 0:
            failed.append(f"nvcc {name}.cu failed ({proc.returncode}):\n{text}")
        else:
            os.replace(tmp, out)
    if failed:
        raise RuntimeError("\n".join(failed))
    return logs


def load(name: str) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu``, built first if needed."""
    with _LOCK:
        lib = _LIBS.get(name)
        if lib is None:
            path = _lib_path(name)
            if not path.exists():
                build_all((name,))
            lib = ctypes.CDLL(str(path))
            _LIBS[name] = lib
        return lib


def function(name: str, symbol: str, argtypes) -> ctypes._CFuncPtr:
    """``symbol`` of ``csrc/<name>.cu``'s library with its argument types
    set; it returns the CUDA error code of its launch (0: launched)."""
    fn = getattr(load(name), symbol)
    fn.argtypes = argtypes
    fn.restype = ctypes.c_int
    return fn
