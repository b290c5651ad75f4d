"""ctypes bindings to the native host-side data pipeline
(``native/src/wavcodec.cpp``, shared with the JAX package): RIFF wav
parse, fused mu-law quantization and the TBPTT window gather, as
``samplernn_pase_tpu.data.native_loader``.

The shared library is built at first use (``make -C native``, written
under a name of this process's own and renamed into place, so that
processes building at once never load a half-written file).  Without a
toolchain or a loadable library every entry point falls back to numpy.
This is host code, not a device kernel: ``route()`` says which of the
two runs, and ``ROUTES`` counts the calls each route took.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
from pathlib import Path

import numpy as np

_NATIVE_DIR = Path(__file__).resolve().parents[2] / "native"
_LIB_PATH = _NATIVE_DIR / "libsrnn_native.so"
_lib = None
_tried = False

# calls served by each route since the last reset_routes()
ROUTES = {"native": 0, "numpy": 0}


def reset_routes():
    for k in ROUTES:
        ROUTES[k] = 0


def _build() -> bool:
    tmp = f"libsrnn_native.{os.getpid()}.tmp.so"
    try:
        subprocess.run(["make", "-C", str(_NATIVE_DIR), f"TARGET={tmp}"],
                       check=True, capture_output=True, timeout=120)
        os.replace(_NATIVE_DIR / tmp, _LIB_PATH)
        return True
    except Exception:
        (_NATIVE_DIR / tmp).unlink(missing_ok=True)
        return False


def _open():
    try:
        lib = ctypes.CDLL(str(_LIB_PATH))
        lib.srnn_gather_windows  # newest symbol: stale-.so probe
        return lib
    except (OSError, AttributeError):
        return None


def _open_fresh():
    """Open the just-rebuilt .so.  dlopen caches by path: if a stale
    mapping of the library is already loaded in this process (the probe
    that asked for the rebuild), opening the same path again returns the
    old handle, so load a copy under a name of its own instead."""
    lib = _open()
    if lib is not None:
        return lib
    import shutil
    import tempfile
    try:
        tmp = (Path(tempfile.mkdtemp(prefix="srnn_native_"))
               / f"libsrnn_native_{os.getpid()}.so")
        shutil.copy2(_LIB_PATH, tmp)
        lib = ctypes.CDLL(str(tmp))
        lib.srnn_gather_windows
        return lib
    except (OSError, AttributeError):
        return None


def _register(lib):
    lib.srnn_mulaw_encode.argtypes = [
        ctypes.POINTER(ctypes.c_float), ctypes.POINTER(ctypes.c_int32),
        ctypes.c_int64, ctypes.c_int32]
    lib.srnn_mulaw_decode.argtypes = [
        ctypes.POINTER(ctypes.c_int32), ctypes.POINTER(ctypes.c_float),
        ctypes.c_int64, ctypes.c_int32]
    lib.srnn_read_wav.argtypes = [
        ctypes.c_char_p, ctypes.POINTER(ctypes.c_float), ctypes.c_int64,
        ctypes.POINTER(ctypes.c_int32)]
    lib.srnn_read_wav.restype = ctypes.c_int64
    lib.srnn_load_quantized.argtypes = [
        ctypes.c_char_p, ctypes.POINTER(ctypes.c_int32), ctypes.c_int64,
        ctypes.c_int32, ctypes.POINTER(ctypes.c_int32)]
    lib.srnn_load_quantized.restype = ctypes.c_int64
    lib.srnn_gather_windows.argtypes = [
        ctypes.POINTER(ctypes.c_int64), ctypes.c_int32, ctypes.c_int64,
        ctypes.POINTER(ctypes.c_int32)]


def _load():
    global _lib, _tried
    if _lib is not None or _tried:
        return _lib
    _tried = True
    lib = _open() if _LIB_PATH.exists() else None
    if lib is None:
        # missing or stale (predates the current symbol set): rebuild
        if not _build():
            return None
        lib = _open_fresh()
    if lib is None:
        return None
    _register(lib)
    _lib = lib
    return _lib


def available(build: bool = True) -> bool:
    """True when the native library is loadable.  ``build=False`` never
    runs ``make``: a hot path that merely prefers the native route (the
    batcher's window gather) must not wait on a build.  A healthy prebuilt
    library is still picked up on that path; a stale one is left for a
    later ``build=True`` call to rebuild."""
    global _lib, _tried
    if not build:
        if _lib is not None or _tried:
            return _lib is not None
        if not _LIB_PATH.exists():
            return False
        lib = _open()
        if lib is None:
            return False     # stale: keep _tried False so that a
                             # build=True call can still rebuild
        _register(lib)
        _lib, _tried = lib, True
        return True
    return _load() is not None


def route(build: bool = True) -> str:
    """"native" when the library serves the calls, else "numpy"."""
    return "native" if available(build) else "numpy"


def _fptr(a):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_float))


def _iptr(a):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_int32))


def _numpy_read(path):
    from samplernn_pase_tpu_torch.ops.audio_io import read_wav as rw
    ROUTES["numpy"] += 1
    return rw(path)


def mulaw_encode(x: np.ndarray, q_levels: int = 256) -> np.ndarray:
    lib = _load()
    x = np.ascontiguousarray(x, np.float32)
    if lib is None:
        from samplernn_pase_tpu_torch.data.dataset import _quantize_host
        ROUTES["numpy"] += 1
        return _quantize_host(x, q_levels)
    ROUTES["native"] += 1
    out = np.empty(x.shape, np.int32)
    lib.srnn_mulaw_encode(_fptr(x.ravel()), _iptr(out.ravel()),
                          x.size, q_levels)
    return out


def mulaw_decode(lv: np.ndarray, q_levels: int = 256) -> np.ndarray:
    lib = _load()
    lv = np.ascontiguousarray(lv, np.int32)
    if lib is None:
        ROUTES["numpy"] += 1
        mu = float(q_levels - 1)
        y = 2.0 * (lv.astype(np.float64) / mu) - 1.0
        return (np.sign(y) * np.expm1(np.abs(y) * np.log1p(mu))
                / mu).astype(np.float32)
    ROUTES["native"] += 1
    out = np.empty(lv.shape, np.float32)
    lib.srnn_mulaw_decode(_iptr(lv.ravel()), _fptr(out.ravel()),
                          lv.size, q_levels)
    return out


def read_wav(path) -> tuple[np.ndarray, int]:
    lib = _load()
    if lib is None:
        return _numpy_read(path)
    sr = ctypes.c_int32(0)
    n = lib.srnn_read_wav(str(path).encode(), None, 0, ctypes.byref(sr))
    if n < 0:  # an encoding the native parser does not take
        return _numpy_read(path)
    ROUTES["native"] += 1
    out = np.empty(int(n), np.float32)
    got = lib.srnn_read_wav(str(path).encode(), _fptr(out), n,
                            ctypes.byref(sr))
    return out[:max(got, 0)], int(sr.value)


def gather_windows(addrs: np.ndarray, w: int,
                   out: np.ndarray | None = None) -> np.ndarray | None:
    """Batched TBPTT window gather (the batcher's hot path).

    addrs: int64 [B] host addresses, each of ``w`` contiguous int32
    levels (views into the padded utterance streams).  Returns int32
    [B, w], or None without the native library (the caller stacks)."""
    lib = _load()
    if lib is None:
        return None
    ROUTES["native"] += 1
    b = addrs.shape[0]
    if out is None:
        out = np.empty((b, w), np.int32)
    lib.srnn_gather_windows(
        addrs.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)), b, w,
        _iptr(out))
    return out


def load_quantized(path, q_levels: int = 256) -> tuple[np.ndarray, int]:
    """wav file -> (mu-law levels int32, sample_rate), one native pass."""
    from samplernn_pase_tpu_torch.data.dataset import _quantize_host
    lib = _load()
    if lib is None:
        x, sr = _numpy_read(path)
        return _quantize_host(x, q_levels), sr
    sr = ctypes.c_int32(0)
    n = lib.srnn_read_wav(str(path).encode(), None, 0, ctypes.byref(sr))
    if n < 0:
        x, sr2 = _numpy_read(path)
        return _quantize_host(x, q_levels), sr2
    ROUTES["native"] += 1
    out = np.empty(int(n), np.int32)
    got = lib.srnn_load_quantized(str(path).encode(), _iptr(out), n,
                                  q_levels, ctypes.byref(sr))
    return out[:max(got, 0)], int(sr.value)
