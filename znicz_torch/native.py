"""The host runtime (port of ``znicz_tpu/native.py``): ctypes bindings
for ``csrc/host/znicz_native.cpp``, the port's own copy of the C++ host
data path.

  - :class:`XorShift128P`, the xorshift128+ stream (splitmix64 seed
    expansion): ``fill_uniform``, ``fill_normal`` and the Fisher-Yates
    ``shuffle`` of an int32 row, which backs the loader's
    ``native_shuffle``;
  - :func:`gather_f32`, a row gather, and :func:`u8_to_f32`, the image
    loader's decode: numpy only, since numpy gives the bits of the
    library's loops.

The shared library is built with ``g++`` (:data:`CXX`) at first use into
``build/host/`` beside the package (listed in ``.gitignore``), named by a
hash of its source and flags, so a changed source is rebuilt; never at
import.  The first attempt's outcome, the library or the failure, is kept
for the rest of the process.  The same source and flags as the
reference's give its draws bit for bit.  One difference from the
reference, which falls back to numpy's generator when the library does
not build (and so silently changes the training order):
:class:`XorShift128P` raises ``RuntimeError`` without the library.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Dict, Optional, Tuple, Union

import numpy as np

SOURCE = Path(__file__).resolve().parent / "csrc" / "host" / \
    "znicz_native.cpp"
BUILD_DIR = Path(__file__).resolve().parent.parent / "build" / "host"
#: the compiler, and its flags (the reference's)
CXX = "g++"
CXX_FLAGS = ["-O3", "-shared", "-fPIC", "-std=c++17"]
#: the C interface version the bindings expect
ABI = 1

_lock = threading.Lock()
#: the first attempt's outcome for each (source, build dir, compiler,
#: flags): the loaded library, or the error that attempt raised
_outcomes: Dict[Tuple, Union[ctypes.CDLL, Exception]] = {}

_U64P = ctypes.POINTER(ctypes.c_uint64)
_F32P = ctypes.POINTER(ctypes.c_float)
_I32P = ctypes.POINTER(ctypes.c_int32)
_SIZE, _F = ctypes.c_size_t, ctypes.c_float
SIGNATURES = {
    "znicz_seed": [_U64P, ctypes.c_uint64],
    "znicz_fill_uniform": [_U64P, _F32P, _SIZE, _F, _F],
    "znicz_fill_normal": [_U64P, _F32P, _SIZE, _F],
    "znicz_shuffle_i32": [_U64P, _I32P, _SIZE],
}


def library_path() -> Path:
    """Where the library for the current source, compiler and flags
    lives."""
    blob = SOURCE.read_bytes() + " ".join([CXX] + CXX_FLAGS).encode()
    return BUILD_DIR / \
        f"libznicz_native-{hashlib.sha1(blob).hexdigest()[:12]}.so"


def build() -> Path:
    """Compile the library unless it is built already; returns its path.
    Raises ``RuntimeError`` when the compiler is missing or fails."""
    out = library_path()
    if out.exists():
        return out
    cxx = shutil.which(CXX)
    if cxx is None:
        raise RuntimeError(f"{CXX!r} not found: the host runtime "
                           f"({SOURCE.name}) cannot be built here")
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".tmp{os.getpid()}")
    proc = subprocess.run([cxx, *CXX_FLAGS, str(SOURCE), "-o", str(tmp)],
                          capture_output=True, text=True, timeout=300)
    if proc.returncode != 0:
        raise RuntimeError(f"{CXX} failed on {SOURCE.name} (rc "
                           f"{proc.returncode}):\n{proc.stderr}")
    os.replace(tmp, out)
    return out


def _load(path: Path) -> ctypes.CDLL:
    loaded = ctypes.CDLL(str(path))
    for name, argtypes in SIGNATURES.items():
        getattr(loaded, name).argtypes = argtypes
    loaded.znicz_native_abi.restype = ctypes.c_int
    if loaded.znicz_native_abi() != ABI:
        raise RuntimeError(f"{path.name}: ABI {loaded.znicz_native_abi()}, "
                           f"expected {ABI}")
    return loaded


def lib() -> ctypes.CDLL:
    """The loaded library, built on first use; raises ``RuntimeError``
    when it cannot be built or loaded.  Only the first call for a given
    source, build directory, compiler and flags tries: later calls give
    its outcome again."""
    key = (SOURCE, BUILD_DIR, CXX, tuple(CXX_FLAGS))
    with _lock:
        if key not in _outcomes:
            try:
                _outcomes[key] = _load(build())
            except (RuntimeError, OSError, subprocess.SubprocessError) as e:
                _outcomes[key] = e
        outcome = _outcomes[key]
    if isinstance(outcome, Exception):
        raise RuntimeError(str(outcome))
    return outcome


def _ptr(arr: np.ndarray, ctype):
    return arr.ctypes.data_as(ctypes.POINTER(ctype))


class XorShift128P:
    """A host xorshift128+ stream seeded by splitmix64 from ``seed``;
    raises ``RuntimeError`` when the library cannot be built."""

    def __init__(self, seed: int):
        self._lib = lib()
        self.state = np.zeros(2, np.uint64)
        self._lib.znicz_seed(_ptr(self.state, ctypes.c_uint64),
                             ctypes.c_uint64(int(seed)))

    def fill_uniform(self, out: np.ndarray, low: float, high: float) -> None:
        """``out`` (C-contiguous float32) from U[low, high)."""
        if out.dtype != np.float32 or not out.flags.c_contiguous:
            raise ValueError("out must be a C-contiguous float32 array")
        self._lib.znicz_fill_uniform(_ptr(self.state, ctypes.c_uint64),
                                     _ptr(out, ctypes.c_float), out.size,
                                     low, high)

    def fill_normal(self, out: np.ndarray, stddev: float) -> None:
        """``out`` (C-contiguous float32) from N(0, stddev^2), Box-Muller
        in pairs."""
        if out.dtype != np.float32 or not out.flags.c_contiguous:
            raise ValueError("out must be a C-contiguous float32 array")
        self._lib.znicz_fill_normal(_ptr(self.state, ctypes.c_uint64),
                                    _ptr(out, ctypes.c_float), out.size,
                                    stddev)

    def shuffle(self, arr: np.ndarray) -> None:
        """Fisher-Yates shuffle of ``arr`` (C-contiguous int32) in
        place."""
        if arr.dtype != np.int32 or not arr.flags.c_contiguous:
            raise ValueError("arr must be a C-contiguous int32 array")
        self._lib.znicz_shuffle_i32(_ptr(self.state, ctypes.c_uint64),
                                    _ptr(arr, ctypes.c_int32), arr.size)


def gather_f32(src: np.ndarray, idx: np.ndarray,
               dst: Optional[np.ndarray] = None) -> np.ndarray:
    """``src[idx]`` as float32 rows into ``dst`` (made if None).  Indices
    are checked first, as the reference checks them for its C loop."""
    rows = np.ascontiguousarray(src.reshape(len(src), -1), np.float32)
    idx = np.ascontiguousarray(idx, np.int32)
    if idx.size and (idx.min() < 0 or idx.max() >= len(rows)):
        raise IndexError(f"gather index out of range [0, {len(rows)})")
    if dst is None:
        dst = np.empty((len(idx),) + src.shape[1:], np.float32)
    elif not (dst.flags.c_contiguous and dst.dtype == np.float32):
        raise ValueError("dst must be a C-contiguous float32 buffer")
    np.take(rows, idx, axis=0, out=dst.reshape(len(idx), -1))
    return dst


def u8_to_f32(src: np.ndarray, scale: float = 1.0 / 255.0,
              shift: float = 0.0) -> np.ndarray:
    """``float32(src) * scale + shift`` of a uint8 array, in float32."""
    src = np.asarray(src, np.uint8)
    return src.astype(np.float32) * np.float32(scale) + np.float32(shift)
