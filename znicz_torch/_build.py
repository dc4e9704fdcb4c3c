"""Build and load the port's CUDA kernels.

Each source under ``csrc/`` is compiled by ``nvcc`` for Hopper
(``sm_90a``) into a shared library with a plain C interface and loaded
with ``ctypes``.  The libraries go into ``build/kernels/`` beside the
package (listed in ``.gitignore``), named by a hash of their source, so a
changed source is rebuilt and an unchanged one is reused.  Everything is
built at first use, never at import: the CPU tests import every module
on a machine with no ``nvcc``.

Every C entry point launches on the stream it is given and returns
``cudaGetLastError()``; :func:`check` raises on anything but 0.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Dict, Tuple

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent.parent / "build" / "kernels"

#: library name -> source file in ``csrc/``
SOURCES = {"fused_block": "fused_block.cu",
           "bias_relu": "bias_relu.cu",
           "lrn": "lrn.cu",
           "fused_block_bwd": "fused_block_bwd.cu",
           "bias_relu_bwd": "bias_relu_bwd.cu",
           "lrn_bwd": "lrn_bwd.cu"}

NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_P, _I, _F, _LL = ctypes.c_void_p, ctypes.c_int, ctypes.c_float, \
    ctypes.c_longlong

#: C functions of each library: name -> argtypes.  The first is the
#: float32 launch function, the ``*_bf16_*`` ones launch the bf16 operand
#: variants (``*_bf16_ring_*`` the float32 kernels' ring design on bf16
#: rows, ``*_bf16_vec_*`` the float32 bias+ReLU kernels' design on 16-byte
#: units of eight bf16); every restype is int
SIGNATURES = {
    "fused_block": {
        "znicz_fused_block_fwd":
            [_P] * 3 + [_I] * 7 + [_F] * 3 + [_I] * 10 + [_P],
        "znicz_fused_block_smem_limit": [_I],
        "znicz_fused_block_bf16_fwd":
            [_P] * 3 + [_I] * 7 + [_F] * 3 + [_I] * 6 + [_P],
        "znicz_fused_block_bf16_ring_fwd":
            [_P] * 3 + [_I] * 7 + [_F] * 3 + [_I] * 9 + [_P]},
    "bias_relu": {"znicz_bias_relu_fwd": [_P, _P, _P, _LL, _I, _I, _P],
                  "znicz_bias_relu_bf16_fwd":
                      [_P, _P, _P, _LL, _I, _I, _P],
                  "znicz_bias_relu_bf16_vec_fwd":
                      [_P, _P, _P, _LL, _I, _I, _P]},
    "lrn": {"znicz_lrn_fwd":
            [_P, _P, _LL, _I, _I, _I, _F, _F, _F, _I, _I, _I, _I, _LL]
            + [_I] * 5 + [_P],
            "znicz_lrn_bf16_fwd":
            [_P, _P, _LL] + [_I] * 4 + [_F] * 3 + [_I, _I, _P],
            "znicz_lrn_bf16_ring_fwd":
            [_P] * 3 + [_LL] + [_I] * 3 + [_F] * 2 + [_I] * 3 + [_LL]
            + [_I] * 5 + [_P],
            "znicz_lrn_bf16_pow_table": [_P, _F, _I, _P]},
    "fused_block_bwd": {
        "znicz_fused_block_bwd":
            [_P] * 6 + [_I] * 7 + [_F] * 4 + [_I] * 11 + [_P],
        "znicz_fused_block_bf16_bwd":
            [_P] * 8 + [_I] * 7 + [_F] * 4 + [_I] * 8 + [_P],
        "znicz_fused_block_bf16_ring_bwd":
            [_P] * 6 + [_I] * 7 + [_F] * 4 + [_I] * 10 + [_P]},
    "bias_relu_bwd": {
        "znicz_bias_relu_bwd": [_P] * 7 + [_LL] + [_I] * 8 + [_P],
        "znicz_bias_relu_bf16_bwd": [_P] * 6 + [_LL] + [_I] * 5 + [_P],
        "znicz_bias_relu_bf16_vec_bwd": [_P] * 7 + [_LL] + [_I] * 7 + [_P]},
    "lrn_bwd": {
        "znicz_lrn_bwd": [_P, _P, _P, _LL, _I, _I, _I] + [_F] * 4
        + [_I] * 4 + [_LL] + [_I] * 5 + [_P],
        "znicz_lrn_bf16_bwd":
            [_P] * 3 + [_LL] + [_I] * 4 + [_F] * 4 + [_I, _I, _P],
        "znicz_lrn_bf16_ring_bwd":
            [_P] * 4 + [_LL] + [_I] * 3 + [_F] * 3 + [_I] * 3 + [_LL]
            + [_I] * 5 + [_P]},
}


_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}
#: per library: nvcc's output ("" for a library found already built)
build_logs: Dict[str, str] = {}


def _nvcc() -> str:
    for cand in (shutil.which("nvcc"),
                 os.path.join(os.environ.get("CUDA_HOME", ""), "bin", "nvcc"),
                 "/usr/local/cuda/bin/nvcc"):
        if cand and os.path.isfile(cand):
            return cand
    raise RuntimeError("nvcc not found (PATH, $CUDA_HOME/bin, "
                       "/usr/local/cuda/bin): the CUDA kernels cannot be "
                       "built on this machine")


def _target(name: str) -> Path:
    """The library's path, named by a hash of its source, the shared
    headers it may include and the flags."""
    blob = (CSRC / SOURCES[name]).read_bytes() + b"".join(
        h.read_bytes() for h in sorted(CSRC.glob("*.cuh")))
    digest = hashlib.sha1(blob + " ".join(NVCC_FLAGS).encode()) \
        .hexdigest()[:12]
    return BUILD_DIR / f"{name}-{digest}.so"


def build_all() -> Dict[str, str]:
    """Compile every library that is missing, one ``nvcc`` per source, all
    started together; load them all.  Returns :data:`build_logs`."""
    with _lock:
        missing = [n for n in SOURCES if not _target(n).exists()]
        if missing:
            BUILD_DIR.mkdir(parents=True, exist_ok=True)
            nvcc = _nvcc()
            procs = {}
            for name in missing:
                tmp = _target(name).with_suffix(f".tmp{os.getpid()}")
                cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp),
                       str(CSRC / SOURCES[name])]
                procs[name] = (tmp, subprocess.Popen(
                    cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                    text=True))
            failed = []
            for name, (tmp, proc) in procs.items():
                log, _ = proc.communicate()
                build_logs[name] = log
                if proc.returncode != 0:
                    failed.append(f"{name} (rc {proc.returncode}):\n{log}")
                else:
                    os.replace(tmp, _target(name))
            if failed:
                raise RuntimeError("nvcc failed: " + "\n".join(failed))
        for name in SOURCES:
            if name not in _libs:
                lib = ctypes.CDLL(str(_target(name)))
                for fn_name, argtypes in SIGNATURES[name].items():
                    fn = getattr(lib, fn_name)
                    fn.argtypes = argtypes
                    fn.restype = ctypes.c_int
                lib.znicz_error_string.argtypes = [ctypes.c_int]
                lib.znicz_error_string.restype = ctypes.c_char_p
                _libs[name] = lib
                build_logs.setdefault(name, "")
    return build_logs


def entry(name: str, fn_name: str = ""):
    """C function ``fn_name`` of library ``name`` (its first function by
    default), built on first use."""
    if name not in _libs:
        build_all()
    return getattr(_libs[name], fn_name or next(iter(SIGNATURES[name])))


def check(rc: int, name: str, fn_name: str = "") -> None:
    """Raise if C function ``fn_name`` of library ``name`` (its launch
    function by default) reported a CUDA error."""
    if rc != 0:
        msg = _libs[name].znicz_error_string(rc).decode()
        fn_name = fn_name or next(iter(SIGNATURES[name]))
        raise RuntimeError(f"{fn_name}: CUDA error {rc} ({msg})")


#: an SM's most resident threads on Hopper, and the shared memory it
#: reserves for each resident block (232,448 + 1,024 bytes = 228 KB an SM)
SM_THREADS, SMEM_RESERVED = 2048, 1024


def resident_blocks(threads: int, smem: int, smem_limit: int) -> int:
    """Blocks of ``threads`` threads and ``smem`` bytes of shared memory
    that fit one SM whose blocks may opt into ``smem_limit`` bytes."""
    return min(SM_THREADS // threads,
               (smem_limit + SMEM_RESERVED) // (smem + SMEM_RESERVED))


@functools.lru_cache(maxsize=None)
def device_limits(dev: int) -> Tuple[int, int]:
    """(one block's opt-in shared memory in bytes, SMs) of CUDA device
    ``dev``: what the kernels' planners size their launches by."""
    import torch

    smem = entry("fused_block", "znicz_fused_block_smem_limit")(dev)
    return smem, torch.cuda.get_device_properties(dev).multi_processor_count


def stream_of(t) -> int:
    """The raw handle of PyTorch's current stream on ``t``'s device."""
    import torch

    return torch.cuda.current_stream(t.device).cuda_stream
