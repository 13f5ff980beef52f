"""Build, load and launch the hand-written CUDA kernels in ``csrc/``.

Each ``csrc/*.cu`` compiles with ``nvcc`` into its own shared library
with a plain C interface, loaded through ctypes. The build runs at
first use, every source at once (one ``nvcc`` process each), into
``_build/`` beside this file; a library's name carries a hash of the
sources and flags, so an edited source rebuilds and an unchanged one is
reused. Nothing here runs at import: the CPU tests import every module
of the package on machines without ``nvcc``.

Every C entry point returns ``cudaGetLastError()`` after its launch;
``Kernel.__call__`` raises on a nonzero code and otherwise adds one to
the kernel's ``launches`` count.
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

import torch

CSRC = Path(__file__).with_name("csrc")
BUILD_DIR = Path(__file__).with_name("_build")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
    "-Xptxas", "-v",
)

_lock = threading.Lock()
_libs: dict[str, ctypes.CDLL] = {}
#: per source: (seconds, nvcc output) of the build this process ran
build_logs: dict[str, tuple[float, str]] = {}


def _nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    for cand in (
        cuda_home and os.path.join(cuda_home, "bin", "nvcc"),
        shutil.which("nvcc"),
        "/usr/local/cuda/bin/nvcc",
    ):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH")


def _sources() -> list[Path]:
    return sorted(CSRC.glob("*.cu"))


def _lib_path(src: Path) -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for f in sorted(CSRC.iterdir()):
        if f.suffix in (".cu", ".cuh"):
            h.update(f.name.encode() + f.read_bytes())
    return BUILD_DIR / f"{src.stem}-{h.hexdigest()[:16]}.so"


def build_all() -> dict[str, tuple[float, str]]:
    """Compile every source whose library is missing, all in parallel.
    Raises with nvcc's output if any fails; returns ``build_logs``."""
    with _lock:
        todo = [s for s in _sources() if not _lib_path(s).exists()]
        if not todo:
            return build_logs
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        nvcc = _nvcc()
        procs = []
        for src in todo:
            tmp = _lib_path(src).with_suffix(f".{os.getpid()}.tmp")
            cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(src)]
            procs.append((src, tmp, time.perf_counter(), subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True,
            )))
        failed = []
        for src, tmp, t0, proc in procs:
            out, _ = proc.communicate()
            build_logs[src.name] = (time.perf_counter() - t0, out)
            if proc.returncode:
                failed.append(f"{src.name}:\n{out}")
                tmp.unlink(missing_ok=True)
            else:
                os.replace(tmp, _lib_path(src))
        if failed:
            raise RuntimeError("nvcc failed\n" + "\n".join(failed))
        return build_logs


def _library(stem: str) -> ctypes.CDLL:
    lib = _libs.get(stem)
    if lib is None:
        build_all()
        lib = ctypes.CDLL(str(_lib_path(CSRC / f"{stem}.cu")))
        _libs[stem] = lib
    return lib


class Kernel:
    """One C entry point of one source. ``launches`` counts the
    launches that returned no error, from any thread (the OSD daemons
    launch from op workers, coalesce groups, recovery threads and the
    dispatcher's thread at once)."""

    def __init__(self, source: str, symbol: str, argtypes: list) -> None:
        self.source = source
        self.symbol = symbol
        self.argtypes = argtypes
        self.launches = 0
        self._count_lock = threading.Lock()
        self._fn = None

    def _load(self):
        if self._fn is None:
            lib = _library(self.source)
            fn = getattr(lib, self.symbol)
            fn.argtypes = self.argtypes
            fn.restype = ctypes.c_int
            err = getattr(lib, f"{self.source}_error_string")
            err.argtypes = [ctypes.c_int]
            err.restype = ctypes.c_char_p
            self._err = err
            self._fn = fn
        return self._fn

    def __call__(self, *args) -> None:
        code = self._load()(*args, torch.cuda.current_stream().cuda_stream)
        if code:
            msg = self._err(code).decode()
            raise RuntimeError(f"{self.symbol}: CUDA error {code} ({msg})")
        with self._count_lock:
            self.launches += 1


_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong

#: Kernel A — GF(2^8) matrix apply (csrc/gf_apply.cu)
GF_APPLY = Kernel(
    "gf_apply", "gf_apply", [_P, _P, _I, _P, _P, _I, _P, _L, _L, _P]
)
#: Kernel B — matrix apply fused with per-window CRC32C (csrc/gf_apply.cu)
GF_APPLY_CSUM = Kernel(
    "gf_apply", "gf_apply_csum",
    [_P, _P, _I, _P, _P, _I, _P, _L, _L, _P, _L, _I, _I, _P, _P, _P],
)
#: Kernel C — batched per-block CRC32C (csrc/crc32c.cu)
CRC32C_BLOCKS = Kernel(
    "crc32c", "crc32c_blocks", [_P, _P, _L, _L, ctypes.c_uint, _P, _P]
)

#: Kernel D — XOR-schedule apply, stacked and per-shard (csrc/xor_schedule.cu)
XOR_SCHEDULE = Kernel(
    "xor_schedule", "xor_schedule",
    [_P, _P, _I, _P, _P, _I, _P, _I, _I, _I, _L, _L, _I, _I, _I, _I, _P],
)

#: Kernel E — CLAY repair stage a, uncoupled values (csrc/clay_repair.cu)
CLAY_UNCOUPLED = Kernel(
    "clay_repair", "clay_uncoupled",
    [_P, _P, _I, _P, _P, _I, _I, _I, _P, _P, _P, _L, _L, _L, _P],
)
#: Kernel F — CLAY repair stage c, couple and scatter (csrc/clay_repair.cu)
CLAY_COUPLE_SCATTER = Kernel(
    "clay_repair", "clay_couple_scatter",
    [_P, _P, _P, _P, _I, _I, _P, _P, _L, _L, _L, _L, _L, _P],
)

ALL = (GF_APPLY, GF_APPLY_CSUM, CRC32C_BLOCKS, XOR_SCHEDULE, CLAY_UNCOUPLED,
       CLAY_COUPLE_SCATTER)
