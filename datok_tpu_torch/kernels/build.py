"""Build the port's native code from the sources in ``csrc/``.

Each library is a :class:`Lib` spec: the source it compiles, the
headers it depends on, its entry symbols with their ``ctypes`` argument
types, and whether ``nvcc`` or ``g++`` builds it.  The CUDA libraries
(K1, KF, KP) are compiled with ``nvcc`` for ``sm_90a`` into shared
libraries with a plain C interface, loaded with ``ctypes`` (no PyTorch
headers, so a build takes seconds).  The host builds of the kernels'
per-lane headers are compiled with ``g++`` for the tests.  All go into
``datok_tpu_torch/_build/`` at first use and are rebuilt when a source
is newer than the library.  A failed build raises: there is no
fallback.
"""

from __future__ import annotations

import ctypes
import os
import shutil
import subprocess
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass
from typing import Dict, List, Sequence, Tuple

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(_PKG, "_build")

NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]
GXX_FLAGS = ["-O2", "-std=c++17", "-shared", "-fPIC"]

_p, _i32, _i64 = ctypes.c_void_p, ctypes.c_int32, ctypes.c_int64


@dataclass(frozen=True)
class Lib:
    """One shared library: ``sources[0]`` is compiled, the rest are the
    headers it includes; ``entries`` maps each exported symbol to its
    argument types (every entry returns ``int``)."""

    name: str
    sources: Tuple[str, ...]
    entries: Tuple[Tuple[str, Tuple], ...]
    cuda: bool

    @property
    def path(self) -> str:
        return os.path.join(BUILD_DIR, f"libdt_{self.name}.so")

    @property
    def log(self) -> str:
        """The compiler's report (``-Xptxas -v``: registers, spills)."""
        return os.path.join(BUILD_DIR, f"{self.name}.log")


def _src(*names: str) -> Tuple[str, ...]:
    return tuple(os.path.join(CSRC, n) for n in names)


# table, n_cells, S, max_sym, eps, unknown, identity, hot_rows, n_hot,
# hot_of, n_hot_of, root_h, tag_mask, st, n_st, full, meta, L, B, lengths,
# entries, stops, max_steps, events, counts, bad, state, steps, cold,
# cold_total
_TRANSDUCE_ARGS = (_p, _i64, _i32, _i32, _i32, _i32, _i32, _p, _i32, _p,
                   _i32, _i32, ctypes.c_uint32, _p, _i32, _i32, _p, _i32,
                   _i32, _p, _p, _p, _i32, _p, _p, _p, _p, _p, _p, _p)
# base, pairs, hop, n_cells, size, eps, unknown, identity, meta, L, B,
# lengths, entries, stops, max_steps, events, counts, bad, state, steps,
# cold, cold_total
_TRANSDUCE_DA_ARGS = (_p, _p, _p, _i64) + (_i32,) * 4 + (_p, _i32, _i32) + (
    _p,) * 3 + (_i32,) + (_p,) * 7
# a, h, table, W, n_planes, select, B, out
_HOT_FETCH_ARGS = (_p, _p, _p, _i32, _i32, _i32, _i32, _p)
# ring, R, B, planes, H, K, h0, ys, h_out
_MICRO_FUSED_ARGS = (_p, _i32, _i32, _p, _i32, _i32, _p, _p, _p)

TRANSDUCE = Lib("transduce", _src("transduce.cu", "transduce_step.cuh"),
                (("dt_transduce_launch", _TRANSDUCE_ARGS + (_p,)),
                 ("dt_transduce_da_launch", _TRANSDUCE_DA_ARGS + (_p,))),
                True)
TRANSDUCE_HOST = Lib(
    "transduce_host", _src("transduce_host.cpp", "transduce_step.cuh"),
    (("dt_transduce_host", _TRANSDUCE_ARGS),
     ("dt_transduce_da_host", _TRANSDUCE_DA_ARGS)), False)
# a, h, out, B, table, stream
HOT_FETCH = Lib("hot_fetch", _src("hot_fetch.cu", "hot_fetch_lane.cuh"),
                (("dt_hot_fetch_launch", (_p, _p, _p, _i32, _p, _p)),), True)
# + grid, threads, smem, ring_rows, device, stream
MICRO_FUSED = Lib(
    "micro_fused", _src("micro_fused.cu", "micro_fused_lane.cuh"),
    (("dt_micro_fused_launch", _MICRO_FUSED_ARGS + (_i32,) * 5 + (_p,)),),
    True)
MICRO_HOST = Lib(
    "micro_host",
    _src("micro_host.cpp", "hot_fetch_lane.cuh", "micro_fused_lane.cuh"),
    (("dt_hot_fetch_host", _HOT_FETCH_ARGS),
     ("dt_micro_fused_host", _MICRO_FUSED_ARGS),
     ("dt_micro_fused_staged_host", _MICRO_FUSED_ARGS + (_i32,))), False)

CUDA_LIBS = (TRANSDUCE, HOT_FETCH, MICRO_FUSED)

_lock = threading.Lock()
_loaded: Dict[str, ctypes.CDLL] = {}


def _stale(lib: str, sources: Sequence[str]) -> bool:
    if not os.path.exists(lib):
        return True
    return os.path.getmtime(lib) < max(os.path.getmtime(s) for s in sources)


def _compile(cmd: List[str], src: str, lib: str) -> str:
    """Compile ``src`` with ``cmd`` into ``lib`` (through a temporary
    file, so a concurrent loader never sees half a library); returns
    the compiler's output."""
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{lib}.tmp{os.getpid()}.{threading.get_ident()}"
    r = subprocess.run([*cmd, "-o", tmp, src], capture_output=True, text=True)
    if r.returncode != 0:
        raise RuntimeError(
            f"build of {os.path.basename(lib)} failed ({r.returncode}):\n"
            f"{' '.join(r.args)}\n{r.stdout}{r.stderr}"
        )
    os.replace(tmp, lib)
    return r.stdout + r.stderr


def _nvcc() -> str:
    nvcc = shutil.which("nvcc")
    if nvcc is None and os.path.exists("/usr/local/cuda/bin/nvcc"):
        nvcc = "/usr/local/cuda/bin/nvcc"
    if nvcc is None:
        raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")
    return nvcc


def build(spec: Lib) -> str:
    """Build ``spec`` if needed; returns the library path.  A CUDA
    build keeps the compiler's report beside it (:attr:`Lib.log`)."""
    if _stale(spec.path, spec.sources):
        if spec.cuda:
            log = _compile([_nvcc(), *NVCC_FLAGS], spec.sources[0],
                           spec.path)
            with open(spec.log, "w") as fh:
                fh.write(log)
        else:
            _compile(["g++", *GXX_FLAGS], spec.sources[0], spec.path)
    return spec.path


def build_all(specs: Sequence[Lib]) -> Dict[str, float]:
    """Build several libraries at once, one compiler process each;
    returns each library's seconds (about 0 when it was up to date)."""
    def one(spec):
        t0 = time.perf_counter()
        build(spec)
        return spec.name, time.perf_counter() - t0

    with ThreadPoolExecutor(max_workers=max(1, len(specs))) as ex:
        return dict(ex.map(one, specs))


def load(spec: Lib) -> ctypes.CDLL:
    """The library of ``spec``, built from ``csrc/`` at first use, with
    its entries' argument types set.  Once loaded, a library is not
    checked again in this process: the wrappers call this at every
    launch, and the mtime check costs file-system calls."""
    lib = _loaded.get(spec.name)
    if lib is not None:
        return lib
    path = build(spec)
    with _lock:
        lib = _loaded.get(spec.name)
        if lib is None:
            lib = ctypes.CDLL(path)
            for sym, argtypes in spec.entries:
                f = getattr(lib, sym)
                f.restype = ctypes.c_int
                f.argtypes = list(argtypes)
            _loaded[spec.name] = lib
        return lib
