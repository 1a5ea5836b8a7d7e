"""The TPU probes' data, carried across to torch tensors.

The JAX probes (``bench_micro/micro_pallas.py``, ``micro_fused.py``,
``micro_ablate.py``) draw their planes and inputs from
``np.random.default_rng(0)``; :func:`fetch_inputs` and
:func:`fused_inputs` make the same arrays in the same order, so both
sides see the same bytes.  Also the card's name and power limit, a
CUDA-event timer and a CUDA-graph capture, which the port's probe
scripts use for every number they print.
"""

from __future__ import annotations

import os
import re
import subprocess
import tempfile
import warnings

import numpy as np
import torch

N_SYMBOLS = 256  # the probes' A_pad
RING = 128  # ring rows of micro_fused.py


def fetch_planes_from_numpy(planes_f32: np.ndarray, device="cpu") -> torch.Tensor:
    """The fetch probes' (256, n*H) planes as a uint8 tensor.

    The TPU multiplies them in bf16, which is exact only because every
    value is an integer in 0..255; raises unless that holds."""
    p = np.asarray(planes_f32)
    if p.ndim != 2 or p.shape[0] != N_SYMBOLS:
        raise ValueError(f"planes must be ({N_SYMBOLS}, n*H), got {p.shape}")
    if not (np.all(p == np.floor(p)) and np.all((p >= 0) & (p <= 255))):
        raise ValueError("planes must hold integers in 0..255")
    return torch.from_numpy(np.ascontiguousarray(p, dtype=np.uint8)).to(device)


def fused_planes_from_numpy(planes_i8: np.ndarray, device="cpu") -> torch.Tensor:
    """The fused probe's transposed (2H, 256) int8 planes as a tensor."""
    p = np.asarray(planes_i8)
    if p.ndim != 2 or p.shape[1] != N_SYMBOLS or p.shape[0] % 2:
        raise ValueError(f"planes must be (2H, {N_SYMBOLS}), got {p.shape}")
    if p.dtype != np.int8:
        raise TypeError(f"planes must be int8, got {p.dtype}")
    return torch.from_numpy(np.ascontiguousarray(p)).to(device)


def fetch_inputs(B: int, H: int):
    """``(planes (256, 3H) f32, a (B,), h (B,))`` int32 as
    micro_pallas.py:130-138 and micro_ablate.py:25-27 draw them."""
    rng = np.random.default_rng(0)
    planes = rng.integers(0, 256, (N_SYMBOLS, 3 * H)).astype(np.float32)
    a = rng.integers(0, N_SYMBOLS, B).astype(np.int32)
    h = rng.integers(0, H, B).astype(np.int32)
    return planes, a, h


def fused_inputs(B: int, H: int):
    """``(table (256, H) i64, planes_i8 (2H, 256), ring (128, B) i32,
    h0 (B,) i32)`` as micro_fused.py:38-47 draws them."""
    rng = np.random.default_rng(0)
    table = rng.integers(0, 1 << 16, (N_SYMBOLS, H)).astype(np.int64)
    planes_T = np.stack(
        [(table & 0xFF).T, ((table >> 8) & 0xFF).T], axis=0
    ).reshape(2 * H, N_SYMBOLS)
    planes_i8 = (planes_T - 128).astype(np.int8)
    ring = rng.integers(1, 200, (RING, B)).astype(np.int32)
    h0 = rng.integers(0, H, B).astype(np.int32)
    return table, planes_i8, ring, h0


def card() -> str:
    """``name, power limit`` of card 0, as nvidia-smi reports them."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True,
    ).stdout.strip().splitlines()[0]


def require_cuda() -> torch.device:
    if not torch.cuda.is_available():
        raise RuntimeError("the probes time CUDA kernels: no GPU")
    return torch.device("cuda")


def graph_replay(fn):
    """``fn()`` captured in one CUDA graph, the counterpart of the TPU
    probes' jitted ``fori_loop``; returns ``(replay, out)``: ``replay()``
    runs the captured launches again and returns ``out``, the captured
    result tensors, which each replay rewrites; ``replay.count`` counts
    the replays and ``replay.graph`` is the graph, kept for
    :func:`graph_kernels`."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()  # warm-up before the capture, on a side stream (it runs)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph(keep_graph=True)
    with torch.cuda.graph(graph):
        out = fn()
    graph.instantiate()

    def replay():
        graph.replay()
        replay.count += 1
        return out

    replay.count, replay.graph = 0, graph
    return replay, out


def graph_kernels(graph, name: str) -> int:
    """How many kernel nodes of ``graph`` (a captured
    ``torch.cuda.CUDAGraph`` that kept its graph) run a function whose
    name holds ``name``: each replay launches each of them once.  Read
    from the graph's own description, which CUDA writes as a DOT file
    (``cudaGraphDebugDotPrint``) naming each kernel node's function."""
    with tempfile.TemporaryDirectory() as tmp, warnings.catch_warnings():
        warnings.simplefilter("ignore")  # debug_dump warns that it runs
        path = os.path.join(tmp, "graph.dot")
        graph.debug_dump(path)
        with open(path) as f:
            dot = f.read()
    kernels = re.findall(r"\{KERNEL\s*\|\s*\{ID \|[^|]*\| ([^<\\}]+)", dot)
    if not kernels:
        raise RuntimeError("the graph's description names no kernel node")
    return sum(name in k for k in kernels)


def chain_times(run, reps: int, kernel: str = ""):
    """Mean milliseconds of one chain ``run()``, eager (one launch a
    step from Python) and as a CUDA-graph replay, each over ``reps``
    runs; raises unless every replay's output equals the eager one.
    With ``kernel`` (a CUDA kernel's name), also the launches of that
    kernel the replays ran: the replays times the graph's nodes of that
    kernel (:func:`graph_kernels`), of which it must have at least one.
    Returns (eager ms, graph ms, eager output, replayed launches)."""
    eager_ms, want = cuda_ms(run, reps)
    replay, _ = graph_replay(run)
    for _ in range(reps):
        if not torch.equal(replay(), want):
            raise RuntimeError("a graph replay of the chain differs from "
                               "the eager chain")
    graph_ms, got = cuda_ms(replay, reps)
    if not torch.equal(got, want):
        raise RuntimeError("a graph replay of the chain differs from the "
                           "eager chain")
    launches = 0
    if kernel:
        per_replay = graph_kernels(replay.graph, kernel)
        if per_replay < 1:
            raise RuntimeError(f"the chain's graph holds no {kernel}")
        launches = replay.count * per_replay
    return eager_ms, graph_ms, want, launches


def cuda_ms(fn, reps: int, warmup: int = 1):
    """Mean milliseconds of ``reps`` calls of ``fn`` between two CUDA
    events, after ``warmup`` untimed calls; returns (ms, last result)."""
    out = None
    for _ in range(warmup):
        out = fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        out = fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps, out
