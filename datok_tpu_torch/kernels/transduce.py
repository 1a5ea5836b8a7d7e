"""Wrapper of K1, the batched transduce kernel (``csrc/transduce.cu``).

``transduce`` takes the same arguments and returns the same tensors as
the plain machine (:func:`datok_tpu_torch.runtime.machine.run_machine`).
Tensors on the CPU go to the plain machine; tensors on a CUDA device go
to K1, and anything K1 does not take raises.  ``transduce.launches``
counts K1 launches.
"""

from __future__ import annotations

import ctypes

import torch

from ..runtime.machine import run_machine
from ..runtime.rep import Tables
from . import build


def _check(tb: Tables, meta_T, lengths, entries, stops, max_steps):
    dev = meta_T.device
    if meta_T.dim() != 2:
        raise ValueError(f"meta_T must be (L, B), got {tuple(meta_T.shape)}")
    L, B = meta_T.shape
    if L < 1:
        raise ValueError("meta_T needs at least one row")
    if max_steps < 1:
        raise ValueError(f"max_steps must be positive, got {max_steps}")
    for name, x, dtype in (("meta_T", meta_T, torch.int32),
                           ("lengths", lengths, torch.int32),
                           ("entries", entries, torch.int32),
                           ("stops", stops, torch.bool)):
        if x.device != dev:
            raise ValueError(f"{name} is on {x.device}, meta_T on {dev}")
        if x.dtype != dtype:
            raise TypeError(f"{name} must be {dtype}, got {x.dtype}")
        if not x.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        if name != "meta_T" and tuple(x.shape) != (B,):
            raise ValueError(f"{name} must be ({B},), got {tuple(x.shape)}")
    if tb.device != dev:
        raise ValueError(f"tables are on {tb.device}, meta_T on {dev}")
    return L, B


def _outputs(B: int, max_steps: int, dev):
    return (
        torch.empty((B, max_steps), dtype=torch.int32, device=dev),
        torch.empty(B, dtype=torch.int32, device=dev),
        torch.empty(B, dtype=torch.bool, device=dev),
        torch.empty((B, 6), dtype=torch.int32, device=dev),
        torch.empty(B, dtype=torch.int32, device=dev),
    )


def _args(tb: Tables, meta_T, lengths, entries, stops, max_steps, outs):
    (table,) = tb.arrays
    L, B = meta_T.shape
    return [
        table.data_ptr(), tb.n_cells, tb.S, tb.max_sym, tb.eps, tb.unknown,
        tb.identity, meta_T.data_ptr(), L, B, lengths.data_ptr(),
        entries.data_ptr(),
        stops.data_ptr(), max_steps, *(o.data_ptr() for o in outs),
    ]


def transduce(tb: Tables, meta_T: torch.Tensor, lengths: torch.Tensor,
              entries: torch.Tensor, stops: torch.Tensor, max_steps: int):
    """Run every lane of the wave; see ``run_machine`` for the
    arguments and the returned ``(events, counts, bad, state, steps)``.
    On a CUDA device only ``events[i, :counts[i]]`` is written."""
    L, B = _check(tb, meta_T, lengths, entries, stops, max_steps)
    dev = meta_T.device
    if dev.type == "cpu":
        return run_machine(tb, meta_T, lengths, entries, stops, max_steps)
    if dev.type != "cuda":
        raise ValueError(f"K1 runs on CUDA devices, not {dev}")
    if tb.kind != "MATOK":
        raise ValueError("K1 takes the dense matrix layout (tok.to_matrix())")
    lib = build.load(build.TRANSDUCE)
    outs = _outputs(B, max_steps, dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.dt_transduce_launch(
            *_args(tb, meta_T, lengths, entries, stops, max_steps, outs),
            ctypes.c_void_p(stream),
        )
    if rc != 0:
        raise RuntimeError(f"K1 launch failed: CUDA error {rc}")
    transduce.launches += 1
    return outs


transduce.launches = 0


def transduce_host(tb: Tables, meta_T: torch.Tensor, lengths: torch.Tensor,
                   entries: torch.Tensor, stops: torch.Tensor, max_steps: int):
    """K1's step header compiled for the host with g++ (tests only:
    checks the kernel's C++ step logic on machines without a GPU).
    CPU tensors in, the same outputs as :func:`transduce` out."""
    L, B = _check(tb, meta_T, lengths, entries, stops, max_steps)
    if meta_T.device.type != "cpu" or tb.kind != "MATOK":
        raise ValueError("the host build takes CPU tensors of a matrix model")
    lib = build.load(build.TRANSDUCE_HOST)
    outs = _outputs(B, max_steps, meta_T.device)
    rc = lib.dt_transduce_host(
        *_args(tb, meta_T, lengths, entries, stops, max_steps, outs)
    )
    if rc != 0:
        raise RuntimeError(f"host build returned {rc}")
    return outs
