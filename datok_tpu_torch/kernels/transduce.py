"""Wrapper of K1, the batched transduce kernel (``csrc/transduce.cu``).

``transduce`` takes the same arguments and returns the same tensors as
the plain machine (:func:`datok_tpu_torch.runtime.machine.run_machine`),
and runs the full step (run skip and fused boundaries) as the engine
does.  Tensors on the CPU go to the plain machine; tensors on a CUDA
device go to K1, and anything K1 does not take raises.  K1 keeps the
rows of the tables' hot set (``tb.hot``) in shared memory, and reads
the per-state words (``tb.state_bits``) and every other cell from
device memory.  ``out=`` takes preallocated outputs
(:func:`outputs`), so that several launches, one a block of lanes, can
write row blocks of one buffer.  ``transduce.launches`` counts K1
launches.

``transduce_general`` runs K1's general form, one character or one
backtrack a step, the same way, over a matrix model's table or a
double-array model's cells (the counterpart of the JAX general
machine, ``jax_engine._run_machine`` over ``MatrixRep`` or
``DoubleArrayRep``); an engine built with ``engine="general"``
launches it.  ``transduce`` takes only the matrix: the full form reads
per-state words, which a double array does not have.
``transduce_host`` runs either form of K1's step header built for the
host (tests).

On a double array K1 reads the tables' interleaved (word, check) pairs
and hop table (``rep.da_pairs``), and each lane carries the base of
each state it holds, so that a step waits on one L2 load, as a matrix
step does: its chain of dependent loads is what bounds it.  A hop
reads the hop table through L1.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Sequence

import torch

from ..runtime.hot import HOT_TAG_MASK
from ..runtime.machine import FORMS, run_machine
from ..runtime.rep import Tables
from . import build


def _check(tb: Tables, meta, lengths, entries, stops, max_steps, cold_total):
    dev = meta.device
    if meta.dim() != 2:
        raise ValueError(f"meta must be (B, L), got {tuple(meta.shape)}")
    B, L = meta.shape
    if L < 1:
        raise ValueError("meta needs at least one column")
    if max_steps < 1:
        raise ValueError(f"max_steps must be positive, got {max_steps}")
    for name, x, dtype in (("meta", meta, torch.int32),
                           ("lengths", lengths, torch.int32),
                           ("entries", entries, torch.int32),
                           ("stops", stops, torch.bool)):
        if x.device != dev:
            raise ValueError(f"{name} is on {x.device}, meta on {dev}")
        if x.dtype != dtype:
            raise TypeError(f"{name} must be {dtype}, got {x.dtype}")
        if not x.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        if name != "meta" and tuple(x.shape) != (B,):
            raise ValueError(f"{name} must be ({B},), got {tuple(x.shape)}")
    if tb.device != dev:
        raise ValueError(f"tables are on {tb.device}, meta on {dev}")
    sb = tb.state_bits
    if sb is not None and (sb.device != dev or sb.dtype != torch.int32
                           or tuple(sb.shape) != (tb.S + 1,)
                           or not sb.is_contiguous()):
        raise ValueError(f"state_bits must be a contiguous ({tb.S + 1},) "
                         f"int32 tensor on {dev}")
    if cold_total is not None and (cold_total.device != dev
                                   or cold_total.dtype != torch.int64
                                   or tuple(cold_total.shape) != (2,)):
        raise ValueError("cold_total must be a (2,) int64 tensor on "
                         f"{dev}")
    return B, L


def outputs(B: int, max_steps: int, dev):
    """Empty outputs of a ``B``-lane launch on ``dev``: ``(events (B,
    max_steps) int32, counts (B,) int32, bad (B,) bool, state (B, 6)
    int32, steps (B,) int32, cold (2,) int64)``."""
    return (
        torch.empty((B, max_steps), dtype=torch.int32, device=dev),
        torch.empty(B, dtype=torch.int32, device=dev),
        torch.empty(B, dtype=torch.bool, device=dev),
        torch.empty((B, 6), dtype=torch.int32, device=dev),
        torch.empty(B, dtype=torch.int32, device=dev),
        torch.empty(2, dtype=torch.int64, device=dev),
    )


def _check_out(out, B: int, max_steps: int, dev):
    specs = (((B, max_steps), torch.int32), ((B,), torch.int32),
             ((B,), torch.bool), ((B, 6), torch.int32), ((B,), torch.int32),
             ((2,), torch.int64))
    if len(out) != len(specs):
        raise ValueError(f"out must hold {len(specs)} tensors, got {len(out)}")
    for i, (o, (shape, dtype)) in enumerate(zip(out, specs)):
        if (o.device != dev or o.dtype != dtype or tuple(o.shape) != shape
                or not o.is_contiguous()):
            raise ValueError(
                f"out[{i}] must be a contiguous {shape} {dtype} tensor on "
                f"{dev}, got {tuple(o.shape)} {o.dtype} on {o.device}")


# a double-array state id is a slot id, and an entry context keeps 28
# bits of it (``entries & 0x0FFFFFFF``, jax_engine.py:1918)
DA_MAX_CELLS = 1 << 28


def _check_layout(tb: Tables, full: bool) -> None:
    """Refuse tables the form does not take: the full form needs a
    matrix, and a double array must fit the entry contexts."""
    if tb.kind == "DATOK":
        if full:
            raise ValueError(
                "K1's full form needs the dense matrix layout "
                "(tok.to_matrix()); a double array runs the general form "
                "(transduce_general)")
        if not 2 <= tb.n_cells < DA_MAX_CELLS:
            raise ValueError(
                f"a double array of {tb.n_cells} cells: K1 takes 2 to "
                f"2^28 - 1, so that every slot fits an entry context")
        if (tb.pairs is None or tb.hop is None
                or tuple(tb.pairs.shape) != (tb.n_cells, 2)
                or tb.hop.dim() != 2 or tb.hop.shape[1] != 2
                or not tb.pairs.is_contiguous()
                or not tb.hop.is_contiguous()):
            raise ValueError("a double array needs its (word, check) pairs "
                             "and hop table (rep.da_pairs, through "
                             "tables_from_tokenizer)")
    elif tb.n_cells >= 1 << 31:
        raise ValueError(f"{tb.n_cells} cells: K1 takes fewer than 2^31")


def _da_args(tb: Tables, meta, lengths, entries, stops, max_steps, outs,
             cold_total):
    """The double-array entries' arguments (no hot set, no per-state
    words), the stream left out."""
    base, _ = tb.arrays
    B, L = meta.shape
    return [
        base.data_ptr(), tb.pairs.data_ptr(), tb.hop.data_ptr(), tb.n_cells,
        tb.size, tb.eps, tb.unknown, tb.identity, meta.data_ptr(), L, B,
        lengths.data_ptr(), entries.data_ptr(), stops.data_ptr(), max_steps,
        *(o.data_ptr() for o in outs),
        None if cold_total is None else cold_total.data_ptr(),
    ]


def _args(tb: Tables, meta, lengths, entries, stops, max_steps, outs,
          cold_total, full: bool):
    hot = tb.hot
    if hot is None:
        (table,) = tb.arrays
        hot_args = [None, 0, None, 0, 0, 0]
    else:
        table = hot.table
        hot_args = [hot.rows.data_ptr(), hot.rows.numel(),
                    hot.hot_of.data_ptr(), hot.hot_of.numel(), hot.root_h,
                    HOT_TAG_MASK]
    sb = tb.state_bits
    if sb is None:
        raise ValueError("K1 needs the tables' per-state words "
                         "(tables_from_tokenizer of a matrix model)")
    B, L = meta.shape
    return [
        table.data_ptr(), tb.n_cells, tb.S, tb.max_sym, tb.eps, tb.unknown,
        tb.identity, *hot_args, sb.data_ptr(), sb.numel(), int(full),
        meta.data_ptr(), L, B, lengths.data_ptr(),
        entries.data_ptr(), stops.data_ptr(), max_steps,
        *(o.data_ptr() for o in outs),
        None if cold_total is None else cold_total.data_ptr(),
    ]


def _run(tb: Tables, meta, lengths, entries, stops, max_steps, cold_total,
         out, full: bool):
    """Both forms' launch: the checks, then the plain machine for CPU
    tensors or K1 on the card; returns the outputs and whether K1
    launched."""
    B, L = _check(tb, meta, lengths, entries, stops, max_steps, cold_total)
    _check_layout(tb, full)
    dev = meta.device
    if out is not None:
        _check_out(out, B, max_steps, dev)
    if dev.type == "cpu":
        res = run_machine(tb, meta, lengths, entries, stops, max_steps,
                          form="full" if full else "general")
        if cold_total is not None:
            cold_total += res[5]
        if out is None:
            return res, False
        for o, r in zip(out, res):
            o.copy_(r)
        return tuple(out), False
    if dev.type != "cuda":
        raise ValueError(f"K1 runs on CUDA devices, not {dev}")
    lib = build.load(build.TRANSDUCE)
    outs = outputs(B, max_steps, dev) if out is None else tuple(out)
    if tb.kind == "DATOK":
        launch = lib.dt_transduce_da_launch
        args = _da_args(tb, meta, lengths, entries, stops, max_steps, outs,
                        cold_total)
    else:
        launch = lib.dt_transduce_launch
        args = _args(tb, meta, lengths, entries, stops, max_steps, outs,
                     cold_total, full)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = launch(*args, ctypes.c_void_p(stream))
    if rc != 0:
        raise RuntimeError(f"K1 launch failed: CUDA error {rc}")
    return outs, True


def transduce(tb: Tables, meta: torch.Tensor, lengths: torch.Tensor,
              entries: torch.Tensor, stops: torch.Tensor, max_steps: int,
              cold_total: Optional[torch.Tensor] = None,
              out: Optional[Sequence[torch.Tensor]] = None):
    """Run every lane of the wave with the full step (a matrix model's
    tables; a double array raises); see
    ``run_machine`` for the arguments and the returned ``(events,
    counts, bad, state, steps, cold)``.  On a CUDA device only
    ``events[i, :counts[i]]`` is written.  ``cold_total``, a (2,) int64
    tensor on the same device, gains ``cold`` (on the card with atomics,
    so launches on several streams may share it).  ``out``, six
    contiguous tensors of the shapes :func:`outputs` gives, on the same
    device, receives the results and is returned (on the CPU the plain
    machine's are copied in)."""
    res, launched = _run(tb, meta, lengths, entries, stops, max_steps,
                         cold_total, out, True)
    transduce.launches += launched
    return res


transduce.launches = 0


def transduce_general(tb: Tables, meta: torch.Tensor, lengths: torch.Tensor,
                      entries: torch.Tensor, stops: torch.Tensor,
                      max_steps: int,
                      cold_total: Optional[torch.Tensor] = None,
                      out: Optional[Sequence[torch.Tensor]] = None):
    """:func:`transduce` with K1's general step (on the CPU the plain
    machine's), over a matrix model's tables or a double array's (fewer
    than 2^28 cells); ``transduce_general.launches`` counts its
    launches, over either layout."""
    res, launched = _run(tb, meta, lengths, entries, stops, max_steps,
                         cold_total, out, False)
    transduce_general.launches += launched
    return res


transduce_general.launches = 0


def transduce_host(tb: Tables, meta: torch.Tensor, lengths: torch.Tensor,
                   entries: torch.Tensor, stops: torch.Tensor, max_steps: int,
                   cold_total: Optional[torch.Tensor] = None,
                   form: str = "full"):
    """K1's step header compiled for the host with g++ (tests only:
    checks the kernel's C++ step logic, hot rows and tags included, on
    machines without a GPU), with the step of ``form`` (``"full"`` or
    ``"general"``; a double array takes only the general one).  CPU
    tensors in, the same outputs as :func:`transduce` out."""
    if form not in FORMS:
        raise ValueError(f"form must be one of {FORMS}, got {form!r}")
    B, L = _check(tb, meta, lengths, entries, stops, max_steps, cold_total)
    full = form == "full"
    _check_layout(tb, full)
    if meta.device.type != "cpu":
        raise ValueError("the host build takes CPU tensors")
    lib = build.load(build.TRANSDUCE_HOST)
    outs = outputs(B, max_steps, meta.device)
    if tb.kind == "DATOK":
        rc = lib.dt_transduce_da_host(*_da_args(
            tb, meta, lengths, entries, stops, max_steps, outs, cold_total))
    else:
        rc = lib.dt_transduce_host(*_args(
            tb, meta, lengths, entries, stops, max_steps, outs, cold_total,
            full))
    if rc != 0:
        raise RuntimeError(f"host build returned {rc}")
    return outs
