"""Transition tables on a torch device.

Counterpart of ``MatrixRep``, ``DoubleArrayRep`` and ``make_rep``
(datok_tpu/runtime/jax_engine.py:104-175).  The tables are the model's
own numpy arrays (``tok.array``, or ``tok.base`` and ``tok.check``),
reinterpreted as int32 so that torch can hold them: the port computes
on the same bytes as the JAX package.  Bit tests therefore read
``FIRSTBIT`` (1<<31) as the sign bit.  A matrix model's tables may also
carry K1's hot set (:class:`HotTable`, :func:`with_hot`).
"""

from __future__ import annotations

from dataclasses import dataclass, replace
from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from ..fsa.io import RESTBIT  # bits 0..29: state id / base offset
from .hot import pack_hot


@dataclass(frozen=True)
class HotTable:
    """K1's hot set on a device (:func:`datok_tpu_torch.runtime.hot.pack_hot`):
    ``states`` (H,) state ids, hot index = position; ``table`` the whole
    table with tagged cells; ``rows`` the hot states' tagged rows, which
    K1 stages into shared memory; ``hot_of`` (S+1,) each state's hot
    index + 1 (0 = cold); ``root_h`` the root's."""

    states: np.ndarray
    table: torch.Tensor
    rows: torch.Tensor
    hot_of: torch.Tensor
    root_h: int

    @property
    def H(self) -> int:
        return len(self.states)


@dataclass(frozen=True)
class Tables:
    """A model's transition tables and constants on one device.

    ``kind`` is the tokenizer type: ``"MATOK"`` (``arrays`` = the dense
    table, cell ``(a-1)*S + t``) or ``"DATOK"`` (``arrays`` = base,
    check).  ``max_sym`` is the matrix's column count and ``size`` the
    double array's ``check[1]`` size field.
    """

    kind: str
    arrays: Tuple[torch.Tensor, ...]
    S: int
    eps: int
    unknown: int
    identity: int
    n_cells: int
    max_sym: int
    size: int
    hot: Optional[HotTable] = None

    @property
    def device(self) -> torch.device:
        return self.arrays[0].device


def tables_from_tokenizer(tok, device) -> Tables:
    """Carry ``tok``'s tables to ``device`` (no copy of the semantics:
    the cells are ``make_rep(tok).tables`` bit for bit)."""
    device = torch.device(device)
    if tok.type() == "MATOK":
        raw = (np.asarray(tok.array, dtype=np.uint32),)
        S = int(tok.state_count)
        n_cells = len(raw[0])
        max_sym = n_cells // (S + 1) if S else 0
        size = 0
    else:
        raw = (np.asarray(tok.base, dtype=np.uint32),
               np.asarray(tok.check, dtype=np.uint32))
        S = 0
        n_cells = len(raw[0])
        max_sym = 0
        size = int(tok.check[1] & RESTBIT)
    arrays = tuple(
        torch.from_numpy(np.ascontiguousarray(a).view(np.int32)).to(device)
        for a in raw
    )
    return Tables(
        kind=tok.type(), arrays=arrays, S=S, eps=int(tok.epsilon),
        unknown=int(tok.unknown), identity=int(tok.identity),
        n_cells=n_cells, max_sym=max_sym, size=size,
    )


def with_hot(tb: Tables, states: Sequence[int]) -> Tables:
    """``tb`` with the hot set ``states`` packed for K1; without one when
    ``states`` is empty, the model is not a matrix, or the tags do not
    fit (:func:`datok_tpu_torch.runtime.hot.pack_hot` returns None)."""
    if tb.kind != "MATOK" or len(states) == 0:
        return replace(tb, hot=None)
    (table,) = tb.arrays
    raw = table.cpu().numpy().view(np.uint32)
    packed = pack_hot(raw, tb.S, tb.max_sym, states)
    if packed is None:
        return replace(tb, hot=None)
    tagged, rows, hot_of = packed

    def put(a):
        return torch.from_numpy(np.ascontiguousarray(a).view(np.int32)).to(tb.device)

    return replace(tb, hot=HotTable(
        states=np.asarray(states, dtype=np.int64), table=put(tagged),
        rows=put(rows), hot_of=put(hot_of),
        root_h=int(hot_of[1]) if tb.S >= 1 else 0))


def _take(arr: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``arr[idx]`` with 0 for indices outside the array (the
    ``mode="fill"`` gathers of the JAX reps)."""
    n = arr.shape[0]
    inside = (idx >= 0) & (idx < n)
    v = arr[idx.clamp(0, n - 1)]
    return torch.where(inside, v, torch.zeros_like(v))


def eps_avail(tb: Tables, t: torch.Tensor) -> torch.Tensor:
    """Is an ε (token bound) arc available at state ``t``?"""
    if tb.kind == "MATOK":
        (table,) = tb.arrays
        return _take(table, (tb.eps - 1) * tb.S + t.long()) != 0
    base, check = tb.arrays
    tc = (_take(base, t.long()) & RESTBIT).long() + tb.eps
    chk = _take(check, tc) & RESTBIT
    return (tc < tb.n_cells) & (chk == t)


def transition(tb: Tables, t0: torch.Tensor, a: torch.Tensor):
    """``(valid, nontok, t_next)`` of the arc ``t0 --a-->``."""
    if tb.kind == "MATOK":
        (table,) = tb.arrays
        # symbols outside 1..max_sym read as no arc (jax_engine.py:123-126)
        a_ok = (a > 0) & (a <= tb.max_sym)
        idx = (a.clamp(1, max(tb.max_sym, 1)).long() - 1) * tb.S + t0.long()
        traw = torch.where(a_ok, _take(table, idx), torch.zeros_like(a))
        valid = traw != 0
        nontok = traw < 0  # FIRSTBIT
        # the target keeps bit 30 (RESTBIT | 1<<30, jax_engine.py:129)
        return valid, nontok, traw & 0x7FFFFFFF
    base, check = tb.arrays
    n = tb.n_cells
    # no a == 0 guard: bug-compatible with the reference (jax_engine.py:158)
    tc = (_take(base, t0.long()) & RESTBIT).long() + a.long()
    in_rng = (tc >= 0) & (tc < n)
    tc_c = tc.clamp(0, n - 1)
    chk_raw = torch.where(in_rng, check[tc_c], torch.zeros_like(a))
    valid = (tc <= tb.size) & in_rng & ((chk_raw & RESTBIT) == t0)
    nontok = chk_raw < 0
    # separate state: hop to its representative (datok.go:1056-1063)
    b_t = base[tc_c]
    t_next = torch.where(b_t < 0, b_t & RESTBIT, tc.to(torch.int32))
    return valid, nontok, t_next
