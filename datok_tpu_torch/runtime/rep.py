"""Transition tables on a torch device.

Counterpart of ``MatrixRep``, ``DoubleArrayRep`` and ``make_rep``
(datok_tpu/runtime/jax_engine.py:104-175).  The tables are the model's
own numpy arrays (``tok.array``, or ``tok.base`` and ``tok.check``),
reinterpreted as int32 so that torch can hold them: the port computes
on the same bytes as the JAX package.  Bit tests therefore read
``FIRSTBIT`` (1<<31) as the sign bit.  A matrix model's tables may also
carry K1's hot set (:class:`HotTable`, :func:`with_hot`), which
:func:`hot_table` tags on the device from the untagged table, so that a
wave can take a set of its own.

A matrix model's tables also carry what the full step (run skip and
fused boundaries) reads of each state, one int32 word a state
(:func:`state_table`), and the skip class it was built with
(:func:`skip_class`), which the engine's encoder stamps into meta.  A
double array's also carry K1's form of its cells (:func:`da_pairs`):
interleaved (word, check) pairs and a hop table for the separate
states.
"""

from __future__ import annotations

from dataclasses import dataclass, replace
from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from ..fsa.io import FIRSTBIT, RESTBIT  # RESTBIT: state id / base offset
from .hot import HOT_SHIFT, MAX_HOT

# The per-state word of the full step (:func:`state_table`):
ST_EPS_TGT = (1 << 28) - 1  # bits 0..27: the ε target where a boundary fuses
ST_EPS = 1 << 28  # an ε arc leaves the state (the probe)
ST_EPS_AT_TGT = 1 << 29  # an ε arc leaves its ε target
ST_LC = 1 << 30  # the state self-loops on every letter of the skip class


@dataclass(frozen=True)
class HotTable:
    """K1's hot set on a device (:func:`datok_tpu_torch.runtime.hot.pack_hot`):
    ``states`` (H,) state ids, hot index = position; ``table`` the whole
    table with tagged cells; ``rows`` the hot states' tagged rows, which
    K1 stages into shared memory; ``hot_of`` (S+1,) each state's hot
    index + 1 (0 = cold); ``root_h`` the root's; ``ready`` (on a card)
    a CUDA event recorded after the tensors were written, which a
    launch on another stream waits for."""

    states: np.ndarray
    table: torch.Tensor
    rows: torch.Tensor
    hot_of: torch.Tensor
    root_h: int
    ready: Optional[object] = None

    @property
    def H(self) -> int:
        return len(self.states)


@dataclass(frozen=True)
class Tables:
    """A model's transition tables and constants on one device.

    ``kind`` is the tokenizer type: ``"MATOK"`` (``arrays`` = the dense
    table, cell ``(a-1)*S + t``) or ``"DATOK"`` (``arrays`` = base,
    check).  ``max_sym`` is the matrix's column count and ``size`` the
    double array's ``check[1]`` size field.  A double array's ``pairs``
    and ``hop`` are :func:`da_pairs`'s, as int32; its ``check`` is a
    strided view of ``pairs``, so that the cells are not held twice.
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
    state_bits: Optional[torch.Tensor] = None
    lc_mask: Optional[np.ndarray] = None
    pairs: Optional[torch.Tensor] = None
    hop: Optional[torch.Tensor] = None

    @property
    def device(self) -> torch.device:
        return self.arrays[0].device


def skip_class(tok) -> Tuple[np.ndarray, np.ndarray]:
    """The run skip's letter class of a matrix model: ``(lc_mask (128,)
    bool, lc_avail (S+1,) uint8)``, a copy of the skip-class part of
    ``_tok_static`` (datok_tpu/runtime/jax_engine.py:793-833).

    A state is letter-absorbing (``lc_avail``) when it self-loops, with
    no nontoken flag, on every letter of the class; such a state takes a
    whole run of them in one step (each skipped character would probe
    the same ε bit and take the same self-arc).  The class starts as
    the ASCII letters a-z in sigma and greedily drops letters that break
    many otherwise absorbing states (the DE grammar routes ``s`` through
    its genitive states).  Cached on ``tok``."""
    st = getattr(tok, "_skip_class", None)
    if st is not None:
        return st
    arr = np.asarray(tok.array, dtype=np.uint32)
    S = int(tok.state_count)
    states = np.arange(S + 1, dtype=np.int64)
    letters = [cp for cp in range(ord("a"), ord("z") + 1) if cp in tok.sigma]
    lc_avail = np.zeros(S + 1, dtype=np.uint8)
    lc_mask = np.zeros(128, dtype=bool)
    if letters:
        syms = np.array([tok.sigma[cp] for cp in letters], dtype=np.int64)
        cells_lc = arr[((syms[:, None] - 1) * S + states[None, :])]
        ok_lc = (
            (cells_lc != 0)
            & ((cells_lc & ~np.uint32(FIRSTBIT)) == states[None, :])
            & ((cells_lc >> 31) == 0)
        )  # (len(letters), S+1)
        counts = ok_lc.sum(axis=0)
        cand = counts >= max(1, int(len(letters) * 0.75))  # absorbing-ish
        keep = np.ones(len(letters), dtype=bool)
        for _ in range(6):  # drop at most a few run-splitting letters
            flagged = ok_lc[keep].all(axis=0) & cand
            best_gain, best_i = 0, -1
            for i in np.flatnonzero(keep):
                k2 = keep.copy()
                k2[i] = False
                gain = int((ok_lc[k2].all(axis=0) & cand).sum()) - int(
                    flagged.sum()
                )
                if gain > best_gain:
                    best_gain, best_i = gain, i
            if best_i < 0 or best_gain < max(4, int(cand.sum() * 0.1)):
                break
            keep[best_i] = False
        lc_avail = (ok_lc[keep].all(axis=0)).astype(np.uint8)
        lc_avail[0] = 0
        for i in np.flatnonzero(keep):
            lc_mask[letters[i]] = True
    tok._skip_class = (lc_mask, lc_avail)
    return tok._skip_class


def state_table(array: np.ndarray, S: int, max_sym: int, eps: int,
                lc_avail: np.ndarray) -> np.ndarray:
    """The word the full step reads of each state 0..S (int32):

    - bits 0..27 (:data:`ST_EPS_TGT`): the target ``e`` of the state's ε
      arc where a boundary at the state can fuse, else 0.  It fuses
      when the state is not 0 (a backtrack register of 0 means none),
      the ε arc is a transition the step can take (``1 <= eps <=
      max_sym``), and ``e`` is a state 1..S;
    - bit 28 (:data:`ST_EPS`): the state's ε cell is not 0, the probe of
      the general step for every state 0..S;
    - bit 29 (:data:`ST_EPS_AT_TGT`): the same at ``e``;
    - bit 30 (:data:`ST_LC`): ``lc_avail``, the state is letter-absorbing
      (:func:`skip_class`).

    This is the GPU's form of what the JAX package's ``HotSpec``
    precomputes per hot state (``lc_avail``, ``eps_avail``,
    ``hot_eps_full`` and the fused entries' bit 15), for every state."""
    arr = np.asarray(array, dtype=np.uint32).reshape(-1)
    states = np.arange(S + 1, dtype=np.int64)
    idx = (eps - 1) * S + states
    inside = (idx >= 0) & (idx < len(arr))
    cells = np.where(inside, arr[np.where(inside, idx, 0)], np.uint32(0))
    has = cells != 0
    tgt = (cells & np.uint32(0x7FFFFFFF)).astype(np.int64)
    fuse = has & (states != 0) & (tgt >= 1) & (tgt <= S) & (1 <= eps <= max_sym)
    e = np.where(fuse, tgt, 0)
    word = (e | has.astype(np.int64) << 28
            | (fuse & has[e]).astype(np.int64) << 29
            | (np.asarray(lc_avail) != 0).astype(np.int64) << 30)
    return word.astype(np.int32)


def da_pairs(base: np.ndarray, check: np.ndarray,
             spread: int = 0) -> Tuple[np.ndarray, np.ndarray]:
    """K1's form of a double array's cells: ``(pairs, hop)``.

    ``pairs`` (n, 2) uint32 holds (word, check) for each cell, the
    ``.datok`` file's own interleaving, so that one 8-byte load brings
    a transition's check together with where the lane goes next.  The
    word of a plain cell is ``base`` itself: the next state is the
    cell, and its base is in hand.  The word of a separate cell
    (``base & FIRSTBIT``) is ``FIRSTBIT | j``, with j the index of an
    entry of ``hop`` that holds its representative ``r = base &
    RESTBIT`` and ``r``'s own ``base & RESTBIT`` (0 where ``r`` lies
    outside the array): the target and base that the plain machine's
    one hop gives (:func:`transition`, datok.go:1056-1063).  ``hop``
    (m, 2) uint32 has one entry a distinct representative (one zero
    entry where no cell is separate).

    ``spread`` > 0 asks for a hop table of at least that many entries
    that the hops spread over, for measurements: each representative's
    entry is repeated, and the separate cells of each representative
    are dealt out to its copies in turn.  The targets and bases are the
    same, so a machine that reads it gives the same results."""
    base = np.asarray(base, dtype=np.uint32)
    check = np.asarray(check, dtype=np.uint32)
    n = len(base)
    sep = np.flatnonzero(base & np.uint32(FIRSTBIT))
    reps, j = np.unique(base[sep] & np.uint32(RESTBIT), return_inverse=True)
    inside = reps < n
    rep_base = np.where(inside, base[np.where(inside, reps, 0)],
                        np.uint32(0)) & np.uint32(RESTBIT)
    n_hop = len(reps)
    copies = max(1, -(-spread // n_hop)) if n_hop else 1
    if copies > 1:  # each cell's rank among its representative's cells
        order = np.argsort(j, kind="stable")
        starts = np.searchsorted(j[order], np.arange(n_hop))
        rank = np.empty_like(j)
        rank[order] = np.arange(len(j)) - starts[j[order]]
        j = j + n_hop * (rank % copies)
    word = base.copy()
    word[sep] = np.uint32(FIRSTBIT) | j.astype(np.uint32)
    hop = np.zeros((max(1, n_hop * copies), 2), dtype=np.uint32)
    if n_hop:
        hop[:, 0] = np.tile(reps, copies)
        hop[:, 1] = np.tile(rep_base, copies)
    return np.stack([word, check], axis=1), hop


def tables_from_tokenizer(tok, device, spread: int = 0) -> Tables:
    """Carry ``tok``'s tables to ``device`` (no copy of the semantics:
    the cells are ``make_rep(tok).tables`` bit for bit); a matrix
    model's also carry :func:`state_table` and the skip class, a double
    array's :func:`da_pairs` (with its hop table spread over at least
    ``spread`` entries, for measurements)."""
    device = torch.device(device)

    def put(a):
        return torch.from_numpy(np.ascontiguousarray(a).view(np.int32)).to(
            device)

    state_bits = lc_mask = pairs = hop = None
    if tok.type() == "MATOK":
        raw = np.asarray(tok.array, dtype=np.uint32)
        S = int(tok.state_count)
        n_cells = len(raw)
        max_sym = n_cells // (S + 1) if S else 0
        size = 0
        arrays = (put(raw),)
        lc_mask, lc_avail = skip_class(tok)
        state_bits = torch.from_numpy(state_table(
            raw, S, max_sym, int(tok.epsilon), lc_avail)).to(device)
    else:
        base = np.asarray(tok.base, dtype=np.uint32)
        S = 0
        n_cells = len(base)
        max_sym = 0
        size = int(tok.check[1] & RESTBIT)
        pairs_np, hop_np = da_pairs(base, tok.check, spread)
        pairs, hop = put(pairs_np), put(hop_np)
        arrays = (put(base), pairs[:, 1])
    return Tables(
        kind=tok.type(), arrays=arrays, S=S, eps=int(tok.epsilon),
        unknown=int(tok.unknown), identity=int(tok.identity),
        n_cells=n_cells, max_sym=max_sym, size=size,
        state_bits=state_bits, lc_mask=lc_mask, pairs=pairs, hop=hop,
    )


def tags_fit(table: torch.Tensor) -> bool:
    """Can the cells of ``table`` (untagged, int32) carry hot tags: no
    cell has any of bits 20..30 set (``pack_hot``'s test)."""
    return not bool((table & 0x7FF00000).any())


def pack_hot_device(table: torch.Tensor, S: int, max_sym: int,
                    states: Sequence[int]):
    """:func:`datok_tpu_torch.runtime.hot.pack_hot` with torch ops on the
    table's device: ``(tagged, rows, hot_of)`` as int32 tensors there,
    bit for bit ``pack_hot``'s, or None where it gives None.  ``table``
    is the untagged table as int32.  Nothing is written in place: the
    tagged table is a new tensor."""
    if not tags_fit(table):
        return None
    return _tag_device(table, S, max_sym, states)


def _tag_device(table: torch.Tensor, S: int, max_sym: int,
                states: Sequence[int]):
    """:func:`pack_hot_device` on a table whose tags are known to fit."""
    states = np.asarray(states, dtype=np.int64).reshape(-1)
    H = len(states)
    if (S >= 1 << HOT_SHIFT or H > MAX_HOT
            or (H and (states.min() < 0 or states.max() > S))
            or len(np.unique(states)) != H):
        return None
    dev = table.device
    st = torch.from_numpy(states).to(dev)
    hot_of = torch.zeros(S + 1, dtype=torch.int32, device=dev)
    hot_of[st] = torch.arange(1, H + 1, dtype=torch.int32, device=dev)
    target = table & 0x7FFFFFFF
    inside = (table != 0) & (target <= S)
    tag = torch.index_select(hot_of, 0, target.clamp_(max=S)) << HOT_SHIFT
    tagged = table | tag.masked_fill_(~inside, 0)
    n = tagged.numel()
    idx = (torch.arange(max_sym, dtype=torch.int64, device=dev)[None, :] * S
           + st[:, None]).reshape(-1)
    rows = torch.zeros((H * max_sym + 3) // 4 * 4, dtype=torch.int32,
                       device=dev)
    if n:
        rows[:H * max_sym] = torch.where(idx < n, tagged[idx.clamp(max=n - 1)],
                                         0)
    return tagged, rows, hot_of


def hot_table(tb: Tables, states: Sequence[int]) -> Optional[HotTable]:
    """K1's hot set ``states`` for the matrix tables ``tb``, tagged on
    their device from the untagged table (:func:`pack_hot_device`);
    None where the tags do not fit.  Tables that already hold a set
    passed that test when it was built, so only a first set reads the
    whole table for it (:func:`tags_fit`, which waits for the device)."""
    (table,) = tb.arrays
    tag = pack_hot_device if tb.hot is None else _tag_device
    packed = tag(table, tb.S, tb.max_sym, states)
    if packed is None:
        return None
    tagged, rows, hot_of = packed
    states = np.asarray(states, dtype=np.int64).reshape(-1)
    root = np.flatnonzero(states == 1)
    ready = None
    if tb.device.type == "cuda":
        ready = torch.cuda.Event()
        ready.record(torch.cuda.current_stream(tb.device))
    return HotTable(states=states, table=tagged, rows=rows, hot_of=hot_of,
                    root_h=int(root[0]) + 1 if len(root) else 0, ready=ready)


def with_hot(tb: Tables, states: Sequence[int]) -> Tables:
    """``tb`` with the hot set ``states`` packed for K1; without one when
    ``states`` is empty, the model is not a matrix, or the tags do not
    fit (:func:`hot_table` returns None).  The per-state words stay as
    they are: they hold state ids."""
    if tb.kind != "MATOK" or len(states) == 0:
        return replace(tb, hot=None)
    return replace(tb, hot=hot_table(tb, states))


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


def takes_hop(tb: Tables, t0: torch.Tensor, a: torch.Tensor) -> torch.Tensor:
    """Does the arc ``t0 --a-->`` of a double array land on a separate
    cell (the hop of :func:`transition`)?  Only the count of hops
    reads it."""
    base, _ = tb.arrays
    tc = (_take(base, t0.long()) & RESTBIT).long() + a.long()
    return base[tc.clamp(0, tb.n_cells - 1)] < 0


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
