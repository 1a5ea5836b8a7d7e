"""Double-array tokenizer representation (``.datok``).

Functional equivalent of the reference's ``DaTokenizer``
(the reference's datok.go): a base/check array per Aoe (1989) /
Mizobuchi et al. (2000) with per-cell flag bits

  * ``base & FIRSTBIT``  — separate state: base points at a
    representative state instead of a slot block (datok.go:286-297),
  * ``check & FIRSTBIT`` — target of a nontoken arc (datok.go:300-311),
  * ``check & SECONDBIT``— target of a tokenend arc (datok.go:314-325),

and the array size stored in ``check(1)`` (datok.go:328-335).  The
on-disk ``.datok`` format is byte compatible (datok.go:502-729):

    DATOK | version u16 | epsilon u16 | unknown u16 | identity u16 |
    final u16 | sigmaCount u16 | arraySize*2 u32 (legacy) | sigma runes |
    'T' | interleaved (base u32, check u32) little-endian pairs

everything gzipped.

Construction note: the reference finds free slots with a linear
first-fit scan plus the Morita/Niu skip heuristic
(``xCheckSkipNiu``, datok.go:381-401).  We keep the same placement
*policy* (first fit from 1; skip to 0.9*maxSize for outdegree >= 3) but
search with vectorized windows and a first-free pointer, which is
orders of magnitude faster and yields the same load-factor class.  The
reference's own cell layout is nondeterministic (Go map iteration
order), so layout parity is neither possible nor required — behavioral
equivalence is (verified by transduce parity tests).
"""

from __future__ import annotations

import struct
from typing import Dict, List

import numpy as np

from .automaton import Automaton
from .io import (
    DAMAGIC,
    FIRSTBIT,
    RESTBIT,
    SECONDBIT,
    VERSION,
    encode_rune,
    gz_read,
    gz_write,
    put_u16,
    put_u32,
    read_rune,
)


class DaTokenizer:
    def __init__(self) -> None:
        self.sigma: Dict[int, int] = {}  # codepoint -> symbol id
        self.sigma_ascii = np.zeros(256, dtype=np.int64)
        self.base = np.zeros(0, dtype=np.uint32)
        self.check = np.zeros(0, dtype=np.uint32)
        self.max_size = 0
        self._trans_count = -1
        self.epsilon = 0
        self.unknown = 0
        self.identity = 0
        self.final = 0
        self.tokenend = 0

    def type(self) -> str:
        return "DATOK"

    def __len__(self) -> int:
        return len(self.base)

    # -- compilation from the intermediate automaton --------------------
    @classmethod
    def from_automaton(cls, auto: Automaton) -> "DaTokenizer":
        """Lower an :class:`Automaton` to base/check (datok.go:82-236).

        BFS over (source, target) mappings per Mizobuchi et al. (2000)
        p.128; duplicate targets collapse to a representative via the
        separate bit (datok.go:200-214).
        """
        dat = cls()
        dat.final = auto.final
        dat.unknown = auto.unknown
        dat.identity = auto.identity
        dat.epsilon = auto.epsilon
        dat.tokenend = auto.tokenend

        if dat.identity != -1:
            dat.sigma_ascii[:] = dat.identity
        for num, sym in auto.sigma_rev.items():
            cp = ord(sym)
            if cp < 256:
                dat.sigma_ascii[cp] = num
            dat.sigma[cp] = num

        final = auto.final
        try:  # native C++ builder: same placement, Go-class speed
            from ..utils.native import native_da_build

            r = native_da_build(auto)
        except Exception:
            r = None
        if r is not None:
            dat.base, dat.check = r
            dat.max_size = len(dat.base) - final
            return dat

        cap = max(1024, final + 2)
        base = np.zeros(cap, dtype=np.uint32)
        check = np.zeros(cap, dtype=np.uint32)
        occ = np.zeros(cap, dtype=bool)  # check-cell occupancy
        first_free = 1

        def ensure(n: int) -> None:
            nonlocal cap, base, check, occ
            if n >= cap:
                ncap = max(n + 1, cap * 2)
                base = np.resize(base, ncap)
                base[cap:] = 0
                check = np.resize(check, ncap)
                check[cap:] = 0
                occ = np.resize(occ, ncap)
                occ[cap:] = False
                cap = ncap

        def find_base(A: List[int]) -> int:
            nonlocal first_free
            amin = A[0]
            amax = A[-1]
            if len(A) >= 3:
                b = int(abs((dat.max_size - 1) * 0.9)) + 1
            else:
                while first_free < cap and occ[first_free]:
                    first_free += 1
                b = max(1, first_free - amin)
            CH = 2048
            while True:
                ensure(b + CH + amax + final + 1)
                ok = ~occ[b + amin : b + amin + CH]
                for a in A[1:]:
                    ok = ok & ~occ[b + a : b + a + CH]
                nz = np.flatnonzero(ok)
                if len(nz):
                    return b + int(nz[0])
                b += CH

        # BFS queue of (source-in-Ms, target-in-Mt) mappings
        srcs = [1]
        tgts = [1]
        lookup = {1: 1}
        mark = 0
        while mark < len(srcs):
            s = srcs[mark]
            t = tgts[mark]
            mark += 1
            A = auto.get_set(s)
            # Empty symbol set: the reference's xCheck returns base 1.
            b = find_base(A) if A else 1
            base[t] = np.uint32(b)
            trans = auto.transitions[s] or {}
            for a in A:
                t1 = b + a
                if a != final:
                    e = trans[a]
                    s1 = e.end
                    cell = t
                    if e.nontoken:
                        cell |= FIRSTBIT
                    if e.tokenend:
                        cell |= SECONDBIT
                    check[t1] = np.uint32(cell)
                    occ[t1] = True
                    if dat.max_size < t1:
                        dat.max_size = t1
                    r = lookup.get(s1, 0)
                    if r == 0:
                        lookup[s1] = t1
                        srcs.append(s1)
                        tgts.append(t1)
                    else:
                        # Overwrite with the representative state
                        base[t1] = np.uint32(r | FIRSTBIT)
                else:
                    check[t1] = np.uint32(t)
                    occ[t1] = True
                    if dat.max_size < t1:
                        dat.max_size = t1

        n = dat.max_size + final
        ensure(n)
        dat.base = base[:n].copy()
        dat.check = check[:n].copy()
        # Size of the FSA stored in check(1) (datok.go:230, 328-335).
        dat.check[1] = np.uint32(n)
        return dat

    # -- accessors mirroring the bit layout ------------------------------
    def get_size(self) -> int:
        return int(self.check[1] & RESTBIT)

    def trans_count(self) -> int:
        """Number of non-empty base cells (datok.go:458-474)."""
        if self._trans_count > 0:
            return self._trans_count
        self._trans_count = int(np.count_nonzero(self.base[1:] & RESTBIT))
        return self._trans_count

    def load_factor(self) -> float:
        """Kanda et al. (2018) non-empty ratio (datok.go:478-480)."""
        return self.trans_count() / len(self.base) * 100

    def outgoing(self, t: int):
        """List valid outgoing symbol ids of a state, negated for the
        special symbols — debug introspection (datok.go:433-454)."""
        size = self.get_size()
        base_t = int(self.base[t] & RESTBIT)
        valid = []
        for a in self.sigma.values():
            t1 = base_t + a
            if t1 <= size and t1 < len(self.check) and int(self.check[t1] & RESTBIT) == t:
                valid.append(a)
        for a in (self.epsilon, self.unknown, self.identity, self.final):
            t1 = base_t + a
            if t1 <= size and t1 < len(self.check) and int(self.check[t1] & RESTBIT) == t:
                valid.append(-a)
        return sorted(valid)

    # -- representation conversion ---------------------------------------
    def to_matrix(self):
        """Derive the dense-matrix representation from base/check.

        States are the DA slots reachable from the root slot 1,
        renumbered densely in BFS discovery order; separate states
        resolve through their representative before numbering
        (datok.go:1056-1063), and the nontoken flag moves from the
        check word (datok.go:300-311) to the matrix cell's FIRSTBIT
        (matrix.go:84-90).  The tokenend SECONDBIT is not carried —
        no transduce path reads it (boundaries are ε-driven).

        Runtime-equivalent by construction (transduce parity is
        pinned by tests); this is what lets ``.datok`` models ride
        the fused-kernel TPU engine, which wants the dense layout.

        Load-time cost, measured on the committed DE model (2,887,688
        bc-pairs, datok.go:82-236 layout): 0.62 s and ~160 MB extra
        peak RSS (int64 base/check casts, 16 B/pair, plus the 12.5 MB
        dense table) on top of the 115 ms / 231 MB ``.datok`` load.
        Cost scales with bc-pairs (the casts) and reachable_states ×
        sigma (the BFS + dense table), so prefer the DA-general
        machine over conversion when the dense table 4·(S+1)·A bytes
        would not comfortably fit HBM alongside the batch, or when a
        sub-second model load matters more than per-byte throughput.
        """
        from .matrix import MatrixTokenizer

        mat = MatrixTokenizer()
        mat.unknown = self.unknown
        mat.identity = self.identity
        mat.epsilon = self.epsilon
        mat.sigma = dict(self.sigma)
        mat.sigma_ascii = self.sigma_ascii.copy()

        size = self.get_size()
        base = self.base.astype(np.int64)
        check = self.check.astype(np.int64)
        syms = sorted(
            set(self.sigma.values())
            | {s for s in (self.epsilon, self.unknown, self.identity) if s > 0}
        )
        mx = max(syms) if syms else 0

        # Frontier-vectorized BFS (the scalar per-state-per-symbol loop
        # took 3.5 s on the committed DE model: 18,266 states × 171
        # symbols).  Discovery order is identical to the nested loop —
        # np.nonzero over the (frontier, symbols) validity matrix is
        # row-major, i.e. (state order, symbol order) — so the dense
        # renumbering is unchanged.
        syms_a = np.asarray(syms, dtype=np.int64)
        n_cells = len(check)
        id_of = np.zeros(n_cells, dtype=np.int64)  # slot → dense (0 = unseen)
        id_of[1] = 1
        n_assigned = 1
        a_src: list = []
        a_sym: list = []
        a_tgt: list = []
        a_nt: list = []
        frontier = np.array([1], dtype=np.int64)
        while frontier.size:
            b = base[frontier] & RESTBIT
            tc = b[:, None] + syms_a[None, :]
            ok = (tc <= size) & (tc < n_cells)
            tcc = np.clip(tc, 0, n_cells - 1)
            ok &= (check[tcc] & RESTBIT) == frontier[:, None]
            src_i, sym_i = np.nonzero(ok)  # row-major = discovery order
            t1 = tcc[src_i, sym_i]
            nt = (check[t1] & FIRSTBIT) != 0
            sep = (base[t1] & FIRSTBIT) != 0
            tgt = np.where(sep, base[t1] & RESTBIT, t1)
            unseen = id_of[tgt] == 0
            if unseen.any():
                ut = tgt[unseen]
                # new slots by first occurrence in discovery order
                _, first = np.unique(ut, return_index=True)
                new_slots = ut[np.sort(first)]
                id_of[new_slots] = np.arange(
                    n_assigned + 1, n_assigned + 1 + len(new_slots)
                )
                n_assigned += len(new_slots)
            else:
                new_slots = np.empty(0, dtype=np.int64)
            a_src.append(id_of[frontier[src_i]])
            a_sym.append(syms_a[sym_i])
            a_tgt.append(id_of[tgt])
            a_nt.append(nt)
            frontier = new_slots
        S = n_assigned
        mat.state_count = S
        mat.array = np.zeros((S + 1) * (mx + 1), dtype=np.uint32)
        if a_src:
            src = np.concatenate(a_src)
            sym = np.concatenate(a_sym)
            tgt_id = np.concatenate(a_tgt).astype(np.uint32)
            nt = np.concatenate(a_nt)
            mat.array[(sym - 1) * S + src] = tgt_id | np.where(
                nt, np.uint32(FIRSTBIT), np.uint32(0)
            )
        return mat

    # -- serialization ---------------------------------------------------
    def to_bytes(self) -> bytes:
        out = bytearray()
        out += DAMAGIC

        mx = 0
        for num in self.sigma.values():
            if num > mx:
                mx = num
        sigmalist = [0] * (mx + 1)
        for cp, num in self.sigma.items():
            sigmalist[num] = cp

        put_u16(out, VERSION)
        put_u16(out, self.epsilon)
        put_u16(out, self.unknown)
        put_u16(out, self.identity)
        put_u16(out, self.final)
        put_u16(out, len(sigmalist))
        put_u32(out, len(self.base) * 2)  # legacy field
        for cp in sigmalist:
            out += encode_rune(cp)
        out += b"T"
        inter = np.empty((len(self.base), 2), dtype="<u4")
        inter[:, 0] = self.base
        inter[:, 1] = self.check
        out += inter.tobytes()
        return bytes(out)

    def save(self, path: str) -> None:
        gz_write(path, self.to_bytes())

    # -- convenience transduction (scalar oracle path) -------------------
    def transduce(self, text: str, writer=None) -> str:
        from ..runtime.oracle import transduce as _transduce

        return _transduce(self, text, writer)

    def tokenize(self, text: str, flags=None) -> str:
        from ..runtime.oracle import transduce as _transduce
        from ..runtime.writer import SIMPLE, TokenWriter

        w = TokenWriter(SIMPLE if flags is None else flags)
        _transduce(self, text, w)
        return w.getvalue()


def parse_datok(data: bytes) -> DaTokenizer:
    """Parse raw (un-gzipped) ``.datok`` bytes (datok.go:621-729)."""
    if data[:5] != DAMAGIC:
        raise ValueError("Not a datok file")
    off = 5
    (version, epsilon, unknown, identity, final, sigma_count) = struct.unpack_from(
        "<HHHHHH", data, off
    )
    off += 12
    (array_size2,) = struct.unpack_from("<I", data, off)
    off += 4
    if version != VERSION:
        raise ValueError("Version not compatible")
    array_size = array_size2 // 2  # legacy doubling

    dat = DaTokenizer()
    dat.epsilon = epsilon
    dat.unknown = unknown
    dat.identity = identity
    dat.final = final
    dat.max_size = array_size - 1

    if dat.identity != -1:
        dat.sigma_ascii[:] = dat.identity

    for x in range(sigma_count):
        cp, off = read_rune(data, off)
        if cp != 0:
            if cp < 256:
                dat.sigma_ascii[cp] = x
            dat.sigma[cp] = x

    if data[off : off + 1] != b"T":
        raise ValueError("Not a datok file")
    off += 1

    body = data[off : off + array_size * 8]
    if len(body) < array_size * 8:
        raise ValueError("Not enough bytes read")
    pairs = np.frombuffer(body, dtype="<u4").reshape(array_size, 2)
    dat.base = pairs[:, 0].astype(np.uint32)
    dat.check = pairs[:, 1].astype(np.uint32)
    return dat


def load_datok_file(path: str) -> DaTokenizer:
    return parse_datok(gz_read(path))
