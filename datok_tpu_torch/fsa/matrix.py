"""Dense transition-matrix tokenizer representation (``.matok``).

Functional equivalent of the reference's ``MatrixTokenizer``
(the reference's matrix.go): a ``(state_count+1) * sigma_count`` flat
``uint32`` table addressed as ``array[(a-1)*state_count + t0]``, with
``FIRSTBIT`` (1<<31) marking targets of nontoken (character-dropping)
arcs (matrix.go:84-90).  The on-disk ``.matok`` format is byte
compatible (matrix.go:126-337):

    MATOK | version u16 | epsilon u16 | unknown u16 | identity u16 |
    stateCount u32 | sigmaCount u16 | sigma runes (UTF-8, NUL for
    specials) | 'M' | sigmaCount*(stateCount+1) little-endian u32 cells

everything gzipped.
"""

from __future__ import annotations

import struct
from typing import Dict

import numpy as np

from .automaton import Automaton
from .io import (
    FIRSTBIT,
    MAMAGIC,
    VERSION,
    encode_rune,
    gz_read,
    gz_write,
    put_u16,
    put_u32,
    read_rune,
)


class MatrixTokenizer:
    def __init__(self) -> None:
        self.sigma: Dict[int, int] = {}  # codepoint -> symbol id
        self.sigma_ascii = np.zeros(256, dtype=np.int64)
        self.array = np.zeros(0, dtype=np.uint32)
        self.state_count = 0
        self.epsilon = 0
        self.unknown = 0
        self.identity = 0

    # -- identity of the representation ---------------------------------
    def type(self) -> str:
        return "MATOK"

    # -- compilation from the intermediate automaton --------------------
    @classmethod
    def from_automaton(cls, auto: Automaton) -> "MatrixTokenizer":
        """Lower an :class:`Automaton` to the dense matrix (matrix.go:30-99).

        Cells are filled by a traversal from state 1; unreachable states
        stay all-zero.  Arcs on the ``final`` pseudo-symbol carry target
        0 and are skipped (their writes are no-ops in the reference).
        """
        mat = cls()
        mat.unknown = auto.unknown
        mat.identity = auto.identity
        mat.epsilon = auto.epsilon
        mat.state_count = auto.state_count

        mx = 0
        if mat.identity != -1:
            mat.sigma_ascii[:] = mat.identity
            mx = mat.identity

        for num, sym in auto.sigma_rev.items():
            cp = ord(sym)
            if cp < 256:
                mat.sigma_ascii[cp] = num
            mat.sigma[cp] = num
            if num > auto.sigma_count:
                raise ValueError("sigmaCount is smaller")
            if num > mx:
                mx = num

        sc = auto.state_count
        mat.array = np.zeros((sc + 1) * (mx + 1), dtype=np.uint32)

        seen = np.zeros(sc + 2, dtype=bool)
        stack = [1]
        while stack:
            start = stack.pop()
            if start > sc:
                raise ValueError("stateCount is smaller")
            if seen[start]:
                continue
            seen[start] = True
            trans = auto.transitions[start] or {}
            for alpha, e in trans.items():
                if alpha == auto.final:
                    # final pseudo-arc: end == 0, write would be a no-op
                    continue
                cell = e.end
                if e.nontoken:
                    cell |= FIRSTBIT
                mat.array[(alpha - 1) * sc + start] = cell
                if not seen[e.end]:
                    stack.append(e.end)
        return mat

    # -- serialization ---------------------------------------------------
    def to_bytes(self) -> bytes:
        """Serialize to raw (un-gzipped) ``.matok`` bytes (matrix.go:126-210)."""
        out = bytearray()
        out += MAMAGIC

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
        put_u32(out, self.state_count)
        put_u16(out, len(sigmalist))
        for cp in sigmalist:
            out += encode_rune(cp)
        out += b"M"
        out += np.ascontiguousarray(self.array, dtype="<u4").tobytes()
        return bytes(out)

    def save(self, path: str) -> None:
        gz_write(path, self.to_bytes())

    @classmethod
    def from_bytes(cls, data: bytes) -> "MatrixTokenizer":
        return parse_matrix(data)

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


def parse_matrix(data: bytes) -> MatrixTokenizer:
    """Parse raw (un-gzipped) ``.matok`` bytes (matrix.go:235-337)."""
    if data[:5] != MAMAGIC:
        raise ValueError("Not a matok file")
    off = 5
    (version, epsilon, unknown, identity) = struct.unpack_from("<HHHH", data, off)
    off += 8
    (state_count,) = struct.unpack_from("<I", data, off)
    off += 4
    (sigma_count,) = struct.unpack_from("<H", data, off)
    off += 2
    if version != VERSION:
        raise ValueError("Version not compatible")

    mat = MatrixTokenizer()
    mat.epsilon = epsilon
    mat.unknown = unknown
    mat.identity = identity
    mat.state_count = state_count
    array_size = (state_count + 1) * sigma_count

    # identity read as u16 is never -1; the init always runs, exactly
    # like the reference's loader (matrix.go:289-293).
    if mat.identity != -1:
        mat.sigma_ascii[:] = mat.identity

    for x in range(sigma_count):
        cp, off = read_rune(data, off)
        if cp != 0:
            if cp < 256:
                mat.sigma_ascii[cp] = x
            mat.sigma[cp] = x

    if data[off : off + 1] != b"M":
        raise ValueError("Not a matok file")
    off += 1

    body = data[off : off + array_size * 4]
    if len(body) < array_size * 4:
        raise ValueError("Not enough bytes read")
    mat.array = np.frombuffer(body, dtype="<u4").astype(np.uint32)
    return mat


def load_matrix_file(path: str) -> MatrixTokenizer:
    return parse_matrix(gz_read(path))
