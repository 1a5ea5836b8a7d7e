"""Foma FST file parser.

Parses the gzipped Foma text format (``##props##`` / ``##sigma##`` /
``##states##`` sections) into the intermediate :class:`Automaton`,
replicating the exact semantics of the reference parser
(the reference's fomafile.go:77-450), including:

  * validation that the FST is deterministic and epsilon-free
    (fomafile.go:158-165),
  * the +1 shift of every state and symbol id so 0 = fail
    (fomafile.go:285-289),
  * special sigma symbols ``@_EPSILON_SYMBOL_@``, ``@_UNKNOWN_SYMBOL_@``,
    ``@_IDENTITY_SYMBOL_@``, ``@_TOKEN_BOUND_@`` (and the deprecated
    ``@_TOKEN_SYMBOL_@``) (fomafile.go:397-427),
  * arc classification into char / nontoken / tokenend arcs and the
    rejection of unsupported transitions (fomafile.go:292-323),
  * the extra ``final`` pseudo-symbol column added when the states
    section begins (fomafile.go:118-121),
  * persistence of the per-state ``state``/``final`` fields across
    continuation arc lines (foma lists subsequent arcs of a state
    without repeating the state id),
  * the two-line encoding of a literal newline sigma symbol and the
    skipping of unsupported multi-char symbols (MCS).
"""

from __future__ import annotations

import gzip
from typing import Iterator

from .automaton import Automaton, Edge

_PROPS, _SIGMA, _STATES, _NONE = 1, 2, 3, 4


class FomaError(ValueError):
    """Raised when a Foma file violates the tokenizer conventions."""


def load_foma_file(path: str) -> Automaton:
    """Load a gzipped Foma FST file (fomafile.go:56-72)."""
    with gzip.open(path, "rb") as f:
        return parse_foma(f)


def _complete_lines(data: bytes) -> Iterator[str]:
    """Yield complete (newline-terminated) lines, with the newline.

    The reference reads with ``ReadString('\\n')`` and treats EOF with a
    partial final line as end of input, discarding the fragment.
    """
    start = 0
    while True:
        nl = data.find(b"\n", start)
        if nl < 0:
            return
        yield data[start : nl + 1].decode("utf-8")
        start = nl + 1


def parse_foma(f) -> Automaton:
    """Parse a Foma text FST from a binary file object."""
    data = f.read()
    auto = Automaton()
    lines = _complete_lines(data)

    mode = 0
    # These persist across arc lines: continuation lines omit the state
    # (and its final flag), which therefore carry over (fomafile.go:188-280).
    state = in_sym = out_sym = end = final = 0

    for line in lines:
        if line.startswith("##"):
            if line.startswith("##props##"):
                mode = _PROPS
            elif line.startswith("##states##"):
                mode = _STATES
                # Add the final-transition pseudo symbol, '#' in
                # Mizobuchi et al (2000) (fomafile.go:118-121).
                auto.sigma_count += 1
                auto.final = auto.sigma_count
            elif line.startswith("##sigma##"):
                mode = _SIGMA
            elif line.startswith("##end##"):
                mode = _NONE
            elif not line.startswith("##foma-net"):
                # Unknown input line: reference logs and stops parsing.
                break
            continue

        if mode == _PROPS:
            elem = line.split(" ")
            # fields: arity arccount statecount linecount finalcount
            # pathcount is_deterministic is_pruned is_minimized
            # is_epsilon_free is_loop_free extras name
            if elem[6] != "1":
                raise FomaError("The FST needs to be deterministic")
            if elem[9] != "1":
                raise FomaError("The FST needs to be epsilon free")
            auto.arc_count = int(elem[1])
            # States start at 1 (state 0 = fail), so allocate one extra.
            auto.state_count = int(elem[2])
            auto.transitions = [None] * (auto.state_count + 1)
            continue

        if mode == _STATES:
            elem = line[:-1].split(" ")
            if elem[0] == "-1":
                continue
            vals = [int(x) for x in elem[:5]]

            n = len(elem)
            if n == 5:
                state, in_sym, out_sym, end, final = vals
            elif n == 4:
                if vals[1] == -1:
                    # Final state without outgoing edges.
                    state, final = vals[0], vals[3]
                    if final == 1:
                        if auto.transitions[state + 1] is None:
                            auto.transitions[state + 1] = {}
                        auto.transitions[state + 1][auto.final] = Edge(0, 0, 0)
                    continue
                state, in_sym, end, final = vals
                out_sym = in_sym
            elif n == 3:
                in_sym, out_sym, end = vals
            elif n == 2:
                in_sym, end = vals
                out_sym = in_sym

            nontoken = False
            tokenend = False

            # +1 shift: no 0 states / 0 symbols (fomafile.go:285-289).
            isym = in_sym + 1
            osym = out_sym + 1

            if isym != osym:
                if osym == auto.tokenend and isym == auto.epsilon:
                    tokenend = True
                elif osym == auto.epsilon:
                    nontoken = True
                else:
                    raise FomaError(
                        "Unsupported transition: %d -> %d (%d:%d)"
                        % (state, end, isym, osym)
                    )
            elif isym == auto.tokenend:
                # Ignore tokenend-accepting arcs.
                continue
            elif isym == auto.epsilon:
                raise FomaError("General epsilon transitions are not supported")
            elif isym in auto._sigma_mcs:
                # Ignore arcs on unsupported multi-char symbols.
                continue

            if auto.transitions[state + 1] is None:
                auto.transitions[state + 1] = {}
            if isym >= 0:
                auto.transitions[state + 1][isym] = Edge(
                    isym, osym, end + 1, nontoken=nontoken, tokenend=tokenend
                )
            if final == 1:
                auto.transitions[state + 1][auto.final] = Edge(0, 0, 0)
            continue

        if mode == _SIGMA:
            elem = line[:-1].split(" ", 1)
            number = int(elem[0]) + 1
            auto.sigma_count = number

            sym_str = elem[1] if len(elem) > 1 else ""
            if len(sym_str) == 1:
                symbol = sym_str
            elif len(sym_str) > 1:
                # Multi-char symbol: special or unsupported.
                if sym_str == "@_EPSILON_SYMBOL_@":
                    auto.epsilon = number
                elif sym_str == "@_UNKNOWN_SYMBOL_@":
                    auto.unknown = number
                elif sym_str == "@_IDENTITY_SYMBOL_@":
                    auto.identity = number
                elif sym_str in ("@_TOKEN_SYMBOL_@", "@_TOKEN_BOUND_@"):
                    auto.tokenend = number
                else:
                    auto._sigma_mcs.add(number)
                continue
            else:
                # Literal newline symbol: the symbol is the newline, so
                # the entry spans two lines; the next line must be "\n".
                nxt = next(lines, None)
                if nxt is None:
                    raise FomaError("Unexpected EOF in sigma")
                if len(nxt) != 1:
                    auto._sigma_mcs.add(number)
                    continue
                symbol = "\n"

            auto.sigma_rev[number] = symbol

    return auto
