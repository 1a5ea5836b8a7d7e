"""Intermediate automaton representation.

Mirrors the semantics of the reference's intermediate IR
(``Automaton`` in the reference's fomafile.go:21-51): a deterministic,
epsilon-free FST whose states and symbol ids are shifted by +1 so that
0 means "fail" / "no transition" (fomafile.go:285-289).

Arcs carry two classification flags derived from the Datok tokenizer
conventions (Readme.md:106-124):

  * ``nontoken`` — the arc maps a character to epsilon output (ignored
    character, e.g. whitespace); the *target state* of such an arc is
    flagged so that leading non-word characters are dropped from token
    surfaces (fomafile.go:292-323).
  * ``tokenend`` — an epsilon-input arc whose output is the
    ``@_TOKEN_BOUND_@`` symbol; traversal marks a token boundary.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Set


@dataclass
class Edge:
    in_sym: int
    out_sym: int
    end: int  # target state (1-based; 0 = fail)
    nontoken: bool = False
    tokenend: bool = False


@dataclass
class Automaton:
    """Deterministic epsilon-free FST in tokenizer convention.

    ``transitions[state][in_sym] -> Edge`` for state in 1..state_count.
    Index 0 is unused (fail state).  The pseudo-symbol ``final`` marks
    final states (an extra "#" column per Mizobuchi et al. 2000; see
    fomafile.go:118-121).
    """

    sigma_rev: Dict[int, str] = field(default_factory=dict)  # sym id -> char
    arc_count: int = 0
    sigma_count: int = 0
    state_count: int = 0
    transitions: List[Optional[Dict[int, Edge]]] = field(default_factory=list)

    # Special symbols in sigma (−1 = undefined)
    epsilon: int = -1
    unknown: int = -1
    identity: int = -1
    final: int = -1
    tokenend: int = -1

    # Unsupported multi-char-symbol ids, live during parsing only
    # (arcs on them are ignored, fomafile.go:319-323).
    _sigma_mcs: Set[int] = field(default_factory=set)

    def get_set(self, s: int) -> List[int]:
        """All outgoing symbol ids of state ``s`` (fomafile.go:488-495).

        Returned sorted for deterministic construction (the reference
        iterates Go map order, which is intentionally random; any order
        is semantically valid, sorted keeps our builds reproducible).
        """
        t = self.transitions[s]
        return sorted(t.keys()) if t else []
