"""Seeded Datok-convention tokenizer models and texts, built from code.

The reference models (``tokenizer_de.matok`` and its twins) are not
part of the repository, so the port's tests and its smoke run build a
model of the same shape here.  The model follows the Datok grammar
conventions (Readme.md:106-124, SURVEY.md §0): character arcs map to
themselves or to ε (nontoken whitespace), ε-input arcs are token
bounds, two consecutive bounds end a sentence, and ``\\x04`` ends a
text.  Its paths reach every branch of the transduce step:

* word, number, punctuation and sentence-punctuation states with ε
  token bounds, and a double bound after ``. ! ? …``;
* an abbreviation trie (``bzw.``, ``z.B.``): a word followed by ``.``
  that is not an abbreviation backtracks to the last token end (f2);
* states without an ε arc (``-`` before a letter, ``3.`` before a
  space) force-emit their buffer (f3), and an identity character at
  the root after a known non-ASCII one (stale ``ok``) force-emits an
  empty buffer (the f3 bump);
* characters outside sigma reach the identity arc inside words and
  the identity→unknown retry (f1) at the root;
* Latin-1 letters ride the ASCII path, and ``œ € „`` are non-ASCII
  symbols that set ``ok``;
* the word state self-loops on every letter, so the run skip takes
  whole runs of lowercase letters in it.  With ``genitive=True`` words
  that leave the root or the abbreviation trie go to one of
  :data:`N_GENITIVE` word states that self-loop on every letter but
  ``s``, which leads to a genitive state, as the DE grammar routes
  ``s``: the skip class then drops ``s``.

The matrix has 171 symbol columns, like the DE model's.  With
:data:`DE_N_ABBREV` abbreviations it has about 18,400 states, 12.6 MB
of u32 cells (BASELINE.md:18).
"""

from __future__ import annotations

import random
from typing import List, Sequence, Union

from ..fsa.automaton import Automaton, Edge
from ..fsa.double_array import DaTokenizer
from ..fsa.matrix import MatrixTokenizer

EPS, UNKNOWN, IDENTITY, TOKENEND = 1, 2, 3, 4
N_COLUMNS = 171  # symbol columns of the DE model's matrix
DE_N_ABBREV = 5945  # abbreviations that bring the state count to DE's
N_GENITIVE = 6  # word states of the genitive option that loop on all but s

_LOWER = "abcdefghijklmnopqrstuvwxyz"
_UPPER = _LOWER.upper()
_DIGITS = "0123456789"
_WS = " \n\t"
_EOT = "\x04"
_SENT = ".!?"
_PUNCT = ",;:\"'()[]{}/\\&%$#@*+=<>|_"
_NONASCII_LETTERS = "œłšžč"
_NONASCII_PUNCT = "€–„“”…"
_FIXED = (
    _LOWER + _UPPER + _DIGITS + _WS + _EOT + _SENT + "-" + _PUNCT
    + _NONASCII_LETTERS + _NONASCII_PUNCT
)
# Latin-1 letters fill sigma up to the DE model's column count; the
# last two (þ, ÿ) stay outside and map to the identity symbol
_LATIN1 = "".join(
    chr(c) for c in range(0xC0, 0x100) if c not in (0xD7, 0xF7)
)[: N_COLUMNS - 1 - TOKENEND - len(_FIXED)]
SIGMA = _FIXED + _LATIN1
LETTERS = _LOWER + _UPPER + _LATIN1 + _NONASCII_LETTERS
# characters the model does not know (ASCII-range ones read as the
# identity symbol without touching ``ok``; the others clear ``ok``)
OUTSIDE = "~^`¤×þ→中😀"

_COMMON = ("bzw", "z.B", "Abk", "Weststr", "usw", "Dr", "Nr", "ca", "vgl",
           "etc", "Mio", "Jan", "Prof", "d.h", "u.a")

# fixed states; trie nodes follow
(ROOT, WORD, HYPHEN, NUM, NUM_SEP, NUM_FRAC, PUNCT, SENT, SENT2, DASH,
 DASH2, UNK, ABBR_END) = range(1, 14)
_N_FIXED = 13


def _abbreviations(n: int, rng: random.Random) -> List[str]:
    out = set(_COMMON[:n])
    while len(out) < n:
        if rng.random() < 0.15:  # dotted, like "z.B" or "u.a.m"
            s = ".".join(rng.choice(_LOWER + _UPPER)
                         for _ in range(rng.randint(2, 3)))
        else:
            s = rng.choice(_UPPER if rng.random() < 0.5 else _LOWER) + "".join(
                rng.choice(_LOWER) for _ in range(rng.randint(1, 7))
            )
        out.add(s)
    return sorted(out)


def synth_automaton(n_abbrev: int, seed: int = 0, eot: bool = True,
                    genitive: bool = False):
    """The model as an :class:`Automaton`, plus its abbreviation list.

    ``eot=False`` leaves ``\\x04`` out of sigma (one column fewer): it
    then reads as the identity symbol, inside words and at the root,
    like any other character the model does not know.  ``genitive``
    adds the genitive word states (module docstring) after the trie's."""
    rng = random.Random(seed)
    abbrevs = _abbreviations(n_abbrev, rng)
    abbrev_set = set(abbrevs)
    prefixes = sorted({a[:i] for a in abbrevs for i in range(1, len(a) + 1)})
    node = {p: _N_FIXED + 1 + i for i, p in enumerate(prefixes)}

    sigma = SIGMA if eot else SIGMA.replace(_EOT, "")
    sym = {ch: TOKENEND + 1 + i for i, ch in enumerate(sigma)}
    S = _N_FIXED + len(prefixes)
    gen_words = []
    if genitive:
        gen_words = list(range(S + 1, S + 1 + N_GENITIVE))
        S += N_GENITIVE + 1  # the word states, then the genitive state

    def word(key: str) -> int:
        """Where a word goes that leaves the root or the trie."""
        if not gen_words:
            return WORD
        return gen_words[sum(map(ord, key)) % len(gen_words)]

    auto = Automaton()
    auto.epsilon, auto.unknown, auto.identity = EPS, UNKNOWN, IDENTITY
    auto.tokenend = TOKENEND
    auto.final = N_COLUMNS  # no final arcs: Datok ignores final states
    auto.sigma_count = N_COLUMNS
    auto.sigma_rev = {v: ch for ch, v in sym.items()}
    auto.state_count = S
    trans = [None] + [dict() for _ in range(S + 1)]
    auto.transitions = trans

    edges = {}

    def arc(src, a, dst, nontoken=False):
        key = (a, dst, nontoken)
        e = edges.get(key)
        if e is None:
            if a == EPS:
                e = Edge(EPS, TOKENEND, dst, tokenend=True)
            else:
                e = Edge(a, a, dst, nontoken=nontoken)
            edges[key] = e
        trans[src][a] = e

    def chars(src, cs, dst):
        for ch in cs:
            arc(src, sym[ch], dst)

    for ch in _WS + (_EOT if eot else ""):
        arc(ROOT, sym[ch], ROOT, nontoken=True)
    for ch in LETTERS:
        arc(ROOT, sym[ch], node.get(ch, word(ch)))
    chars(ROOT, _DIGITS, NUM)
    chars(ROOT, _PUNCT + _NONASCII_PUNCT[:-1], PUNCT)
    chars(ROOT, _SENT + "…", SENT)
    chars(ROOT, "-", DASH)
    arc(ROOT, UNKNOWN, UNK)

    chars(WORD, LETTERS, WORD)
    arc(WORD, IDENTITY, WORD)
    chars(WORD, "-", HYPHEN)
    arc(WORD, EPS, ROOT)
    chars(HYPHEN, LETTERS, WORD)

    chars(NUM, _DIGITS, NUM)
    chars(NUM, ".,:", NUM_SEP)
    arc(NUM, EPS, ROOT)
    chars(NUM_SEP, _DIGITS, NUM_FRAC)
    chars(NUM_FRAC, _DIGITS, NUM_FRAC)
    chars(NUM_FRAC, ".,:", NUM_SEP)
    arc(NUM_FRAC, EPS, ROOT)

    arc(PUNCT, EPS, ROOT)
    chars(SENT, _SENT + "…", SENT)
    arc(SENT, EPS, SENT2)  # two bounds in a row: sentence end
    arc(SENT2, EPS, ROOT)
    chars(DASH, "-", DASH2)
    chars(DASH, _DIGITS, NUM)
    chars(DASH2, "-", DASH2)
    arc(DASH2, EPS, ROOT)
    arc(UNK, EPS, ROOT)
    arc(ABBR_END, EPS, ROOT)

    for p, s in node.items():
        if p.endswith("."):
            for ch in LETTERS:
                if p + ch in node:
                    arc(s, sym[ch], node[p + ch])
            if p[:-1] in abbrev_set:
                arc(s, EPS, ROOT)
            continue
        for ch in LETTERS:
            arc(s, sym[ch], node.get(p + ch, word(p + ch)))
        if p + "." in node:
            arc(s, sym["."], node[p + "."])
        elif p in abbrev_set:
            arc(s, sym["."], ABBR_END)
        arc(s, IDENTITY, WORD)
        chars(s, "-", HYPHEN)
        arc(s, EPS, ROOT)
    if gen_words:
        gen = S
        for s in gen_words:
            for ch in LETTERS:
                arc(s, sym[ch], gen if ch == "s" else s)
        chars(gen, LETTERS, WORD)
        for s in gen_words + [gen]:
            arc(s, IDENTITY, WORD)
            chars(s, "-", HYPHEN)
            arc(s, EPS, ROOT)
    return auto, abbrevs


def synth_tokenizer(n_abbrev: int = DE_N_ABBREV, seed: int = 0,
                    eot: bool = True, genitive: bool = False
                    ) -> MatrixTokenizer:
    """Deterministic matrix model; ``tok.abbrevs`` holds its vocabulary.
    ``eot=False`` builds it without ``\\x04`` in sigma; ``genitive``
    with the genitive word states (the skip class drops ``s``)."""
    auto, abbrevs = synth_automaton(n_abbrev, seed, eot, genitive)
    tok = MatrixTokenizer.from_automaton(auto)
    tok.abbrevs = abbrevs
    return tok


def synth_datok(n_abbrev: int, seed: int = 0) -> DaTokenizer:
    """The double-array twin of :func:`synth_tokenizer` (same seed)."""
    auto, abbrevs = synth_automaton(n_abbrev, seed)
    tok = DaTokenizer.from_automaton(auto)
    tok.abbrevs = abbrevs
    return tok


def _word(rng: random.Random) -> str:
    n = rng.randint(1, 10)
    pool = _LOWER if rng.random() < 0.8 else LETTERS
    w = "".join(rng.choice(pool) for _ in range(n))
    if rng.random() < 0.3:
        w = rng.choice(_UPPER) + w
    r = rng.random()
    if r < 0.05:
        w += "-" + _word(rng)
    elif r < 0.08:
        i = rng.randint(0, len(w))
        w = w[:i] + rng.choice(OUTSIDE) + w[i:]
    return w


def _piece(rng: random.Random, abbrevs: Sequence[str]) -> str:
    r = rng.random()
    if r < 0.40:
        return _word(rng)
    if r < 0.55 and abbrevs:
        a = rng.choice(abbrevs)
        k = rng.random()
        if k < 0.7:
            return a + "."
        if k < 0.85:
            return a
        return a[: rng.randint(1, len(a))] + "."
    if r < 0.65:
        return rng.choice([
            str(rng.randint(0, 99999)),
            f"{rng.randint(0, 99)},{rng.randint(0, 99):02d}",
            f"{rng.randint(1, 31)}.{rng.randint(1, 12)}.{rng.randint(1900, 2030)}",
            f"{rng.randint(0, 23)}:{rng.randint(0, 59):02d}",
            f"-{rng.randint(0, 99)}",
            f"{rng.randint(0, 99)}.",
        ])
    if r < 0.78:
        return rng.choice([
            rng.choice(_PUNCT + _NONASCII_PUNCT),
            "--", "-" + _word(rng), "...", "!!!", "?", "…",
        ])
    if r < 0.82:
        return rng.choice(OUTSIDE)
    return _word(rng) + rng.choice(".!?")


def synth_text(tok, n_docs: int, lengths: Union[int, Sequence[int]],
               seed: int = 0) -> List[str]:
    """``n_docs`` documents of exactly ``lengths`` characters (one int
    for all, or one per document), built from the model's vocabulary
    (``tok.abbrevs``) with numbers, punctuation, ``\\x04`` separators
    and a few characters outside sigma."""
    rng = random.Random(seed)
    abbrevs = getattr(tok, "abbrevs", ())
    if isinstance(lengths, int):
        lengths = [lengths] * n_docs
    if len(lengths) != n_docs:
        raise ValueError(f"{len(lengths)} lengths for {n_docs} documents")
    docs = []
    for n in lengths:
        parts: List[str] = []
        size = 0
        while size < n:
            p = _piece(rng, abbrevs)
            r = rng.random()
            if r < 0.03:
                p += rng.choice(["\x04", ".\x04\n", "\x04\n"])
            elif r < 0.13:
                p += rng.choice(["\n", "\t", "  ", ""])
            else:
                p += " "
            parts.append(p)
            size += len(p)
        docs.append("".join(parts)[:n])
    return docs
