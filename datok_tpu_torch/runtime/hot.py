"""The hot set of K1: which states' rows K1 keeps in shared memory.

``default_profile_texts`` and ``profile_hot_states`` are the JAX
engine's (datok_tpu/runtime/jax_engine.py:1471-1597, with
``_CALIBRATION`` and ``_CALIBRATION_EN``), run on the port's own
oracle.  Asked for one (``BatchEngine(..., hot_size="auto")``), the
engine chooses the hot set once from them, as the JAX engine's default
does, and caps it at what one block's shared memory holds
(:func:`hot_capacity`).

:func:`pack_hot` lays the hot set out for K1 as *tagged cells*: every
nonzero cell of the table keeps its bits (bit 31 the nontoken bit,
bits 0..19 the target's id) and gains the target's hot index + 1 in
bits 20..29 (0 = cold), so that a step learns from the cell it read
whether its next state is hot.  The hot rows are copies of the tagged
table's rows, one after another, which K1 stages into shared memory.
Clearing the tag bits gives back the original cell, so every fetch is
exact for any hot set.  K1's fused boundary reads its consume cell from
the tagged table, whose tag gives the final target's hot index, and the
ε target's hot index from ``hot_of``.
"""

from __future__ import annotations

import json
import os
from typing import List, Optional, Sequence, Tuple

import numpy as np

from ..fsa.io import FIRSTBIT
from .oracle import transduce_events

# tagged cells: bits 20..29 hold the target's hot index + 1
HOT_SHIFT = 20
HOT_TAG_MASK = 0x3FF << HOT_SHIFT
MAX_HOT = (1 << 10) - 1  # the largest hot index + 1 that fits the tag
# shared memory one block of an H100 can take (232,448 bytes)
SMEM_BYTES = 227 * 1024

# Small built-in calibration sample for hot-state profiling (mixed
# German/English with URLs, abbreviations, numbers, EOT, punctuation).
_CALIBRATION = (
    "Der Vorsitzende der Abk. hat z.B. gewählt und bzw. verlor. "
    'Sie sagte: "Es geht mir gut!", daraufhin ging sie zur Weststr. 3. '
    "Gefunden auf https://korap.ids-mannheim.de/?q=Baum und www.wikipedia.org. "
    "Ich bin unter korap@ids-mannheim.de erreichbar, auch am 5.9.2018 um 14:30 Uhr. "
    "Die Preise lagen bei 3,50 Euro bzw. 50.4% — toll!!! Oder etwa nicht??? "
    "Don't they're we'll it's I'm isn't a test? Mr. Smith paid $4.50 on Jan. 3rd. "
    "Dieses verf***** Kleid kostet 3,5 Mio. Euro ... D'dorf Ku'damm M'gladbach.\x04\n"
    "Emoticons ;) :-) T__T und Emojis 😀 sowie Pfeile → und <b>XML</b> &quot; "
    "eine readme.txt zum Herunterladen via ftp://files.example.org/pub/a.zip. "
    "Kupietz und Schmidt (2018): Korpuslinguistik. [2018] war super, oder?\x04"
)


# English-centric calibration twin of _CALIBRATION: clitic splitting
# (n't/'ll/'ve/'re/'s), months, ordinals, honorifics — the EN model's
# hot machinery (src/en/tokenizer.xfst:1-131).
_CALIBRATION_EN = (
    "Don't you think they're ready? We'll've seen it by Jan. 3rd, won't we. "
    "I'm sure it's Mr. Smith's car — he can't park there, shan't he move it? "
    "She'd said: \"You mustn't worry\", but we weren't worried at all. "
    "Prof. Jones et al. published on Feb. 29, 2016 at www.example.com. "
    "The U.S.A. isn't the U.K.; approx. 50.4% agreed vs. 23% who didn't.\x04\n"
    "Visit https://en.wikipedia.org/wiki/Token or mail info@example.org asap. "
    "Cats, dogs etc. cost $4.50 apiece in Oct. — that's a lot, isn't it?\x04"
)


def default_profile_texts(tok) -> List[str]:
    """Calibration corpus for hot-state profiling: the built-in
    samples and the conformance scenarios (``conformance/scenarios.json``
    in the repository, extracted from the reference's test suite), which
    exercise the state machinery real corpora hit.  The JAX function
    also reads the reference's word lists where they are installed; they
    are not part of the repository, and the port does not look for
    them."""
    texts = [_CALIBRATION]
    root = os.path.join(os.path.dirname(__file__), "..", "..")
    scen = os.path.join(root, "conformance", "scenarios.json")
    try:
        with open(scen, encoding="utf-8") as fh:
            data = json.load(fh)
        texts.extend(
            s["input"] for s in data if isinstance(s.get("input"), str)
        )
    except OSError:
        pass
    texts.append(_CALIBRATION_EN)
    return texts


def profile_hot_states(tok, texts: Sequence[str], limit) -> np.ndarray:
    """Rank states by transition-time occupancy over sample texts.

    ``limit`` may be an int or ``"auto"``: auto sizes the hot set to
    cover 98.5% of profiled transitions, rounded up to a multiple of 128
    and kept within 384..640 (the JAX engine's rule for its TPU kernel;
    :func:`hot_capacity` caps it for K1).  The root comes first; states
    the texts never visit fill the set breadth-first from the root.
    """
    counter = {}
    for text in texts:
        transduce_events(tok, text, state_counter=counter)
    ranked = [s for s, _ in sorted(counter.items(), key=lambda kv: -kv[1])]
    if limit == "auto":
        total = sum(counter.values()) or 1
        cum = 0
        need = len(ranked)
        for i, st in enumerate(ranked):
            cum += counter[st]
            if cum >= 0.985 * total:
                need = i + 1
                break
        limit = max(384, min(640, ((need + 127) // 128) * 128))
    hot = [1] + [s for s in ranked if s != 1]
    if len(hot) < limit:
        # structural fill: breadth-first from the root
        arr = np.asarray(tok.array, dtype=np.uint32).reshape(-1)
        S = tok.state_count
        seen = set(hot)
        queue = list(hot)
        qi = 0
        A = len(arr) // (S + 1)
        while qi < len(queue) and len(hot) < limit:
            s = queue[qi]
            qi += 1
            cells = arr[np.arange(A) * S + s]
            for cell in cells[cells != 0]:
                tgt = int(cell & ~np.uint32(FIRSTBIT))
                if tgt and tgt not in seen:
                    seen.add(tgt)
                    hot.append(tgt)
                    queue.append(tgt)
                    if len(hot) >= limit:
                        break
    return np.array(hot[:limit], dtype=np.int64)


def sample_texts(texts, budget: int = 262144):
    """Round-robin document sample for native statistics walks
    (census, cold rate): prefixes of ≤256 docs joined by newlines —
    the '\n' re-grounds the walk at a boundary symbol; long documents
    contribute an interior slice too (their vocabulary is not all in
    the prefix).  Returns the joined str, or None for empty input.
    (A copy of datok_tpu/runtime/jax_engine.py:743.)"""
    n = len(texts)
    if n == 0:
        return None
    take = max(256, budget // max(1, min(n, 256)))
    step = max(1, n // 256)
    parts = []
    got = 0
    for i in range(0, n, step):
        t = texts[i]
        if len(t) > 2 * take:
            mid = len(t) // 2
            parts.append(t[: take // 2])
            parts.append(t[mid : mid + take - take // 2])
        else:
            parts.append(t[:take])
        got += min(len(t), take)
        if got >= budget:
            break
    return "\n".join(parts)


def census_cut(counts: np.ndarray, H: int,
               ladder: Sequence[int]) -> Tuple[int, np.ndarray]:
    """The size and census states of a wave's hot set, by the rule of
    ``BatchEngine.wave_spec`` (datok_tpu/runtime/jax_engine.py:1824-1850):
    the states that cover 99.9% of the sampled fetches count ``n``; the
    size is the smallest rung of ``ladder`` below ``H`` (the engine's own
    set's size) that holds ``n`` states besides the root, else ``H``;
    the census states, by count (ties by id), are trimmed to one less
    than the size and returned sorted by id.  Returns ``(size,
    states)``; the states are the cache key of the set."""
    counts = np.asarray(counts)
    states = np.flatnonzero(counts)
    order = np.argsort(-counts[states], kind="stable")
    cum = np.cumsum(counts[states][order])
    n999 = int(np.searchsorted(cum, 0.999 * cum[-1]) + 1) if len(cum) else 1
    for rung in ladder:
        if rung < H and n999 <= rung - 1:
            H = rung
            break
    if len(states) > H - 1:
        states = states[order][: H - 1]
    return H, np.sort(states)


def wave_hot_states(census: np.ndarray, base: Sequence[int]) -> np.ndarray:
    """The hot set of a wave, as ``HotSpec.for_wave`` builds it
    (datok_tpu/runtime/jax_engine.py:1106-1132): the root first, then
    the census states (:func:`census_cut`) other than the root, trimmed
    to ``len(base) - 1``, then states of ``base`` (the engine's own set
    cut to the wave's size, the root first) in its order, never
    repeating a state or the root, up to ``len(base)`` states."""
    base = np.asarray(base, dtype=np.int64)
    H = len(base)
    hs = np.asarray(census, dtype=np.int64)
    hs = hs[(hs != 1) & (hs > 0)]
    if len(hs) >= H - 1:
        hs = hs[: H - 1]
    else:
        fill = base[~np.isin(base, hs) & (base != 1)]
        hs = np.concatenate([hs, fill[: H - 1 - len(hs)]])
    return np.concatenate([[1], hs]).astype(np.int64)


def hot_capacity(max_sym: int) -> int:
    """The most hot states whose rows (4 bytes x ``max_sym`` each) fit in
    one block's shared memory and whose index fits the tag: 339 at the
    DE model's 171 symbol columns."""
    return min(MAX_HOT, SMEM_BYTES // (4 * max(max_sym, 1)))


def pack_hot(array: np.ndarray, S: int, max_sym: int,
             states: Sequence[int]
             ) -> Optional[Tuple[np.ndarray, np.ndarray, np.ndarray]]:
    """K1's tables for the hot set ``states`` (hot index = position).

    Returns ``(tagged, rows, hot_of)``: the whole table with tagged
    cells (uint32, the shape of ``array``); the hot states' rows of it,
    row h holding the cells ``(a-1)*S + states[h]`` for a = 1..max_sym
    (0 outside the table), padded with zeros to a multiple of four
    cells; and ``hot_of`` (int32, S+1 entries), each state's hot index
    + 1 (0 = cold).  Returns None when the tags do not fit: S >= 2^20,
    a cell with any of bits 20..30 set, a state outside 0..S, or more
    than :data:`MAX_HOT` states.  The engine then runs with no hot set.
    """
    array = np.asarray(array, dtype=np.uint32).reshape(-1)
    states = np.asarray(states, dtype=np.int64).reshape(-1)
    H = len(states)
    if (S >= 1 << HOT_SHIFT or H > MAX_HOT
            or bool((array & np.uint32(0x7FF00000)).any())
            or (H and (states.min() < 0 or states.max() > S))
            or len(np.unique(states)) != H):
        return None
    hot_of = np.zeros(S + 1, dtype=np.int32)
    hot_of[states] = np.arange(1, H + 1, dtype=np.int32)
    target = (array & np.uint32(0x7FFFFFFF)).astype(np.int64)
    tag = np.zeros(len(array), dtype=np.uint32)
    inside = (array != 0) & (target <= S)
    tag[inside] = hot_of[target[inside]].astype(np.uint32) << HOT_SHIFT
    tagged = array | tag
    idx = (np.arange(max_sym, dtype=np.int64)[None, :] * S
           + states[:, None])
    ok = idx < len(array)
    rows = np.where(ok, tagged[np.where(ok, idx, 0)], np.uint32(0))
    n = H * max_sym
    padded = np.zeros((n + 3) // 4 * 4, dtype=np.uint32)
    padded[:n] = rows.reshape(-1)
    return tagged, padded, hot_of


def untag(cells: np.ndarray) -> np.ndarray:
    """Tagged cells with their tags cleared: the original cells."""
    return np.asarray(cells, dtype=np.uint32) & np.uint32(~HOT_TAG_MASK & 0xFFFFFFFF)
