"""Host decode of packed device events.

Re-homed from datok_tpu/runtime/jax_engine.py:1390-1468 (numpy code in
a module that imports jax).  One change: both decode paths fail loud
when ``counts`` claims more events than the buffer holds.  The native
decoder already raises there (utils/native.py:346-350); the numpy path
of the JAX package truncates silently, and every consumer computes
document offsets from the unclamped counts.
"""

from __future__ import annotations

from typing import List

import numpy as np

from ..utils.native import native_decode_events

from .machine import PACK_POS_BITS, PACK_POS_MASK


def _unpack(flat: np.ndarray) -> np.ndarray:
    flat = flat.astype(np.uint32)
    tri = np.empty((len(flat), 3), dtype=np.int32)
    tri[:, 0] = flat & 3
    tri[:, 1] = (flat >> 2) & PACK_POS_MASK
    tri[:, 2] = (flat >> (2 + PACK_POS_BITS)) & PACK_POS_MASK
    return tri


def decode_events_flat(ev, counts):
    """Decode compact (B, E) event rows to ONE flat (N, 3) array.

    Lane i's events are the ``counts[i]`` consecutive triples starting
    at ``counts[:i].sum()``.  Rides the threaded native decoder when
    the native library is available; the numpy path is the fallback.
    """
    ev = np.asarray(ev)
    counts = np.asarray(counts)
    E = ev.shape[1]
    if counts.size and int(counts.max()) > E:
        raise ValueError(
            f"event rows narrower than counts: E={E} < "
            f"max(counts)={int(counts.max())}"
        )
    tri = native_decode_events(ev, counts)
    if tri is not None:
        return tri, counts
    mask = np.arange(E, dtype=np.int32)[None, :] < counts[:, None]
    return _unpack(ev[mask]), counts  # row-major: per-lane step order


def _split(tri: np.ndarray, counts, as_arrays: bool) -> List:
    rows = tri if as_arrays else [tuple(r) for r in tri.tolist()]
    out = []
    off = 0
    for n in counts.tolist():
        out.append(rows[off: off + n])
        off += n
    return out


def decode_events_compact(ev, counts, as_arrays: bool = False) -> List:
    """Per-lane events of compact (B, E) rows: lists of
    ``(kind, start, end)`` tuples, or (N, 3) int32 arrays with
    ``as_arrays`` (the shape the native writer feeds)."""
    tri, counts = decode_events_flat(ev, counts)
    return _split(tri, counts, as_arrays)


def decode_events_batch(ys: np.ndarray, n_steps: int,
                        as_arrays: bool = False) -> List:
    """Per-lane events of a step-indexed ``(steps, B)`` buffer, the
    layout of the JAX machines (0 = no event at that step)."""
    sub = np.asarray(ys)[:n_steps].T  # (B, steps), per-lane step order
    mask = sub != 0
    return _split(_unpack(sub[mask]), mask.sum(axis=1), as_arrays)
