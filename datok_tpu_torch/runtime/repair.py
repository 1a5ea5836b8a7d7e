"""Exact host transduce of lanes the device left unfinished.

Re-homed from datok_tpu/runtime/pipeline.py (``transduce_doc_exact``
:100-135, ``_full_doc_metas`` :399-414, ``_cut_walk`` :417-430): host
code behind a module that imports jax.  A lane that runs out of its
step budget on the device (``bad``) is re-run here, so the engine's
output never depends on the budget.
"""

from __future__ import annotations

from typing import List

from ..utils.native import native_cut_walk, native_encode
from .oracle import transduce_events, transduce_events_fast


def transduce_doc_exact(tok, doc: str, entry: int, cut: bool,
                        encoder=None):
    """Host-exact transduce of one stream chunk; returns
    ``(events, exit_ctx)``.

    ``cut=True`` (a chunk ending in ``\\x04`` interior to its stream)
    stops at ``len(doc)`` with no EOF epilogue; ``cut=False`` runs the
    full walk with the epilogue.  Native cut walk / native transduce
    when available, Python oracle otherwise.
    """
    if not cut:
        box: List[int] = []
        ev = transduce_events_fast(
            tok, doc, entry_state=int(entry), exit_box=box
        )
        return ev, (box[0] if box else 1)
    metas = _full_doc_metas(encoder, doc) if encoder is not None else None
    ev, rw = _cut_walk(tok, doc, metas, int(entry), 0, len(doc))
    pos, ctx, nev = rw[-1]
    if pos == len(doc) and nev == len(ev):
        return list(ev), int(ctx)
    # A silent fallback would run the EOF epilogue on an interior chunk
    # (implicit sentence/text ends mid-stream); fail loud instead, as
    # the JAX package does (pipeline.py:122-135).
    raise RuntimeError(
        "EOT-ending interior chunk left an unclean cut "
        f"(b={pos} != len={len(doc)}, events {nev}/{len(ev)}): the "
        "eot_in_sigma cut-cleanliness invariant is violated for this "
        "model; process the stream unsplit"
    )


def _full_doc_metas(encoder, doc: str):
    """Absolute-indexed packed symbol metas for a whole document, or
    None when the native encoder is unavailable."""
    r = native_encode(encoder, doc.encode("utf-8", "surrogatepass"))
    return None if r is None else r[1]


def _cut_walk(tok, text, metas, entry, start, stop):
    """One bounded walk: events + rewind stream, native when possible."""
    if metas is not None:
        r = native_cut_walk(tok, metas, entry, start, stop)
        if r is not None:
            return r
    rw: List = []
    ev = transduce_events(
        tok, text, entry_state=entry, start=start, stop_at=stop,
        rewinds_box=rw,
    )
    return ev, rw
