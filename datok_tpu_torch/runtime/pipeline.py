"""Host orchestration: stream → lanes → events → formatted output.

Counterpart of datok_tpu/runtime/pipeline.py, which cannot be imported
here because it imports ``jax_engine`` (:40).  A stream is split into
documents at ``\\x04`` (EOT) boundaries where the model makes such cuts
clean (:func:`eot_in_sigma`), the documents run as parallel lanes of
:class:`~datok_tpu_torch.runtime.engine.BatchEngine` (K1 on a CUDA
device, the plain machine on the CPU), and their events are replayed in
order through one writer, which reproduces the reference's
single-stream output byte for byte.

Documents longer than the packed-event limit (``MAX_SEGMENT``) run in
one of two exact modes: *chained* (:func:`events_long_batch`: each
segment cuts at its end and hands the context checkpointed at its last
buffer rewind to the next) or *speculative*
(:func:`events_speculative_batch`: all segments of all documents in one
wave from guessed contexts, each cut verified on the host by
rewind-stream convergence, chaining where a cut fails).  Both are exact
for any input, with a host fallback for a single token longer than a
segment.

What differs from the JAX module: the engine returns compact event rows
(``run_events_compact``, decoded by ``decode_events_compact``) instead
of a step-indexed buffer.  A caller that passes neither ``engine=`` nor
``device=`` gets an engine on ``"cuda"``, which raises without a card.
"""

from __future__ import annotations

import codecs
import re
import sys
from typing import List, Optional, Sequence

import numpy as np

from ..fsa.io import FIRSTBIT, RESTBIT
from .encode import text_to_codepoints
from .events import EV_SENT, replay_events
from .writer import SIMPLE, TokenWriter

from .debug import divergence_debug_enabled
from .decode import decode_events_compact
from .engine import BatchEngine
from .machine import MAX_SEGMENT
from .repair import _cut_walk, _full_doc_metas, transduce_doc_exact

# Packed context flag bits (oracle.py entry layout): after an EOT the
# machine has emitted both the sentence and the text end, so the
# canonical post-EOT context is root + both flags (+ the stale-ok bit
# carried from the last non-ASCII codepoint seen, matrix.go:421-435).
SPLIT_FLAGS = (1 << 28) | (1 << 29)


def split_documents(text: str, epilogue_sentinel: bool = True) -> List[str]:
    """Split a stream into chunks, each ending just after an EOT.

    ``epilogue_sentinel`` appends an EMPTY final chunk when the stream
    ends exactly at an EOT: documents ending in ``\\x04`` run as cuts
    (no EOF epilogue), so the stream-final epilogue runs as its own
    zero-length chunk chained from the last exit context.
    ``"".join(result) == text`` either way.
    """
    out = []
    start = 0
    while True:
        i = text.find("\x04", start)
        if i < 0:
            break
        out.append(text[start : i + 1])
        start = i + 1
    if start < len(text) or not out:
        out.append(text[start:])
    elif epilogue_sentinel:
        out.append("")
    return out


def eot_in_sigma(tok) -> bool:
    """True if ``\\x04`` is a real sigma symbol of the model: the
    property that makes EOT-boundary cuts clean (the proof is in the
    JAX module, pipeline.py:71-88).  A model without it may consume
    ``\\x04`` mid-token, so its stream runs as one document."""
    return 4 in tok.sigma


def split_stream(tok, text: str) -> List[str]:
    """EOT chunks plus the epilogue sentinel when EOT cuts are clean
    (:func:`eot_in_sigma`), else the whole stream as one document."""
    if eot_in_sigma(tok):
        return split_documents(text, epilogue_sentinel=True)
    return [text]


def eot_split_safe(tok) -> bool:
    """True if every EOT arc in the model targets the root state: after
    a chunk ending in ``\\x04`` the machine is where a fresh chunk
    starts, so the exit contexts need no chaining check."""
    cached = getattr(tok, "_eot_split_safe", None)
    if cached is not None:
        return cached
    safe = False
    if tok.type() == "MATOK":
        a = int(tok.sigma_ascii[4])
        if a > 0:
            S = tok.state_count
            col = np.asarray(tok.array[(a - 1) * S : (a - 1) * S + S + 1])
            targets = np.unique(col[col != 0] & ~np.uint32(FIRSTBIT))
            # every EOT arc targets the root, and the root accepts EOT
            # (so the never-fail retry path also converges to the root)
            safe = col[1] != 0 and set(targets.tolist()) <= {1}
    else:
        # double array: check every *reachable* state's EOT target
        # (unreachable cells can alias valid-looking transitions)
        a = int(tok.sigma_ascii[4])
        if a > 0:
            base = np.asarray(tok.base, dtype=np.int64)
            check = np.asarray(tok.check, dtype=np.int64)
            size = int(check[1] & RESTBIT)
            n = len(base)
            A = max(max(tok.sigma.values(), default=0), tok.final) + 1
            sym = np.arange(1, A, dtype=np.int64)
            # the 'final' pseudo-symbol is never a runtime input
            sym = sym[sym != tok.final]
            eot_pos = int(np.searchsorted(sym, a))

            seen = np.zeros(n, dtype=bool)
            seen[1] = True
            frontier = [1]
            finals = set()
            while frontier:
                nxt = []
                for s in frontier:
                    tc = (base[s] & RESTBIT) + sym
                    ok = (tc <= size) & (tc < n)
                    tcc = np.clip(tc, 0, n - 1)
                    valid = ok & ((check[tcc] & RESTBIT) == s)
                    tgts = tcc[valid]
                    sep = (base[tgts] & (1 << 31)) != 0
                    reps = np.where(sep, base[tgts] & RESTBIT, tgts)
                    if valid[eot_pos]:  # EOT arc from this state
                        te = int(tcc[eot_pos])
                        if base[te] & (1 << 31):
                            te = int(base[te] & RESTBIT)
                        finals.add(te)
                    for t in np.unique(reps):
                        t = int(t)
                        if 0 < t < n and not seen[t]:
                            seen[t] = True
                            nxt.append(t)
                frontier = nxt
            root_tc = (base[1] & RESTBIT) + a
            root_ok = (
                root_tc <= size
                and root_tc < n
                and (check[root_tc] & RESTBIT) == 1
            )
            safe = root_ok and finals <= {1}
    tok._eot_split_safe = safe
    return safe


_WIDE = re.compile("[^\x00-\xff]")


def _stale_ok_after(known: frozenset, doc: str, ok: int) -> int:
    """Stale-``ok`` register value after transducing ``doc``: "was the
    last codepoint >= 256 in sigma" (``known``: the encoder's keys), or
    the entry value for documents without one (the reference reassigns
    ``ok`` only on that path).

    The JAX module scans the tail in a Python loop over characters
    (pipeline.py:219-238), which on Latin-1 text without a codepoint
    >= 256 walks 4096 characters per document.  Here a Latin-1 encode
    (a copy in C for such text) tells that there is none, a regex scan
    finds the last one otherwise, and a set lookup replaces a
    ``searchsorted`` call per document."""
    try:
        doc.encode("latin-1")
    except UnicodeEncodeError:
        return int(ord(_WIDE.findall(doc)[-1]) in known)
    return ok


def predict_entries(encoder, docs: Sequence[str], entry: int = 1,
                    breaks=None):
    """Predicted packed entry contexts for an EOT-split document list:
    after each non-final document (it ends in EOT) a conforming model
    sits at the root with both end flags and the chained stale-``ok``
    bit.  The caller verifies real exits against these predictions.

    Returns ``(entries[n] int32, next_entry)``.  ``breaks[k]`` true
    starts a new stream at document k (entry 1).
    """
    n = len(docs)
    ents = np.empty(n, dtype=np.int32)
    cur = int(entry)
    known = frozenset(encoder.keys.tolist())
    for k, doc in enumerate(docs):
        if breaks is not None and breaks[k]:
            cur = 1
        ents[k] = cur
        ok = _stale_ok_after(known, doc, (cur >> 30) & 1)
        cur = 1 | SPLIT_FLAGS | (ok << 30)
    return ents, cur


def _stale_ok_at_cuts(encoder, doc: str, cuts, entry_ok: int):
    """Exact stale-``ok`` flag at each cut position ("was the last
    codepoint >= 256 before here in sigma"), which a speculative
    segment's entry context must reproduce."""
    cps = np.frombuffer(
        doc.encode("utf-32-le", "surrogatepass"), dtype=np.uint32
    )
    hi = np.nonzero(cps >= 256)[0]
    keys = encoder.keys
    if hi.size and len(keys):
        vals = cps[hi].astype(np.int64)
        idx = np.clip(np.searchsorted(keys, vals), 0, len(keys) - 1)
        known = keys[idx] == vals
    else:
        known = np.zeros(len(hi), dtype=bool)
    out = []
    for cut in cuts:
        p = int(np.searchsorted(hi, cut))
        out.append(int(entry_ok) if p == 0 else int(known[p - 1]))
    return out


def _run_wave(engine: BatchEngine, texts: Sequence[str], entries, stops):
    """One device wave of segments; returns ``(decoded events per lane,
    bad (B,), state (B, 6))``."""
    meta, lengths, _ = engine.encoder.encode_batch(texts)
    ev, counts, bad, state = engine.run_events_compact(
        meta, lengths, entries=np.asarray(entries, dtype=np.int32),
        stops=np.asarray(stops, dtype=bool),
    )
    return decode_events_compact(ev, counts), np.asarray(bad, dtype=bool), state


def events_long_batch(
    engine: BatchEngine,
    docs: Sequence[str],
    seg_len: int = 8192,
    entries: Optional[np.ndarray] = None,
    stops=None,
):
    """Transduce long documents on the device by chained segmentation.

    Each document runs as segments of ``seg_len`` characters; a
    segment cuts at its end, and the next resumes from the context the
    machine checkpointed at its last buffer rewind, re-reading only the
    pending token.  Sentence ends after the last rewind are dropped
    from the cut segment because the resumed replay re-emits them.
    Segments of one document are sequential; different documents'
    segments run as parallel lanes.  ``stops[k]`` cuts document k's
    final segment too (it ends in an interior EOT).

    Returns (events, exit_ctxs) with absolute positions per document.
    """
    n = len(docs)
    events: List[List] = [[] for _ in range(n)]
    pos = [0] * n  # current segment origin per doc
    ctx = np.ones(n, dtype=np.int32)
    if entries is not None:
        ctx[:] = entries
    orig_entry = ctx.copy()
    doc_stop = np.zeros(n, dtype=bool)
    if stops is not None:
        doc_stop[:] = stops
    done = [len(d) == 0 for d in docs]
    exit_ctx = np.ones(n, dtype=np.int32)

    def host_whole_doc(k: int) -> None:
        """Exact host fallback: redo document k from scratch."""
        events[k], exit_ctx[k] = transduce_doc_exact(
            engine.tok, docs[k], int(orig_entry[k]), bool(doc_stop[k]),
            encoder=engine.encoder,
        )
        done[k] = True

    while not all(done):
        lanes = [k for k in range(n) if not done[k]]
        seg_texts = [docs[k][pos[k] : pos[k] + seg_len] for k in lanes]
        is_last = [pos[k] + seg_len >= len(docs[k]) for k in lanes]
        decoded, bad, state = _run_wave(
            engine, seg_texts, ctx[lanes],
            ~np.asarray(is_last) | doc_stop[lanes],
        )
        for j, k in enumerate(lanes):
            if bad[j]:
                host_whole_doc(k)
                continue
            off = pos[k]
            if is_last[j]:
                events[k].extend(
                    (kd, s + off, e + off) for kd, s, e in decoded[j]
                )
                exit_ctx[k] = int(state[j, 0])
                done[k] = True
            else:
                b_exit = int(state[j, 2])
                if b_exit <= 0:
                    # the pending token spans the whole segment
                    host_whole_doc(k)
                    continue
                evs = decoded[j]
                while evs and evs[-1][0] == EV_SENT:
                    evs = evs[:-1]
                events[k].extend((kd, s + off, e + off) for kd, s, e in evs)
                ctx[k] = int(state[j, 1])  # checkpoint context at b
                pos[k] += b_exit
    return events, exit_ctx


def _verify_cut(
    tok, text: str, x_ctx: int, x_pos: int, cut: int, spec_entry: int,
    seg_end: int, windows=(256, 2048, 8192), metas=None,
):
    """Verify one speculative cut; return the splice or None.

    Walks the true machine from the previous segment's rewind
    checkpoint ``(x_ctx, x_pos)`` across the cut, and the speculative
    machine from ``(spec_entry, cut)``, recording both rewind streams.
    The first true rewind at or after the cut that matches a
    speculative rewind (position and packed context) proves the two
    machines identical from there on.

    Returns ``(true_events, n_spec_drop, spec_prefix)``: the exact
    events over ``[x_pos, convergence)``, how many leading device
    events to drop, and the host-replayed prefix those must equal.
    ``None`` = no convergence in the windows.
    """
    for w in windows:
        stop = min(cut + w, seg_end)
        spec_ev, spec_rw = _cut_walk(tok, text, metas, spec_entry, cut, stop)
        spec_at = {pos: (ctx, nev) for pos, ctx, nev in spec_rw}
        tr_ev, tr_rw = _cut_walk(tok, text, metas, x_ctx, x_pos, stop)
        for pos, ctx, nev in tr_rw:
            if pos < cut:
                continue
            hit = spec_at.get(pos)
            if hit is not None and hit[0] == ctx:
                return tr_ev[:nev], hit[1], spec_ev[: hit[1]]
        if stop >= seg_end:
            break
    return None


def _speculative_plan(engine: BatchEngine, text: str, entry: int,
                      seg_len: int):
    """Cuts, speculative lane entries and whole-document metas of one
    text: segment 0 starts from ``entry``, later ones from a fresh root
    with the exact stale-``ok`` bit at their cut."""
    cuts = list(range(0, len(text), seg_len)) or [0]
    metas = _full_doc_metas(engine.encoder, text) if len(cuts) > 1 else None
    oks = _stale_ok_at_cuts(engine.encoder, text, cuts, (int(entry) >> 30) & 1)
    lane_entry = [int(entry) if j == 0 else (1 | (oks[j] << 30))
                  for j in range(len(cuts))]
    return cuts, lane_entry, metas


def _run_lanes(engine: BatchEngine, texts, entries, stops, max_lanes: int):
    """``_run_wave`` over groups of at most ``max_lanes`` lanes."""
    total = len(texts)
    decoded: List = [None] * total
    bad = np.zeros(total, dtype=bool)
    state = np.zeros((total, 6), dtype=np.int64)
    for gi in range(0, total, max_lanes):
        sl = slice(gi, min(gi + max_lanes, total))
        decoded[sl], bad[sl], state[sl] = _run_wave(
            engine, texts[sl], entries[sl], stops[sl])
    return decoded, bad, state


def _divergence(lane: int, j: int, cut: int) -> None:
    if divergence_debug_enabled():
        print(
            f"datok-tpu: speculative-cut divergence (lane {lane}, seg {j}, "
            f"cut {cut}); falling back to exact replay — use "
            "datok_tpu_torch.runtime.debug.dump_divergence on the document "
            "for a step trace",
            file=sys.stderr,
        )


def events_speculative_batch(
    engine: BatchEngine,
    docs: Sequence[str],
    seg_len: int = 8192,
    entries: Optional[np.ndarray] = None,
    max_lanes: int = 4096,
    stops=None,
):
    """Transduce long documents by speculative segmentation.

    Every segment of every document runs as a parallel lane in one
    wave: segment 0 from the exact entry, later segments from a fresh
    root context at their cut (with the exact stale-``ok`` bit).  Each
    cut is then verified on the host (:func:`_verify_cut`); a document
    whose cuts fail to verify falls back to
    :func:`events_long_batch`.  This parallelizes inside a single giant
    document.

    Returns (events, exit_ctxs) with absolute positions per document.
    """
    tok = engine.tok
    n = len(docs)
    ent = np.ones(n, dtype=np.int32)
    if entries is not None:
        ent[:] = entries
    doc_stop = np.zeros(n, dtype=bool)
    if stops is not None:
        doc_stop[:] = stops

    # lane plan: all segments of all documents
    doc_cuts: List[List[int]] = []
    lane_text: List[str] = []
    lane_entry: List[int] = []
    lane_stop: List[bool] = []
    lane_of: List[List[int]] = []  # per doc: lane indices in segment order
    spec_entry_of: List[List[int]] = []
    doc_metas: List = []
    for k, doc in enumerate(docs):
        cuts, spec_entries, metas = _speculative_plan(
            engine, doc, int(ent[k]), seg_len)
        doc_cuts.append(cuts)
        doc_metas.append(metas)
        lane_of.append(list(range(len(lane_text), len(lane_text) + len(cuts))))
        spec_entry_of.append(spec_entries)
        for j, cut in enumerate(cuts):
            lane_text.append(doc[cut : cut + seg_len])
            lane_entry.append(spec_entries[j])
            # the final segment of an EOT-interior doc cuts too
            lane_stop.append(j < len(cuts) - 1 or bool(doc_stop[k]))

    decoded, bad, state = _run_lanes(engine, lane_text, lane_entry,
                                     lane_stop, max_lanes)

    # stitch: verify each cut, splice exact events
    events: List[List] = [None] * n
    exit_ctx = np.ones(n, dtype=np.int32)
    chained_fallback: List[int] = []
    for k, doc in enumerate(docs):
        cuts = doc_cuts[k]
        lanes = lane_of[k]
        K = len(lanes)
        if any(bad[lane] for lane in lanes):
            chained_fallback.append(k)
            continue
        evs: List = []
        x_ctx = x_pos = None
        failed = False
        for j, lane in enumerate(lanes):
            cut = cuts[j]
            seg_end = cuts[j + 1] if j + 1 < K else len(doc)
            dec_abs = [(kd, s + cut, e + cut) for kd, s, e in decoded[lane]]
            drop = 0
            if j > 0:
                r = _verify_cut(
                    tok, doc, x_ctx, x_pos, cut, spec_entry_of[k][j],
                    seg_end, metas=doc_metas[k],
                )
                if r is None:
                    failed = True
                    break
                true_evs, drop, spec_prefix = r
                if drop > len(dec_abs) or dec_abs[:drop] != list(spec_prefix):
                    _divergence(lane, j, cut)
                    failed = True  # device↔oracle divergence: be exact
                    break
                evs.extend(true_evs)
            body = dec_abs[drop:]
            if j < K - 1:
                b_exit = int(state[lane, 2])
                if b_exit <= 0:
                    # no rewind inside the segment (token spans it all)
                    failed = True
                    break
                # events after the last rewind are re-emitted by the
                # next cut's true walk (only SENTs can follow a rewind)
                while body and body[-1][0] == EV_SENT:
                    body.pop()
                x_ctx = int(state[lane, 1])
                x_pos = cut + b_exit
            evs.extend(body)
        if failed:
            chained_fallback.append(k)
            continue
        events[k] = evs
        exit_ctx[k] = int(state[lanes[-1], 0])

    if chained_fallback:
        evs_c, exits_c = events_long_batch(
            engine,
            [docs[k] for k in chained_fallback],
            seg_len=seg_len,
            entries=ent[chained_fallback],
            stops=doc_stop[chained_fallback],
        )
        for k, ev, ex in zip(chained_fallback, evs_c, exits_c):
            events[k] = ev
            exit_ctx[k] = ex
    return events, exit_ctx


def events_until_checkpoint(
    engine: BatchEngine,
    text: str,
    entry: int = 1,
    seg_len: int = 8192,
    max_lanes: int = 4096,
):
    """Transduce ``text``, an unterminated document, up to its LAST
    rewind checkpoint: every segment, the final one included, cuts at
    its end; all run as one speculative wave, cuts are verified, and
    the context at the last rewind is returned so the caller can resume
    when more input arrives.

    Returns ``(events, ck_pos, ck_ctx)``: exact events over
    ``[0, ck_pos)`` and the packed context at ``ck_pos``; with no rewind
    in the whole text, ``([], 0, entry)``.
    """
    tok = engine.tok

    def host_tail():
        # exact bounded fallback: the native/oracle walk with its rewinds
        metas = _full_doc_metas(engine.encoder, text)
        ev, rw = _cut_walk(tok, text, metas, int(entry), 0, len(text))
        best = None
        for pos, ctx, nev in rw:
            if pos > 0:
                best = (pos, ctx, nev)
        if best is None:
            return [], 0, int(entry)
        pos, ctx, nev = best
        evs = list(ev[:nev])
        while evs and evs[-1][0] == EV_SENT:
            evs.pop()
        return evs, pos, ctx

    cuts, lane_entry, metas = _speculative_plan(engine, text, entry, seg_len)
    K = len(cuts)
    decoded, bad, state = _run_lanes(
        engine, [text[c : c + seg_len] for c in cuts], lane_entry,
        [True] * K, max_lanes)
    if bad.any():
        return host_tail()

    evs: List = []
    x_ctx, x_pos = int(entry), 0
    for j in range(K):
        cut = cuts[j]
        seg_end = cuts[j + 1] if j + 1 < K else len(text)
        dec_abs = [(kd, s + cut, e + cut) for kd, s, e in decoded[j]]
        drop = 0
        if j > 0:
            r = _verify_cut(
                tok, text, x_ctx, x_pos, cut, lane_entry[j], seg_end,
                metas=metas,
            )
            if r is None:
                return host_tail()
            true_evs, drop, spec_prefix = r
            if drop > len(dec_abs) or dec_abs[:drop] != list(spec_prefix):
                return host_tail()  # device↔oracle divergence: be exact
            evs.extend(true_evs)
        body = dec_abs[drop:]
        b_exit = int(state[j, 2])
        if b_exit <= 0:
            # no rewind inside this segment: the verify windows do not
            # cover a segment-sized token, so take the exact host path
            return host_tail() if j > 0 else ([], 0, int(entry))
        while body and body[-1][0] == EV_SENT:
            body.pop()
        evs.extend(body)
        x_ctx = int(state[j, 1])
        x_pos = cut + b_exit
    return evs, x_pos, x_ctx


def _run_docs(
    tok,
    engine: BatchEngine,
    docs: Sequence[str],
    *,
    entry: int = 1,
    max_lanes: int = 4096,
    long_strategy: str = "auto",
    as_arrays: bool = False,
):
    """Transduce EOT-split documents as parallel lanes, exactly.

    ``entry`` is the packed context the FIRST document starts in (1 =
    fresh root; a checkpoint context when resuming a stream).  Each
    document starts from its predicted entry (:func:`predict_entries`);
    where a real exit differs from the next document's entry, that
    document runs again from the real one, until the chain holds.
    Returns ``(events_per_doc, exit_ctx_of_last_doc)``.
    """
    n = len(docs)
    verified_safe = eot_split_safe(tok) and entry == 1
    # chunks ending in EOT stop at their end (no EOF epilogue); the
    # epilogue runs in the stream-final chunk.  Gated on eot_in_sigma,
    # which proves such cuts clean.
    can_cut = eot_in_sigma(engine.tok)
    cuts = np.array(
        [can_cut and d.endswith("\x04") for d in docs], dtype=bool
    )
    entries, _ = predict_entries(engine.encoder, docs, entry=entry)
    events: List = [None] * n
    exits = np.ones(n, dtype=np.int32)
    have = [False] * n
    rounds = 0

    while not all(have):
        rounds += 1
        if rounds > n + 2:  # defensive: converges in <= n rounds
            for k in range(n):
                if not have[k]:
                    # entries hold state ids of engine.tok (a .datok
                    # model runs as its matrix form): walk engine.tok
                    events[k], exits[k] = transduce_doc_exact(
                        engine.tok, docs[k], int(entries[k]),
                        bool(cuts[k]), encoder=engine.encoder,
                    )
                    have[k] = True
            break
        todo = [k for k in range(n) if not have[k]]
        # length-bucketed waves: each wave pads to its own longest text
        todo.sort(key=lambda k: len(docs[k]))
        for gi in range(0, len(todo), max_lanes):
            group = todo[gi : gi + max_lanes]
            small = [k for k in group if len(docs[k]) <= MAX_SEGMENT]
            large = [k for k in group if len(docs[k]) > MAX_SEGMENT]
            if small:
                evs, exs = engine.events_batch(
                    [docs[k] for k in small],
                    entries=entries[small],
                    return_exits=True,
                    as_arrays=as_arrays,
                    stops=cuts[small],
                )
                for k, ev, ex in zip(small, evs, exs):
                    events[k] = ev
                    exits[k] = ex
                    have[k] = True
            if large:
                # chaining parallelizes across documents only, so with
                # few giant documents speculate inside each instead
                spec = long_strategy == "speculative" or (
                    long_strategy == "auto" and len(large) < 64
                )
                run_long = (
                    events_speculative_batch if spec else events_long_batch
                )
                evs_l, exits_l = run_long(
                    engine, [docs[k] for k in large],
                    entries=entries[large], stops=cuts[large],
                )
                for k, ev, ex in zip(large, evs_l, exits_l):
                    events[k] = ev
                    exits[k] = ex
                    have[k] = True
        if verified_safe:
            break  # exits provably return to root; no chaining needed
        # verify the chain: a mismatched entry invalidates the successor
        for k in range(n - 1):
            if have[k] and exits[k] != entries[k + 1]:
                entries[k + 1] = exits[k]
                have[k + 1] = False
    return events, int(exits[-1]) if n else entry


def _replay_docs(docs, events, w) -> None:
    """Feed per-document event streams through the writer (one C call
    per document where the writer has ``feed``, as NativeWriter does)."""
    feed = getattr(w, "feed", None)
    if feed is not None:
        for doc, evs in zip(docs, events):
            feed(evs, text_to_codepoints(doc))
    else:
        for doc, evs in zip(docs, events):
            replay_events(evs, doc, w)


def _engine(tok, engine: Optional[BatchEngine], device) -> BatchEngine:
    """``engine``, or a new one on ``device`` (``"cuda"`` when None)."""
    if engine is not None:
        return engine
    return BatchEngine(tok, device="cuda" if device is None else device)


def tokenize_stream(
    tok,
    text: str,
    writer: Optional[TokenWriter] = None,
    *,
    engine: Optional[BatchEngine] = None,
    device=None,
    max_lanes: int = 4096,
    long_strategy: str = "auto",
) -> TokenWriter:
    """Tokenize one stream through the batched engine.

    The stream is split at EOT boundaries (:func:`split_stream`) and
    its documents run as parallel lanes from predicted entries, chained
    exactly by :func:`_run_docs`.  ``long_strategy`` picks the mode of
    documents over ``MAX_SEGMENT``: ``"auto"`` (speculative for fewer
    than 64 of them in a wave), ``"speculative"`` or ``"chained"``.

    Without ``engine``, a new engine runs on ``device`` (``"cuda"`` by
    default).  Returns the writer (a new ``SIMPLE`` one if none is
    given).
    """
    w = writer if writer is not None else TokenWriter(SIMPLE)
    engine = _engine(tok, engine, device)
    docs = split_stream(engine.tok, text)
    events, _exit = _run_docs(
        tok, engine, docs, max_lanes=max_lanes, long_strategy=long_strategy,
        as_arrays=getattr(w, "feed", None) is not None,
    )
    _replay_docs(docs, events, w)
    return w


def tokenize_reader(
    tok,
    reader,
    writer: Optional[TokenWriter] = None,
    *,
    engine: Optional[BatchEngine] = None,
    device=None,
    chunk_bytes: int = 4 << 20,
    seg_len: int = 8192,
    max_lanes: int = 4096,
) -> TokenWriter:
    """Tokenize a file-like object with memory bounded by the chunk.

    Input flows in ``chunk_bytes`` chunks; each chunk's complete
    documents run as parallel lanes, the trailing unterminated document
    is advanced to its last rewind checkpoint
    (:func:`events_until_checkpoint`), and only the rest is carried
    forward.  ``reader`` may be binary (incremental UTF-8 decode, split
    multi-byte sequences are safe) or text mode.  Output is
    byte-identical to :func:`tokenize_stream` on the whole stream.
    ``engine`` and ``device`` as there.
    """
    w = writer if writer is not None else TokenWriter(SIMPLE)
    engine = _engine(tok, engine, device)
    as_arrays = getattr(w, "feed", None) is not None

    dec = codecs.getincrementaldecoder("utf-8")(errors="replace")
    ctx = 1  # packed machine context carried across chunk boundaries
    tail = ""
    can_cut = eot_in_sigma(engine.tok)
    while True:
        data = reader.read(chunk_bytes)
        at_eof = not data
        new = (
            dec.decode(data, final=at_eof)
            if isinstance(data, bytes)
            else (data or "")
        )
        if at_eof:
            tail += new
            break
        if not new:  # pure UTF-8 continuation bytes
            continue
        text = tail + new
        if can_cut:
            docs = split_documents(text, epilogue_sentinel=False)
            # trailing doc is unterminated unless the chunk ended in EOT
            partial = "" if docs[-1].endswith("\x04") else docs[-1]
            complete = docs[:-1] if partial or not docs[-1] else docs
        else:
            # EOT cuts are not provably clean for this model: no
            # document split; the checkpoint machinery below is exact
            partial, complete = text, []
        if complete and any(complete):
            # mid-stream chunks all end in EOT and run as cuts; the
            # stream-final epilogue runs after the read loop
            events, ctx = _run_docs(
                tok, engine, complete, entry=ctx, max_lanes=max_lanes,
                as_arrays=as_arrays,
            )
            _replay_docs(complete, events, w)
        if len(partial) >= 2 * seg_len:
            evs, ck_pos, ck_ctx = events_until_checkpoint(
                engine, partial, entry=ctx, seg_len=seg_len,
                max_lanes=max_lanes,
            )
            if evs:
                _replay_docs([partial[:ck_pos]], [evs], w)
            tail = partial[ck_pos:]
            ctx = ck_ctx
        else:
            tail = partial
    # EOF: the remaining tail (possibly empty) runs to completion from
    # the carried context, with the stream-final epilogue and the
    # reference's "\n\n" for an empty stream
    docs = split_stream(engine.tok, tail)
    events, ctx = _run_docs(
        tok, engine, docs, entry=ctx, max_lanes=max_lanes, as_arrays=as_arrays,
    )
    _replay_docs(docs, events, w)
    w.flush()
    return w
