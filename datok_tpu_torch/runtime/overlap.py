"""Overlapped end-to-end pipeline: encode ∥ device ∥ format.

Counterpart of datok_tpu/runtime/overlap.py, which cannot be imported
here because it imports ``jax_engine`` (:54); ``_Wave``,
``WaveResult``, ``_pack_items``, ``_assemble``, ``_bucket`` and
``_splice`` are copied from it.  The stages run as they do there:

* a **prep thread** assembles waves of documents, encodes them with the
  internally threaded native encoder (GIL released) into the wave's
  slot, and dispatches it: on a CUDA device the slot's pinned host
  buffers are copied with ``non_blocking=True`` on the slot's own CUDA
  stream and K1 is launched behind them, so the card runs wave N while
  the host encodes wave N+1;
* a **fetch thread** waits on the wave's event (not on the whole card)
  and copies its events, counts, ``bad`` flags and states into the
  slot's pinned buffers, on the same stream;
* the **consumer** (the generator's caller) decodes, verifies the
  entry-state chain, repairs on the host, and formats.

Steady-state throughput is that of the slowest stage, not the sum of
the stages.  Backpressure and buffer reuse come from a fixed ring of
slots: a slot's buffers are reused only after its wave is consumed,
which also guarantees that its copies and K1 launch have finished.

On a per-wave engine (:attr:`BatchEngine.per_wave`) the prep thread
censuses each wave's documents before it encodes them and launches K1
with the wave's own hot set (:meth:`BatchEngine.wave_spec`; stats key
``census``), as the JAX module does; the wave holds its set until it is
consumed, after its launch has finished.

What differs from the JAX module: K1 writes compact event rows, so
there is no ``_compact_ys`` step; the port's encoder does not depend on
the hot set, so a wave with its own set is encoded as any other.
The lane placement is the JAX module's: on a sharded engine
(:class:`~datok_tpu_torch.parallel.mesh.ShardedEngine`) the lanes are
dealt over the shards by :func:`~datok_tpu_torch.parallel.mesh.balance_perm`.
The CPU device has no streams and no pinned memory: there the slot's
buffers are plain tensors and the plain machine runs in the prep
thread.

Exactness is the JAX module's: every document is dispatched from its
predicted entry context; the consumer replays the chain, and a document
whose true entry differs, or whose lane ran out of its step budget
(``bad``), is re-transduced exactly on the host.
"""

from __future__ import annotations

import contextlib
import queue
import threading
import time as _time
import warnings
from typing import Iterable, Iterator, List, Optional, Tuple

import numpy as np
import torch

from ..kernels import build
from ..utils.native import native_encode_wave
from .debug import divergence_debug_enabled, dump_divergence
from .decode import decode_events_flat
from .encode import text_to_codepoints
from .engine import BatchEngine
from .events import replay_events
from .machine import MAX_SEGMENT
from .pipeline import (_engine, eot_in_sigma, events_speculative_batch,
                       predict_entries, split_stream)
from .repair import transduce_doc_exact
from .writer import SIMPLE, TokenWriter


class _Wave:
    __slots__ = ("tags", "docs", "handles", "slot", "events",
                 "exits", "entries", "breaks", "inv", "cuts", "n_enc",
                 "spec")

    def __init__(self, tags, docs, handles, slot, entries, breaks,
                 events=None, exits=None, inv=None, cuts=None,
                 n_enc=0, spec=None):
        self.tags = tags
        self.docs = docs
        self.handles = handles  # (ev, counts, bad, state, done event, cps)
        self.slot = slot
        self.entries = entries  # dispatched (predicted) entry contexts
        self.breaks = breaks  # per-doc stream-start markers
        self.events = events  # precomputed (long-doc path)
        self.exits = exits  # precomputed exit contexts (long-doc path)
        self.inv = inv  # doc→lane map when length-sorted (else None)
        self.cuts = cuts  # per-doc: dispatched as interior-EOT cut
        self.n_enc = n_enc  # encoded lane count (docs + shape pads)
        self.spec = spec  # the wave's hot set, held while K1 reads it


class WaveResult:
    """One consumed wave: flat events + flat codepoints, repair-exact.

    ``tri``: (N, 3) int32 — the concatenation of every document's
    event triples (kind, pos_a, pos_b), document-relative positions;
    document k owns ``counts[k]`` consecutive rows.  ``cps_flat`` /
    ``cps_offs`` / ``cps_lens`` give document k's codepoints at
    ``cps_flat[cps_offs[k] : cps_offs[k] + cps_lens[k]]``.

    ``cps_flat`` may be a view of a reused encode scratch buffer: it
    is valid only until the generator is advanced again (the slot
    returns to the ring when the consumer resumes it).  Format first,
    then ``next()``.
    """

    __slots__ = ("tags", "docs", "tri", "counts",
                 "cps_flat", "cps_offs", "cps_lens")

    def __init__(self, tags, docs, tri, counts, cps_flat, cps_offs,
                 cps_lens):
        self.tags = tags
        self.docs = docs
        self.tri = tri
        self.counts = counts
        self.cps_flat = cps_flat
        self.cps_offs = cps_offs
        self.cps_lens = cps_lens


class _Slot:
    """One entry of the ring: the native encoder's scratch dict and the
    wave's host tensors, which grow on demand and never shrink.  On a
    CUDA device the host tensors lie in pinned memory (pinned once, not
    per wave) and the slot has a CUDA stream of its own."""

    __slots__ = ("scratch", "host", "stream")

    def __init__(self, dev: torch.device):
        self.scratch: dict = {}
        self.host: dict = {}
        self.stream = (torch.cuda.Stream(device=dev) if dev.type == "cuda"
                       else None)

    def buf(self, key: str, n: int, dtype) -> torch.Tensor:
        """The first ``n`` elements of the slot's host tensor ``key``."""
        b = self.host.get(key)
        if b is None or b.numel() < n:
            b = torch.empty(int(n * 1.25) + 64, dtype=dtype,
                            pin_memory=self.stream is not None)
            self.host[key] = b
        return b[:n]

    def to_host(self, key: str, x: torch.Tensor) -> torch.Tensor:
        """``x`` on the host: on a CUDA device a copy into the slot's
        pinned tensor ``key``, issued on the current stream without
        waiting (see :meth:`wait`); on the CPU ``x`` itself."""
        if self.stream is None:
            return x
        h = self.buf(key, x.numel(), x.dtype).view(x.shape)
        return h.copy_(x, non_blocking=True)

    def wait(self) -> None:
        """Wait for the work issued on the slot's stream (CUDA)."""
        if self.stream is not None:
            self.stream.synchronize()


@contextlib.contextmanager
def _on(dev: torch.device, slot: _Slot):
    """The slot's stream as this thread's current one (both the current
    device and the current stream are per thread); nothing on the CPU."""
    if slot.stream is None:
        yield
        return
    with torch.cuda.device(dev), torch.cuda.stream(slot.stream):
        yield


def _pack_items(items, pack_len):
    """Merge consecutive compatible items into ≤``pack_len``-char
    "superdocs" — the lane-packing pass.

    The device engine processes one document per lane; short documents
    leave lanes idle once they finish while long ones straggle.  Packing
    consecutive documents of the SAME stream (equal tag, no stream
    break) into one lane restores near-uniform lane lengths at zero
    exactness cost: the machine crosses the in-lane EOT boundaries
    natively, which IS the reference's single-stream semantics
    (matrix.go:593-605).  Only a document ending in EOT can be followed
    within a superdoc (the machine must see the terminator to reset);
    order is preserved, so output equals the per-document replay
    concatenated.
    """
    cur = None
    for it in items:
        tag, doc = it[0], it[1]
        brk = bool(it[2]) if len(it) > 2 else False
        if cur is not None:
            ctag, cdoc, cbrk = cur
            if (
                not brk
                and tag == ctag
                and doc != ""  # the epilogue sentinel stays its own item
                and cdoc.endswith("\x04")
                and len(cdoc) + len(doc) <= pack_len
                # stop growing once half full: packing pays only for
                # SMALL documents (datok_tpu/runtime/overlap.py:141-146)
                and len(cdoc) < pack_len // 2
            ):
                cur = (ctag, cdoc + doc, cbrk)
                continue
            yield cur
        cur = (tag, doc, brk)
    if cur is not None:
        yield cur


def _assemble(items, lanes, max_wave_chars):
    """Group items into waves; oversize docs go alone.

    Items are ``(tag, doc)`` pairs or ``(tag, doc, stream_start)``
    triples — a true third element marks the document as the first of
    a NEW stream (fresh root entry, e.g. a new corpus file) instead of
    chaining from its predecessor."""
    batch: List = []
    chars = 0
    for it in items:
        tag, doc = it[0], it[1]
        brk = bool(it[2]) if len(it) > 2 else False
        if len(doc) > MAX_SEGMENT:
            if batch:
                yield ("wave", batch)
                batch, chars = [], 0
            yield ("long", [(tag, doc, brk)])
            continue
        batch.append((tag, doc, brk))
        chars += max(len(doc), 1)
        if len(batch) >= lanes or chars >= max_wave_chars:
            yield ("wave", batch)
            batch, chars = [], 0
    if batch:
        yield ("wave", batch)


def _bucket(n: int, lo: int) -> int:
    """Smallest power-of-two ≥ ``n`` that is ≥ ``lo``."""
    b = lo
    while b < n:
        b *= 2
    return b


def _splice(tri, counts, repl):
    """Replace document k's event rows with ``repl[k]`` (host repairs)."""
    offs = np.zeros(len(counts) + 1, dtype=np.int64)
    np.cumsum(counts, out=offs[1:])
    parts = []
    new_counts = np.asarray(counts, dtype=np.int32).copy()
    for k in range(len(counts)):
        if k in repl:
            parts.append(repl[k])
            new_counts[k] = len(repl[k])
        else:
            parts.append(tri[offs[k] : offs[k + 1]])
    tri2 = np.concatenate(parts) if parts else tri[:0]
    return np.ascontiguousarray(tri2), new_counts


def waves_pipelined(
    engine: BatchEngine,
    items: Iterable[Tuple[object, str]],
    *,
    lanes: int = 8192,
    slots: int = 3,
    max_wave_chars: int = 32 << 20,
    long_seg_len: int = 8192,
    pack_len: int = 0,
    stats: Optional[dict] = None,
    copy_cps: bool = False,
) -> Iterator[WaveResult]:
    """Yield :class:`WaveResult` per wave, in input order.

    ``copy_cps=True`` copies each wave's ``cps_flat`` out of the reused
    encode scratch slot, so the :class:`WaveResult` stays valid after
    the generator is advanced.  The default (zero-copy) alias is the
    fast path for consumers that format before calling ``next()`` —
    the contract in :class:`WaveResult`'s docstring.

    ``pack_len`` > 0 merges consecutive same-tag documents into
    ≤pack_len-char lanes (see :func:`_pack_items`), exact by stream
    semantics.  Callers that need per-ITEM event granularity must leave
    it 0.

    ``items`` yields ``(tag, doc)`` pairs (the tag is passed through —
    callers use it to route output, e.g. a corpus file index).  Event
    positions are document-relative.  The generator owns a prep and a
    fetch thread; closing it (``.close()``) or exhausting it joins
    them.  An exception in either thread is raised to the caller.

    ``stats``: optional dict, filled with cumulative per-stage wall
    seconds (``encode``, ``dispatch``, ``fetch``, ``decode``, and
    ``census``: choosing a per-wave engine's wave sets), wave and
    document counts,
    ``repairs`` (host chain repairs) and ``long_docs``.
    """
    dev = engine.device
    if dev.type == "cuda":
        # a first nvcc build inside the prep thread would stall the
        # pipeline and spoil the stage times
        build.load(build.TRANSDUCE)
    q: "queue.Queue" = queue.Queue()
    free: "queue.Queue" = queue.Queue()
    for _ in range(max(2, slots)):
        free.put(_Slot(dev))
    stop = threading.Event()
    err: List[BaseException] = []
    if pack_len:
        items = _pack_items(items, pack_len)
    st = stats if stats is not None else {}
    # "census": the prep thread's per-wave hot sets (0.0 unless
    # engine.per_wave)
    for k in ("encode", "dispatch", "fetch", "decode", "census"):
        st.setdefault(k, 0.0)
    for k in ("waves", "docs", "repairs", "long_docs"):
        st.setdefault(k, 0)

    can_cut = eot_in_sigma(engine.tok)

    def prep():
        pred = 1  # prep-side predicted entry chain (host, cheap)
        try:
            for kind, batch in _assemble(items, lanes, max_wave_chars):
                if stop.is_set():
                    return
                tags = [t for t, _, _ in batch]
                docs = [d for _, d, _ in batch]
                breaks = [b for _, _, b in batch]
                # interior-EOT chunks run as CUTS (no EOF epilogue) —
                # the stream-exact dispatch; the stream-final epilogue
                # arrives as split_documents' empty sentinel chunk
                cuts = [can_cut and d.endswith("\x04") for d in docs]
                entries, pred = predict_entries(
                    engine.encoder, docs, entry=pred, breaks=breaks
                )
                if kind == "long":
                    # giant document: exact speculative segmentation
                    # (its own device waves + host cut verification)
                    evs, exits = events_speculative_batch(
                        engine, docs, seg_len=long_seg_len,
                        entries=entries, stops=cuts,
                    )
                    evs = [
                        np.asarray(e, dtype=np.int32).reshape(-1, 3)
                        for e in evs
                    ]
                    st["long_docs"] += len(docs)
                    q.put(_Wave(tags, docs, None, None, entries,
                                breaks, events=evs, exits=exits,
                                cuts=cuts))
                    continue
                slot = free.get()  # backpressure: ring of reusable slots
                if stop.is_set():
                    return
                # per-wave hot set: census a sample of this wave's
                # documents (exact native walk) and tag the table for
                # the wave's own working set, before encoding, as the
                # JAX module does (jax_engine.wave_spec block comment)
                wspec = None
                if getattr(engine, "per_wave", False):
                    t0 = _time.time()
                    wspec = engine.wave_spec(docs)
                    st["census"] += _time.time() - t0
                t0 = _time.time()
                # Shape bucketing: L and B padded to powers of two.  K1
                # compiles nothing, but its event buffer is B x
                # max_steps_for(L_pad) int32 per wave, so equal shapes
                # let the caching allocator hand each slot's stream the
                # same blocks again instead of fragmenting device
                # memory.  Tail-lane pads are empty docs; the consumer
                # drops their events.
                L_max = max((len(d) for d in docs), default=1)
                L_pad = min(_bucket(max(L_max, 1), 128), MAX_SEGMENT)
                B_real = len(docs)
                B_pad = _bucket(max(B_real, 1), 8)
                full_docs = list(docs) + [""] * (B_pad - B_real)
                full_entries = np.concatenate(
                    [
                        np.asarray(entries, dtype=np.int32),
                        np.ones(B_pad - B_real, dtype=np.int32),
                    ]
                )
                # Lane placement: on a sharded engine, the snake deal of
                # balance_perm (the shards take contiguous blocks of
                # lanes, so each gets equal work); on one device a plain
                # length sort, which groups lanes of similar length into
                # one warp (K1 runs one lane per thread, so a warp
                # retires with its longest lane).  Results are
                # unpermuted at consume via inv[:B_real]; the entry
                # chain does not depend on lane placement.
                inv = None
                n_sh = getattr(engine, "n_shards", 1)
                lens_full = [len(d) for d in full_docs]
                if n_sh > 1 and B_real > n_sh:
                    from ..parallel.mesh import balance_perm

                    perm = balance_perm(lens_full, n_sh)
                elif B_real > 64 and min(lens_full[:B_real]) != max(
                    lens_full[:B_real]
                ):
                    perm = np.argsort(np.asarray(lens_full), kind="stable")
                else:
                    perm = None
                if perm is not None:
                    inv_full = np.empty_like(perm)
                    inv_full[perm] = np.arange(len(perm))
                    enc_docs = [full_docs[i] for i in perm]
                    enc_entries = full_entries[perm]
                    inv = inv_full[:B_real]
                else:
                    enc_docs = full_docs
                    enc_entries = full_entries
                # the native encoder writes meta straight into the
                # slot's (pinned) host tensor: sized to the wave first,
                # since the encoder silently replaces a buffer that is
                # too small with a fresh pageable one
                meta_h = slot.buf("meta", B_pad * L_pad, torch.int32)
                slot.scratch["meta"] = slot.host["meta"].numpy()
                r = native_encode_wave(engine.encoder, enc_docs,
                                       pad_to=L_pad, scratch=slot.scratch)
                if r is None:
                    slot.scratch.pop("cps_offs", None)  # not flat-laid-out
                    r = engine.encoder.encode_batch(enc_docs, pad_to=L_pad)
                meta, lengths, cps = r
                meta_h = meta_h.view(meta.shape)
                if meta.ctypes.data != meta_h.data_ptr():
                    meta_h.numpy()[...] = meta  # encoded elsewhere: copy in
                if "cps_offs" in slot.scratch:
                    cps_layout = (slot.scratch["cps"],
                                  slot.scratch["cps_offs"], lengths)
                else:
                    offs = np.zeros(len(cps), dtype=np.int64)
                    if len(cps) > 1:
                        np.cumsum([len(c) for c in cps[:-1]], out=offs[1:])
                    flat = (np.concatenate(cps) if cps
                            else np.zeros(0, dtype=np.int32))
                    cps_layout = (flat, offs,
                                  np.asarray([len(c) for c in cps],
                                             dtype=np.int32))
                lens_h = slot.buf("lengths", B_pad, torch.int32)
                lens_h.numpy()[:] = lengths
                ents_h = slot.buf("entries", B_pad, torch.int32)
                ents_h.numpy()[:] = enc_entries
                stops_h = slot.buf("stops", B_pad, torch.bool)
                stops_h.numpy()[:] = [can_cut and d.endswith("\x04")
                                      for d in enc_docs]
                st["encode"] += _time.time() - t0
                t0 = _time.time()
                with _on(dev, slot):
                    ev_d, counts_d, bad_d, state_d, _steps = (
                        engine.run_raw_async(meta_h, lens_h, ents_h, stops_h,
                                             wspec))
                    # no synchronize here: the fetch thread waits on this
                    # event, so the host goes on to encode the next wave
                    done = None
                    if slot.stream is not None:
                        done = torch.cuda.Event()
                        done.record()
                st["dispatch"] += _time.time() - t0
                st["waves"] += 1
                q.put(
                    _Wave(tags, docs,
                          (ev_d, counts_d, bad_d, state_d, done, cps_layout),
                          slot, entries, breaks, inv=inv, cuts=cuts,
                          n_enc=len(enc_docs), spec=wspec)
                )
        except BaseException as e:  # surfaced by the consumer
            err.append(e)
        finally:
            q.put(None)

    def _fetch_wave(wave: "_Wave") -> None:
        """Device→host fetch of one wave's results (in the fetch
        thread), the pipeline's only device→host traffic: on the slot's
        stream, after the wave's event, into the slot's pinned tensors.
        Replaces the device handles with numpy arrays so the consumer's
        decode and format overlap the NEXT wave's transfer."""
        ev_d, counts_d, bad_d, state_d, done, cps_layout = wave.handles
        slot = wave.slot
        B = len(wave.docs)
        Bf = wave.n_enc if wave.inv is not None else B
        t0 = _time.time()
        with _on(dev, slot):
            if done is not None:
                done.synchronize()  # this wave's K1, not the whole card
            small = [slot.to_host(k, x[:Bf]) for k, x in
                     (("counts", counts_d), ("bad", bad_d), ("state", state_d))]
            slot.wait()
            # copied out: the pinned tensors serve the slot's next wave
            counts, bad, state = (h.numpy().copy() for h in small)
            cmax = int(counts.max()) if counts.size else 0
            E = 32
            while E < cmax:
                E *= 2
            E = min(E, ev_d.shape[1])
            # slice on the device: padding lanes and empty columns never
            # cross the link
            ev_h = slot.to_host("ev", ev_d[:Bf, :E])
            slot.wait()
            ev = ev_h.numpy()
        st["fetch"] += _time.time() - t0
        wave.handles = ("np", ev, counts, bad, state, cps_layout)

    q2: "queue.Queue" = queue.Queue()

    def fetcher():
        try:
            while True:
                w = q.get()
                if w is None:
                    return
                if w.handles is not None and not stop.is_set():
                    _fetch_wave(w)
                q2.put(w)
        except BaseException as e:  # surfaced by the consumer
            err.append(e)
        finally:
            q2.put(None)

    t = threading.Thread(target=prep, name="datok-prep", daemon=True)
    t.start()
    tf = threading.Thread(target=fetcher, name="datok-fetch", daemon=True)
    tf.start()

    entry = 1  # TRUE packed entry context for the next document
    wave = None
    try:
        while True:
            wave = q2.get()
            if wave is None:
                if err:
                    raise err[0]
                break
            if wave.events is not None:  # precomputed long docs
                repl = {}
                for k, doc in enumerate(wave.docs):
                    if wave.breaks[k]:
                        entry = 1  # fresh stream: root by definition
                    if entry != int(wave.entries[k]):
                        st["repairs"] += 1
                        ev_l, entry = transduce_doc_exact(
                            engine.tok, doc, int(entry),
                            bool(wave.cuts[k]), encoder=engine.encoder,
                        )
                        repl[k] = np.asarray(
                            ev_l, dtype=np.int32
                        ).reshape(-1, 3)
                    else:
                        entry = int(wave.exits[k])
                evs = [repl.get(k, e) for k, e in enumerate(wave.events)]
                tri = (
                    np.concatenate(evs)
                    if evs
                    else np.zeros((0, 3), dtype=np.int32)
                )
                counts = np.asarray([len(e) for e in evs], dtype=np.int32)
                cps_l = [text_to_codepoints(d) for d in wave.docs]
                offs = np.zeros(len(cps_l), dtype=np.int64)
                if len(cps_l) > 1:
                    np.cumsum([len(c) for c in cps_l[:-1]], out=offs[1:])
                st["docs"] += len(wave.docs)
                yield WaveResult(
                    wave.tags, wave.docs, tri, counts,
                    np.concatenate(cps_l)
                    if cps_l else np.zeros(0, dtype=np.int32),
                    offs,
                    np.asarray([len(c) for c in cps_l], dtype=np.int32),
                )
                continue

            # the fetch thread already moved this wave's results to
            # host ("np" marker); length-sorted waves scatter real docs
            # over all encoded lanes, so Bf covered them all
            _tag, ev, counts, bad, state, cps_layout = wave.handles
            B = len(wave.docs)
            t0 = _time.time()
            tri, counts = decode_events_flat(ev, counts)
            cps_flat, cps_offs, cps_lens = cps_layout
            if wave.inv is not None:
                # restore input order; inv[:B] drops the shape-pad lanes
                inv = wave.inv
                offs_p = np.zeros(len(counts) + 1, dtype=np.int64)
                np.cumsum(counts, out=offs_p[1:])
                tri = (
                    np.concatenate(
                        [tri[offs_p[i] : offs_p[i + 1]] for i in inv]
                    )
                    if len(inv)
                    else tri[:0]
                )
                counts = counts[inv]
                bad = bad[inv]
                state = state[inv]
                cps_offs = np.asarray(cps_offs)[inv]
                cps_lens = np.asarray(cps_lens)[inv]
            st["decode"] += _time.time() - t0
            st["docs"] += B
            repl = {}
            for k, doc in enumerate(wave.docs):
                if wave.breaks[k]:
                    entry = 1  # fresh stream: root by definition
                # the prediction dispatched for this doc must equal the
                # TRUE entry (previous doc's actual exit); mismatches
                # (rare: models whose EOT arcs leave the root) replay
                # exactly on the host and realign the chain
                if bad[k] or entry != int(wave.entries[k]):
                    if bad[k] and divergence_debug_enabled():
                        dump_divergence(engine, doc, entry=int(entry))
                    st["repairs"] += 1
                    ev_l, entry = transduce_doc_exact(
                        engine.tok, doc, int(entry),
                        bool(wave.cuts[k]), encoder=engine.encoder,
                    )
                    repl[k] = np.asarray(ev_l, dtype=np.int32).reshape(-1, 3)
                else:
                    entry = int(state[k, 0])
            if repl:
                tri, counts = _splice(tri, counts, repl)
            if copy_cps:
                cps_flat = np.array(cps_flat, copy=True)
            yield WaveResult(
                wave.tags, wave.docs, tri, counts,
                cps_flat, cps_offs, cps_lens,
            )
            free.put(wave.slot)  # buffers reusable from here on
            wave = None
    finally:
        stop.set()
        # drain so the prep thread can't block on a full slot ring
        # (waves may sit in either queue or in the consumer's hand)
        if wave is not None and wave.slot is not None:
            free.put(wave.slot)
        for qq in (q, q2):
            try:
                while True:
                    w = qq.get_nowait()
                    if w is not None and w.slot is not None:
                        free.put(w.slot)
            except queue.Empty:
                pass
        # the drain may have stolen prep's final None from q; wake the
        # fetch thread unconditionally so it can exit
        q.put(None)
        # stop is set and the slot ring is drained, so the prep thread
        # exits after at most one in-flight wave (and the fetch thread
        # after the prep's final None); join without a practical
        # timeout, but warn instead of silently leaving a daemon thread
        # issuing device work
        t.join(timeout=300)
        tf.join(timeout=60)
        if t.is_alive() or tf.is_alive():
            warnings.warn(
                "datok pipeline thread did not exit within its join "
                "timeout; it may still be issuing device work on this "
                "engine",
                RuntimeWarning,
                stacklevel=2,
            )


def events_pipelined(
    engine: BatchEngine,
    items: Iterable[Tuple[object, str]],
    *,
    lanes: int = 8192,
    slots: int = 3,
    max_wave_chars: int = 32 << 20,
    long_seg_len: int = 8192,
    stats: Optional[dict] = None,
) -> Iterator[Tuple[object, str, np.ndarray]]:
    """Yield ``(tag, doc, events[N,3] int32)`` in input order.

    Per-document wrapper over :func:`waves_pipelined` (same arguments;
    see there for semantics and the ``stats`` dict)."""
    for w in waves_pipelined(
        engine, items, lanes=lanes, slots=slots,
        max_wave_chars=max_wave_chars, long_seg_len=long_seg_len,
        stats=stats,
    ):
        offs = np.zeros(len(w.counts) + 1, dtype=np.int64)
        np.cumsum(w.counts, out=offs[1:])
        for k, (tag, doc) in enumerate(zip(w.tags, w.docs)):
            yield tag, doc, w.tri[offs[k] : offs[k + 1]]


def tokenize_stream_pipelined(
    tok,
    text: str,
    writer: Optional[TokenWriter] = None,
    *,
    engine: Optional[BatchEngine] = None,
    device=None,
    lanes: int = 8192,
    flags: Optional[int] = None,
    pack_len: int = 1024,
    stats: Optional[dict] = None,
) -> TokenWriter:
    """Overlapped-pipeline twin of :func:`pipeline.tokenize_stream`.

    Byte-identical output; use for large streams where end-to-end wall
    clock matters.  When the writer is native (``NativeWriter``) the
    whole wave is formatted in one GIL-releasing C call.  ``engine`` and
    ``device`` as there; ``stats`` gains ``format`` seconds.
    """
    w = writer if writer is not None else TokenWriter(
        SIMPLE if flags is None else flags
    )
    engine = _engine(tok, engine, device)
    docs = split_stream(engine.tok, text)
    feed_wave = getattr(w, "feed_wave", None)
    feed = getattr(w, "feed", None)
    st = stats if stats is not None else {}
    st.setdefault("format", 0.0)
    for wave in waves_pipelined(
        engine, ((None, d) for d in docs), lanes=lanes, stats=st,
        pack_len=pack_len,
    ):
        t0 = _time.time()
        if feed_wave is not None:
            feed_wave(wave.tri, wave.counts, wave.cps_flat,
                      wave.cps_offs, wave.cps_lens)
        else:
            offs = np.zeros(len(wave.counts) + 1, dtype=np.int64)
            np.cumsum(wave.counts, out=offs[1:])
            for k, doc in enumerate(wave.docs):
                evs = wave.tri[offs[k] : offs[k + 1]]
                if feed is not None:
                    feed(
                        evs,
                        wave.cps_flat[
                            wave.cps_offs[k] :
                            wave.cps_offs[k] + wave.cps_lens[k]
                        ],
                    )
                else:
                    replay_events(
                        [tuple(r) for r in evs.tolist()], doc, w
                    )
        st["format"] += _time.time() - t0
    w.flush()
    return w
