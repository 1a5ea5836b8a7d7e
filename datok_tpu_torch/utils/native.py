"""ctypes bindings for the native host runtime (``native/datok_host.cpp``).

The port's copy of datok_tpu/utils/native.py: the same bindings over
the port's own copy of the source.  The shared library is built on
demand with g++ into ``datok_tpu_torch/_build/`` (through a temporary
file, so that concurrent processes never load half a library); every
consumer has a pure-Python fallback, so a missing toolchain degrades
gracefully.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import threading

import numpy as np

_lock = threading.Lock()
_lib = None
_tried = False

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_SRC = os.path.join(_PKG, "native", "datok_host.cpp")
_SO = os.path.join(_PKG, "_build", "libdatok_host.so")


def _build() -> str | None:
    if not os.path.exists(_SRC):
        return None
    so = _SO
    if os.path.exists(so) and os.path.getmtime(so) >= os.path.getmtime(_SRC):
        return so
    tmp = f"{so}.tmp{os.getpid()}.{threading.get_ident()}"
    try:
        os.makedirs(os.path.dirname(so), exist_ok=True)
        subprocess.run(
            ["g++", "-O3", "-march=native", "-pthread", "-shared", "-fPIC",
             "-o", tmp, _SRC],
            check=True,
            capture_output=True,
        )
        os.replace(tmp, so)
        return so
    except Exception:
        return None


def get_lib():
    """Load (building if needed) the native library, or None."""
    global _lib, _tried
    with _lock:
        if _lib is not None or _tried:
            return _lib
        _tried = True
        so = _build()
        if so is None:
            return None
        lib = ctypes.CDLL(so)
        i8p = ctypes.POINTER(ctypes.c_uint8)
        i32p = ctypes.POINTER(ctypes.c_int32)
        u32p = ctypes.POINTER(ctypes.c_uint32)

        lib.dt_encode.restype = ctypes.c_int64
        lib.dt_encode.argtypes = [
            i8p, ctypes.c_int64, i32p, i32p, i32p, ctypes.c_int64,
            ctypes.c_int32, i32p, i32p,
        ]
        lib.dt_encode2.restype = ctypes.c_int64
        lib.dt_encode2.argtypes = [
            i8p, ctypes.c_int64, i32p, i32p, i32p, ctypes.c_int64,
            ctypes.c_int32, i8p, i32p, ctypes.c_int64, i32p, i32p,
        ]
        i64p0 = ctypes.POINTER(ctypes.c_int64)
        lib.dt_cp_lens.restype = None
        lib.dt_cp_lens.argtypes = [i8p, i64p0, ctypes.c_int64, i32p]
        lib.dt_encode_batch.restype = ctypes.c_int64
        lib.dt_encode_batch.argtypes = [
            i8p, i64p0, ctypes.c_int64, i32p, i32p, i32p, ctypes.c_int64,
            ctypes.c_int32, i8p, i32p, ctypes.c_int64, ctypes.c_int64,
            i32p, i32p, i32p, ctypes.c_int32,
        ]
        lib.dt_transduce.restype = ctypes.c_int64
        lib.dt_transduce.argtypes = [
            u32p, ctypes.c_int32, ctypes.c_int32, ctypes.c_int32,
            ctypes.c_int32, ctypes.c_int32, i32p, ctypes.c_int64, i32p,
            ctypes.c_int64, i32p,
        ]
        i64p = ctypes.POINTER(ctypes.c_int64)
        lib.dt_cold_rate.restype = ctypes.c_int64
        lib.dt_cold_rate.argtypes = [
            u32p, ctypes.c_int32, ctypes.c_int32, ctypes.c_int32,
            ctypes.c_int32, i32p, ctypes.c_int64, i8p, i64p,
        ]
        lib.dt_state_census.restype = ctypes.c_int64
        lib.dt_state_census.argtypes = [
            u32p, ctypes.c_int32, ctypes.c_int32, ctypes.c_int32,
            ctypes.c_int32, i32p, ctypes.c_int64, i32p,
        ]
        lib.dt_cut_walk.restype = ctypes.c_int64
        lib.dt_cut_walk.argtypes = [
            u32p, ctypes.c_int32, ctypes.c_int32, ctypes.c_int32,
            ctypes.c_int32, ctypes.c_int32, i32p, ctypes.c_int64,
            ctypes.c_int64, i32p, ctypes.c_int64, i32p, i64p,
        ]
        i64p_ = ctypes.POINTER(ctypes.c_int64)
        lib.dt_da_build.restype = ctypes.c_void_p
        lib.dt_da_build.argtypes = [
            i64p_, i32p, i32p, i8p, ctypes.c_int32, ctypes.c_int32,
        ]
        lib.dt_da_size.restype = ctypes.c_int64
        lib.dt_da_size.argtypes = [ctypes.c_void_p]
        lib.dt_da_copy.argtypes = [ctypes.c_void_p, u32p, u32p]
        lib.dt_da_free.argtypes = [ctypes.c_void_p]
        lib.dt_writer_new.restype = ctypes.c_void_p
        lib.dt_writer_new.argtypes = [ctypes.c_int]
        lib.dt_writer_free.argtypes = [ctypes.c_void_p]
        lib.dt_writer_feed.argtypes = [
            ctypes.c_void_p, i32p, ctypes.c_int64, i32p, ctypes.c_int64,
        ]
        lib.dt_writer_feed_wave.argtypes = [
            ctypes.c_void_p, i32p, i32p, ctypes.c_int64, i32p, i64p, i32p,
        ]
        lib.dt_writer_feed_wave_mt.argtypes = [
            ctypes.c_void_p, i32p, i32p, ctypes.c_int64, i32p, i64p, i32p,
            ctypes.c_int,
        ]
        lib.dt_decode_events.argtypes = [
            u32p, ctypes.c_int64, ctypes.c_int64, i32p, i32p, ctypes.c_int,
        ]
        lib.dt_writer_size.restype = ctypes.c_int64
        lib.dt_writer_size.argtypes = [ctypes.c_void_p]
        lib.dt_writer_copy.argtypes = [ctypes.c_void_p, i8p]
        lib.dt_writer_reset_output.argtypes = [ctypes.c_void_p]
        _lib = lib
        return _lib


def _ptr(a, ctype):
    return a.ctypes.data_as(ctypes.POINTER(ctype))


def native_encode(encoder, data: bytes, device: bool = False):
    """UTF-8 bytes → (codepoints, metas) via the native library.

    Returns None if the library is unavailable.

    The default (``device=False``) metas feed the host-side scalar
    walks, which read only the symbol/flag fields and the default
    ``[a-z]`` run class.  ``device=True`` additionally stamps the
    engine-coupled fields — the encoder's adaptive skip-class run
    lengths and the symbol CLASS bits (meta bits 24..30, encode.py) —
    so the output is valid input for the class-compressed device
    kernel, bit-identical to ``encoder.encode``.
    """
    lib = get_lib()
    if lib is None:
        return None
    n = len(data)
    buf = np.frombuffer(data, dtype=np.uint8)
    cps = np.empty(n, dtype=np.int32)
    metas = np.empty(n, dtype=np.int32)
    ascii_tab = np.ascontiguousarray(encoder.ascii_tab, dtype=np.int32)
    keys = np.ascontiguousarray(encoder.keys, dtype=np.int32)
    vals = np.ascontiguousarray(encoder.vals, dtype=np.int32)
    if device:
        lc = encoder._lc_mask_u8
        if lc is None:
            lc = encoder._lc_mask_u8 = np.ascontiguousarray(
                encoder.lc_mask, dtype=np.uint8
            )
        cls_tab = encoder.cls_tab
        out = lib.dt_encode2(
            _ptr(buf, ctypes.c_uint8), n,
            _ptr(ascii_tab, ctypes.c_int32),
            _ptr(keys, ctypes.c_int32), _ptr(vals, ctypes.c_int32),
            len(keys), encoder.fallback,
            _ptr(lc, ctypes.c_uint8),
            (
                _ptr(cls_tab, ctypes.c_int32)
                if cls_tab is not None
                else None
            ),
            0 if cls_tab is None else len(cls_tab),
            _ptr(cps, ctypes.c_int32), _ptr(metas, ctypes.c_int32),
        )
    else:
        out = lib.dt_encode(
            _ptr(buf, ctypes.c_uint8), n,
            _ptr(ascii_tab, ctypes.c_int32),
            _ptr(keys, ctypes.c_int32), _ptr(vals, ctypes.c_int32), len(keys),
            encoder.fallback,
            _ptr(cps, ctypes.c_int32), _ptr(metas, ctypes.c_int32),
        )
    return cps[:out], metas[:out]


def _encoder_tables(encoder):
    """Contiguous C views of an encoder's tables, cached on it."""
    t = getattr(encoder, "_native_tabs", None)
    if t is None:
        t = (
            np.ascontiguousarray(encoder.ascii_tab, dtype=np.int32),
            np.ascontiguousarray(encoder.keys, dtype=np.int32),
            np.ascontiguousarray(encoder.vals, dtype=np.int32),
            np.ascontiguousarray(encoder.lc_mask, dtype=np.uint8),
            (
                None
                if encoder.cls_tab is None
                else np.ascontiguousarray(encoder.cls_tab, dtype=np.int32)
            ),
        )
        encoder._native_tabs = t
    return t


def _scratch_i32(scratch, key, n):
    """Reusable int32 buffer from a caller-held pool (page-fault
    amortization across waves); fresh allocation when no pool."""
    if scratch is None:
        return np.empty(n, dtype=np.int32)
    buf = scratch.get(key)
    if buf is None or buf.size < n:
        buf = np.empty(int(n * 1.25) + 64, dtype=np.int32)
        scratch[key] = buf
    return buf[:n]


def native_encode_wave(encoder, texts, pad_to=None, threads=None,
                       scratch=None):
    """Encode a whole wave of texts into the padded device layout.

    One GIL-releasing, internally-threaded C call per wave
    (``dt_encode_batch``; pad cells zeroed row-wise in C).  Returns
    ``(meta[B, L], lengths[B], cps)`` matching
    ``SymbolEncoder.encode_batch`` bit for bit, or None when the
    native library is unavailable.  ``scratch``: optional dict a
    pipelined caller passes to reuse the meta/cps buffers across waves
    (fresh 100+ MB allocations cost more in page faults than the
    encode itself).
    """
    lib = get_lib()
    if lib is None:
        return None
    if threads is None:
        threads = host_workers()
    datas = [t.encode("utf-8", "surrogatepass") for t in texts]
    B = len(datas)
    offs = np.zeros(B + 1, dtype=np.int64)
    np.cumsum([len(d) for d in datas], out=offs[1:])
    total = int(offs[-1])
    data = b"".join(datas)
    buf = (
        np.frombuffer(data, dtype=np.uint8)
        if total
        else np.zeros(1, dtype=np.uint8)
    )
    # exact per-row codepoint count = bytes minus UTF-8 continuation
    # bytes — lets the meta array be allocated at its final width
    cp_lens = np.empty(max(B, 1), dtype=np.int32)
    lib.dt_cp_lens(
        _ptr(buf, ctypes.c_uint8), _ptr(offs, ctypes.c_int64), B,
        _ptr(cp_lens, ctypes.c_int32),
    )
    L = max(1, int(cp_lens[:B].max()) if B else 1)
    if pad_to is not None:
        if L > pad_to:
            raise ValueError(f"text length {L} exceeds pad_to {pad_to}")
        L = pad_to
    meta = _scratch_i32(scratch, "meta", B * L).reshape(B, L)
    cps_flat = _scratch_i32(scratch, "cps", max(total, 1))
    lengths = np.empty(B, dtype=np.int32)
    at, keys, vals, lc, cls_tab = _encoder_tables(encoder)
    rc = lib.dt_encode_batch(
        _ptr(buf, ctypes.c_uint8), _ptr(offs, ctypes.c_int64), B,
        _ptr(at, ctypes.c_int32), _ptr(keys, ctypes.c_int32),
        _ptr(vals, ctypes.c_int32), len(keys), encoder.fallback,
        _ptr(lc, ctypes.c_uint8),
        None if cls_tab is None else _ptr(cls_tab, ctypes.c_int32),
        0 if cls_tab is None else len(cls_tab),
        L, _ptr(meta, ctypes.c_int32),
        _ptr(cps_flat, ctypes.c_int32), _ptr(lengths, ctypes.c_int32),
        threads,
    )
    if rc != 0:
        return None
    cps = [
        cps_flat[offs[i] : offs[i] + int(lengths[i])] for i in range(B)
    ]
    if scratch is not None:
        # flat codepoint layout for wave-level formatting
        # (dt_writer_feed_wave): doc i's codepoints live at
        # cps_flat[offs[i] : offs[i]+lengths[i]] — offs are UTF-8 byte
        # offsets (the encoder writes each doc at its byte position)
        scratch["cps_offs"] = offs[:B]
        scratch["cps_lens"] = lengths
    return meta, lengths, cps


def host_workers() -> int:
    """Host-stage worker count: DATOK_HOST_WORKERS env, else CPU count.

    One knob for every parallel host stage (encode threads, decode
    threads, wave-format chunks) so production hosts with many cores
    scale the feeding/draining stages without code changes
    (SURVEY.md §5 "communication backend": throughput is bounded by
    input feeding, not collectives).
    """
    v = os.environ.get("DATOK_HOST_WORKERS")
    if v:
        try:
            return max(1, int(v))
        except ValueError:
            pass
    # Cap the default: up to three stages (encode prep, decode+format
    # consumer, fetch) can each take this many threads concurrently in
    # the wave pipeline, so an uncapped many-core default oversubscribes
    # the host and shrinks feed_wave_mt chunks toward per-doc
    # granularity.  DATOK_HOST_WORKERS is the explicit override.
    return max(1, min(os.cpu_count() or 1, 16))


def native_decode_events(ev: np.ndarray, counts: np.ndarray,
                         workers: int | None = None):
    """Decode the compacted (B, E) packed event buffer to one flat
    (N, 3) int32 triple array (see jax_engine.decode_events_flat) via
    the threaded native decoder, or None when unavailable."""
    lib = get_lib()
    if lib is None:
        return None
    ev = np.ascontiguousarray(ev, dtype=np.uint32)
    counts = np.ascontiguousarray(counts, dtype=np.int32)
    B, E = ev.shape
    # A narrower ev slice than counts implies would decode with
    # per-lane truncation, and every downstream consumer computes
    # document offsets from the UNCLAMPED counts — cross-document
    # event misattribution, not a local error.  Fail loud instead
    # (the C-side clamp stays as the out-of-bounds backstop).
    if counts.size and int(counts.max()) > E:
        raise ValueError(
            f"event rows narrower than counts: E={E} < "
            f"max(counts)={int(counts.max())}"
        )
    total = int(np.minimum(counts, E).clip(min=0).sum())
    tri = np.empty((total, 3), dtype=np.int32)
    if workers is None:
        workers = host_workers()
    lib.dt_decode_events(
        _ptr(ev, ctypes.c_uint32), B, E, _ptr(counts, ctypes.c_int32),
        _ptr(tri, ctypes.c_int32), int(workers),
    )
    return tri


def native_da_build(auto):
    """Double-array construction via the native builder, or None.

    Bit-identical to the Python builder in fsa/double_array.py (same
    BFS order and placement policy); returns (base, check) uint32
    arrays with the array size already stored in check[1].
    """
    lib = get_lib()
    if lib is None:
        return None
    n_states = len(auto.transitions) - 1
    offs = np.zeros(n_states + 2, dtype=np.int64)
    syms: list = []
    ends: list = []
    flags: list = []
    for s in range(1, n_states + 1):
        trans = auto.transitions[s]
        if trans:
            for a in sorted(trans.keys()):
                syms.append(a)
                if a != auto.final:
                    e = trans[a]
                    ends.append(e.end)
                    flags.append(
                        (1 if e.nontoken else 0) | (2 if e.tokenend else 0)
                    )
                else:
                    ends.append(0)
                    flags.append(0)
        offs[s + 1] = len(syms)
    arc_sym = np.asarray(syms, dtype=np.int32)
    arc_end = np.asarray(ends, dtype=np.int32)
    arc_flags = np.asarray(flags, dtype=np.uint8)
    h = lib.dt_da_build(
        _ptr(offs, ctypes.c_int64),
        _ptr(arc_sym, ctypes.c_int32),
        _ptr(arc_end, ctypes.c_int32),
        _ptr(arc_flags, ctypes.c_uint8),
        n_states,
        auto.final,
    )
    if not h:
        return None
    try:
        n = lib.dt_da_size(h)
        base = np.empty(n, dtype=np.uint32)
        check = np.empty(n, dtype=np.uint32)
        lib.dt_da_copy(
            h, _ptr(base, ctypes.c_uint32), _ptr(check, ctypes.c_uint32)
        )
    finally:
        lib.dt_da_free(h)
    return base, check


def native_transduce_events(
    tok, metas: np.ndarray, as_array: bool = False, entry_state: int = 1,
    exit_box=None,
):
    """Scalar matrix transduce via the native library (events), or None.

    With ``as_array`` returns an (N, 3) int32 array instead of tuples.
    """
    lib = get_lib()
    if lib is None or tok.type() != "MATOK":
        return None
    n = len(metas)
    cap = (2 * n + 16) * 3
    ev = np.empty(cap, dtype=np.int32)
    table = getattr(tok, "_native_table", None)
    if table is None:
        table = np.ascontiguousarray(tok.array, dtype=np.uint32)
        tok._native_table = table
    metas = np.ascontiguousarray(metas, dtype=np.int32)
    t_out = np.zeros(1, dtype=np.int32)
    cnt = lib.dt_transduce(
        _ptr(table, ctypes.c_uint32), tok.state_count,
        tok.epsilon, tok.unknown, tok.identity, entry_state,
        _ptr(metas, ctypes.c_int32), n,
        _ptr(ev, ctypes.c_int32), cap, _ptr(t_out, ctypes.c_int32),
    )
    if cnt < 0:
        return None
    if exit_box is not None:
        exit_box.append(int(t_out[0]))
    tri = ev[: cnt * 3].reshape(-1, 3)
    if as_array:
        return tri.copy()
    return [tuple(r) for r in tri.tolist()]


def native_cold_rate(tok, metas: np.ndarray, hot_mask: np.ndarray):
    """Cold-fetch fraction of the exact transduce walk over ``metas``
    against a hot-set membership bitmap, or ``None`` when the native
    library is unavailable.

    ``hot_mask``: uint8 (state_count + 1,), 1 for hot states.  Returns
    ``(cold, fetches)`` — each cold fetch is a would-be stall of the
    fused kernel, the statistic that drives adaptive hot-set selection
    (every stall costs roughly one kernel round of latency for the
    lane, see pallas_engine's injection note).
    """
    lib = get_lib()
    if lib is None or tok.type() != "MATOK":
        return None
    table = getattr(tok, "_native_table", None)
    if table is None:
        table = np.ascontiguousarray(tok.array, dtype=np.uint32)
        tok._native_table = table
    metas = np.ascontiguousarray(metas, dtype=np.int32)
    hot_mask = np.ascontiguousarray(hot_mask, dtype=np.uint8)
    fetches = np.zeros(1, dtype=np.int64)
    cold = lib.dt_cold_rate(
        _ptr(table, ctypes.c_uint32), tok.state_count,
        tok.epsilon, tok.unknown, tok.identity,
        _ptr(metas, ctypes.c_int32), len(metas),
        _ptr(hot_mask, ctypes.c_uint8),
        fetches.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
    )
    return int(cold), int(fetches[0])


def native_state_census(tok, metas: np.ndarray):
    """Histogram of transition-fetch SOURCE states of the exact walk
    over ``metas`` (the per-wave hot-set selection statistic), or
    ``None`` when the native library is unavailable.

    Returns ``(counts, fetches)`` — counts int32 (state_count + 1,).
    A wave's own fetch working set is tiny (measured 458 states at
    99.95% coverage on novel prose, bench_micro/probe_novel.py), so
    the top-H census states make a near-perfectly covering per-wave
    hot set where a corpus-profiled one runs percent-level cold.
    """
    lib = get_lib()
    if lib is None or tok.type() != "MATOK":
        return None
    table = getattr(tok, "_native_table", None)
    if table is None:
        table = np.ascontiguousarray(tok.array, dtype=np.uint32)
        tok._native_table = table
    metas = np.ascontiguousarray(metas, dtype=np.int32)
    counts = np.zeros(tok.state_count + 1, dtype=np.int32)
    fetches = lib.dt_state_census(
        _ptr(table, ctypes.c_uint32), tok.state_count,
        tok.epsilon, tok.unknown, tok.identity,
        _ptr(metas, ctypes.c_int32), len(metas),
        _ptr(counts, ctypes.c_int32),
    )
    return counts, int(fetches)


def native_cut_walk(
    tok, metas: np.ndarray, entry_state: int, start: int, stop_at: int
):
    """Cut walk via the native library, or None if unavailable.

    ``metas`` are the *full document* packed symbol metas (absolute
    indexing).  Returns ``(events, rewinds)`` matching the oracle's
    ``transduce_events(start=, stop_at=, rewinds_box=)`` semantics:
    events as (kind, start, end) tuples, rewinds as
    (pos, packed_ctx, n_events_so_far) tuples including the entry.
    """
    lib = get_lib()
    if lib is None or tok.type() != "MATOK":
        return None
    span = max(0, int(stop_at) - int(start))
    ev_cap = (2 * span + 16) * 3
    rw_cap = (span + 16) * 3
    ev = np.empty(ev_cap, dtype=np.int32)
    rw = np.empty(rw_cap, dtype=np.int32)
    n_rw = np.array([rw_cap], dtype=np.int64)
    table = getattr(tok, "_native_table", None)
    if table is None:
        table = np.ascontiguousarray(tok.array, dtype=np.uint32)
        tok._native_table = table
    metas = np.ascontiguousarray(metas, dtype=np.int32)
    cnt = lib.dt_cut_walk(
        _ptr(table, ctypes.c_uint32), tok.state_count,
        tok.epsilon, tok.unknown, tok.identity, int(entry_state),
        _ptr(metas, ctypes.c_int32), int(start), int(stop_at),
        _ptr(ev, ctypes.c_int32), ev_cap,
        _ptr(rw, ctypes.c_int32), _ptr(n_rw, ctypes.c_int64),
    )
    if cnt < 0:
        return None
    events = [tuple(r) for r in ev[: cnt * 3].reshape(-1, 3).tolist()]
    rewinds = [
        tuple(r) for r in rw[: int(n_rw[0]) * 3].reshape(-1, 3).tolist()
    ]
    return events, rewinds


class NativeWriter:
    """C++ TokenWriter-parity formatter fed by event arrays."""

    def __init__(self, flags: int):
        self.lib = get_lib()
        if self.lib is None:
            raise RuntimeError("native library unavailable")
        self.h = self.lib.dt_writer_new(flags)

    def feed(self, events, cps: np.ndarray) -> None:
        ev = np.asarray(events, dtype=np.int32).reshape(-1)
        cps = np.ascontiguousarray(cps, dtype=np.int32)
        self.lib.dt_writer_feed(
            self.h, _ptr(ev, ctypes.c_int32), len(ev) // 3,
            _ptr(cps, ctypes.c_int32), len(cps),
        )

    def feed_wave(self, ev_tri, ev_counts, cps_flat, cps_offs,
                  cps_lens, workers: int | None = None) -> None:
        """Replay a whole wave (see dt_writer_feed_wave): ``ev_tri`` is
        the (N, 3) concatenation of all documents' events, documents
        delimited by ``ev_counts``; codepoints for document i live at
        ``cps_flat[cps_offs[i] : +cps_lens[i]]``.

        ``workers`` > 1 splits the wave at clean writer boundaries and
        formats chunks on parallel OS threads (dt_writer_feed_wave_mt;
        byte-identical by construction).  Default: DATOK_HOST_WORKERS
        env var, else the CPU count.
        """
        ev = np.ascontiguousarray(ev_tri, dtype=np.int32)
        ev_counts = np.ascontiguousarray(ev_counts, dtype=np.int32)
        cps_flat = np.ascontiguousarray(cps_flat, dtype=np.int32)
        cps_offs = np.ascontiguousarray(cps_offs, dtype=np.int64)
        cps_lens = np.ascontiguousarray(cps_lens, dtype=np.int32)
        if workers is None:
            workers = host_workers()
        self.lib.dt_writer_feed_wave_mt(
            self.h, _ptr(ev, ctypes.c_int32),
            _ptr(ev_counts, ctypes.c_int32), len(ev_counts),
            _ptr(cps_flat, ctypes.c_int32),
            _ptr(cps_offs, ctypes.c_int64),
            _ptr(cps_lens, ctypes.c_int32),
            int(workers),
        )

    def getvalue(self) -> str:
        n = self.lib.dt_writer_size(self.h)
        buf = np.empty(n, dtype=np.uint8)
        if n:
            self.lib.dt_writer_copy(self.h, _ptr(buf, ctypes.c_uint8))
        return buf.tobytes().decode("utf-8")

    def flush(self) -> None:  # TokenWriter API compat
        pass

    def __del__(self):
        try:
            self.lib.dt_writer_free(self.h)
        except Exception:
            pass
