"""The port's benchmark: the card's rates in one guarded JSON line.

    python3 -m datok_tpu_torch.bench [--lanes B] [--len L] [--reps N]
                                     [--fast] [--e2e-mb MB] [--profile]

The counterpart of the JAX package's ``bench.py``.  It drives the
port's entry points on the card (``BatchEngine.run_raw_device``,
``events_batch`` with the native writer, ``tokenize_stream_pipelined``,
``tokenize_stream``, ``cli.main(["corpus", ...])``, ``ShardedEngine``),
and every row launches K1 (``csrc/transduce.cu``): its full form, and
its general form over a double array in ``datok_general``.  Rows, in
order, with the key each prints at the top of the line (MB/s of UTF-8
input, the median of ``--reps`` runs after two warm-ups):

- ``value`` (``uniform``): ``[doc] * B`` on the default engine, the
  inputs staged on the card first; the timed call is ``run_raw_device``
  and a read of the bad-lane count, which waits for K1;
  ``uniform_wave_mbps`` and ``wave_rung_h``: the same with the wave's
  own hot set (``hot_size="auto"``, ``per_wave=True``), the A/B beside
  the headline: on an H100 no hot set beat none;
- ``device_time_mbps``: bytes over the device time of every kernel of
  one uniform call (``torch.profiler``), with K1's share;
- ``hetero_mbps``, ``hetero_wave_mbps``: ``doc`` rotated a lane
  (bench.py:457-460); ``mixed_mbps``, ``mixed_wave_mbps``: the
  conformance scenarios cycled over lanes of L/4..L, sorted by length;
  ``mixed_pipeline``: B mixed documents as one stream through
  ``tokenize_stream_pipelined(lanes=B // 2, pack_len=0)``;
  ``novel_mbps``: prose of made-up words;
- ``en_mbps``: the EN model named by ``DATOK_EN_MODEL`` on
  ``BENCH_TEXT_EN`` lanes, or null with ``en_skipped``;
- ``datok_mbps``: the DE-size double array (``synth_datok``) through
  ``"auto"`` (converted to the matrix); ``datok_general_mbps``: through
  ``engine="general"``, K1's double-array form;
- ``e2e_mbps``: one wave of the smoke's phase-4 texts through
  ``events_batch`` and ``NativeWriter`` (PERF.md §2);
- ``pipelined_mbps``, ``pipelined_stage_mbps``: ``--e2e-mb`` MB of
  ``doc`` through ``tokenize_stream_pipelined(lanes=B // 2)``.  The
  JAX ``bench.py`` calls this stream ``e2e_mbps``; here the names are
  PERF.md's;
- ``stream_mbps``: the smoke's phase-7 stream through the serial
  ``tokenize_stream``; ``corpus_mbps``: 64 files through
  ``cli.main(["corpus", ...])``, the model's load, manifest and file
  I/O included;
- ``sharded``: ``ShardedEngine()`` over every card on the pipelined
  stream, beside the single engine's rate (on one card the sharded
  launch path only);
- ``host_scaling``: the native encode, decode and format stages at
  W workers, [median, min, max] over ``BENCH_HOST_REPS``, and each at
  the widest W in as many spawned processes.

Every row carries ``correct``, ``bad_lanes`` (lanes of its last run
over their step budget, repaired on the host), ``spread`` ([min, max]
beside the median) and its own K1 launches (``k1_launches``).  Outside
the timed window every lane is held to the native oracle
(``native_transduce_events``, then the native writer), and every stream
and corpus file byte for byte to the oracle over it as one lane.  A row
that raises, differs, or whose K1 did not launch ends the run before
the line is printed; nothing here catches a row's failure.  Only an
absent model file gives null with a reason.

The DE rows run ``synth_tokenizer()`` (the DE model's shape) unless
``DATOK_DE_MODEL`` names a ``.matok`` file.  The card is the default
and required: ``--device cpu`` runs the plain machine, for tests, where
the wrappers count no K1 launch (a test counts them in their place).
"""

from __future__ import annotations

import argparse
import contextlib
import io
import json
import multiprocessing
import os
import statistics
import subprocess
import sys
import tempfile
import time
from typing import Callable, List, Optional, Sequence

import numpy as np
import torch

from . import cli
from .fsa.io import load_tokenizer_file
from .kernels import transduce as kt
from .parallel.mesh import ShardedEngine
from .runtime import engine as engine_mod
from .runtime.decode import decode_events_compact
from .runtime.encode import text_to_codepoints
from .runtime.engine import BatchEngine
from .runtime.overlap import tokenize_stream_pipelined
from .runtime.pipeline import tokenize_stream
from .runtime.writer import SIMPLE
from .testing.synth import DE_N_ABBREV, synth_datok, synth_text, synth_tokenizer
from .utils.native import (NativeWriter, host_workers, native_decode_events,
                           native_encode, native_encode_wave,
                           native_transduce_events)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SCENARIOS = os.path.join(ROOT, "conformance", "scenarios.json")
SEED = 0

# the reference's benchmark text (bench.py:78-86, matrix_test.go:13-21)
BENCH_TEXT = """Der Vorsitzende der Abk. hat gewählt. Gefunden auf wikipedia.org. Ich bin unter korap@ids-mannheim.de erreichbar.
Unsere Website ist https://korap.ids-mannheim.de/?q=Baum. Unser Server ist 10.0.10.51. Zu 50.4% ist es sicher.
Der Termin ist am 5.9.2018.
Ich habe die readme.txt heruntergeladen.
Ausschalten!!! Hast Du nicht gehört???
Ich wohne in der Weststr. und Du? Kupietz und Schmidt [2018]: Korpuslinguistik. Dieses verf***** Kleid! Ich habe die readme.txt heruntergeladen.
Er sagte: \"Es geht mir gut!\", daraufhin ging er. &quot;Das ist von C&A!&quot; Früher bzw. später ... Sie erreichte den 1. Platz!
Archive:  Ich bin kein zip. D'dorf Ku'damm Lu'hafen M'gladbach W'schaft.
Mach's macht's was'n ist's haste willste kannste biste kriegste."""

# the JAX package's English text (bench.py:91-98)
BENCH_TEXT_EN = (
    "Don't you think they're ready? We'll see it by Jan. 3rd, won't we. "
    "I'm sure it's Mr. Smith's car -- he can't park there. "
    "Visit https://en.wikipedia.org/wiki/Token or mail info@example.org. "
    "Prof. Jones et al. published on Feb. 29, 2016 at www.example.com. "
    "The U.S.A. isn't the U.K.; approx. 50.4% agreed vs. 23% who didn't. "
    "Cats, dogs etc. cost $4.50 apiece in Oct. -- quite a lot, isn't it? "
)

# the stream of smoke phase 7: (count, shortest, longest) of documents
# of 1-16 KB, of long ones of 0.5-1.5 MB, and (count, size) of the
# pieces of seeded text they are cut from
STREAM_DOCS = (2000, 1 << 10, 16 << 10)
STREAM_LONG = (16, 1 << 19, 3 << 19)
STREAM_POOL = (64, 1 << 16)
CORPUS_FILES = 64
HOST_WIDTHS = (1, 2, 4, 8, 16)
# the overlapped pipeline's stages (its ``stats`` seconds)
_STAGES = ("encode", "dispatch", "fetch", "decode", "format")

ROWS = ("uniform", "uniform_wave", "device_time", "hetero", "hetero_wave",
        "mixed", "mixed_wave", "mixed_pipeline", "novel", "en", "datok",
        "datok_general", "e2e", "pipelined", "stream", "corpus", "sharded",
        "host_scaling")
FAST_ROWS = ROWS[:5]  # BENCH_FAST: the headline, device time and hetero


# ---- workloads --------------------------------------------------------------

def bench_doc(L: int, text: str = BENCH_TEXT) -> str:
    """``text`` repeated, cut to L - 2 characters, then ``".\\x04"``
    (bench.py:414)."""
    return (text * (L // len(text) + 1))[: L - 2] + ".\x04"


def rotated_texts(doc: str, B: int, L: int) -> List[str]:
    """Lane i reads ``doc`` rotated by (i * 131) % (L - 2) characters
    (bench.py:457-460)."""
    return [(doc[(i * 131) % (L - 2):-2] + doc[: (i * 131) % (L - 2)]) + ".\x04"
            for i in range(B)]


def mixed_texts(B: int, L: int) -> List[str]:
    """The conformance scenarios' inputs (and ``BENCH_TEXT``) cycled
    into documents of L/4..L characters, a copy of
    bench_micro/probe_hetero_mixed.py:23-47 ``hetero_texts``; the
    scenarios are read from the repository, wherever the caller runs."""
    with open(SCENARIOS, encoding="utf-8") as f:
        scen = json.load(f)
    pool = [
        s["input"].replace("\x04", " ")
        for s in scen if s.get("input") and len(s["input"]) > 20
    ]
    pool += [BENCH_TEXT]
    rng = np.random.RandomState(7)
    texts = []
    for _ in range(B):
        target = int(L // 4 + (rng.rand() * (3 * L // 4 - 2)))
        buf = []
        n = 0
        j = rng.randint(len(pool))
        while n < target:
            t = pool[(j + len(buf)) % len(pool)]
            buf.append(t)
            n += len(t) + 1
        texts.append(" ".join(buf)[: target - 2] + ".\x04")
    return texts


_SYL = (
    "ver ge be ent er zer an auf aus vor nach über unter zwischen "
    "hand werk schaft ung keit heit lich bar sam haus berg tal feld "
    "wald bach stein brück dorf burg heim hof gart mark platz weg "
    "stras lauf spiel werk zeug kraft stoff licht schatt morg abend "
    "nacht wint somm früh spät grün blau rot gelb schwarz weiß grau "
    "klein groß lang kurz breit schmal tief hoch nied flach rund "
    "spitz stumpf warm kalt heiß kühl nass trock hart weich fest "
    "los voll leer ganz halb viert drit zweit letz erst neu alt "
    "jung frisch reif roh gar fein grob zart rau glatt krumm "
).split()
_END_N = ["e", "en", "er", "es", "ung", "heit", "keit", "schaft", ""]
_END_V = ["t", "te", "ten", "st", "est", "end", ""]


def novel_texts(B: int, L: int, seed: int = 11) -> List[str]:
    """Pseudo-German prose of syllable words that no profile holds, a
    copy of bench_micro/probe_novel.py:48-73 ``novel_texts``."""
    rng = np.random.RandomState(seed)
    texts = []
    for _ in range(B):
        target = L - 2
        parts = []
        n = 0
        first = True
        while n < target:
            k = rng.randint(1, 4)
            w = "".join(_SYL[rng.randint(len(_SYL))] for _ in range(k))
            w += (_END_N if rng.rand() < 0.6 else _END_V)[rng.randint(7)]
            if first or rng.rand() < 0.4:
                w = w.capitalize()
            first = False
            parts.append(w)
            n += len(w) + 1
            if rng.rand() < 0.12:
                parts[-1] += "."
                first = True
            elif rng.rand() < 0.08:
                parts[-1] += ","
        texts.append(" ".join(parts)[: target] + ".\x04")
    return texts


def bench_lane(i: int, L: int) -> str:
    """BENCH_TEXT rotated by a per-lane offset, L characters long."""
    off = (i * 131) % len(BENCH_TEXT)
    rot = BENCH_TEXT[off:] + BENCH_TEXT[:off]
    return (rot * (L // len(rot) + 1))[:L]


def wave_texts(tok, B: int, L: int, synth_text: Callable) -> List[str]:
    """Smoke phase 4's wave: synthetic documents of length L/4..L,
    rotated BENCH_TEXT lanes and a few empty texts, interleaved."""
    rng = np.random.default_rng(SEED)
    n_syn = (B + 2) // 3
    syn = iter(synth_text(tok, n_syn,
                          [int(x) for x in rng.integers(L // 4, L + 1, n_syn)],
                          seed=SEED + 1))
    texts = []
    for i in range(B):
        if i % 997 == 500:
            texts.append("")
        elif i % 3 == 0:
            texts.append(next(syn))
        else:
            texts.append(bench_lane(i, L))
    return texts


def stream_text(tok, docs=STREAM_DOCS, long=STREAM_LONG,
                pool=STREAM_POOL) -> str:
    """Smoke phase 7's stream: ``docs`` short documents ending in
    ``\\x04\\n``, ``long`` of them replaced by long EOT-free ones, cut
    from ``pool`` pieces of seeded synthetic text (generating 32 MB of
    it directly takes minutes)."""
    rng = np.random.default_rng(SEED + 5)
    # without the generator's own EOTs, so that documents keep their size
    text = "".join(synth_text(tok, *pool, seed=SEED + 6)).replace("\x04", " ")
    n_docs, lo, hi = docs
    n_long, llo, lhi = long

    def cut(n):
        o = int(rng.integers(0, len(text) - n))
        return text[o:o + n]

    out = [cut(int(n)) + "\x04\n" for n in rng.integers(lo, hi + 1, n_docs)]
    for i, n in zip(rng.choice(n_docs, n_long, replace=False),
                    rng.integers(llo, lhi + 1, n_long)):
        n = int(n)
        body = "".join(cut(min(n, pool[1])) for _ in range(n // pool[1] + 1))
        out[i] = body[:n] + "\x04\n"
    return "".join(out)


def cut_mid_word(text: str) -> str:
    """``text`` without its final ``\\x04\\n``, cut inside its last word."""
    body = text[:-2]
    for i in range(len(body) - 1, 0, -1):
        if body[i].isalpha() and body[i - 1].isalpha():
            return body[:i]
    return body + "Wor"


def corpus_texts(docs: Sequence[str], n_files: int) -> List[str]:
    """Smoke phase 9's files: ``docs`` dealt into ``n_files`` runs of
    documents ending in ``\\x04\\n``; file 7 empty, files 13, 29, 41
    and 58 cut mid-word without EOT (those that exist)."""
    per = len(docs) // n_files
    texts = ["".join(t + "\x04\n" for t in docs[i * per:(i + 1) * per])
             for i in range(n_files)]
    texts[7 % n_files] = ""
    for i in (13, 29, 41, 58):
        if i < n_files:
            texts[i] = cut_mid_word(texts[i])
    return texts


# ---- the guard --------------------------------------------------------------

def native_oracle(eng, text: str) -> str:
    """The native oracle over ``text`` as one lane, formatted by the
    native writer: the ground truth of every stream and file."""
    metas = native_encode(eng.encoder, text.encode("utf-8"))[1]
    ref = native_transduce_events(eng.tok, metas, as_array=True)
    if ref is None:
        raise RuntimeError("native oracle unavailable")
    w = NativeWriter(SIMPLE)
    w.feed(ref, text_to_codepoints(text))
    return w.getvalue()


def check_same(name: str, got: str, want: str) -> None:
    """Raise, naming the first differing character, unless equal."""
    if got != want:
        i = next((j for j, (x, y) in enumerate(zip(got, want)) if x != y),
                 min(len(got), len(want)))
        raise RuntimeError(f"{name}: output differs from the native "
                           f"oracle at character {i}: {got[i - 40:i + 40]!r}"
                           f" vs {want[i - 40:i + 40]!r}")


def wave_cps(texts: Sequence[str]):
    """The wave's codepoints as the native writer takes them: ``(cps,
    offsets, lengths)``."""
    lens = np.array([len(t) for t in texts], dtype=np.int32)
    offs = np.zeros(len(texts), dtype=np.int64)
    np.cumsum(lens[:-1], out=offs[1:])
    cps = np.frombuffer("".join(texts).encode("utf-32-le"), dtype="<u4")
    return cps.astype(np.int32), offs, lens


def format_wave(texts: Sequence[str], evs) -> str:
    """The wave's bytes through the native writer, from each lane's
    (N, 3) events."""
    counts = np.array([len(e) for e in evs], dtype=np.int32)
    writer = NativeWriter(SIMPLE)
    writer.feed_wave(np.concatenate(evs), counts, *wave_cps(texts))
    return writer.getvalue()


def check_events(name: str, eng, texts: Sequence[str], evs) -> None:
    """Every lane's (N, 3) events against the native oracle over that
    lane on ``eng`` (a matrix model's engine), then the wave's bytes."""
    meta, lengths, _ = eng.encoder.encode_batch(texts)
    refs = []
    for i in range(len(texts)):
        ref = native_transduce_events(eng.tok, meta[i, : lengths[i]],
                                      as_array=True)
        if ref is None:
            raise RuntimeError("native oracle unavailable")
        if not np.array_equal(ref, evs[i]):
            raise RuntimeError(f"{name}: lane {i} differs from the native "
                               f"oracle: {texts[i][:80]!r}")
        refs.append(ref)
    check_same(name, format_wave(texts, evs), format_wave(texts, refs))


def launch_events(eng, texts: Sequence[str], out) -> list:
    """Each lane's (N, 3) events from one launch's outputs, the lanes
    over their step budget taken through the engine's own host repair
    (``events_batch``)."""
    counts, bad = out[1].cpu().numpy(), out[2].cpu().numpy()
    E = max(1, int(counts.max())) if counts.size else 1
    evs = decode_events_compact(out[0][:, :E].cpu().numpy(), counts,
                                as_arrays=True)
    redo = np.flatnonzero(bad)
    if redo.size:
        for i, e in zip(redo, eng.events_batch([texts[i] for i in redo],
                                               as_arrays=True)):
            evs[i] = e
    return evs


@contextlib.contextmanager
def watch_bad(bads: list):
    """Append each K1 launch's ``bad`` lanes (its output tensor, which no
    later launch writes) to ``bads``, for every engine, the sharded one
    and the CLI's included: the engine looks its wrapper up in its
    module at each launch (``BatchEngine._kernel``).  Nothing runs on
    the device for it."""
    saved = engine_mod.transduce, engine_mod.transduce_general

    def watched(fn):
        def call(*args, **kw):
            res = fn(*args, **kw)
            bads.append(res[2])
            return res
        return call

    engine_mod.transduce, engine_mod.transduce_general = map(watched, saved)
    try:
        yield bads
    finally:
        engine_mod.transduce, engine_mod.transduce_general = saved


# ---- host stages in processes -----------------------------------------------

def _stage_worker(conn, stage: str, payload) -> None:
    """One spawned process of the process A/B: its chunk of ``stage``
    once a round, until told to stop."""
    if stage == "encode":
        encoder, docs = payload

        def fn():
            native_encode_wave(encoder, docs, threads=1)
    else:
        ev, counts = payload

        def fn():
            native_decode_events(ev, counts, workers=1)
    fn()
    conn.send("ready")
    while conn.recv() == "run":
        fn()
        conn.send("done")
    conn.close()


def rate_in_procs(stage: str, chunks: list, n_bytes: int, reps: int):
    """[median, min, max] MB/s of ``stage`` with each chunk in its own
    process (``spawn``: the parent holds CUDA and threads, which a fork
    would copy), timed from the round's start to every chunk's end after
    one warm-up round; the processes start, and receive their chunks,
    before the first round."""
    ctx = multiprocessing.get_context("spawn")
    procs, conns = [], []
    try:
        for chunk in chunks:
            parent, child = ctx.Pipe()
            p = ctx.Process(target=_stage_worker, args=(child, stage, chunk))
            p.start()
            child.close()
            procs.append(p)
            conns.append(parent)
        for c in conns:
            if c.recv() != "ready":
                raise RuntimeError(f"{stage} worker failed to start")
        times = []
        for _ in range(reps + 1):
            t0 = time.perf_counter()
            for c in conns:
                c.send("run")
            for c in conns:
                c.recv()
            times.append(time.perf_counter() - t0)
        return _cell(n_bytes, times[1:])
    finally:
        for c in conns:
            with contextlib.suppress(OSError):
                c.send("stop")
        for p in procs:
            p.join(timeout=30)
            if p.is_alive():
                p.terminate()
                p.join()


def _cell(n_bytes: int, times: Sequence[float]) -> list:
    """[median, min, max] MB/s of ``n_bytes`` over ``times``."""
    ts = sorted(times)
    return [n_bytes / statistics.median(ts) / 1e6, n_bytes / ts[-1] / 1e6,
            n_bytes / ts[0] / 1e6]


# ---- the rows ---------------------------------------------------------------

def card_line() -> str:
    """The card's name and power limit as ``nvidia-smi`` gives them."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True,
    ).stdout.strip().splitlines()[0]


def log(msg: str) -> None:
    print(f"bench: {msg}", file=sys.stderr, flush=True)


class Bench:
    """The rows of one run on ``device`` at B=``lanes`` x L=``length``.

    ``tok`` is the DE rows' model (by default ``DATOK_DE_MODEL``'s file,
    else ``synth_tokenizer()``), ``da`` the ``.datok`` rows' (by default
    ``synth_datok(DE_N_ABBREV)``, built when a row first needs it).
    :meth:`run` gives the rows' line."""

    def __init__(self, device="cuda", lanes: int = 32768, length: int = 1024,
                 reps: int = 7, e2e_mb: float = 48, host_reps: int = 9,
                 profile: bool = False, tok=None, da=None,
                 corpus_files: int = CORPUS_FILES):
        self.device = torch.device(device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError("torch.cuda.is_available() is False: no card")
        if self.device.type not in ("cuda", "cpu"):
            raise ValueError(f"unsupported device {self.device}")
        if lanes < 2 or length < 8 or reps < 1:
            raise ValueError("need lanes >= 2, len >= 8 and reps >= 1")
        self.B, self.L, self.reps = lanes, length, reps
        self.e2e_mb, self.host_reps = e2e_mb, host_reps
        self.profile = profile
        self.corpus_files = corpus_files
        self.model = "synth_de"
        self.de_skipped = None
        if tok is None:
            path = os.environ.get("DATOK_DE_MODEL", "")
            if path and os.path.exists(path):
                tok, self.model = load_tokenizer_file(path), os.path.basename(path)
            else:
                self.de_skipped = "DATOK_DE_MODEL names no file"
                tok = synth_tokenizer(seed=SEED)
        self.tok = tok
        self._da = da
        self.eng = BatchEngine(tok, device=self.device)
        self.doc = bench_doc(length)
        self._wave_eng = None
        self._auto_da = None
        self._bad: list = []
        self.result: dict = {}

    # -- shared pieces ------------------------------------------------

    def sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    @property
    def wave_eng(self) -> BatchEngine:
        """The per-wave engine: the wave's own hot set a launch."""
        if self._wave_eng is None:
            self._wave_eng = BatchEngine(self.tok, device=self.device,
                                         hot_size="auto", per_wave=True)
        return self._wave_eng

    @property
    def da(self):
        if self._da is None:
            self._da = synth_datok(DE_N_ABBREV, SEED)
        return self._da

    @property
    def auto_da(self) -> BatchEngine:
        """The double array through ``"auto"``: its matrix."""
        if self._auto_da is None:
            self._auto_da = BatchEngine(self.da, device=self.device)
        return self._auto_da

    def timed(self, fn: Callable, n_bytes: int):
        """``fn()`` twice untimed, then ``reps`` times, each between
        synchronisations; returns the row's rates (median MB/s,
        ``spread``, the last run's ``bad_lanes``) and the last result.
        The second warm-up lets the caching allocator hold a second set
        of outputs while the caller still holds the first: without it
        the first timed run of a wave paid for allocating them."""
        fn()
        fn()
        rates = []
        for _ in range(self.reps):
            self._bad.clear()
            self.sync()
            t0 = time.perf_counter()
            res = fn()
            self.sync()
            rates.append(n_bytes / (time.perf_counter() - t0) / 1e6)
        return {"mbps": statistics.median(rates),
                "spread": [min(rates), max(rates)], "bytes": n_bytes,
                "bad_lanes": self.bad_lanes()}, res

    def bad_lanes(self) -> int:
        """Lanes over budget in the launches watched since the count was
        last cleared (read after they have finished)."""
        return sum(int(b.sum()) for b in self._bad)

    def staged(self, eng: BatchEngine, texts: Sequence[str]):
        """The wave's encoded inputs, on the engine's device."""
        meta, lengths, _ = eng.encoder.encode_batch(texts)
        dev = eng.tables.device
        B = len(texts)
        return (torch.from_numpy(meta).to(dev), torch.from_numpy(lengths).to(dev),
                torch.ones(B, dtype=torch.int32, device=dev),
                torch.zeros(B, dtype=torch.bool, device=dev))

    def raw(self, name: str, eng: BatchEngine, texts: Sequence[str],
            spec=None, oracle: Optional[BatchEngine] = None):
        """A wave staged on the device through ``run_raw_device``, timed
        with the read of its bad-lane count; then every lane against the
        native oracle on ``oracle`` (default ``eng``)."""
        args = self.staged(eng, texts)
        n_bytes = sum(len(t.encode("utf-8")) for t in texts)

        def call():
            out = eng.run_raw_device(*args, spec=spec)
            int(out[2].sum())  # waits for K1
            return out

        row, out = self.timed(call, n_bytes)
        check_events(name, oracle or eng, texts, launch_events(eng, texts, out))
        row.update(lanes=len(texts), L=int(args[0].shape[1]))
        return row

    def stream(self, name: str, run: Callable, text: str, want: str):
        """A stream surface ``run(writer)``, timed, its last output
        byte-equal to ``want``."""
        row, got = self.timed(lambda: run(NativeWriter(SIMPLE)).getvalue(),
                              len(text.encode("utf-8")))
        check_same(name, got, want)
        return row

    def pipelined_text(self) -> str:
        n_docs = int(self.e2e_mb * (1 << 20)) // len(self.doc.encode("utf-8"))
        return self.doc * max(1, n_docs)

    # -- rows: each returns (keys of the line, the row's numbers) ------

    def row_uniform(self):
        row = self.raw("uniform", self.eng, [self.doc] * self.B)
        return {"value": row["mbps"]}, row

    def row_uniform_wave(self):
        texts = [self.doc] * self.B
        spec = self.wave_eng.wave_spec(texts)
        row = self.raw("uniform_wave", self.wave_eng, texts, spec=spec)
        return {"uniform_wave_mbps": row["mbps"], "wave_rung_h": spec.H}, row

    def row_device_time(self):
        """``reps`` uniform calls, each under its own ``torch.profiler``
        window after a warm-up: the device time of every kernel of the
        call and K1's own, each the median over the calls.  The CPU has
        no device timeline: there the calls run and are checked, and the
        rate is null."""
        texts = [self.doc] * self.B
        args = self.staged(self.eng, texts)
        n_bytes = sum(len(t.encode("utf-8")) for t in texts)
        out = self.eng.run_raw_device(*args)  # the warm-up; the CPU's call
        int(out[2].sum())
        calls = []
        for _ in range(self.reps if self.device.type == "cuda" else 0):
            self._bad.clear()
            out, times = self.profiled(lambda: self.eng.run_raw_device(*args))
            calls.append(times)
        check_events("device_time", self.eng, texts,
                     launch_events(self.eng, texts, out))
        if not calls:
            return ({"device_time_mbps": None,
                     "device_time_skipped": "no device timeline on the CPU"},
                    {"spread": None, "bytes": n_bytes,
                     "bad_lanes": self.bad_lanes()})
        rates = [n_bytes / (dev_us / 1e6) / 1e6 for dev_us, _, _ in calls]
        device_ms = statistics.median(c[0] for c in calls) / 1e3
        k1_ms = statistics.median(c[1] for c in calls) / 1e3
        row = {"mbps": statistics.median(rates),
               "spread": [min(rates), max(rates)], "bytes": n_bytes,
               "bad_lanes": self.bad_lanes(), "device_ms": device_ms,
               "k1_ms": k1_ms, "k1_share": k1_ms / device_ms,
               "kernels_ms": calls[-1][2]}
        keys = {"device_time_mbps": row["mbps"],
                "device_time_k1_share": row["k1_share"]}
        if self.profile:
            keys["profile"] = row["profile"] = self.k1_profile(
                texts, args, out, k1_ms)
        return keys, row

    def profiled(self, fn: Callable):
        """``fn()`` (a launch) and the read of its bad-lane count under
        ``torch.profiler``: returns its outputs and (device µs of every
        kernel, K1's µs, ms by kernel); raises if K1 is not among them."""
        from torch.autograd import DeviceType
        from torch.profiler import ProfilerActivity, profile

        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            out = fn()
            int(out[2].sum())
            self.sync()
        kernels = [e for e in prof.key_averages()
                   if e.device_type == DeviceType.CUDA]
        device_us = sum(e.self_device_time_total for e in kernels)
        k1_us = sum(e.self_device_time_total for e in kernels
                    if "transduce_kernel" in e.key)
        if not k1_us:
            raise RuntimeError("the profiler saw no K1 on the card")
        return out, (device_us, k1_us, {e.key: e.self_device_time_total / 1e3
                                        for e in kernels})

    def k1_profile(self, texts, args, out, k1_ms: float) -> dict:
        """K1's ns per lane-step on the uniform call against its bound:
        the larger of its bytes over the memory rate and its step loop's
        instructions (its SASS) over the issue rate."""
        from .kernels import build, sass
        from .utils.native import native_state_census

        n_sm = torch.cuda.get_device_properties(self.device).multi_processor_count
        kern = sass.k1_kernel(self.B, n_sm)
        instr = sass.k1_step_instructions(
            sass.cuobjdump(build.TRANSDUCE.path))[kern][0]
        meta, lengths = (x.cpu().numpy() for x in args[:2])
        seen = np.zeros(self.tok.state_count + 1, dtype=bool)
        for i in {t: i for i, t in enumerate(texts)}.values():
            seen |= native_state_census(self.tok, meta[i, : lengths[i]])[0] > 0
        bound, by, n_b, b_ms, steps, ops_ms = sass.k1_bound(
            args, out, int(seen.sum()), instr, n_sm, sass.max_sm_clock_hz(),
            self.eng.tables.state_bits.numel())
        return {"kernel": kern, "step_instr": instr, "steps": steps,
                "k1_ms": k1_ms, "ns_per_lane_step": k1_ms * 1e6 / steps,
                "bound_ms": bound, "bound_by": by, "bytes": n_b,
                "bytes_ms": b_ms, "instr_ms": ops_ms,
                "bound_ns_per_lane_step": bound * 1e6 / steps,
                "x_bound": k1_ms / bound}

    def row_hetero(self):
        row = self.raw("hetero", self.eng, rotated_texts(self.doc, self.B, self.L))
        return {"hetero_mbps": row["mbps"]}, row

    def row_hetero_wave(self):
        texts = rotated_texts(self.doc, self.B, self.L)
        spec = self.wave_eng.wave_spec(texts)
        row = self.raw("hetero_wave", self.wave_eng, texts, spec=spec)
        row["rung_h"] = spec.H
        return {"hetero_wave_mbps": row["mbps"]}, row

    def row_mixed(self):
        row = self.raw("mixed", self.eng,
                       sorted(mixed_texts(self.B, self.L), key=len))
        return {"mixed_mbps": row["mbps"]}, row

    def row_mixed_wave(self):
        texts = sorted(mixed_texts(self.B, self.L), key=len)
        spec = self.wave_eng.wave_spec(texts)
        row = self.raw("mixed_wave", self.wave_eng, texts, spec=spec)
        row["rung_h"] = spec.H
        return {"mixed_wave_mbps": row["mbps"]}, row

    def pipelined(self, name: str, text: str, lanes: int, **kw):
        """``text`` through ``tokenize_stream_pipelined`` on the default
        engine (:meth:`stream`), with each stage's MB/s: the median over
        the timed runs of the input bytes over the stage's seconds
        (summed over its waves)."""
        stats = []

        def run(w):
            stats.append({})
            return tokenize_stream_pipelined(self.tok, text, w, engine=self.eng,
                                             lanes=lanes, stats=stats[-1], **kw)

        row = self.stream(name, run, text, native_oracle(self.eng, text))
        n = row["bytes"]
        row.update(lanes=lanes, waves=stats[-1]["waves"], docs=stats[-1]["docs"],
                   repairs=stats[-1]["repairs"], stage_mbps={
                       k: statistics.median(n / max(s[k], 1e-9) / 1e6
                                            for s in stats[1:])
                       for k in _STAGES})
        return row

    def row_mixed_pipeline(self):
        """B mixed documents as one stream, pipelined in waves of B / 2
        lanes without packing (bench.py:500-533)."""
        row = self.pipelined("mixed_pipeline",
                             "".join(mixed_texts(self.B, self.L)),
                             max(1, self.B // 2), pack_len=0)
        return {"mixed_pipeline": {
            "mbps": row["mbps"], "dispatch_mbps": row["stage_mbps"]["dispatch"],
            "repairs": row["repairs"], "docs": row["docs"]}}, row

    def row_novel(self):
        row = self.raw("novel", self.eng, novel_texts(self.B, self.L))
        return {"novel_mbps": row["mbps"]}, row

    def row_en(self):
        path = os.environ.get("DATOK_EN_MODEL", "")
        if not (path and os.path.exists(path)):
            return ({"en_mbps": None,
                     "en_skipped": "DATOK_EN_MODEL names no file"}, None)
        eng = BatchEngine(load_tokenizer_file(path), device=self.device)
        row = self.raw("en", eng, [bench_doc(self.L, BENCH_TEXT_EN)] * self.B)
        row["model"] = os.path.basename(path)
        return {"en_mbps": row["mbps"]}, row

    def row_datok(self):
        row = self.raw("datok", self.auto_da, [self.doc] * self.B)
        row["engine"] = self.auto_da.engine
        return {"datok_mbps": row["mbps"]}, row

    def row_datok_general(self):
        """K1's double-array form; the oracle walks the same model's
        matrix (the native oracle takes only matrices)."""
        eng = BatchEngine(self.da, device=self.device, engine="general")
        row = self.raw("datok_general", eng, [self.doc] * self.B,
                       oracle=self.auto_da)
        row["engine"] = eng.engine
        return {"datok_general_mbps": row["mbps"]}, row

    def row_e2e(self):
        """Smoke phase 4's wave through ``events_batch`` and the native
        writer, its codepoints laid out beforehand (e2e_turns.py)."""
        texts = wave_texts(self.tok, self.B, self.L, synth_text)
        cps = wave_cps(texts)

        def wave():
            evs = self.eng.events_batch(texts, as_arrays=True)
            counts = np.array([len(e) for e in evs], dtype=np.int32)
            w = NativeWriter(SIMPLE)
            w.feed_wave(np.concatenate(evs), counts, *cps)
            return evs, w.getvalue()

        row, (evs, got) = self.timed(wave, sum(len(t.encode("utf-8"))
                                               for t in texts))
        check_events("e2e", self.eng, texts, evs)
        check_same("e2e", got, format_wave(texts, evs))
        row.update(lanes=len(texts), L=self.L)
        return {"e2e_mbps": row["mbps"]}, row

    def row_pipelined(self):
        """``--e2e-mb`` MB of ``doc`` through the overlapped pipeline in
        waves of B / 2 lanes (bench.py:575-611)."""
        row = self.pipelined("pipelined", self.pipelined_text(),
                             max(1, self.B // 2))
        return {"pipelined_mbps": row["mbps"],
                "pipelined_stage_mbps": row["stage_mbps"]}, row

    def row_stream(self):
        text = stream_text(self.tok, STREAM_DOCS, STREAM_LONG, STREAM_POOL)
        row = self.stream(
            "stream", lambda w: tokenize_stream(self.tok, text, w, engine=self.eng),
            text, native_oracle(self.eng, text))
        row["docs"] = text.count("\x04")
        return {"stream_mbps": row["mbps"]}, row

    def row_corpus(self):
        """``corpus_files`` files of smoke phase 4's documents (phase 9's
        cut) through ``cli.main(["corpus", ...])``, each run into a new
        output directory; every file of the last run against the oracle
        over it."""
        texts = corpus_texts(wave_texts(self.tok, self.B, self.L, synth_text),
                             self.corpus_files)
        with tempfile.TemporaryDirectory(prefix="datok-bench-") as d:
            model = os.path.join(d, "model.matok")
            self.tok.save(model)
            files = []
            for i, t in enumerate(texts):
                files.append(os.path.join(d, f"doc{i:02d}.txt"))
                with open(files[-1], "w", encoding="utf-8") as f:
                    f.write(t)
            runs = []

            def corpus():
                out = os.path.join(d, f"out{len(runs)}")
                buf = io.StringIO()
                with contextlib.redirect_stdout(buf):
                    rc = cli.main(["corpus", "-t", model, "-o", out, *files,
                                   "--device", str(self.device)])
                if rc != 0:
                    raise RuntimeError(f"corpus: exit code {rc}")
                runs.append(json.loads(buf.getvalue().splitlines()[-1]))
                return out

            row, out = self.timed(corpus, sum(len(t.encode("utf-8"))
                                              for t in texts))
            if (runs[-1]["done"], runs[-1]["skipped"]) != (len(files), 0):
                raise RuntimeError(f"corpus: {runs[-1]}")
            for f, t in zip(files, texts):
                with open(os.path.join(out, os.path.basename(f) + ".tok"),
                          encoding="utf-8") as fh:
                    check_same(f"corpus {os.path.basename(f)}", fh.read(),
                               native_oracle(self.eng, t))
        row["files"] = len(files)
        return {"corpus_mbps": row["mbps"]}, row

    def row_sharded(self):
        """``ShardedEngine()`` over every card (two CPU shards on the
        CPU) on the pipelined stream, in turns with the single engine
        (single, sharded, sharded, single), each ``reps`` runs."""
        devices = None if self.device.type == "cuda" else ["cpu", "cpu"]
        seng = ShardedEngine(self.tok, devices=devices)
        text = self.pipelined_text()
        lanes = max(1, self.B // 2)
        want = native_oracle(self.eng, text)
        turns = [self.stream("sharded", lambda w, e=e: tokenize_stream_pipelined(
                     self.tok, text, w, engine=e, lanes=lanes), text, want)
                 for e in (self.eng, seng, seng, self.eng)]
        one = statistics.median(t["mbps"] for t in turns[::3])
        many = statistics.median(t["mbps"] for t in turns[1:3])
        cards = torch.cuda.device_count() if self.device.type == "cuda" else 0
        keys = {"cards": cards, "shards": [str(d) for d in seng.devices],
                "mbps": many, "single_mbps": one, "ratio": many / one}
        if cards < 2:
            keys["note"] = "one card: the sharded launch path only, no scaling"
        row = {**keys, "spread": [min(t["spread"][0] for t in turns[1:3]),
                                  max(t["spread"][1] for t in turns[1:3])],
               "bytes": turns[1]["bytes"], "lanes": lanes,
               "bad_lanes": turns[2]["bad_lanes"],
               "turns_mbps": [t["mbps"] for t in turns]}
        return {"sharded": keys}, row

    def row_host_scaling(self):
        """The native host stages on ``min(16384, B)`` lanes of ``doc``
        (one K1 wave gives decode and format their inputs): each at W
        threads, then encode and decode in W spawned processes at the
        widest W; every stage's output checked."""
        docs = [self.doc] * min(16384, self.B)
        n_bytes = sum(len(d.encode("utf-8")) for d in docs)
        eng = self.eng
        cores = os.cpu_count() or 1
        ws = [w for w in HOST_WIDTHS if w <= cores]
        args = self.staged(eng, docs)
        out = eng.run_raw_device(*args)
        evs = launch_events(eng, docs, out)
        check_events("host_scaling", eng, docs, evs)
        counts = out[1].cpu().numpy()
        ev = out[0][:, : max(1, int(counts.max()))].cpu().numpy()
        meta = args[0].cpu().numpy()
        scratch: dict = {}
        native_encode_wave(eng.encoder, docs, scratch=scratch)
        cps = (scratch["cps"], scratch["cps_offs"], scratch["cps_lens"])
        tri = native_decode_events(ev, counts)
        want = format_wave(docs, evs)
        wtr = NativeWriter(SIMPLE)

        def cell(name, fn, want, read=lambda x: x):
            """[median, min, max] MB/s of ``fn()`` after a warm-up; the
            last run's output, as ``read`` gives it, must equal ``want``."""
            fn()
            times = []
            for _ in range(self.host_reps):
                t0 = time.perf_counter()
                got = fn()
                times.append(time.perf_counter() - t0)
            got = read(got)
            same = got == want if isinstance(want, str) else np.array_equal(
                got, want)
            if not same:
                raise RuntimeError(f"host_scaling: the {name} stage's output "
                                   f"at {w} workers differs")
            return _cell(n_bytes, times)

        def fmt():
            # the formatting call only: the output stays in the writer
            wtr.lib.dt_writer_reset_output(wtr.h)
            wtr.feed_wave(tri, counts, *cps, workers=w)
            return wtr

        res = {"encode": {}, "decode": {}, "format": {}}
        for w in ws:
            res["encode"][str(w)] = cell("encode", lambda: native_encode_wave(
                eng.encoder, docs, threads=w, scratch=scratch)[0], meta)
            res["decode"][str(w)] = cell("decode", lambda: native_decode_events(
                ev, counts, workers=w), tri)
            res["format"][str(w)] = cell("format", fmt, want,
                                         lambda wr: wr.getvalue())
        wmax = ws[-1]
        B = len(docs)
        cut = [i * B // wmax for i in range(wmax + 1)]
        res["encode_procs"] = {str(wmax): rate_in_procs(
            "encode", [(eng.encoder, docs[a:b]) for a, b in zip(cut, cut[1:])],
            n_bytes, self.host_reps)}
        res["decode_procs"] = {str(wmax): rate_in_procs(
            "decode", [(ev[a:b], counts[a:b]) for a, b in zip(cut, cut[1:])],
            n_bytes, self.host_reps)}
        res.update(cores=cores, host_workers=host_workers(), workers=ws,
                   reps=self.host_reps, start_method="spawn", lanes=B,
                   cell="[median, min, max] MB/s over reps")
        return {"host_scaling": res}, {"spread": None, "bytes": n_bytes, **res}

    # -- the run ------------------------------------------------------

    def run_row(self, name: str) -> None:
        """One row: its K1 launches counted from its runs alone (the
        form its engine runs, and none of the other), its lanes over
        budget, its keys and numbers into :attr:`result`."""
        general = name == "datok_general"
        self.sync()
        kt.transduce.launches = kt.transduce_general.launches = 0
        t0 = time.perf_counter()
        self._bad.clear()
        with watch_bad(self._bad):
            keys, row = getattr(self, f"row_{name}")()
        self.sync()
        self.result.update(keys)
        if row is None:  # a model file that is absent
            log(f"{name}: skipped, {json.dumps(keys)}")
            return
        full, gen = kt.transduce.launches, kt.transduce_general.launches
        launches, other = (gen, full) if general else (full, gen)
        if launches < 1 or other:
            raise RuntimeError(
                f"row {name}: K1's {'general' if general else 'full'} form "
                f"launched {launches} times and the other {other}")
        row.setdefault("bad_lanes", self.bad_lanes())
        row.update(k1_launches=launches, correct=True)
        self.result["k1_launches"][name] = launches
        self.result["rows"][name] = row
        log(f"{name}: {json.dumps(keys)} ({time.perf_counter() - t0:.1f} s, "
            f"K1 launches {launches}, bad lanes {row['bad_lanes']})")

    def run(self, rows: Sequence[str] = ROWS) -> dict:
        """The rows ``rows`` in order; returns the line."""
        cuda = self.device.type == "cuda"
        self.result = {
            "metric": "tokenize_de_matrix_throughput", "unit": "MB/s/card",
            "model": self.model, "states": int(self.tok.state_count),
            "card": card_line() if cuda else None,
            "device": torch.cuda.get_device_name(self.device) if cuda else "cpu",
            "torch": torch.__version__, "cuda": torch.version.cuda,
            "cores": os.cpu_count(), "lanes": self.B, "len": self.L,
            "reps": self.reps, "k1_launches": {}, "rows": {},
        }
        if self.de_skipped:
            self.result["de_skipped"] = self.de_skipped
        for name in rows:
            self.run_row(name)
        return self.result



def main(argv=None) -> int:
    env = os.environ.get
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda",
                    help="cuda (the default; raises without a card) or cpu "
                         "(the plain machine, for tests)")
    ap.add_argument("--lanes", type=int, default=int(env("BENCH_LANES", "32768")))
    ap.add_argument("--len", type=int, default=int(env("BENCH_LEN", "1024")))
    ap.add_argument("--reps", type=int, default=int(env("BENCH_REPS", "7")))
    ap.add_argument("--fast", action="store_true",
                    default=env("BENCH_FAST") == "1",
                    help="the headline, device time and hetero rows only")
    ap.add_argument("--e2e-mb", type=float,
                    default=float(env("BENCH_E2E_MB", "48")),
                    help="MB of the pipelined stream")
    ap.add_argument("--profile", action="store_true",
                    help="K1's ns per lane-step against its bound")
    opts = ap.parse_args(argv)
    bench = Bench(opts.device, opts.lanes, opts.len, opts.reps, opts.e2e_mb,
                  int(env("BENCH_HOST_REPS", "9")), opts.profile)
    line = bench.run(FAST_ROWS if opts.fast else ROWS)
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
