"""Per-wave hot sets, ``AdaptiveEngine`` and ``engine="hot"`` of the port
against the JAX package.

* ``hot.sample_texts`` against ``jax_engine.sample_texts``; the engine's
  ``census_states`` against the JAX engine's (a per-wave Pallas engine
  in interpret mode, as tests/test_wave_spec.py builds it, on the twin
  of the same synthetic model); the chosen states against
  ``HotSpec.for_wave(...).hot_full`` for the same census, base set and
  size, and ``wave_spec`` against the JAX ``wave_spec`` with the port's
  ladder.
* The device tagging (``rep.pack_hot_device``, torch ops) against
  ``hot.pack_hot`` bit for bit, on hot sets of 0, 1, 8 and capacity
  states and on states no text visits.
* A per-wave engine, through the plain machine and K1's g++ host build,
  against a ``hot_size=0`` engine, the JAX engine's ``events_batch`` and
  the oracle; two waves with their own sets on one engine; the cache;
  the pipelined stream with its census; the encoder, which no set
  changes.
* ``AdaptiveEngine``: routing, narrow/wide parity, the lazy wide
  engine, ``choose([])``, no hot set, and ``cold_rate`` against the JAX
  package's ``native_cold_rate``.
* ``engine="hot"`` against the default engine and the JAX default
  engine (which picks its hot machine on the CPU), and
  ``ShardedEngine(per_wave=True)``, which runs its own set.

Every output is an integer or a byte, so every comparison is exact
(tolerance 0).
"""

from dataclasses import replace

import numpy as np
import pytest
import torch

import datok_tpu_torch as dtt
from datok_tpu.runtime import jax_engine
from datok_tpu.runtime.jax_engine import BatchEngine as JaxEngine
from datok_tpu.runtime.jax_engine import HotSpec
from datok_tpu.utils.native import native_cold_rate as jax_native_cold_rate
from datok_tpu_torch.kernels import transduce as kt
from datok_tpu_torch.runtime import engine as engine_mod
from datok_tpu_torch.runtime import hot as hot_mod
from datok_tpu_torch.runtime import overlap as overlap_mod
from datok_tpu_torch.runtime.adaptive import (COLD_THRESHOLD, SAMPLE_CHARS,
                                              AdaptiveEngine)
from datok_tpu_torch.runtime.encode import text_to_codepoints
from datok_tpu_torch.runtime.oracle import transduce_events
from datok_tpu_torch.runtime import rep as rep_mod
from datok_tpu_torch.runtime.rep import (hot_table, pack_hot_device,
                                         tables_from_tokenizer, tags_fit,
                                         with_hot)
from datok_tpu_torch.testing.synth import synth_datok, synth_text, synth_tokenizer
from datok_tpu_torch.utils.native import native_cold_rate
from torch_twins import jax_twin

SEED = 5

# tests/test_torch_da.py's edge texts
EDGE = [
    "", "x -", "3.", "a → b", "œ~", "Mann.", "z.B. bzw. Abk.",
    "Er sagte: „gut“ … und\tging.\x04Neu-\x04",
    "  -x --y 3,50 14:30 5.9.2018.", "ab~c þ ¤ 中文 😀!", "Ende.\x04\n",
    "\x04\x04", "a" * 280 + ".",
]

# tests/test_wave_spec.py's TEXTS and NOVEL
TEXTS = [
    "Der alte Mann ging zügig über die Weststr. zur Arbeit.",
    'Sie rief: "Warte!" und lief z.B. hinterher.',
    "Quantenchromodynamik und Xylophonvirtuosen bzw. 3,14% Rendite.",
    "wikipedia.org sowie korap@ids-mannheim.de um 14:30 Uhr.\x04Neu.\x04",
    "",
    "Mach's gut \U0001F600 ;) <b>xml</b> D'dorf.",
]
NOVEL = [
    "Zyklotronresonanz vexiert jodhaltige Quarzbrocken famos.",
    "Die Psychopharmakakommission qualifizierte Oxymorone hyperbolisch.",
    "Wachstumsschmerzen plagen juvenile Axolotl beträchtlich, ca. 7,5%.",
]

# tests/test_adaptive.py's in-profile and rare-word-dense texts
UNIFORM = hot_mod._CALIBRATION * 8
COLD_HEAVY = (
    "Erreichbar via https://korap.ids-mannheim.de/?q=Baum&x=1 oder "
    "korap[at]ids-mannheim[dot]de bzw. 10.0.10.51:8080. Vgl. "
    "F.D.P.-Fraktion, Ba.-Wü., z.Zt. ca. 0,5% lt. Prof. Dr.-Ing. "
    "Musterfrau-Häberle. ;-) ^_^ &#x2F; <a href='x.htm'>T</a> "
) * 8

# a narrow set that separates the two on the small model: their cold
# rates lie on either side of COLD_THRESHOLD
NARROW = 64


@pytest.fixture(scope="module")
def tok():
    """A small model (242 states) on which the port's auto set and the
    JAX engine's are the same states."""
    return synth_tokenizer(60, SEED)


@pytest.fixture(scope="module")
def big():
    """A model with more states than one block's hot set holds (1,382)."""
    return synth_tokenizer(380, SEED)


@pytest.fixture(scope="module")
def texts(tok):
    rng = np.random.default_rng(SEED)
    return synth_text(tok, 40, [int(x) for x in rng.integers(0, 300, 40)],
                      seed=SEED) + EDGE + TEXTS + NOVEL


@pytest.fixture(scope="module")
def jax_wave(tok):
    """The JAX per-wave engine of tests/test_wave_spec.py on the twin."""
    return JaxEngine(jax_twin(tok), engine="pallas", kernel_k=16,
                     kernel_bl=128, pallas_interpret=True, per_wave=True)


@pytest.fixture(scope="module")
def jax_default(tok):
    """The JAX engine with its defaults: its hot machine on the CPU."""
    eng = JaxEngine(jax_twin(tok))
    assert eng.engine == "hot"
    return eng


def _entries_stops(tok, texts):
    """Non-root entries (exit contexts of a first run, shuffled) and cuts
    on the texts that end in EOT, as the stream splitter sends."""
    _, exits = dtt.BatchEngine(tok, device="cpu").events_batch(
        texts, return_exits=True)
    rng = np.random.default_rng(SEED + 1)
    entries = exits[rng.permutation(len(texts))].astype(np.int32)
    stops = np.array([t.endswith("\x04") for t in texts])
    return entries, stops


# ---- choosing a wave's set ---------------------------------------------------

@pytest.mark.parametrize("case", ["empty", "one_long", "many", "short"])
def test_sample_texts_matches_jax(case):
    rng = np.random.default_rng(SEED)
    docs = {
        "empty": [],
        "one_long": ["Wort " * 200_000],
        "many": [f"Dok {i} " + "x" * int(rng.integers(0, 3000))
                 for i in range(700)],
        "short": ["a", "", "bc"],
    }[case]
    for budget in (262144, 65536, 1000):
        assert (hot_mod.sample_texts(docs, budget)
                == jax_engine.sample_texts(docs, budget))


@pytest.mark.parametrize("which", ["synth", "edge", "texts", "novel"])
def test_census_states_matches_jax(tok, texts, jax_wave, which):
    docs = {"synth": texts[:40], "edge": EDGE, "texts": TEXTS,
            "novel": NOVEL}[which]
    eng = dtt.BatchEngine(tok, device="cpu", hot_size="auto")
    got = eng.census_states(docs)
    want = jax_wave.census_states(docs)
    assert got is not None and want is not None
    np.testing.assert_array_equal(got, want)
    assert got[1] > 0
    assert eng.census_states([]) is None is jax_wave.census_states([])


def test_wave_spec_matches_jax_wave_spec(tok, texts, jax_wave, monkeypatch):
    """With the port's ladder, the JAX engine's ``wave_spec`` chooses the
    states the port's does, in the same order, at the same size."""
    eng = dtt.BatchEngine(tok, device="cpu", hot_size="auto")
    np.testing.assert_array_equal(eng.tables.hot.states,
                                  jax_wave.spec.hot_full)
    monkeypatch.setattr(jax_wave, "WAVE_H_LADDER",
                        dtt.BatchEngine.WAVE_H_LADDER, raising=False)
    sizes = set()
    for docs in (texts[:40], texts[:3], TEXTS, NOVEL, ["Der Mann."]):
        got, want = eng.wave_spec(docs), jax_wave.wave_spec(docs)
        assert want is not jax_wave.spec
        np.testing.assert_array_equal(got.states, want.hot_full)
        sizes.add(got.H)
    assert sizes == {128, eng.hot_size}


@pytest.mark.parametrize("census", ["fill", "trim", "root_only", "wave"])
def test_wave_states_match_for_wave(big, census):
    """``wave_hot_states`` against ``HotSpec.for_wave(base, twin,
    states).hot_full`` (tests/test_wave_spec.py::test_for_wave_fill_and_trim)
    for the same census, base set and size."""
    twin = jax_twin(big)
    eng = dtt.BatchEngine(big, device="cpu", hot_size="auto", per_wave=True)
    own = eng.tables.hot.states
    H = 128
    base = HotSpec(twin, own[1:H], cold_p2=2048)
    assert base.pallas_ok and base.H == H
    np.testing.assert_array_equal(base.hot_full, own[:H])
    states = {
        "fill": np.array([5, 9]),
        "trim": np.arange(2, big.state_count, 2)[: 4 * H],
        "root_only": np.array([1]),
        "wave": hot_mod.census_cut(eng.census_states(NOVEL), eng.hot_size,
                                   eng.WAVE_H_LADDER)[1],
    }[census]
    got = hot_mod.wave_hot_states(states, own[:H])
    want = HotSpec.for_wave(base, twin, states)
    assert want is not base
    np.testing.assert_array_equal(got, want.hot_full)
    assert got[0] == 1 and len(got) == H == len(np.unique(got))


def test_census_cut_rungs(big):
    """The smallest rung below the engine's size that holds the states
    of 99.9% of the fetches besides the root; trimmed by count; sorted."""
    counts = np.zeros(big.state_count + 1, np.int64)
    counts[[1, 7, 3, 9]] = [100, 50, 50, 1]
    assert hot_mod.census_cut(counts, 339, (128, 256))[0] == 128
    H, st = hot_mod.census_cut(counts, 3, (128, 256))
    assert H == 3 and st.tolist() == [1, 3]  # ties by id: 3 before 7
    counts[10:300] = 5
    assert hot_mod.census_cut(counts, 339, (128, 256))[0] == 339
    assert hot_mod.census_cut(counts, 1000, (128, 256))[0] == 1000
    counts[10:160] = 0  # 144 states left
    assert hot_mod.census_cut(counts, 339, (128, 256))[0] == 256


# ---- tagging on the device ---------------------------------------------------

@pytest.mark.parametrize("size", [0, 1, 8, "capacity", "unvisited"])
def test_device_tagging_equals_pack_hot(big, size):
    tb = tables_from_tokenizer(big, "cpu")
    S, A = big.state_count, tb.max_sym
    array = np.asarray(big.array, dtype=np.uint32)
    cap = hot_mod.hot_capacity(A)
    counts = dtt.BatchEngine(big, device="cpu").census_states(NOVEL)
    rng = np.random.default_rng(SEED)
    if size == "unvisited":
        states = rng.choice(np.flatnonzero(counts == 0), 40, replace=False)
        states = np.concatenate([states, [0, S]])
    elif size == "capacity":
        states = np.concatenate([[1], rng.choice(np.arange(2, S + 1), cap - 1,
                                                 replace=False)])
    else:
        states = np.arange(1, size + 1)
    want = hot_mod.pack_hot(array, S, A, states)
    got = pack_hot_device(tb.arrays[0], S, A, states)
    assert tags_fit(tb.arrays[0])
    for g, w in zip(got, want):
        assert g.dtype == torch.int32
        np.testing.assert_array_equal(g.numpy().view(np.uint32),
                                      w.view(np.uint32))
    # the untagged table stays as it was: nothing is tagged in place
    np.testing.assert_array_equal(tb.arrays[0].numpy().view(np.uint32), array)
    if len(states):
        hot = hot_table(tb, states)
        assert hot.H == len(states) and hot.ready is None
        assert hot.root_h == int(want[2][1])


def test_device_tagging_refuses_what_pack_hot_refuses(big, monkeypatch):
    tb = tables_from_tokenizer(big, "cpu")
    S, A = big.state_count, tb.max_sym
    array = np.asarray(big.array, dtype=np.uint32)
    for states in ([S + 1], [1, 1], [-1], list(range(1, 1025))):
        assert hot_mod.pack_hot(array, S, A, states) is None
        assert pack_hot_device(tb.arrays[0], S, A, states) is None
    bad = array.copy()
    bad[5] |= np.uint32(1 << 25)
    table = torch.from_numpy(bad.view(np.int32))
    assert hot_mod.pack_hot(bad, S, A, [1]) is None
    assert not tags_fit(table)
    assert pack_hot_device(table, S, A, [1]) is None
    assert hot_table(replace(tb, arrays=(table,)), [1]) is None
    assert pack_hot_device(tb.arrays[0], 1 << 20, A, [1]) is None
    # tables that hold a set passed the test when it was built: a wave's
    # set does not read the whole table again
    scans = []
    monkeypatch.setattr(rep_mod, "tags_fit",
                        lambda t: scans.append(1) or tags_fit(t))
    own = with_hot(tb, [1, 2, 3])
    assert own.hot is not None and len(scans) == 1
    assert hot_table(own, [1, 4]) is not None and len(scans) == 1


# ---- the per-wave engine -----------------------------------------------------

@pytest.mark.parametrize("machine", ["plain", "host_build"])
def test_per_wave_events_match_jax_and_oracle(monkeypatch, tok, texts,
                                              jax_default, machine):
    """A per-wave engine (its own set each wave) equals a ``hot_size=0``
    engine, the JAX engine and the oracle, through the plain machine and
    K1's host build, from the root and from non-root entries with cuts."""
    launched = []

    def host(tb, *a, **kw):
        launched.append(tb.hot)
        return kt.transduce_host(tb, *a, **kw)

    if machine == "host_build":
        monkeypatch.setattr(engine_mod, "transduce", host)
    eng = dtt.BatchEngine(tok, device="cpu", hot_size="auto")
    assert eng.per_wave and eng.engine == "pallas"
    none = dtt.BatchEngine(tok, device="cpu")
    assert not none.per_wave and none.tables.hot is None
    entries, stops = _entries_stops(tok, texts)
    want, want_exits = jax_default.events_batch(
        texts, entries=entries, stops=stops, return_exits=True)
    for docs in (EDGE, TEXTS, NOVEL, texts):
        out = eng.tokenize_batch(docs)
        assert out == none.tokenize_batch(docs)
        assert out == jax_default.tokenize_batch(docs)
        assert out == [tok.tokenize(t) for t in docs]
        for t, evs in zip(docs, eng.events_batch(docs)):
            assert evs == transduce_events(tok, t)
    got, got_exits = eng.events_batch(texts, entries=entries, stops=stops,
                                      return_exits=True)
    assert got == want
    np.testing.assert_array_equal(got_exits, want_exits)
    if machine == "host_build":
        # the per-wave engine's launches took sets of their own; the
        # hot_size=0 engine's took none
        sets = {id(h) for h in launched if h is not None}
        assert len(sets) >= 2 and None in launched


def test_two_waves_own_sets_and_cache(tok, texts):
    eng = dtt.BatchEngine(tok, device="cpu", hot_size="auto")
    a, b = eng.wave_spec(texts[:40]), eng.wave_spec(NOVEL)
    assert a.H != b.H or not np.array_equal(a.states, b.states)
    assert eng.wave_spec(texts[:40]) is a and eng.wave_spec(NOVEL) is b
    none = dtt.BatchEngine(tok, device="cpu")
    for spec, docs in ((a, texts[:40]), (b, NOVEL), (a, NOVEL),
                       (b, texts[:40])):
        meta, lengths, _ = eng.encoder.encode_batch(docs)
        got = eng.run_raw(meta, lengths, spec=spec)
        want = none.run_raw(meta, lengths)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, w)
        assert eng.last_cold_share is not None
    # the same census gives one object; the cache starts anew past
    # WAVE_CACHE sets and never holds more than WAVE_CACHE + 1
    for i in range(engine_mod.WAVE_CACHE + 3):
        eng.wave_spec([texts[i]])
        assert len(eng._wave_cache) <= engine_mod.WAVE_CACHE + 1
    assert eng.wave_spec([texts[0]]) is eng.wave_spec([texts[0]])


def test_wave_set_same_as_own_is_own(tok):
    """A wave whose census fills the engine's own set back gives the
    engine's own ``HotTable``; an engine without a hot set, or with
    ``per_wave=False``, returns its own (None without one)."""
    eng = dtt.BatchEngine(tok, device="cpu", hot_size=8)
    assert eng.per_wave
    own = eng.tables.hot
    counts = eng.census_states(TEXTS)
    H, census = hot_mod.census_cut(counts, own.H, eng.WAVE_H_LADDER)
    assert H == 8
    spec = eng.wave_spec(TEXTS)
    np.testing.assert_array_equal(
        spec.states, hot_mod.wave_hot_states(census, own.states))
    eng2 = dtt.BatchEngine(tok, device="cpu", hot_size=1)
    assert eng2.wave_spec(TEXTS) is eng2.tables.hot
    assert dtt.BatchEngine(tok, device="cpu").wave_spec(TEXTS) is None
    off = dtt.BatchEngine(tok, device="cpu", hot_size="auto", per_wave=False)
    assert not off.per_wave and off.wave_spec(NOVEL) is off.tables.hot
    with pytest.raises(ValueError, match="without one"):
        dtt.BatchEngine(tok, device="cpu")._tables_for(spec)


def test_default_engine_takes_no_census(monkeypatch, tok, texts):
    """``BatchEngine(tok)``'s defaults (no hot set) run no census and
    launch with the engine's tables as they are."""
    seen = []
    monkeypatch.setattr(engine_mod, "native_state_census",
                        lambda *a: seen.append(a))
    eng = dtt.BatchEngine(tok, device="cpu")
    assert eng.tables.hot is None and not eng.per_wave
    assert eng._tables_for(None) is eng.tables
    assert eng.tokenize_batch(texts) == [tok.tokenize(t) for t in texts]
    assert not seen


def test_wave_encoded_once_by_the_engine_encoder(monkeypatch, tok):
    """No wave is re-encoded for its set: the engine's one encoder
    encodes each wave once, and its meta is what a ``hot_size=0``
    engine's encoder gives."""
    eng = dtt.BatchEngine(tok, device="cpu", hot_size="auto")
    calls = []
    enc = eng.encoder
    real = enc.encode_batch
    monkeypatch.setattr(enc, "encode_batch",
                        lambda docs, **kw: calls.append(docs) or real(docs, **kw))
    eng.events_batch(NOVEL)
    eng.events_batch(TEXTS)
    assert calls == [NOVEL, TEXTS]
    for docs in (NOVEL, TEXTS):
        for x, y in zip(real(docs),
                        dtt.BatchEngine(tok, device="cpu").encoder
                        .encode_batch(docs)[:2]):
            np.testing.assert_array_equal(x, y)


def test_pipelined_per_wave_equals_serial(monkeypatch, tok, texts):
    """``tokenize_stream_pipelined`` on a per-wave engine: each wave
    launched with its own set, bytes equal to the serial stream, and
    the census timed."""
    eng = dtt.BatchEngine(tok, device="cpu", hot_size="auto")
    specs = []
    real = eng.run_raw_async

    def spy(*a, **kw):
        specs.append(a[4] if len(a) > 4 else kw.get("spec"))
        return real(*a, **kw)

    monkeypatch.setattr(eng, "run_raw_async", spy)
    stream = "\x04".join([t if t else "x" for t in texts]) + "\x04"
    want = dtt.tokenize_stream(tok, stream, engine=eng).getvalue()
    assert want == dtt.tokenize_stream(
        tok, stream, engine=dtt.BatchEngine(tok, device="cpu")).getvalue()
    stats = {}
    got = dtt.tokenize_stream_pipelined(tok, stream, engine=eng, lanes=8,
                                        stats=stats).getvalue()
    assert got == want
    assert stats["census"] > 0 and stats["waves"] == len(specs) >= 2
    assert all(s is not None for s in specs)
    assert len({id(s) for s in specs}) >= 2


def test_wave_holds_its_set(tok):
    """The wave carries its set to the consumer (the set outlives K1's
    reads of it)."""
    assert "spec" in overlap_mod._Wave.__slots__
    eng = dtt.BatchEngine(tok, device="cpu", hot_size="auto")
    held = []
    real = overlap_mod._Wave.__init__

    def init(self, *a, **kw):
        real(self, *a, **kw)
        held.append(self.spec)

    try:
        overlap_mod._Wave.__init__ = init
        out = dtt.tokenize_stream_pipelined(
            tok, "\x04".join(TEXTS + NOVEL) + "\x04", engine=eng,
            lanes=4).getvalue()
    finally:
        overlap_mod._Wave.__init__ = real
    assert out == tok.tokenize("\x04".join(TEXTS + NOVEL) + "\x04")
    assert held and all(isinstance(h, type(eng.tables.hot)) for h in held)


# ---- AdaptiveEngine ----------------------------------------------------------

@pytest.fixture(scope="module")
def ae(tok):
    return AdaptiveEngine(tok, device="cpu", hot_size=NARROW)


def test_adaptive_surface_and_constants(tok, ae):
    assert (COLD_THRESHOLD, SAMPLE_CHARS) == (0.005, 65536)
    assert ae.threshold == COLD_THRESHOLD and ae.sample_chars == SAMPLE_CHARS
    assert ae.narrow.hot_size == NARROW
    assert ae._wide_config == {"hot_size": hot_mod.hot_capacity(171)}


def test_adaptive_routing(ae):
    ae.choose([UNIFORM] * 16)
    assert ae.last_choice == "narrow", ae.last_cold_rate
    ae.choose([COLD_HEAVY] * 16)
    assert ae.last_choice == "wide", ae.last_cold_rate
    assert ae.cold_rate([UNIFORM] * 4) < ae.threshold
    assert ae.cold_rate([COLD_HEAVY] * 4) > ae.threshold


def test_adaptive_narrow_wide_byte_parity(tok, ae):
    docs = [UNIFORM, COLD_HEAVY, "a", "", "Der Mann.\x04Zwei.\x04"] + NOVEL
    out_n = ae.narrow.tokenize_batch(docs)
    assert out_n == ae.wide.tokenize_batch(docs)
    assert out_n == [tok.tokenize(t) for t in docs]
    assert ae.wide.hot_size > ae.narrow.hot_size
    assert ae.tokenize_batch(docs) == out_n
    assert ae.events_batch(docs) == [transduce_events(tok, t) for t in docs]


def test_adaptive_wide_is_lazy(tok):
    a2 = AdaptiveEngine(tok, device="cpu", hot_size=NARROW)
    a2.choose([UNIFORM] * 4)
    assert a2._wide is None, "uniform text must not build the wide engine"
    assert a2.choose([COLD_HEAVY] * 4) is a2.wide is a2._wide


def test_adaptive_choose_empty(ae):
    assert ae.choose([]) is ae.narrow
    assert ae.last_cold_rate == 0.0


def test_adaptive_without_hot_set_is_narrow(tok):
    """With the port's default ``hot_size=0`` the narrow engine has no
    hot set: the cold rate is 0.0 and the choice narrow, as the JAX
    module does for an engine without a spec."""
    a0 = AdaptiveEngine(tok, device="cpu")
    assert a0._hot_mask is None
    for docs in ([COLD_HEAVY] * 8, [UNIFORM], NOVEL):
        assert a0.choose(docs) is a0.narrow
        assert a0.last_cold_rate == 0.0 and a0.last_choice == "narrow"
    assert a0._wide is None


@pytest.mark.parametrize("size", ["capacity", "auto"])
def test_adaptive_at_capacity_is_narrow(big, size):
    """A narrow set that already holds ``hot_capacity`` states (as
    ``"auto"`` does at DE width) leaves nothing for a wide engine: the
    router stays narrow at a cold rate of 0.0 and builds no wide one."""
    cap = hot_mod.hot_capacity(171)
    a = AdaptiveEngine(big, device="cpu",
                       hot_size=cap if size == "capacity" else "auto")
    assert a.narrow.hot_size == cap and a._hot_mask is None
    assert a.choose([COLD_HEAVY] * 8) is a.narrow
    assert a.last_cold_rate == 0.0 and a.last_choice == "narrow"
    assert a._wide is None


@pytest.mark.parametrize("docs", ["uniform", "cold_heavy", "novel"])
def test_adaptive_cold_rate_matches_jax_native(tok, ae, docs):
    texts = {"uniform": [UNIFORM] * 4, "cold_heavy": [COLD_HEAVY] * 4,
             "novel": NOVEL}[docs]
    sample = hot_mod.sample_texts(texts, ae.sample_chars)
    metas = ae.narrow.encoder.encode(text_to_codepoints(sample))
    mask = ae._hot_mask
    assert mask.sum() == NARROW
    want = jax_native_cold_rate(jax_twin(tok), metas, mask)
    got = native_cold_rate(tok, metas, mask)
    assert got == want and want[1] > 0
    assert ae.cold_rate(texts) == want[0] / want[1]


# ---- engine="hot" and the sharded engine -------------------------------------

def test_engine_hot_matches_default_and_jax(monkeypatch, tok, texts,
                                            jax_default):
    eng = dtt.BatchEngine(tok, device="cpu", engine="hot")
    assert eng.engine == "hot" and not eng.per_wave
    assert eng._kernel() is kt.transduce
    np.testing.assert_array_equal(eng.tables.hot.states,
                                  jax_default.spec.hot_full)
    np.testing.assert_array_equal(eng.encoder.lc_mask, eng.tables.lc_mask)
    assert dtt.BatchEngine(tok, device="cpu", engine="hot",
                           hot_size=8).hot_size == 8
    entries, stops = _entries_stops(tok, texts)
    got, got_exits = eng.events_batch(texts, entries=entries, stops=stops,
                                      return_exits=True)
    want, want_exits = jax_default.events_batch(
        texts, entries=entries, stops=stops, return_exits=True)
    assert got == want
    np.testing.assert_array_equal(got_exits, want_exits)
    out = eng.tokenize_batch(texts)
    assert out == dtt.BatchEngine(tok, device="cpu").tokenize_batch(texts)
    assert out == jax_default.tokenize_batch(texts)
    # K1's host build in the place of the plain machine, with the set
    monkeypatch.setattr(engine_mod, "transduce",
                        lambda tb, *a, **kw: kt.transduce_host(tb, *a, **kw))
    assert eng.tokenize_batch(texts) == out


def test_sharded_per_wave_runs_its_own_set(tok, texts):
    seng = dtt.ShardedEngine(tok, devices=["cpu"] * 2, hot_size=NARROW,
                             per_wave=True)
    assert not seng.per_wave and seng.hot_size == NARROW
    assert seng.wave_spec(NOVEL) is seng.tables.hot
    assert seng.tokenize_batch(texts) == [tok.tokenize(t) for t in texts]
    other = dtt.BatchEngine(tok, device="cpu", hot_size="auto").wave_spec(
        NOVEL)
    meta, lengths, _ = seng.encoder.encode_batch(NOVEL)
    with pytest.raises(NotImplementedError, match="per-wave hot sets"):
        seng.run_raw_device(meta, lengths, spec=other)
    hot = dtt.ShardedEngine(tok, devices=["cpu"] * 2, engine="hot")
    assert hot.engine == "hot" and hot.hot_size > 0
    assert hot.tokenize_batch(texts) == [tok.tokenize(t) for t in texts]


def test_engine_hot_on_datok_converts(tok):
    da = synth_datok(60, SEED)
    eng = dtt.BatchEngine(da, device="cpu", engine="hot")
    assert eng.engine == "hot" and eng.tables.kind == "MATOK"
    assert eng.hot_size > 0
    assert eng.tokenize_batch(EDGE) == [da.tokenize(t) for t in EDGE]


# ---- on a card ---------------------------------------------------------------

@pytest.mark.cuda
def test_per_wave_on_card_matches_plain(tok, texts):
    """K1 with each wave's own set (tagged on the card) equals the plain
    machine and the oracle, and launches once a wave."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (K1 has no CPU mode)")
    eng = dtt.BatchEngine(tok, "cuda", hot_size="auto")
    cpu = dtt.BatchEngine(tok, "cpu")
    before = kt.transduce.launches
    for docs in (texts[:40], NOVEL, TEXTS):
        spec = eng.wave_spec(docs)
        assert spec.table.is_cuda and spec.ready is not None
        assert eng.tokenize_batch(docs) == cpu.tokenize_batch(docs)
    assert kt.transduce.launches == before + 3
