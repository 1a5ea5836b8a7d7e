"""The overlapped pipeline of the port (``datok_tpu_torch.runtime.overlap``)
on the CPU against the JAX one (general engine, JAX CPU backend) and
against ``tok.tokenize`` of the whole stream, on matrix, ``.datok`` and
no-EOT synthetic models.

Outputs are integers and bytes, so every comparison is exact.
"""

import threading
import time
import warnings

import numpy as np
import pytest
import torch

import datok_tpu.runtime.overlap as JO
import datok_tpu_torch as dtt
from datok_tpu.runtime.jax_engine import BatchEngine as JaxEngine
from datok_tpu_torch.runtime import overlap as O
from datok_tpu_torch.runtime import pipeline as P
from datok_tpu_torch.testing.synth import synth_datok, synth_text, synth_tokenizer
from torch_twins import jax_twin

N_ABBREV, SEED = 200, 7
# "datok_general": the .datok model on an engine="general" engine, which
# keeps the double array (the other kinds' engines run a matrix)
KINDS = ["matok", "datok", "noeot", "datok_general"]
ENGINE = {"datok_general": "general"}

# the JAX overlap tests' texts (tests/test_overlap.py:26-40)
STREAM = (
    "Der alte Mann. Er ging heim.\x04Zwei Texte? Ja!\x04" * 12
    + "Ümläut über straße.\x04Nach nicht-ASCII bleibt ok gesetzt.\x04"
    + "Ende ohne EOT am Schluss"
)
EDGES = [
    "",
    "\x04",
    "\x04\x04",
    "a",
    "Erste.\n\n\n\n\x04\x0aNächst.\x04",
    "A.\x04\x04B.\x04",
    "nur leerzeichen   \x04   \x04",
]


@pytest.fixture(scope="module")
def models():
    da = synth_datok(N_ABBREV, SEED)
    return {
        "matok": synth_tokenizer(N_ABBREV, SEED),
        "datok": da,
        "noeot": synth_tokenizer(N_ABBREV, SEED, eot=False),
        "datok_general": da,
    }


@pytest.fixture(scope="module")
def engines(models):
    engs = {k: dtt.BatchEngine(m, device="cpu",
                               engine=ENGINE.get(k, "auto"))
            for k, m in models.items()}
    assert engs["datok_general"].tables.kind == "DATOK"
    return engs


@pytest.fixture(scope="module")
def jax_engines(models):
    return {k: JaxEngine(jax_twin(m), engine="general")
            for k, m in models.items()}


def _both(models, engines, jax_engines, kind, text, **kw):
    """The port's and the JAX package's pipelined output of ``text``,
    with their stats dicts."""
    tok = models[kind]
    st, jst = {}, {}
    got = dtt.tokenize_stream_pipelined(tok, text, engine=engines[kind],
                                        stats=st, **kw).getvalue()
    jeng = jax_engines[kind]
    want = JO.tokenize_stream_pipelined(jeng.tok, text, engine=jeng,
                                        stats=jst, **kw).getvalue()
    return got, want, st, jst


@pytest.mark.parametrize("pack_len", [0, 1024])
@pytest.mark.parametrize("lanes", [4, 5, 7])
@pytest.mark.parametrize("kind", KINDS)
def test_stream_matches_jax_and_oracle(models, engines, jax_engines, kind,
                                       lanes, pack_len):
    got, want, st, jst = _both(models, engines, jax_engines, kind, STREAM,
                               lanes=lanes, pack_len=pack_len)
    assert got == want
    assert got == models[kind].tokenize(STREAM)
    assert st["waves"] == jst["waves"] and st["docs"] == jst["docs"]


@pytest.mark.parametrize("i", range(len(EDGES)))
def test_edges_match_jax_and_oracle(models, engines, jax_engines, i):
    got, want, _, _ = _both(models, engines, jax_engines, "matok", EDGES[i])
    assert got == want == models["matok"].tokenize(EDGES[i])


def test_long_document_between_short_ones(models, engines, jax_engines):
    """A document over ``MAX_SEGMENT`` takes the long route inside prep
    (speculative segmentation) and the chain continues across it."""
    long_doc = ("Langer Satz mit Wörtern und Zahlen 123. " * 820) + "\x04"
    assert len(long_doc) > O.MAX_SEGMENT
    text = "Kurz davor.\x04" + long_doc + "Kurz danach!\x04"
    got, want, st, jst = _both(models, engines, jax_engines, "matok", text,
                               lanes=4)
    assert got == want == models["matok"].tokenize(text)
    assert st["long_docs"] == jst["long_docs"] == 1


@pytest.mark.parametrize("kind", KINDS)
def test_long_route_with_small_segment_limit(models, engines, jax_engines,
                                             monkeypatch, kind):
    """The long route on every model kind, with ``MAX_SEGMENT`` cut to
    300 in both pipelines and 64-character segments."""
    tok = models[kind]
    docs = [d.replace("\x04", " ") for d in
            synth_text(tok, 3, [40, 700, 50], seed=SEED + 1)]
    text = docs[0] + "\x04" + docs[1] + "\x04" + docs[2]
    items = [(k, d) for k, d in enumerate(P.split_stream(tok, text))]
    monkeypatch.setattr(O, "MAX_SEGMENT", 300)
    monkeypatch.setattr(JO, "MAX_SEGMENT", 300)
    st, jst = {}, {}
    got = list(O.events_pipelined(engines[kind], iter(items), lanes=4,
                                  long_seg_len=64, stats=st))
    want = list(JO.events_pipelined(jax_engines[kind], iter(items), lanes=4,
                                    long_seg_len=64, stats=jst))
    assert [(t, d) for t, d, _ in got] == [(t, d) for t, d, _ in want]
    for (_, _, a), (_, _, b) in zip(got, want):
        np.testing.assert_array_equal(a, b)
    assert st["long_docs"] == jst["long_docs"] >= 1
    w = dtt.TokenWriter(dtt.SIMPLE)
    for _, doc, ev in got:
        dtt.replay_events([tuple(r) for r in ev.tolist()], doc, w)
    w.flush()
    assert w.getvalue() == tok.tokenize(text)


def test_copy_cps_keeps_waves_valid(models, engines, jax_engines):
    """With ``copy_cps`` every wave stays usable after the generator has
    moved on: format them all at the end."""
    tok = models["matok"]
    items = [(None, d) for d in P.split_stream(tok, STREAM)]
    got = list(O.waves_pipelined(engines["matok"], iter(items), lanes=4,
                                 copy_cps=True))
    want = list(JO.waves_pipelined(jax_engines["matok"], iter(items), lanes=4,
                                   copy_cps=True))
    assert len(got) == len(want) > 2
    w = dtt.NativeWriter(dtt.SIMPLE)
    for a, b in zip(got, want):
        assert a.docs == b.docs
        for x, y in ((a.tri, b.tri), (a.counts, b.counts)):
            np.testing.assert_array_equal(x, y)
        for k in range(len(a.docs)):
            np.testing.assert_array_equal(
                a.cps_flat[a.cps_offs[k]: a.cps_offs[k] + a.cps_lens[k]],
                b.cps_flat[b.cps_offs[k]: b.cps_offs[k] + b.cps_lens[k]])
        w.feed_wave(a.tri, a.counts, a.cps_flat, a.cps_offs, a.cps_lens)
    assert w.getvalue() == tok.tokenize(STREAM)


@pytest.mark.parametrize("kind", KINDS)
def test_tags_pass_through(models, engines, jax_engines, kind):
    items = [(("f", i), f"Satz {i}. Noch einer!\x04") for i in range(9)]
    got = list(O.events_pipelined(engines[kind], iter(items), lanes=4))
    want = list(JO.events_pipelined(jax_engines[kind], iter(items), lanes=4))
    assert [t for t, _, _ in got] == [t for t, _ in items]
    assert [(t, d) for t, d, _ in got] == [(t, d) for t, d, _ in want]
    for (_, _, a), (_, _, b) in zip(got, want):
        assert isinstance(a, np.ndarray) and a.shape[1] == 3
        np.testing.assert_array_equal(a, b)


def _pipeline_threads():
    return [t for t in threading.enumerate()
            if t.name in ("datok-prep", "datok-fetch") and t.is_alive()]


def test_early_close_releases_threads(engines):
    assert not _pipeline_threads()
    gen = O.events_pipelined(
        engines["matok"], ((None, d) for d in ["Eins.\x04"] * 64), lanes=4
    )
    next(gen)
    t0 = time.perf_counter()
    with warnings.catch_warnings():
        warnings.simplefilter("error")  # the join-timeout warning fails
        gen.close()  # must not deadlock on the slot ring
    assert time.perf_counter() - t0 < 60
    assert not _pipeline_threads()


def test_no_host_repair_on_predicted_chain(models, engines, monkeypatch):
    calls = []

    def spy(orig):
        def f(*a, **k):
            calls.append(1)
            return orig(*a, **k)
        return f

    monkeypatch.setattr(O, "transduce_doc_exact", spy(O.transduce_doc_exact))
    monkeypatch.setattr(P, "transduce_doc_exact", spy(P.transduce_doc_exact))
    st = {}
    out = dtt.tokenize_stream_pipelined(models["matok"], STREAM,
                                        engine=engines["matok"], lanes=5,
                                        stats=st).getvalue()
    assert out == models["matok"].tokenize(STREAM)
    assert calls == [] and st["repairs"] == 0


@pytest.mark.parametrize("kind", KINDS)
def test_bad_lanes_are_repaired_exactly(models, kind):
    """A step budget far too small makes lanes ``bad``; the consumer
    repairs them on the host and the output stays exact."""
    tok = models[kind]
    # documents of 100-200 characters need more than the 64 + 0.1 L
    # steps the budget leaves them
    text = "\x04".join(synth_text(tok, 10, 150, seed=SEED + 3)) + STREAM
    eng = dtt.BatchEngine(tok, device="cpu", steps_factor=0.1,
                          engine=ENGINE.get(kind, "auto"))
    jeng = JaxEngine(jax_twin(tok), engine="general", steps_factor=0.1)
    st = {}
    got = dtt.tokenize_stream_pipelined(tok, text, engine=eng, lanes=7,
                                        pack_len=0, stats=st).getvalue()
    want = JO.tokenize_stream_pipelined(jeng.tok, text, engine=jeng, lanes=7,
                                        pack_len=0).getvalue()
    assert st["repairs"] > 0
    assert got == want == tok.tokenize(text)


def test_stats_keys_equal_jax(models, engines, jax_engines):
    _, _, st, jst = _both(models, engines, jax_engines, "matok", STREAM,
                          lanes=5)
    assert sorted(st) == sorted(jst)
    for k in ("waves", "docs", "repairs", "long_docs"):
        assert st[k] == jst[k], k
    assert st["census"] == 0.0
    assert all(st[k] >= 0.0 for k in ("encode", "dispatch", "fetch",
                                      "decode", "format"))


class _Boom(Exception):
    pass


@pytest.mark.parametrize("where", ["items", "dispatch"])
def test_prep_error_reaches_caller(engines, monkeypatch, where):
    """An exception in the prep thread (from the input iterator, or from
    the device dispatch as a failed K1 launch would raise) is raised to
    the consumer, and the threads exit."""
    eng = engines["matok"]

    def items():
        for i in range(12):
            if where == "items" and i == 9:
                raise _Boom("input failed")
            yield None, f"Satz {i}.\x04"

    if where == "dispatch":
        def fail(*a, **k):
            raise _Boom("launch failed")
        monkeypatch.setattr(eng, "run_raw_async", fail)
    with pytest.raises(_Boom):
        list(O.events_pipelined(eng, items(), lanes=4))
    assert not _pipeline_threads()


def test_stream_needs_engine_or_device(models, monkeypatch):
    """Naming neither asks for an engine on "cuda", which raises without
    a card."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="cuda"):
        dtt.tokenize_stream_pipelined(models["matok"], "a.")


def test_run_raw_async_equals_run_raw_device(models, engines):
    """On the CPU the host tensors go to the plain machine as they are,
    with the same results as ``run_raw_device``."""
    eng = engines["matok"]
    texts = synth_text(models["matok"], 6, [0, 5, 40, 90, 17, 60], seed=3)
    meta, lengths, _ = eng.encoder.encode_batch(texts)
    entries = np.full(len(texts), 1 | P.SPLIT_FLAGS, np.int32)
    entries[0] = 1
    stops = np.array([False, True, False, True, False, False])
    want = eng.run_raw_device(meta, lengths, entries, stops)
    got = eng.run_raw_async(torch.from_numpy(meta), torch.from_numpy(lengths),
                            torch.from_numpy(entries), torch.from_numpy(stops))
    ev_g, c_g = got[0], got[1]
    ev_w, c_w = want[0], want[1]
    torch.testing.assert_close(c_g, c_w, rtol=0, atol=0)
    for i in range(len(texts)):
        assert torch.equal(ev_g[i, : c_g[i]], ev_w[i, : c_w[i]])
    for a, b in zip(got[2:], want[2:]):
        assert torch.equal(a, b)


@pytest.mark.cuda
def test_pipelined_on_card(models):
    """The pinned, per-slot-stream path on a card equals the oracle and
    launches K1 once per wave."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (K1 has no CPU mode)")
    from datok_tpu_torch.kernels import transduce as kt

    tok = models["matok"]
    eng = dtt.BatchEngine(tok, device="cuda")
    text = "\x04\n".join(synth_text(tok, 200, 300, seed=SEED + 2)) + STREAM
    kt.transduce.launches = 0
    st = {}
    out = dtt.tokenize_stream_pipelined(tok, text, engine=eng, lanes=32,
                                        stats=st).getvalue()
    assert out == tok.tokenize(text)
    assert kt.transduce.launches == st["waves"] > 1
