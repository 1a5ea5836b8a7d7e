"""The streaming path of the port (``datok_tpu_torch.runtime.pipeline``)
on the CPU against the JAX pipeline (general engine, JAX CPU backend)
and the scalar oracle.

Outputs are integers and bytes, so every comparison is exact.
"""

import functools
import io

import numpy as np
import pytest
import torch

import datok_tpu.runtime.pipeline as JP
import datok_tpu_torch as dtt
from datok_tpu.runtime.encode import SymbolEncoder as JaxEncoder
from datok_tpu.runtime.jax_engine import BatchEngine as JaxEngine
from datok_tpu.runtime.oracle import transduce_events
from datok_tpu_torch.runtime import pipeline as P
from datok_tpu_torch.testing.synth import synth_datok, synth_text, synth_tokenizer
from torch_twins import jax_twin

N_ABBREV, SEED = 200, 7
# "datok_general": the .datok model on an engine="general" engine, which
# keeps the double array (the other kinds' engines run a matrix)
KINDS = ["matok", "datok", "noeot", "datok_general"]
ENGINE = {"datok_general": "general"}


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


@pytest.fixture(scope="module")
def jax_engine(jax_engines):
    return jax_engines["matok"]


def _docs(tok, n, seed, lo=0, hi=400):
    rng = np.random.default_rng(seed)
    return synth_text(tok, n, [int(x) for x in rng.integers(lo, hi, n)],
                      seed=seed)


def _streams(tok):
    """Streams of 5 and 40 documents joined at EOT (the documents carry
    EOTs of their own), one ending exactly at EOT, the empty stream,
    and one with non-ASCII and unknown characters around EOTs."""
    s5 = "\x04".join(_docs(tok, 5, SEED + 1))
    s40 = "\x04\n".join(_docs(tok, 40, SEED + 2, 0, 60))
    return {
        "5docs": s5,
        "40docs": s40,
        "ends_at_eot": s5 + "\x04",
        "empty": "",
        "edges": "Der Mann.\x04z.B. „gut“ …\x04\x04œ~ € þ 中\x04Neu-\x04 3.",
    }


STREAMS = ["5docs", "40docs", "ends_at_eot", "empty", "edges"]


def test_eot_in_sigma_of_synth_models(models):
    assert P.eot_in_sigma(models["matok"]) and P.eot_in_sigma(models["datok"])
    assert not P.eot_in_sigma(models["noeot"])
    text = "a.\x04b.\x04"
    assert P.split_stream(models["noeot"], text) == [text]
    assert P.split_stream(models["matok"], text) == ["a.\x04", "b.\x04", ""]


@pytest.mark.parametrize("name", STREAMS)
@pytest.mark.parametrize("kind", KINDS)
def test_tokenize_stream_matches_oracle(models, engines, kind, name):
    tok = models[kind]
    text = _streams(tok)[name]
    out = dtt.tokenize_stream(tok, text, engine=engines[kind]).getvalue()
    assert out == tok.tokenize(text)


@pytest.mark.parametrize("name", STREAMS)
@pytest.mark.parametrize("kind", KINDS)
def test_tokenize_stream_matches_jax_pipeline(models, engines, jax_engines,
                                              kind, name):
    tok = models[kind]
    text = _streams(tok)[name]
    got = dtt.tokenize_stream(tok, text, engine=engines[kind]).getvalue()
    jeng = jax_engines[kind]
    want = JP.tokenize_stream(jeng.tok, text, engine=jeng).getvalue()
    assert got == want


def _long_case(tok):
    """Long documents with non-root entries and cuts: EOT-free text, one
    with an interior EOT, a token longer than a segment, and the empty
    document."""
    docs = [d.replace("\x04", " ") for d in _docs(tok, 5, SEED + 3, 200, 700)]
    docs[2] = docs[2][:200] + "\x04" + docs[2][200:]
    docs += ["x" * 300 + " kurz.", ""]
    f = P.SPLIT_FLAGS
    entries = np.array([1, 1 | f, 1 | f | (1 << 30), 1, 1 | f, 1, 1], np.int32)
    stops = np.array([False, True, False, True, False, False, True])
    return docs, entries, stops


@pytest.mark.parametrize("seg_len", [48, 128])
@pytest.mark.parametrize("fn", ["events_long_batch", "events_speculative_batch"])
def test_long_documents_match_jax(models, engines, jax_engine, fn, seg_len):
    tok = models["matok"]
    docs, entries, stops = _long_case(tok)
    got, got_exits = getattr(P, fn)(engines["matok"], docs, seg_len=seg_len,
                                    entries=entries, stops=stops)
    want, want_exits = getattr(JP, fn)(jax_engine, docs, seg_len=seg_len,
                                       entries=entries, stops=stops)
    assert got == want
    np.testing.assert_array_equal(got_exits, want_exits)
    # the documents run from the root without a cut equal the oracle
    for k in np.flatnonzero((entries == 1) & ~stops):
        assert got[k] == transduce_events(jax_engine.tok, docs[k]), k


@pytest.mark.parametrize("strategy", ["speculative", "chained"])
def test_run_docs_long_path_takes_host_only_for_giant_token(
        models, engines, monkeypatch, strategy):
    """With ``MAX_SEGMENT`` small, ``_run_docs`` sends documents over it
    to the long path; only the document whose single token is longer
    than a segment may take the exact host fallback."""
    tok = models["matok"]
    eng = engines["matok"]
    host_docs = []
    orig = P.transduce_doc_exact

    def spy(tok_, doc, *a, **k):
        host_docs.append(doc[:8])
        return orig(tok_, doc, *a, **k)

    monkeypatch.setattr(P, "transduce_doc_exact", spy)
    monkeypatch.setattr(P, "MAX_SEGMENT", 200)
    for name in ("events_long_batch", "events_speculative_batch"):
        monkeypatch.setattr(P, name, functools.partial(getattr(P, name), seg_len=64))
    docs = [d.replace("\x04", " ") + "\x04"
            for d in _docs(tok, 6, SEED + 4, 150, 900)]
    docs.insert(3, "x" * 300 + " kurz.\x04")
    docs.append("Ende.")
    text = "".join(docs)
    chunks = P.split_stream(tok, text)
    assert sum(len(d) > 200 for d in chunks) >= 4
    events, _ = P._run_docs(tok, eng, chunks, long_strategy=strategy)
    w = dtt.TokenWriter(dtt.SIMPLE)
    P._replay_docs(chunks, events, w)
    assert w.getvalue() == tok.tokenize(text)
    assert host_docs == ["xxxxxxxx"], host_docs


def _reader_text(tok):
    docs = _docs(tok, 5, SEED + 5, 20, 150)
    # a long EOT-free document makes the reader checkpoint mid-document
    docs.insert(4, synth_text(tok, 1, 300, seed=SEED + 6)[0].replace("\x04", " "))
    return "€\x04".join(docs) + " schön „Ende“ œ"


@pytest.fixture(scope="module")
def reader_case(models, engines):
    """Per model: the reader test text and its ``tokenize_stream`` output."""
    out = {}
    for kind in ("matok", "noeot", "datok_general"):
        tok = models[kind]
        text = _reader_text(tok)
        want = dtt.tokenize_stream(tok, text, engine=engines[kind]).getvalue()
        assert want == tok.tokenize(text)
        out[kind] = text, want
    return out


@pytest.mark.parametrize("mode,chunk", [
    ("bytes", 7), ("bytes", 64), ("bytes", 4096),
    ("text", 7), ("text", 64), ("text", 4096), ("native", 4096),
])
@pytest.mark.parametrize("kind", ["matok", "noeot", "datok_general"])
def test_tokenize_reader_equals_stream(models, engines, reader_case, kind,
                                       chunk, mode):
    tok = models[kind]
    text, want = reader_case[kind]
    if mode == "text":
        reader = io.StringIO(text)
    else:
        reader = io.BytesIO(text.encode("utf-8"))  # splits multi-byte chars
    writer = dtt.NativeWriter(dtt.SIMPLE) if mode == "native" else None
    got = dtt.tokenize_reader(tok, reader, writer, engine=engines[kind],
                              chunk_bytes=chunk, seg_len=48).getvalue()
    assert got == want


def test_tokenize_reader_matches_jax_reader(models, engines, jax_engine):
    tok = models["matok"]
    text = _reader_text(tok)
    got = dtt.tokenize_reader(tok, io.BytesIO(text.encode()), engine=engines["matok"],
                              chunk_bytes=256, seg_len=48).getvalue()
    want = JP.tokenize_reader(jax_engine.tok, io.BytesIO(text.encode()),
                              engine=jax_engine,
                              chunk_bytes=256, seg_len=48).getvalue()
    assert got == want


@pytest.mark.parametrize("entry", ["root", "after_eot"])
def test_events_until_checkpoint_resumes_exactly(models, engines, jax_engine, entry):
    tok = models["matok"]
    text = synth_text(tok, 1, 700, seed=SEED + 7)[0].replace("\x04", " ")
    e0 = 1 if entry == "root" else 1 | P.SPLIT_FLAGS
    evs, ck_pos, ck_ctx = P.events_until_checkpoint(
        engines["matok"], text, entry=e0, seg_len=64)
    assert 0 < ck_pos <= len(text)
    assert (evs, ck_pos, ck_ctx) == JP.events_until_checkpoint(
        jax_engine, text, entry=e0, seg_len=64)
    jtok = jax_engine.tok
    rest = transduce_events(jtok, text, entry_state=ck_ctx, start=ck_pos)
    assert evs + rest == transduce_events(jtok, text, entry_state=e0)


def test_stream_needs_engine_or_device(models, monkeypatch):
    """Naming neither asks for an engine on "cuda", which raises without
    a card."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="cuda"):
        dtt.tokenize_stream(models["matok"], "a.")
    with pytest.raises(RuntimeError, match="cuda"):
        dtt.tokenize_reader(models["matok"], io.StringIO("a."))


def test_stale_ok_after_equals_jax(models):
    """The port's regex scan for the last codepoint >= 256 and its set
    lookup give the JAX module's value (a Python loop over the tail, a vectorized scan
    beyond it) on ASCII, Latin-1 and wide text, inside and beyond the
    4096-character tail, for both entry values."""
    enc = dtt.BatchEngine(models["matok"], device="cpu").encoder
    known = chr(int(enc.keys[0])) if len(enc.keys) else "€"
    rng = np.random.default_rng(SEED)
    pool = ["a", " ", ".", "ä", "ß", "\x04", known, "中", "\ud800", "€", "œ"]
    docs = ["", "abc", "Grüße", "ab中", "ab€", "x€ü", known + "ü" * 5000,
            "中" + "a" * 5000, known + "ü" * 4095, "ü" * 6000]
    for n in (1, 7, 300, 5000):
        for _ in range(6):
            docs.append("".join(rng.choice(pool, n)))
    known = frozenset(enc.keys.tolist())
    jenc = JaxEncoder(jax_twin(models["matok"]))
    for doc in docs:
        for ok in (0, 1):
            assert P._stale_ok_after(known, doc, ok) == JP._stale_ok_after(
                jenc, doc, ok), (doc[:20], len(doc), ok)
