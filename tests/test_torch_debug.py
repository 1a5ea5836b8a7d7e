"""Divergence introspection of the port (``datok_tpu_torch.runtime.debug``)
on the CPU, on a synthetic matrix model: the device half against the
oracle, a report on a corrupted event, and the pipeline's report of a
``bad`` lane."""

import io

import pytest

import datok_tpu_torch as dtt
from datok_tpu.runtime.oracle import transduce_events
from datok_tpu_torch.runtime import debug as D
from datok_tpu_torch.runtime.machine import PACK_POS_BITS
from datok_tpu_torch.testing.synth import synth_text, synth_tokenizer
from torch_twins import jax_twin

DOC = "Der alte Mann ging heim. Er sagte z.B. nichts!"


@pytest.fixture(scope="module")
def tok():
    return synth_tokenizer(200, 7)


@pytest.fixture(scope="module")
def eng(tok):
    return dtt.BatchEngine(tok, device="cpu")


def test_device_events_equal_oracle(tok, eng):
    for entry in (1, 1 | (1 << 28) | (1 << 29)):
        evs, bad = D.device_events(eng, DOC, entry=entry)
        assert not bad
        assert [tuple(e) for e in evs] == transduce_events(
            jax_twin(tok), DOC, entry_state=entry)


def test_dump_divergence_none_on_match(eng):
    buf = io.StringIO()
    assert D.dump_divergence(eng, DOC, out=buf) is None
    assert buf.getvalue() == ""


def test_dump_reports_first_mismatch(eng, monkeypatch):
    """The engine's ``run_raw`` returns one event with its end moved by
    one: the report names event 2 and shows both streams."""
    real = eng.run_raw

    def corrupt(meta, lengths, entries=None, stops=None):
        ev, counts, bad, steps, state = real(meta, lengths, entries, stops)
        ev = ev.copy()
        ev[0, 2] += 1 << (2 + PACK_POS_BITS)
        return ev, counts, bad, steps, state

    monkeypatch.setattr(eng, "run_raw", corrupt)
    buf = io.StringIO()
    r = D.dump_divergence(eng, DOC, out=buf)
    assert r is not None and r["mismatch_event"] == 2 and not r["device_bad"]
    assert r["device"][2] != r["oracle"][2]
    text = buf.getvalue()
    assert "divergence" in text and "oracle[" in text and "device[" in text


def test_host_half_is_the_jax_modules(tok, monkeypatch):
    """The host half is the JAX module's, copied: the same trace, buffer
    view, kind names and switch, from the port's own code."""
    import datok_tpu.runtime.debug as JD

    assert D.oracle_trace is not JD.oracle_trace
    for doc, entry in ((DOC, 1), ("Mann.\x04z.B. 3.", 1 | (1 << 28))):
        assert D.oracle_trace(tok, doc, entry) == JD.oracle_trace(
            jax_twin(tok), doc, entry)
    for b, c in ((4, 8), (0, 0), (20, 3)):
        assert D.show_buffer(DOC + "\x04\n", b, c) == JD.show_buffer(
            DOC + "\x04\n", b, c)
    assert D._KIND == JD._KIND
    for value in ("", "1"):
        monkeypatch.setenv("DATOK_DEBUG_DIVERGENCE", value)
        assert D.divergence_debug_enabled() == JD.divergence_debug_enabled()
    s = D.show_buffer("Der alte Mann ging heim.", 4, 8)
    assert s.index("⟦") < s.index("∣")


def test_pipeline_reports_bad_lanes(tok, monkeypatch, capsys):
    """With ``DATOK_DEBUG_DIVERGENCE`` set, the overlapped pipeline
    reports each ``bad`` lane before repairing it; output stays exact."""
    monkeypatch.setenv("DATOK_DEBUG_DIVERGENCE", "1")
    eng = dtt.BatchEngine(tok, device="cpu", steps_factor=0.1)
    text = "\x04".join(synth_text(tok, 4, 200, seed=11))
    st = {}
    out = dtt.tokenize_stream_pipelined(tok, text, engine=eng, lanes=4,
                                        pack_len=0, stats=st).getvalue()
    assert out == tok.tokenize(text)
    err = capsys.readouterr().err
    assert st["repairs"] > 0
    assert err.count("=== device↔oracle divergence ===") == st["repairs"]
    assert err.count("lane flagged bad: True") == st["repairs"]
