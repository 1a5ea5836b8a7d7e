"""The port's benchmark (``datok_tpu_torch.bench``) on the CPU, small.

Its workloads are held to the JAX package's originals (``bench.py``,
read from its source, and the probes ``bench_micro/probe_hetero_mixed.py``
and ``probe_novel.py``), each workload's lanes on the port's CPU engine
to the JAX engine (general machine, JAX CPU backend) and the native
oracle, exactly; one run of ``main`` at B=16 x L=128 on a small model
gives a line with every key, and a lane, a stream or a launch that goes
wrong ends the run with no line.  On the CPU the wrappers count no K1
launch, so the plain machine's runs are counted in their place.
"""

import ast
import contextlib
import importlib.util
import io
import json
import multiprocessing
import os

import pytest
import torch

import datok_tpu_torch.bench as bench
from datok_tpu.runtime.jax_engine import BatchEngine as JaxEngine
from datok_tpu_torch import BatchEngine
from datok_tpu_torch.kernels import transduce as kt
from datok_tpu_torch.runtime import engine as engine_mod
from datok_tpu_torch.testing.synth import synth_datok, synth_text, synth_tokenizer
from torch_twins import jax_twin

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
B, L, SEED = 16, 128, 2
ARGS = ["--device", "cpu", "--lanes", str(B), "--len", str(L), "--reps", "1",
        "--e2e-mb", "0.004"]
# every key the line prints at its top
KEYS = ("metric", "value", "unit", "uniform_wave_mbps", "wave_rung_h",
        "device_time_mbps", "hetero_mbps", "hetero_wave_mbps", "mixed_mbps",
        "mixed_wave_mbps", "mixed_pipeline", "novel_mbps", "en_mbps",
        "en_skipped", "datok_mbps", "datok_general_mbps", "e2e_mbps",
        "pipelined_mbps", "pipelined_stage_mbps", "stream_mbps",
        "corpus_mbps", "sharded", "host_scaling", "card", "torch", "cuda",
        "cores", "k1_launches", "model", "states")


@pytest.fixture(scope="module")
def tok():
    return synth_tokenizer(40, SEED)


@pytest.fixture(scope="module")
def da():
    return synth_datok(40, SEED)


def _bench_py():
    """The JAX package's ``bench.py``, parsed, not imported (importing it
    sets a compile-cache directory in the environment)."""
    with open(os.path.join(ROOT, "bench.py"), encoding="utf-8") as f:
        return ast.parse(f.read())


def _bench_py_value(name, **env):
    """The value ``bench.py`` gives ``name``: a module constant, or an
    assignment in its ``main`` evaluated with ``env`` and its constants."""
    tree = _bench_py()
    consts = {t.id: ast.literal_eval(n.value) for n in tree.body
              if isinstance(n, ast.Assign) for t in n.targets
              if isinstance(t, ast.Name) and t.id.startswith("BENCH_TEXT")}
    if name in consts:
        return consts[name]
    main = next(n for n in tree.body
                if isinstance(n, ast.FunctionDef) and n.name == "main")
    node = next(n for n in ast.walk(main) if isinstance(n, ast.Assign)
                and any(isinstance(t, ast.Name) and t.id == name
                        for t in n.targets))
    code = compile(ast.Expression(node.value), "bench.py", "eval")
    return eval(code, {**consts, **env})


def _probe(name, monkeypatch):
    """A JAX probe script loaded by path, from the repository root (its
    ``hetero_texts`` reads the scenarios from the working directory)."""
    monkeypatch.chdir(ROOT)
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    path = os.path.join(ROOT, "bench_micro", f"{name}.py")
    spec = importlib.util.spec_from_file_location(f"_jax_probe_{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("L", [L, 1024])
@pytest.mark.parametrize("workload", ["texts", "doc", "doc_en", "hetero",
                                      "mixed", "novel"])
def test_workloads_equal_the_jax_originals(monkeypatch, tmp_path, workload, L):
    doc = _bench_py_value("doc", L=L)
    if workload == "texts":
        assert bench.BENCH_TEXT == _bench_py_value("BENCH_TEXT")
        assert bench.BENCH_TEXT_EN == _bench_py_value("BENCH_TEXT_EN")
    elif workload == "doc":
        assert bench.bench_doc(L) == doc and len(doc) == L
    elif workload == "doc_en":
        assert bench.bench_doc(L, bench.BENCH_TEXT_EN) == _bench_py_value(
            "doc_en", L=L)
    elif workload == "hetero":
        assert bench.rotated_texts(doc, B, L) == _bench_py_value(
            "het", L=L, B=B, doc=doc)
    elif workload == "mixed":
        want = _probe("probe_hetero_mixed", monkeypatch).hetero_texts(B, L)
        monkeypatch.chdir(tmp_path)  # read from the repository, not the cwd
        assert bench.mixed_texts(B, L) == want
    else:
        want = _probe("probe_novel", monkeypatch).novel_texts(B, L)
        assert bench.novel_texts(B, L) == want


def test_mixed_texts_raise_without_the_scenarios(monkeypatch, tmp_path):
    monkeypatch.setattr(bench, "SCENARIOS", str(tmp_path / "none.json"))
    with pytest.raises(FileNotFoundError):
        bench.mixed_texts(B, L)


def test_corpus_texts_are_smoke_phase_9s(tok):
    """64 files are the smoke's phase-9 cut: file 7 empty, four cut
    mid-word; fewer files keep what exists of that."""
    docs = bench.wave_texts(tok, 640, 64, synth_text)
    texts = bench.corpus_texts(docs, 64)
    assert len(texts) == 64 and texts[7] == ""
    for i in (13, 29, 41, 58):
        assert not texts[i].endswith("\x04\n") and texts[i][-1].isalpha()
    assert texts[0] == "".join(t + "\x04\n" for t in docs[:10])
    few = bench.corpus_texts(docs, 4)
    assert few[3] == "" and few[0] == "".join(t + "\x04\n" for t in docs[:160])


def _rows_texts(tok, name):
    doc = bench.bench_doc(L)
    return {
        "uniform": [doc] * B,
        "hetero": bench.rotated_texts(doc, B, L),
        "mixed": sorted(bench.mixed_texts(B, L), key=len),
        "novel": bench.novel_texts(B, L),
        "en": [bench.bench_doc(L, bench.BENCH_TEXT_EN)] * B,
        "e2e": bench.wave_texts(tok, B, L, synth_text),
        "corpus": bench.corpus_texts(bench.wave_texts(tok, 2 * B, L, synth_text),
                                     8),
    }[name]


@pytest.fixture(scope="module")
def engines(tok, da):
    """(the port's CPU engine, the JAX engine, the oracle's engine) of
    each kind: the matrix model and the double array on its general
    form, whose oracle walks the same model's matrix."""
    matrix = BatchEngine(tok, device="cpu")
    return {
        "matok": (matrix, JaxEngine(jax_twin(tok), engine="general"), matrix),
        "datok_general": (BatchEngine(da, device="cpu", engine="general"),
                          JaxEngine(jax_twin(da), engine="general"),
                          BatchEngine(da, device="cpu")),
    }


@pytest.mark.parametrize("kind", ["matok", "datok_general"])
@pytest.mark.parametrize("name", ["uniform", "hetero", "mixed", "novel", "en",
                                  "e2e", "corpus"])
def test_row_lanes_equal_jax_engine_and_oracle(tok, engines, name, kind):
    """Each row's lanes on the port's CPU engine give the JAX engine's
    events and the native oracle's (the benchmark's own guard, which
    raises on a difference), on a matrix and on a double array."""
    eng, jax_eng, oracle = engines[kind]
    texts = _rows_texts(tok, name)
    assert eng.events_batch(texts) == jax_eng.events_batch(texts)
    bench.check_events(name, oracle, texts, eng.events_batch(texts, as_arrays=True))


@contextlib.contextmanager
def _counted(mp):
    """The plain machine's runs counted as the wrappers count K1's
    launches on the card."""
    for name in ("transduce", "transduce_general"):
        real = getattr(kt, name)

        def counting(*args, _real=real, **kw):
            res = _real(*args, **kw)
            _real.launches += 1
            return res

        mp.setattr(engine_mod, name, counting)
        mp.setattr(real, "launches", 0)
    yield


def _small(mp, tok, da):
    """The benchmark at the test's size: the small models, a short
    stream, eight corpus files, host stages at 1 and 2 workers."""
    mp.setattr(bench, "synth_tokenizer", lambda seed=0: tok)
    mp.setattr(bench, "synth_datok", lambda n, seed=0: da)
    mp.setattr(bench, "STREAM_DOCS", (12, 64, 256))
    mp.setattr(bench, "STREAM_LONG", (1, 2000, 3000))
    mp.setattr(bench, "STREAM_POOL", (4, 4096))
    mp.setattr(bench, "CORPUS_FILES", 8)
    mp.setattr(bench, "HOST_WIDTHS", (1, 2))
    mp.setenv("BENCH_HOST_REPS", "2")
    for var in ("DATOK_DE_MODEL", "DATOK_EN_MODEL", "BENCH_FAST"):
        mp.delenv(var, raising=False)


def _main(argv):
    """``bench.main(argv)``: (its stdout, its return code)."""
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = bench.main(argv)
    return out.getvalue(), rc


@pytest.fixture(scope="module")
def run(tok, da):
    """One whole run of ``main`` on the CPU, with the start methods the
    host stages asked of ``multiprocessing``."""
    methods = []
    real = multiprocessing.get_context

    def get_context(method=None):
        methods.append(method)
        return real(method)

    with pytest.MonkeyPatch.context() as mp:
        _small(mp, tok, da)
        mp.setattr(multiprocessing, "get_context", get_context)
        mp.setattr(os, "fork", None)
        with _counted(mp):
            out, rc = _main(ARGS)
    return out, rc, methods


def test_main_prints_one_line_with_every_key(run):
    out, rc, _ = run
    assert rc == 0
    lines = out.splitlines()
    assert len(lines) == 1
    line = json.loads(lines[0])
    missing = [k for k in KEYS if k not in line]
    assert not missing
    assert line["metric"] == "tokenize_de_matrix_throughput"
    assert line["unit"] == "MB/s/card" and line["value"] > 0
    assert line["model"] == "synth_de" and line["card"] is None
    assert line["en_mbps"] is None and "DATOK_EN_MODEL" in line["en_skipped"]
    assert line["device_time_mbps"] is None  # no device timeline here
    assert set(line["pipelined_stage_mbps"]) == {
        "encode", "dispatch", "fetch", "decode", "format"}
    assert line["sharded"]["shards"] == ["cpu", "cpu"]
    # B documents, each ending at EOT, and the empty one after the last
    assert line["mixed_pipeline"]["docs"] == B + 1


def test_every_row_correct_with_its_own_launches(run):
    line = json.loads(run[0])
    rows = [r for r in bench.ROWS if r != "en"]
    assert sorted(line["rows"]) == sorted(rows)
    assert sorted(line["k1_launches"]) == sorted(rows)
    for name in rows:
        row = line["rows"][name]
        assert row["correct"] is True, name
        assert row["bad_lanes"] == 0, name
        assert "spread" in row, name
        assert row["k1_launches"] == line["k1_launches"][name] >= 1, name
    for name in ("uniform", "hetero", "e2e", "pipelined", "stream", "corpus"):
        lo, hi = line["rows"][name]["spread"]
        assert lo <= line["rows"][name]["mbps"] <= hi


def test_host_scaling_spawns(run):
    """The process A/B starts its workers with ``spawn`` (the parent
    holds CUDA and threads), never ``fork``."""
    line = json.loads(run[0])
    hs = line["host_scaling"]
    assert run[2] and set(run[2]) == {"spawn"}
    assert hs["start_method"] == "spawn" and hs["workers"] == [1, 2]
    for stage in ("encode", "decode", "format"):
        for w in ("1", "2"):
            med, lo, hi = hs[stage][w]
            assert lo <= med <= hi
    assert set(hs["encode_procs"]) == set(hs["decode_procs"]) == {"2"}
    assert hs["cores"] == os.cpu_count() and hs["host_workers"] >= 1


@pytest.mark.parametrize("fault", ["lane", "stream", "no_launch"])
def test_a_failing_row_ends_the_run_without_a_line(monkeypatch, tok, da, fault):
    """A lane that differs from the oracle, a stream that differs, or a
    row that launched no K1 raises out of ``main``; nothing is printed."""
    _small(monkeypatch, tok, da)
    argv = ARGS + ["--fast"]
    if fault == "lane":
        real = BatchEngine.run_raw_device

        def corrupt(self, *args, **kw):
            out = real(self, *args, **kw)
            out[0][3, 0] ^= 1 << 2  # lane 3's first event starts elsewhere
            return out

        monkeypatch.setattr(BatchEngine, "run_raw_device", corrupt)
        match = "lane 3 differs from the native oracle"
    elif fault == "stream":
        real = bench.tokenize_stream_pipelined

        def corrupt(*args, **kw):
            w = real(*args, **kw)
            return type("W", (), {"getvalue": lambda _: w.getvalue()[1:]})()

        monkeypatch.setattr(bench, "tokenize_stream_pipelined", corrupt)
        monkeypatch.setattr(bench, "FAST_ROWS", ("pipelined",))
        match = "pipelined: output differs"
    else:
        argv = ARGS + ["--fast"]
        match = "launched 0 times"
    out = io.StringIO()
    with contextlib.ExitStack() as stack:
        if fault != "no_launch":
            stack.enter_context(_counted(monkeypatch))
        with pytest.raises(RuntimeError, match=match):
            with contextlib.redirect_stdout(out):
                bench.main(argv)
    assert out.getvalue() == ""


def test_without_a_card_main_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    out = io.StringIO()
    with pytest.raises(RuntimeError, match="no card"):
        with contextlib.redirect_stdout(out):
            bench.main([])
    assert out.getvalue() == ""


def test_fast_runs_the_fast_rows(monkeypatch, tok, da):
    _small(monkeypatch, tok, da)
    monkeypatch.setenv("BENCH_FAST", "1")
    with _counted(monkeypatch):
        out, rc = _main(ARGS[:-2])
    line = json.loads(out)
    assert rc == 0 and sorted(line["rows"]) == sorted(bench.FAST_ROWS)
    assert "mixed_mbps" not in line and line["hetero_wave_mbps"] > 0


def test_run_raw_device_rows_stage_tensors(monkeypatch, tok):
    """The raw rows hand ``run_raw_device`` tensors already on the
    engine's device, so the timed call copies nothing from the host."""
    seen = []
    real = BatchEngine.run_raw_device

    def spy(self, *args, **kw):
        seen.append([isinstance(a, torch.Tensor) for a in args])
        return real(self, *args, **kw)

    monkeypatch.setattr(BatchEngine, "run_raw_device", spy)
    with _counted(monkeypatch):
        b = bench.Bench("cpu", B, L, reps=2, tok=tok)
        line = b.run(["uniform"])
    assert seen and all(s == [True] * 4 for s in seen)
    assert line["k1_launches"]["uniform"] == 4  # two warm-ups, two runs
