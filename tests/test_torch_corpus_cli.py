"""The port's corpus runner and CLI on the CPU against the JAX package's
(``datok_tpu.runtime.corpus.CorpusRunner`` on the general engine,
``datok_tpu.cli.main``) and ``tok.tokenize``, on matrix, ``.datok`` and
no-EOT synthetic models.  Outputs are bytes: every comparison is exact.
"""

import gzip
import json
import os
import subprocess
import sys

import pytest
import torch

import datok_tpu.cli as jcli
from datok_tpu.runtime.corpus import CorpusRunner as JaxCorpusRunner
from datok_tpu.runtime.jax_engine import BatchEngine as JaxEngine
from datok_tpu_torch import cli
from datok_tpu_torch.runtime.corpus import CorpusRunner
from datok_tpu_torch.runtime.engine import BatchEngine
from datok_tpu_torch.testing.synth import synth_datok, synth_text, synth_tokenizer
from torch_twins import jax_twin

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
N_ABBREV, SEED = 200, 7
KINDS = ["matok", "datok", "noeot"]
# the corpus runner also on the .datok model with an engine="general"
# engine, which keeps the double array (the CLI's --no-accelerated runs
# it in the CLI tests)
RUNNER_KINDS = KINDS + ["datok_general"]
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
    engs = {k: BatchEngine(m, device="cpu", engine=ENGINE.get(k, "auto"))
            for k, m in models.items()}
    assert engs["datok_general"].tables.kind == "DATOK"
    return engs


@pytest.fixture(scope="module")
def jax_engines(models):
    return {k: JaxEngine(jax_twin(m), engine="general")
            for k, m in models.items()}


def _write(tmp_path, texts, prefix="in"):
    files = []
    for i, t in enumerate(texts):
        p = tmp_path / f"{prefix}{i}.txt"
        p.write_text(t, encoding="utf-8")
        files.append(str(p))
    return files


def _read(path):
    with open(path, encoding="utf-8") as f:
        return f.read()


def _out_hashes(out_dir):
    with open(os.path.join(out_dir, "manifest.json"), encoding="utf-8") as f:
        m = json.load(f)
    return {p: e["out"] for p, e in m["files"].items()}


@pytest.mark.parametrize("kind", RUNNER_KINDS)
def test_corpus_resume_matches_jax(models, engines, jax_engines, tmp_path,
                                   kind):
    """tests/test_corpus.py:7-36 on both runners: outputs, counts and the
    manifests' output hashes agree; resume skips finished files and a
    changed source runs again."""
    tok = models[kind]
    files = _write(tmp_path, [f"Text {i}. Der alte Mann!\x04Zweiter Satz {i}."
                              for i in range(3)])
    out, jout = str(tmp_path / "out"), str(tmp_path / "jout")

    def run_both():
        a = CorpusRunner(tok, out, engine=engines[kind]).run(files)
        b = JaxCorpusRunner(jax_engines[kind].tok, jout,
                        engine=jax_engines[kind]).run(files)
        assert a == b
        return a

    stats = run_both()
    assert (stats["done"], stats["skipped"], stats["total"]) == (3, 0, 3)
    assert stats["bytes_in"] > 0 and stats["bytes_out"] > 0
    r = CorpusRunner(tok, out, engine=engines[kind])
    for p in files:
        assert _read(r.out_path(p)) == tok.tokenize(_read(p))
    assert _out_hashes(out) == _out_hashes(jout)

    stats = run_both()
    assert (stats["done"], stats["skipped"], stats["total"]) == (0, 3, 3)

    with open(files[1], "w", encoding="utf-8") as f:
        f.write("Neu!")
    stats = run_both()
    assert (stats["done"], stats["skipped"], stats["total"]) == (1, 2, 3)
    assert _read(r.out_path(files[1])) == tok.tokenize("Neu!")
    assert _out_hashes(out) == _out_hashes(jout)
    assert len(_out_hashes(out)) == 3


@pytest.mark.parametrize("pack_len", ["auto", 0])
@pytest.mark.parametrize("kind", RUNNER_KINDS)
def test_corpus_shared_waves_fresh_chains(models, engines, jax_engines,
                                          tmp_path, kind, pack_len):
    """tests/test_corpus.py:65-108: files share waves, but each file's
    chain starts at the root; a file ending mid-word and an empty file
    leak nothing into the next one."""
    tok = models[kind]
    texts = [
        "Erste Datei endet mitten im Wort readme",
        "Zweite Datei. Noch ein Satz!\x04Und Text zwei.",
        "",
        "Abk. z.B. und mehr.\x04" * 7,
    ] + synth_text(tok, 2, [300, 500], seed=SEED + 1)
    files = _write(tmp_path, texts)
    st, jst = {}, {}
    out, jout = str(tmp_path / "out"), str(tmp_path / "jout")
    a = CorpusRunner(tok, out, engine=engines[kind]).run(
        files, stats=st, pack_len=pack_len)
    b = JaxCorpusRunner(jax_engines[kind].tok, jout,
                        engine=jax_engines[kind]).run(
        files, stats=jst, pack_len=pack_len)
    assert a == b and a["done"] == len(files)
    for k in ("docs", "waves", "repairs", "long_docs"):
        assert st[k] == jst[k], k
    if pack_len == "auto":
        assert st["pack_len"] == jst["pack_len"] == 1024
    r = CorpusRunner(tok, out, engine=engines[kind])
    for p, t in zip(files, texts):
        assert _read(r.out_path(p)) == tok.tokenize(t), p
    assert _out_hashes(out) == _out_hashes(jout)


def test_corpus_needs_engine_or_device(models, tmp_path, monkeypatch):
    """Naming neither asks for an engine on "cuda", which raises without
    a card, before the output directory is made."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="cuda"):
        CorpusRunner(models["matok"], str(tmp_path / "out"))
    assert not (tmp_path / "out").exists()


@pytest.fixture(scope="module")
def model_files(models, tmp_path_factory):
    d = tmp_path_factory.mktemp("models")
    paths = {}
    for kind, tok in models.items():
        paths[kind] = str(d / f"{kind}.{'datok' if kind == 'datok' else 'matok'}")
        tok.save(paths[kind])
    return paths


def _text(tok):
    return ("\x04\n".join(synth_text(tok, 6, [0, 40, 120, 300, 7, 90],
                                     seed=SEED + 2))
            + "\x04Schluss ohne EOT: „gut“ …")


FLAGS = [[], ["--no-tokens"], ["-p"], ["--sentence-positions"],
         ["--newline-after-eot"], ["--no-sentences", "-p"],
         ["-p", "--sentence-positions", "--newline-after-eot"]]


def _main(main, argv, capsys):
    capsys.readouterr()
    rc = main(argv)
    return rc, capsys.readouterr()


@pytest.mark.parametrize("batch", [False, True])
@pytest.mark.parametrize("flags", FLAGS, ids=lambda f: " ".join(f) or "default")
@pytest.mark.parametrize("kind", KINDS)
def test_cli_tokenize_matches_jax(models, model_files, tmp_path, capsys,
                                  kind, flags, batch):
    inp = tmp_path / "in.txt"
    inp.write_text(_text(models[kind]), encoding="utf-8")
    base = ["tokenize", "-t", model_files[kind], str(inp), *flags]
    extra = ["--batch", "--no-accelerated"] if batch else []
    rc, got = _main(cli.main, base + extra + ["--device", "cpu"], capsys)
    jrc, want = _main(jcli.main, base + extra, capsys)
    assert rc == jrc == 0
    assert got.out == want.out and got.out
    if not flags:
        assert got.out == models[kind].tokenize(inp.read_text(encoding="utf-8"))


@pytest.mark.parametrize("kind", KINDS)
def test_cli_corpus_matches_jax(models, model_files, tmp_path, capsys, kind):
    tok = models[kind]
    texts = [_text(tok), "Kurz.\x04", "", "ohne Ende"]
    files = _write(tmp_path, texts)
    out, jout = str(tmp_path / "out"), str(tmp_path / "jout")
    args = ["corpus", "-t", model_files[kind], *files, "-p"]
    rc, got = _main(cli.main, args + ["-o", out, "--device", "cpu"], capsys)
    jrc, want = _main(jcli.main, args + ["-o", jout], capsys)
    assert rc == jrc == 0
    lines, jlines = got.out.splitlines(), want.out.splitlines()
    assert len(lines) == len(jlines) == len(files) + 1
    assert lines[:-1] == jlines[:-1]  # "done PATH (n -> m bytes)"
    stats, jstats = json.loads(lines[-1]), json.loads(jlines[-1])
    pipe, jpipe = stats.pop("pipeline"), jstats.pop("pipeline")
    assert stats == jstats and stats["done"] == len(files)
    assert sorted(pipe) == sorted(jpipe)
    for k, v in jpipe.items():
        if not isinstance(v, float):
            assert pipe[k] == v, k
    for p in files:
        name = os.path.basename(p) + ".tok"
        assert _read(os.path.join(out, name)) == _read(os.path.join(jout, name))
    assert _out_hashes(out) == _out_hashes(jout)


def test_cli_malformed_files_exit_with_one_line(tmp_path, capsys):
    bad = tmp_path / "bad.matok"
    bad.write_bytes(b"not a gzip file at all")
    wrong = tmp_path / "wrong.matok"
    with gzip.open(wrong, "wb") as f:
        f.write(b"BOGUS data here")
    badfst = tmp_path / "bad.fst"
    with gzip.open(badfst, "wb") as f:
        f.write(b"##foma-net 1.0##\n##props##\nnot numbers\n")
    inp = tmp_path / "in.txt"
    inp.write_text("Der Mann.")
    cases = [
        ["tokenize", "-t", str(bad), str(inp)],
        ["tokenize", "-t", str(wrong), str(inp), "--batch", "--device", "cpu"],
        ["tokenize", "-t", str(tmp_path / "nope.matok"), str(inp)],
        ["corpus", "-t", str(bad), "-o", str(tmp_path / "o"), str(inp),
         "--device", "cpu"],
        ["convert", "-i", str(badfst), "-o", str(tmp_path / "o.matok")],
    ]
    for argv in cases:
        rc, res = _main(cli.main, argv, capsys)
        assert rc == 1, argv
        lines = res.err.splitlines()
        assert len(lines) == 1 and lines[0].startswith("datok-tpu-torch: error:"), argv
        assert res.out == ""


@pytest.mark.parametrize("cmd", ["tokenize", "corpus"])
def test_cli_cuda_without_card_fails_without_output(model_files, tmp_path,
                                                    capsys, cmd):
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    inp = tmp_path / "in.txt"
    inp.write_text("Der Mann.\x04")
    out = tmp_path / "out"
    if cmd == "tokenize":
        argv = ["tokenize", "-t", model_files["matok"], str(inp), "--batch",
                "--device", "cuda"]
    else:
        argv = ["corpus", "-t", model_files["matok"], "-o", str(out), str(inp),
                "--device", "cuda"]
    rc, res = _main(cli.main, argv, capsys)
    assert rc != 0
    assert res.out == "" and "cuda" in res.err
    assert not out.exists()


def test_cli_module_subprocess(models, model_files, tmp_path):
    """``python -m datok_tpu_torch.cli tokenize --batch`` in a fresh
    interpreter: stdout byte-equal to the oracle."""
    tok = models["matok"]
    inp = tmp_path / "in.txt"
    inp.write_text(_text(tok), encoding="utf-8")
    r = subprocess.run(
        [sys.executable, "-m", "datok_tpu_torch.cli", "tokenize", "-t",
         model_files["matok"], str(inp), "--batch", "--device", "cpu"],
        cwd=ROOT, capture_output=True, timeout=300)
    assert r.returncode == 0, r.stderr.decode()
    assert r.stdout.decode("utf-8") == tok.tokenize(inp.read_text(encoding="utf-8"))
