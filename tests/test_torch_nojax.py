"""The port never imports jax, nor anything of ``datok_tpu``: a fresh
interpreter imports ``datok_tpu_torch`` with its stream, overlap,
corpus, CLI, debug, hot-set, probe, parallel and benchmark modules,
tokenizes a wave (on one device and over two shards) and a stream
(serial and overlapped) on the CPU and finds no jax module and no
``datok_tpu`` module loaded; and no source file of the port, nor
``chip_smoke.py``, holds an import of ``datok_tpu``."""

import ast
import glob
import os
import subprocess
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

SCRIPT = """
import sys
import datok_tpu_torch as dtt
import datok_tpu_torch.bench
import datok_tpu_torch.bench_micro.micro_ablate
import datok_tpu_torch.bench_micro.micro_fused
import datok_tpu_torch.bench_micro.micro_pallas
import datok_tpu_torch.cli
import datok_tpu_torch.parallel.distributed
import datok_tpu_torch.parallel.mesh
import datok_tpu_torch.runtime.corpus
import datok_tpu_torch.runtime.debug
import datok_tpu_torch.runtime.hot
import datok_tpu_torch.runtime.overlap
import datok_tpu_torch.runtime.pipeline
from datok_tpu_torch.testing.synth import synth_text, synth_tokenizer
tok = synth_tokenizer(40, 2)
texts = synth_text(tok, 8, 120, seed=2) + ["", "Mann.\\x04Frau."]
eng = dtt.BatchEngine(tok, device="cpu")
out = eng.tokenize_batch(texts)
assert out == [tok.tokenize(t) for t in texts]
assert dtt.ShardedEngine(tok, devices=["cpu"] * 2).tokenize_batch(texts) == out
stream = "\\x04".join(texts)
assert dtt.tokenize_stream(tok, stream, engine=eng).getvalue() == tok.tokenize(stream)
got = dtt.tokenize_stream_pipelined(tok, stream, engine=eng, lanes=4)
assert got.getvalue() == tok.tokenize(stream)
assert datok_tpu_torch.runtime.debug.dump_divergence(eng, texts[0]) is None
loaded = sorted(m for m in sys.modules if m == "jax" or m.startswith("jax."))
assert not loaded, loaded
jax_pkg = sorted(m for m in sys.modules
                 if m == "datok_tpu" or m.startswith("datok_tpu."))
assert not jax_pkg, jax_pkg
print("ok")
"""


def test_port_imports_no_jax():
    r = subprocess.run([sys.executable, "-c", SCRIPT], cwd=ROOT,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stderr
    assert r.stdout.strip() == "ok"


def _jax_package_imports(path):
    """Every ``import datok_tpu...`` and ``from datok_tpu... import`` in
    the file at ``path`` (relative imports stay inside the port)."""
    with open(path, encoding="utf-8") as f:
        tree = ast.parse(f.read(), filename=path)
    found = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names = [node.module or ""]
        else:
            continue
        found += [(node.lineno, n) for n in names
                  if n == "datok_tpu" or n.startswith("datok_tpu.")]
    return found


SOURCES = sorted(
    os.path.relpath(p, ROOT)
    for p in glob.glob(os.path.join(ROOT, "datok_tpu_torch", "**", "*.py"),
                       recursive=True)
) + ["chip_smoke.py"]


@pytest.mark.parametrize("path", SOURCES)
def test_no_source_imports_the_jax_package(path):
    assert _jax_package_imports(os.path.join(ROOT, path)) == []


def test_import_check_finds_jax_package_imports(tmp_path):
    """The static check sees both forms, at any depth, and lets the
    port's own imports through."""
    f = tmp_path / "m.py"
    f.write_text("import datok_tpu_torch.cli\nfrom . import x\n"
                 "from datok_tpu_torch.fsa import io\n"
                 "def g():\n    import datok_tpu.cli as c\n"
                 "    from datok_tpu.fsa.io import EOT\n"
                 "    import datok_tpu\n")
    assert _jax_package_imports(str(f)) == [
        (5, "datok_tpu.cli"), (6, "datok_tpu.fsa.io"), (7, "datok_tpu")]
