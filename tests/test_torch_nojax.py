"""The port never imports jax: a fresh interpreter imports
``datok_tpu_torch`` with its stream, overlap, corpus, CLI, debug and
probe modules, tokenizes a wave and a stream (serial and overlapped) on
the CPU and finds no jax module loaded."""

import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

SCRIPT = """
import sys
import datok_tpu_torch as dtt
import datok_tpu_torch.bench_micro.micro_ablate
import datok_tpu_torch.bench_micro.micro_fused
import datok_tpu_torch.bench_micro.micro_pallas
import datok_tpu_torch.cli
import datok_tpu_torch.runtime.corpus
import datok_tpu_torch.runtime.debug
import datok_tpu_torch.runtime.overlap
import datok_tpu_torch.runtime.pipeline
from datok_tpu_torch.testing.synth import synth_text, synth_tokenizer
tok = synth_tokenizer(40, 2)
texts = synth_text(tok, 8, 120, seed=2) + ["", "Mann.\\x04Frau."]
eng = dtt.BatchEngine(tok, device="cpu")
out = eng.tokenize_batch(texts)
assert out == [tok.tokenize(t) for t in texts]
stream = "\\x04".join(texts)
assert dtt.tokenize_stream(tok, stream, engine=eng).getvalue() == tok.tokenize(stream)
got = dtt.tokenize_stream_pipelined(tok, stream, engine=eng, lanes=4)
assert got.getvalue() == tok.tokenize(stream)
assert datok_tpu_torch.runtime.debug.dump_divergence(eng, texts[0]) is None
loaded = sorted(m for m in sys.modules if m == "jax" or m.startswith("jax."))
assert not loaded, loaded
print("ok")
"""


def test_port_imports_no_jax():
    r = subprocess.run([sys.executable, "-c", SCRIPT], cwd=ROOT,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stderr
    assert r.stdout.strip() == "ok"
