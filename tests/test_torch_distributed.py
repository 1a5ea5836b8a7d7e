"""The port's multi-process corpus runs (``datok_tpu_torch.parallel
.distributed``): in one process against the JAX module and the oracle,
and in two real processes joined over gloo on localhost against a
single-process ``CorpusRunner``; counterparts of the distribution tests
of tests/test_parallel.py and of tests/test_distributed_real.py.

Outputs are integers and bytes, so every comparison is exact.  The
two-process test writes only under its ``tmp_path``.
"""

import json
import os
import socket
import subprocess
import sys

import pytest
import torch

import datok_tpu.parallel.distributed as jax_dist
import datok_tpu_torch as dtt
from datok_tpu_torch.parallel import distributed as dist
from datok_tpu_torch.testing.synth import synth_text, synth_tokenizer

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
N_ABBREV, SEED = 120, 13
WORKER_TIMEOUT_S = 240

# One rank of the two-process run: joins the group from the variables
# the test sets, runs the corpus twice (fresh, then resume) and writes
# its reduced counters and the gathered device grid to a JSON file.
WORKER = r"""
import json, os, sys
import torch.distributed
from datok_tpu_torch import load_tokenizer_file
from datok_tpu_torch.parallel import distributed as dist
model, corpus, out_dir, result = sys.argv[1:5]
assert dist.initialize() and dist.get_world_size() == 2
tok = load_tokenizer_file(model)
files = sorted(os.path.join(corpus, f) for f in os.listdir(corpus))
fresh = dist.run_corpus_distributed(tok, files, out_dir, device="cpu")
resume = dist.run_corpus_distributed(tok, files, out_dir, device="cpu")
mesh = dist.global_mesh(["cpu"] * 2)
with open(result, "w", encoding="utf-8") as f:
    json.dump({"rank": dist.get_rank(), "fresh": fresh, "resume": resume,
               "mesh": [[str(d) for d in row] for row in mesh]}, f)
torch.distributed.destroy_process_group()
"""


@pytest.fixture(scope="module")
def tok():
    return synth_tokenizer(N_ABBREV, SEED)


@pytest.fixture
def no_group_env(monkeypatch):
    for k in ("WORLD_SIZE", "RANK", "MASTER_ADDR", "MASTER_PORT",
              "LOCAL_RANK"):
        monkeypatch.delenv(k, raising=False)


def _corpus(tok, d, n=7):
    """``n`` files of synthetic text of unequal sizes (one empty, one
    ending mid-text without EOT) under ``d``; their sorted paths."""
    d.mkdir()
    docs = synth_text(tok, n, [37 * (i + 1) ** 2 for i in range(n)],
                      seed=SEED)
    docs[2] = ""
    for i, t in enumerate(docs):
        (d / f"doc{i}.txt").write_text(t + "\x04\n" * (i % 2), encoding="utf-8")
    return sorted(str(p) for p in d.iterdir())


@pytest.mark.parametrize("pc", [1, 2, 3, 8, 23, 40])
def test_process_shard_matches_jax(pc):
    for n in (0, 1, 5, 23):
        items = [f"f{i}" for i in range(n)]
        shards = [dist.process_shard(items, pi, pc) for pi in range(pc)]
        assert shards == [jax_dist.process_shard(items, pi, pc)
                          for pi in range(pc)]
        assert [x for s in shards for x in s] == items  # exact cover
        sizes = [len(s) for s in shards]
        assert max(sizes) - min(sizes) <= 1  # balanced


def test_single_process_defaults(no_group_env):
    assert dist.initialize() is False  # no WORLD_SIZE: nothing to join
    assert dist.initialize(world_size=1) is False
    assert not torch.distributed.is_initialized()
    assert (dist.get_rank(), dist.get_world_size()) == (0, 1)
    assert dist.process_shard(["a", "b"]) == ["a", "b"]
    c = {"tokens": 5, "bytes": 123}
    assert dist.allreduce_counters(c) == c
    assert dist.global_mesh(["cpu"] * 4) == [[torch.device("cpu")] * 4]


def test_local_devices_need_a_card(no_group_env, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="is_available"):
        dist.local_devices()
    with pytest.raises(RuntimeError, match="is_available"):
        dist.global_mesh()


@pytest.mark.parametrize("local_rank, rank, want", [
    (None, 0, 0), ("2", 0, 2), ("5", 1, 1), (None, 3, 3), (None, 6, 2)])
def test_default_device_is_the_rank_card(no_group_env, monkeypatch, tok,
                                         local_rank, rank, want):
    """With neither engine nor device, each rank of a run over four
    cards takes its own card (``LOCAL_RANK``, else its rank, modulo the
    count), never ``cuda:0`` in every rank."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 4)
    monkeypatch.setattr(dist, "get_rank", lambda: rank)
    monkeypatch.setattr(dist, "get_world_size", lambda: 8)
    monkeypatch.setattr(dist, "allreduce_counters", dict)
    if local_rank is not None:
        monkeypatch.setenv("LOCAL_RANK", local_rank)
    assert dist.rank_device() == torch.device("cuda", want)
    seen = {}

    class Runner:
        def __init__(self, tok, out_dir, **kw):
            seen.update(kw)

        def run(self, files, verbose=False):
            return {"done": len(files)}

    monkeypatch.setattr(dist, "CorpusRunner", Runner)
    files = [f"f{i}" for i in range(8)]
    got = dist.run_corpus_distributed(tok, files, "unused")
    assert got == {"done": 1, "processes": 8}
    assert seen["device"] == torch.device("cuda", want)
    assert seen["manifest_name"] == f"manifest.p{rank}.json"
    dist.run_corpus_distributed(tok, files, "unused", engine=object())
    assert seen["device"] is None  # an engine given: no device is chosen


def test_default_device_needs_a_card(no_group_env, monkeypatch, tok):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="is_available"):
        dist.rank_device()
    with pytest.raises(RuntimeError, match="is_available"):
        dist.run_corpus_distributed(tok, [], "unused")


def test_run_corpus_distributed_single_process(tok, tmp_path, no_group_env):
    files = _corpus(tok, tmp_path / "corpus")
    out = tmp_path / "out"
    stats = dist.run_corpus_distributed(tok, files, str(out), device="cpu")
    assert (stats["done"], stats["skipped"], stats["processes"]) == (
        len(files), 0, 1)
    assert (out / "manifest.p0.json").exists()
    for f in files:
        with open(f, encoding="utf-8") as fh:
            want = tok.tokenize(fh.read())
        got = (out / (os.path.basename(f) + ".tok")).read_text(encoding="utf-8")
        assert got == want
    again = dist.run_corpus_distributed(tok, files, str(out), device="cpu")
    assert (again["done"], again["skipped"]) == (0, len(files))


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def test_two_processes_over_gloo(tok, tmp_path):
    files = _corpus(tok, tmp_path / "corpus")
    model = tmp_path / "synth.matok"
    tok.save(str(model))
    solo_dir = tmp_path / "solo"
    solo = dtt.CorpusRunner(tok, str(solo_dir), device="cpu").run(files)

    out_dir = tmp_path / "dist"
    env = {k: v for k, v in os.environ.items() if k != "LOCAL_RANK"}
    env.update(PYTHONPATH=ROOT, MASTER_ADDR="localhost",
               MASTER_PORT=str(_free_port()), WORLD_SIZE="2")
    results = [tmp_path / f"result.p{r}.json" for r in range(2)]
    logs = [tmp_path / f"rank{r}.err" for r in range(2)]
    procs = []
    try:
        for r, (res, log) in enumerate(zip(results, logs)):
            with open(log, "w", encoding="utf-8") as err:
                procs.append(subprocess.Popen(
                    [sys.executable, "-c", WORKER, str(model),
                     str(tmp_path / "corpus"), str(out_dir), str(res)],
                    env={**env, "RANK": str(r)}, cwd=str(tmp_path),
                    stdout=subprocess.DEVNULL, stderr=err))
        for p in procs:
            p.wait(timeout=WORKER_TIMEOUT_S)
    except subprocess.TimeoutExpired:
        pytest.fail("the two ranks did not finish in time")
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for p, log in zip(procs, logs):
        assert p.returncode == 0, log.read_text(encoding="utf-8")[-3000:]

    data = [json.loads(r.read_text(encoding="utf-8")) for r in results]
    assert [d["rank"] for d in data] == [0, 1]
    fresh = data[0]["fresh"]
    assert data[1]["fresh"] == fresh  # both hold the reduced counters
    assert fresh["processes"] == 2
    for key in ("done", "skipped", "total", "bytes_in", "bytes_out"):
        assert fresh[key] == solo[key], (key, fresh, solo)
    assert (fresh["done"], fresh["skipped"]) == (len(files), 0)
    for d in data:  # the resume skips every file, on both ranks
        assert (d["resume"]["done"], d["resume"]["skipped"]) == (0, len(files))
        assert d["mesh"] == [["cpu", "cpu"], ["cpu", "cpu"]]
    for f in files:
        base = os.path.basename(f) + ".tok"
        assert (out_dir / base).read_bytes() == (solo_dir / base).read_bytes()
    assert (out_dir / "manifest.p0.json").exists()
    assert (out_dir / "manifest.p1.json").exists()
    assert sorted(os.listdir(tmp_path)) == sorted(
        ["corpus", "synth.matok", "solo", "dist",
         *(r.name for r in results), *(g.name for g in logs)])
