"""Corpus-scale processing with a resumable shard manifest.

Counterpart of datok_tpu/runtime/corpus.py: a run writes a JSON
manifest recording per-file completion (with output checksums), so an
interrupted run resumes where it stopped.  The manifest format, the
atomic save, the hashes, the resume logic, ``out_path`` and the
``pack_len="auto"`` rule are the JAX module's; every pending file runs
through this package's :func:`~datok_tpu_torch.runtime.overlap.waves_pipelined`.
Without ``engine=``, the runner's engine runs on ``device=`` (``"cuda"``
by default).
"""

from __future__ import annotations

import hashlib
import itertools
import json
import os
import tempfile
from typing import Sequence

import numpy as np

from ..utils.native import NativeWriter
from .events import replay_events
from .overlap import waves_pipelined
from .pipeline import _engine, split_stream
from .writer import SIMPLE, TokenWriter


def _sha(data: bytes) -> str:
    return hashlib.sha256(data).hexdigest()[:16]


class CorpusRunner:
    """Tokenize many input files to per-file outputs, resumably."""

    def __init__(self, tok, out_dir: str, flags: int = SIMPLE, engine=None,
                 manifest_name: str = "manifest.json", *, device=None):
        self.tok = tok
        self.engine = _engine(tok, engine, device)
        self.out_dir = out_dir
        self.flags = flags
        os.makedirs(out_dir, exist_ok=True)
        self.manifest_path = os.path.join(out_dir, manifest_name)
        self.manifest = self._load_manifest()

    def _load_manifest(self) -> dict:
        if os.path.exists(self.manifest_path):
            with open(self.manifest_path, encoding="utf-8") as f:
                return json.load(f)
        return {"flags": self.flags, "files": {}}

    def _save_manifest(self) -> None:
        # atomic write so a crash never corrupts resume state
        fd, tmp = tempfile.mkstemp(dir=self.out_dir, suffix=".manifest")
        with os.fdopen(fd, "w", encoding="utf-8") as f:
            json.dump(self.manifest, f, indent=1)
        os.replace(tmp, self.manifest_path)

    def _done(self, path: str, src_hash: str) -> bool:
        ent = self.manifest["files"].get(path)
        return bool(ent) and ent.get("src") == src_hash and ent.get("ok")

    def _writer(self):
        """C++ TokenWriter when available (byte-identical); the Python
        one where the native library cannot be built."""
        try:
            return NativeWriter(self.flags)
        except RuntimeError:
            return TokenWriter(self.flags)

    def out_path(self, path: str) -> str:
        base = os.path.basename(path)
        return os.path.join(self.out_dir, base + ".tok")

    def run(self, files: Sequence[str], verbose: bool = False,
            stats: dict | None = None, pack_len="auto") -> dict:
        """Process files, skipping ones already completed.  Returns stats.

        All pending files flow through ONE overlapped pipeline
        (:func:`overlap.waves_pipelined`): documents from different
        files share waves, and each file's documents are tagged with
        the file index and start a fresh entry chain
        (``stream_start``), exactly as a per-file transduce would.
        Consecutive documents of one file are lane-packed (``pack_len``;
        see ``overlap._pack_items``).
        """
        skipped = 0
        # only (path, src_hash, n_bytes) is held for the whole corpus;
        # file contents are read and decoded lazily inside items() one
        # file at a time, so corpus size never bounds resident memory
        pending = []
        for path in files:
            with open(path, "rb") as f:
                data = f.read()
            src_hash = _sha(data)
            if self._done(path, src_hash):
                skipped += 1
                continue
            pending.append((path, src_hash, len(data)))
            del data

        def items():
            for fi, (path, _h, _n) in enumerate(pending):
                with open(path, "rb") as f:
                    text = f.read().decode("utf-8", errors="replace")
                for j, d in enumerate(split_stream(self.engine.tok, text)):
                    yield (fi, d, j == 0)

        if pack_len == "auto":
            # lane packing only helps corpora of TINY documents
            # (datok_tpu/runtime/corpus.py:116-122); decide from the
            # first documents' median length
            it = items()
            head = list(itertools.islice(it, 512))
            lens = sorted(len(d) for _, d, _ in head)
            med = lens[len(lens) // 2] if lens else 0
            pack_len = 1024 if med < 256 else 0
            if stats is not None:
                stats["pack_len"] = pack_len
                stats["median_doc_len"] = med
            items_it = itertools.chain(head, it)
        else:
            items_it = items()

        state = {"fi": -1, "w": None, "done": 0, "out": 0}

        def finish():
            fi, w = state["fi"], state["w"]
            if fi < 0:
                return
            w.flush()
            out = w.getvalue().encode("utf-8")
            path, src_hash, n_in = pending[fi]
            with open(self.out_path(path), "wb") as f:
                f.write(out)
            self.manifest["files"][path] = {
                "src": src_hash,
                "out": _sha(out),
                "bytes_in": n_in,
                "bytes_out": len(out),
                "ok": True,
            }
            self._save_manifest()
            if verbose:
                print(f"done {path} ({n_in} -> {len(out)} bytes)")
            state["fi"], state["w"] = -1, None
            state["done"] += 1
            state["out"] += len(out)

        for wave in waves_pipelined(self.engine, items_it, stats=stats,
                                    pack_len=pack_len):
            offs = np.zeros(len(wave.counts) + 1, dtype=np.int64)
            np.cumsum(wave.counts, out=offs[1:])
            k = 0
            while k < len(wave.docs):
                fi = wave.tags[k]
                k2 = k
                while k2 < len(wave.docs) and wave.tags[k2] == fi:
                    k2 += 1
                if fi != state["fi"]:
                    finish()
                    state["fi"], state["w"] = fi, self._writer()
                w = state["w"]
                feed_wave = getattr(w, "feed_wave", None)
                if feed_wave is not None:
                    feed_wave(
                        wave.tri[offs[k] : offs[k2]],
                        wave.counts[k:k2],
                        wave.cps_flat,
                        wave.cps_offs[k:k2],
                        wave.cps_lens[k:k2],
                    )
                else:
                    for j in range(k, k2):
                        replay_events(
                            [tuple(r) for r in
                             wave.tri[offs[j] : offs[j + 1]].tolist()],
                            wave.docs[j], w,
                        )
                k = k2
        finish()
        return {
            "done": state["done"],
            "skipped": skipped,
            "total": len(files),
            "bytes_in": sum(p[2] for p in pending),
            "bytes_out": state["out"],
        }
