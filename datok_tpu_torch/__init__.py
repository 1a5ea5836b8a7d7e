"""datok_tpu_torch — the PyTorch / CUDA port of datok_tpu.

The batched transduce path of :mod:`datok_tpu` on an NVIDIA H100: the
device machine is K1, a CUDA kernel written for Hopper
(``csrc/transduce.cu``), beside a plain PyTorch version of the same
machine that runs on the CPU.  The package keeps its own copies of the
host layers of :mod:`datok_tpu` (model formats, encoder, oracle,
events, writer and the native host library); it imports neither jax
nor anything of :mod:`datok_tpu`.  Entry points run on ``"cuda"``
unless the caller names another device.

    from datok_tpu_torch import load_tokenizer_file, BatchEngine
    tok = load_tokenizer_file("tokenizer_de.matok")
    eng = BatchEngine(tok)                       # K1 on the card
    eng = BatchEngine(load_datok_file("tokenizer_de.datok"),
                      engine="general")          # K1 over base/check
    eng = BatchEngine(tok, hot_size="auto")      # each wave its own hot set
    eng = BatchEngine(tok, engine="hot")         # K1 with a profiled hot set
    eng = AdaptiveEngine(tok, hot_size=128)      # narrow or wide set a batch
    eng = ShardedEngine(tok)                     # lanes over every card
    outs = eng.tokenize_batch(["Der alte Mann.", "..."])
    out = tokenize_stream(tok, stream_text, engine=eng).getvalue()
    out = tokenize_stream_pipelined(tok, stream_text, engine=eng).getvalue()
    CorpusRunner(tok, "out/", engine=eng).run(["a.txt", "b.txt"])
    run_corpus_distributed(tok, files, "out/")  # one shard of files a rank

The same commands as ``datok-tpu``: ``python -m datok_tpu_torch.cli``
(``tokenize``, ``corpus``, ``convert``; ``--device cuda`` by default).
"""

from .fsa.automaton import Automaton
from .fsa.double_array import DaTokenizer, load_datok_file, parse_datok
from .fsa.foma import load_foma_file, parse_foma
from .fsa.io import load_tokenizer_file
from .fsa.matrix import MatrixTokenizer, load_matrix_file, parse_matrix
from .parallel.distributed import run_corpus_distributed
from .parallel.mesh import ShardedEngine
from .runtime.adaptive import AdaptiveEngine
from .runtime.corpus import CorpusRunner
from .runtime.engine import BatchEngine
from .runtime.events import (EV_SENT, EV_TEXT, EV_TOKEN,
                             format_events, replay_events)
from .runtime.oracle import transduce, transduce_reader
from .runtime.overlap import (events_pipelined, tokenize_stream_pipelined,
                              waves_pipelined)
from .runtime.pipeline import tokenize_reader, tokenize_stream
from .runtime.writer import (NEWLINE_AFTER_EOT, SENTENCE_POS,
                             SENTENCES, SIMPLE, TOKEN_POS, TOKENS,
                             TokenWriter)
from .utils.native import NativeWriter, native_transduce_events

__all__ = [
    "Automaton",
    "load_foma_file",
    "parse_foma",
    "parse_matrix",
    "parse_datok",
    "AdaptiveEngine",
    "BatchEngine",
    "CorpusRunner",
    "DaTokenizer",
    "MatrixTokenizer",
    "NativeWriter",
    "ShardedEngine",
    "load_datok_file",
    "load_matrix_file",
    "load_tokenizer_file",
    "native_transduce_events",
    "TokenWriter",
    "TOKENS",
    "SENTENCES",
    "TOKEN_POS",
    "SENTENCE_POS",
    "NEWLINE_AFTER_EOT",
    "SIMPLE",
    "transduce",
    "transduce_reader",
    "tokenize_stream",
    "tokenize_reader",
    "tokenize_stream_pipelined",
    "events_pipelined",
    "waves_pipelined",
    "run_corpus_distributed",
    "EV_TOKEN",
    "EV_SENT",
    "EV_TEXT",
    "format_events",
    "replay_events",
]
