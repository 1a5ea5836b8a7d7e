"""Command-line interface of the PyTorch port.

Mirrors ``datok_tpu/cli.py`` (itself the reference CLI, cmd/datok.go):

    datok-tpu-torch convert -i FOMA -o TOKENIZER [-d]
    datok-tpu-torch tokenize -t TOKENIZER INPUT [--no-tokens] [--no-sentences]
        [-p|--token-positions] [--sentence-positions] [--newline-after-eot]
        [--batch] [--device DEVICE]
    datok-tpu-torch corpus -t TOKENIZER -o OUT_DIR FILES... [--device DEVICE]

``convert`` and the flag set are the JAX CLI's own (copied).
``tokenize`` runs the host oracle, and with ``--batch`` streams the
input through the port's batched engine (``tokenize_reader``);
``corpus`` runs the resumable :class:`CorpusRunner` on the overlapped
pipeline.  ``--device`` (default ``cuda``) takes the place of the JAX
package's implicit platform: ``cuda`` runs K1 and fails without a
card, ``cpu`` runs the plain machine.
"""

from __future__ import annotations

import argparse
import contextlib
import gzip
import json
import struct
import sys
import zlib

import torch

from .fsa.double_array import DaTokenizer
from .fsa.foma import load_foma_file
from .fsa.io import load_tokenizer_file
from .fsa.matrix import MatrixTokenizer
from .runtime.corpus import CorpusRunner
from .runtime.engine import BatchEngine
from .runtime.oracle import transduce_reader
from .runtime.pipeline import tokenize_reader
from .runtime.writer import (NEWLINE_AFTER_EOT, SENTENCE_POS, SENTENCES,
                             TOKEN_POS, TOKENS, TokenWriter)


def cmd_convert(args) -> int:
    auto = load_foma_file(args.foma)
    if args.double_array:
        dat = DaTokenizer.from_automaton(auto)
        print("Load factor", dat.load_factor())
        dat.save(args.tokenizer)
    else:
        mat = MatrixTokenizer.from_automaton(auto)
        mat.save(args.tokenizer)
    print("File successfully converted.")
    return 0


def make_flags(args) -> int:
    flags = 0
    if args.tokens:
        flags |= TOKENS
    if args.token_positions:
        flags |= TOKEN_POS
    if args.sentences:
        flags |= SENTENCES
    if args.sentence_positions:
        flags |= SENTENCE_POS
    if args.newline_after_eot:
        flags |= NEWLINE_AFTER_EOT
    return flags


def _engine(tok, args) -> BatchEngine:
    """The batched engine on ``--device``; a device that cannot run is a
    one-line error before any output.  ``--no-accelerated`` picks the
    general machine, as it does in ``datok-tpu`` (K1's general form,
    over a ``.datok`` model's own base and check)."""
    try:
        dev = torch.device(args.device)
    except RuntimeError as e:
        raise ValueError(f"--device {args.device}: {e}") from None
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise ValueError(f"--device {args.device}: no CUDA device is available")
    accelerated = getattr(args, "accelerated", True)
    return BatchEngine(tok, device=dev,
                       engine="auto" if accelerated else "general")


def cmd_tokenize(args) -> int:
    tok = load_tokenizer_file(args.tokenizer)
    engine = _engine(tok, args) if args.batch else None
    w = TokenWriter(make_flags(args), out=sys.stdout)
    src = (contextlib.nullcontext(sys.stdin.buffer) if args.input == "-"
           else open(args.input, "rb"))
    with src as f:
        if args.batch:
            # bounded-memory streaming through the device engine
            tokenize_reader(tok, f, w, engine=engine)
        else:
            # the host oracle, with bounded memory (cmd/datok.go:108-133)
            transduce_reader(tok, f, writer=w)
    w.flush()
    return 0


def cmd_corpus(args) -> int:
    tok = load_tokenizer_file(args.tokenizer)
    runner = CorpusRunner(tok, args.out_dir, flags=make_flags(args),
                          engine=_engine(tok, args))
    pst: dict = {}
    stats = runner.run(args.files, verbose=True, stats=pst)
    # pipeline observability: stage seconds, wave/doc counts, host
    # chain repairs
    stats["pipeline"] = {
        k: (round(v, 3) if isinstance(v, float) else v)
        for k, v in pst.items()
    }
    print(json.dumps(stats))
    return 0


def _flags(p) -> None:
    p.add_argument("--tokens", action=argparse.BooleanOptionalAction, default=True)
    p.add_argument("--sentences", action=argparse.BooleanOptionalAction, default=True)
    p.add_argument("-p", "--token-positions", action="store_true", default=False)
    p.add_argument("--sentence-positions", action="store_true", default=False)
    p.add_argument("--newline-after-eot", action="store_true", default=False)
    p.add_argument("--device", default="cuda",
                   help="torch device of the batched engine: cuda (K1; "
                        "fails without a card) or cpu (the plain machine)")


def main(argv=None) -> int:
    p = argparse.ArgumentParser(
        prog="datok-tpu-torch",
        description="FSA based tokenizer (PyTorch / CUDA)")
    sub = p.add_subparsers(dest="cmd", required=True)

    c = sub.add_parser("convert", help="Convert a compiled foma FST file")
    c.add_argument("-i", "--foma", required=True, help="The Foma FST file")
    c.add_argument("-o", "--tokenizer", required=True, help="The Tokenizer file")
    c.add_argument(
        "-d",
        "--double-array",
        action="store_true",
        help="Convert to Double Array instead of Matrix representation",
    )

    t = sub.add_parser("tokenize", help="Tokenize a text")
    t.add_argument("-t", "--tokenizer", required=True)
    t.add_argument("input", help="Input file to tokenize (use - for STDIN)")
    _flags(t)
    t.add_argument("--batch", action="store_true", default=False,
                   help="Use the batched engine on --device")
    t.add_argument(
        "--accelerated", action=argparse.BooleanOptionalAction, default=True,
        help="--no-accelerated runs K1's general form (over a .datok "
             "model's own layout), as datok-tpu runs its general machine",
    )

    c2 = sub.add_parser(
        "corpus", help="Tokenize many files resumably (shard manifest)"
    )
    c2.add_argument("-t", "--tokenizer", required=True)
    c2.add_argument("-o", "--out-dir", required=True)
    c2.add_argument("files", nargs="+")
    _flags(c2)

    args = p.parse_args(argv)
    # malformed model/foma files exit with a clean one-line error, not a
    # traceback, as in the JAX CLI (datok_tpu/cli.py:137-176)
    try:
        if args.cmd == "convert":
            return cmd_convert(args)
        if args.cmd == "corpus":
            return cmd_corpus(args)
        return cmd_tokenize(args)
    except (
        OSError,
        ValueError,
        KeyError,
        IndexError,
        EOFError,
        gzip.BadGzipFile,
        zlib.error,
        struct.error,
        UnicodeDecodeError,
    ) as e:
        print(f"datok-tpu-torch: error: {e}", file=sys.stderr)
        return 1


if __name__ == "__main__":
    sys.exit(main())
