"""Boundary-event model: the device/host emission contract.

The transduce runtime (scalar oracle and TPU engine alike) emits a
compact stream of *events* instead of calling output callbacks from the
hot loop.  An event is ``(kind, start, end)`` with absolute rune
positions into the input segment:

  * ``EV_TOKEN`` — token surface ``text[start:end]``; the token's
    *buffer base* (needed for the reference's offset arithmetic and
    the newline-after-EOT check, token_writer.go:66-81) is implicit:
    it equals the ``end`` of the previous TOKEN or TEXT event (the
    buffer rewinds exactly at those points, matrix.go:608-627).
  * ``EV_SENT`` — sentence boundary (no positions).
  * ``EV_TEXT`` — text end; ``end`` is the rewind position (the cursor
    after the consumed EOT character).

Replaying events through a :class:`TokenWriter` reproduces the
reference output byte for byte for every flag combination.
"""

from __future__ import annotations

from typing import Iterable, Tuple

from .writer import SIMPLE, TokenWriter

EV_TOKEN = 1
EV_SENT = 2
EV_TEXT = 3

Event = Tuple[int, int, int]


def replay_events(
    events: Iterable[Event], text: str, writer: TokenWriter, base: int = 0
) -> TokenWriter:
    """Feed an event stream through TokenWriter callbacks."""
    token = writer.token
    sentence_end = writer.sentence_end
    text_end = writer.text_end
    for kind, start, end in events:
        if kind == EV_TOKEN:
            token(start - base, text[base:end])
            base = end
        elif kind == EV_SENT:
            sentence_end(0)
        elif kind == EV_TEXT:
            text_end(0)
            base = end
    return writer


def format_events(events: Iterable[Event], text: str, flags: int = SIMPLE) -> str:
    """Render an event stream to the reference's output format."""
    w = TokenWriter(flags)
    replay_events(events, text, w)
    w.flush()
    return w.getvalue()
