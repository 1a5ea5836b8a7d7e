"""Output formatting with TokenWriter parity.

Replicates the reference's flag-configured ``TokenWriter``
(the reference's token_writer.go:9-175) byte for byte:

  * one token surface per line; sentence boundary = blank line; text
    end = one more newline (``SIMPLE`` mode);
  * ``TOKEN_POS``/``SENTENCE_POS`` collect rune offsets (start/end
    pairs; sentence boundaries as token-start/last-token-end) printed
    space-joined at each text end, with counters reset per text;
  * ``NEWLINE_AFTER_EOT`` discounts a newline that directly follows an
    EOT from the offsets of the next text (token_writer.go:66-68).

The reference selects closure implementations once at construction to
avoid per-token branching; here the flag checks are cheap Python and
the hot path is on-device anyway, so a plain class keeps it readable.
"""

from __future__ import annotations

import io

TOKENS = 1
SENTENCES = 2
TOKEN_POS = 4
SENTENCE_POS = 8
NEWLINE_AFTER_EOT = 16

SIMPLE = TOKENS | SENTENCES


class TokenWriter:
    def __init__(self, flags: int = SIMPLE, out=None) -> None:
        self.flags = flags
        self.out = out if out is not None else io.StringIO()
        self.pos_c = 0
        self.pos = []
        self.sent_b = True
        self.sent = []
        self.init = True

    # -- callbacks (token_writer.go:59-167) ------------------------------
    def token(self, offset: int, buf: str) -> None:
        f = self.flags
        if f & (TOKEN_POS | SENTENCE_POS):
            # Accept newline after EOT (token_writer.go:66-68)
            if (
                self.pos_c == 0
                and f & NEWLINE_AFTER_EOT
                and buf[:1] == "\n"
                and not self.init
            ):
                self.pos_c -= 1
            self.init = False

            self.pos_c += offset
            self.pos.append(self.pos_c)
            if self.sent_b:
                self.sent_b = False
                self.sent.append(self.pos_c)
            self.pos_c += len(buf) - offset
            self.pos.append(self.pos_c)
            if f & TOKENS:
                self.out.write(buf[offset:])
                self.out.write("\n")
        elif f & TOKENS:
            self.out.write(buf[offset:])
            self.out.write("\n")

    def sentence_end(self, _: int = 0) -> None:
        f = self.flags
        if f & SENTENCE_POS:
            # End position of the last token becomes the sentence end.
            # (The reference indexes pos[-1] unguarded and would panic
            # on a sentence end before any token; we emit 0 instead.)
            self.sent.append(self.pos[-1] if self.pos else 0)
            self.sent_b = True
            if f & SENTENCES:
                self.out.write("\n")
        elif f & SENTENCES:
            self.out.write("\n")

    def text_end(self, _: int = 0) -> None:
        f = self.flags
        if f & (TOKEN_POS | SENTENCE_POS):
            if f & TOKEN_POS:
                self.out.write(" ".join(str(x) for x in self.pos))
                self.out.write("\n")
            if f & SENTENCE_POS:
                self.out.write(" ".join(str(x) for x in self.sent))
                self.out.write("\n")
                self.sent = []
                self.sent_b = True
            self.pos_c = 0
            self.pos = []
        else:
            self.out.write("\n")

    def flush(self) -> None:
        pass

    def getvalue(self) -> str:
        return self.out.getvalue()
