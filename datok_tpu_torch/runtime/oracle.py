"""Scalar transduce oracle — the host-side conformance reference.

An exact re-statement of the reference's greedy single-backtrack
transduce loop for both runtime representations
(the reference's matrix.go:348-698 and datok.go:781-1135), emitting
boundary :mod:`events` instead of writer callbacks.  Every kernel in
this framework is diffed against this oracle.

Replicated semantics (in reference order):

  * per-char symbol lookup with ASCII fast path and the *stale* ``ok``
    flag: ``ok`` is only (re)assigned on the non-ASCII path, so the
    identity→unknown retry condition ``!ok && a == identity`` can see a
    leftover value (matrix.go:421-435, 472-485) — bug-compatible;
  * epsilon availability probe on every fresh char, saving
    (state, cursor) as the single backtrack register
    (matrix.go:442-454);
  * on failure: identity→unknown retry, then epsilon backtrack (cursor
    rewind), then the never-fail force-emit that flushes the pending
    buffer as a token and restarts at the root (matrix.go:472-556);
  * nontoken leading-character drop only while the pending token is
    empty (matrix.go:579-591);
  * EOT (``\\x04``) emitting sentence end + text end after its
    transition succeeds (matrix.go:593-605);
  * the EOF epilogue: chase trailing epsilon transitions, then the
    backtrack register, then flush the residual buffer and emit the
    implicit sentence/text ends (matrix.go:637-697);
  * double-array variant: validity via ``t <= check(1) &&
    check(t) == t0``, nontoken/tokenend in check-bits, and the
    separate-state representative hop (datok.go:889-1063).
"""

from __future__ import annotations

from typing import List, Optional

from ..fsa.io import EOT, FIRSTBIT, RESTBIT
from .events import EV_SENT, EV_TEXT, EV_TOKEN, Event, replay_events
from .writer import SIMPLE, TokenWriter

_CP_EOT = EOT


def transduce_events(
    tok, text: str, state_counter=None, entry_state: int = 1, exit_box=None,
    debug: bool = False, start: int = 0, stop_at: Optional[int] = None,
    registers_box=None, rewinds_box=None, trace_box=None,
) -> List[Event]:
    """Run the exact transduce loop; return the boundary event stream.

    ``state_counter`` (optional dict) accumulates per-state occupancy
    at transition time — used to profile hot states for the MXU engine.
    ``entry_state`` is a packed entry context
    ``t | sentence_end<<28 | text_end<<29 | ok<<30`` (1 = fresh root);
    ``exit_box`` receives the packed exit context.  Used by the
    split/segmentation pipeline to chain chunk contexts exactly.

    ``start``/``stop_at``/``registers_box`` implement the *cut walk*
    used by speculative segmentation: replay from a rewind checkpoint
    (``entry_state`` = the packed context at the rewind, ``start`` =
    its buffer base) and stop just before reading the character at
    ``stop_at`` — no EOF epilogue, no residual flush.  The machine
    registers at the stop point are appended to ``registers_box`` as a
    dict; positions in emitted events are absolute.

    ``rewinds_box`` (optional list) records the *rewind-checkpoint
    stream*: one ``(pos, packed_ctx, n_events_so_far)`` triple per
    buffer rewind (including the entry configuration).  At a rewind
    every machine register is reset (``b == c``, ``ft == 0``, ε
    registers cleared — matrix.go:608-627), so ``(pos, packed_ctx)``
    fully determines the machine configuration; two walks that rewind
    at the same position with the same packed context are provably in
    identical configurations and have identical futures.  This is the
    convergence criterion of speculative segmentation
    (SURVEY.md §5 "long-context", option (a)).
    """
    is_da = tok.type() == "DATOK"
    eps = tok.epsilon
    unknown = tok.unknown
    identity = tok.identity
    sigma = tok.sigma
    ascii_tab = tok.sigma_ascii

    if is_da:
        base_arr = tok.base
        check_arr = tok.check
        arr_len = len(base_arr)
        size = int(check_arr[1] & RESTBIT)
    else:
        arr = tok.array
        S = tok.state_count

    events: List[Event] = []
    emit = events.append

    n = len(text)
    t = entry_state & 0x0FFFFFFF  # entry state (1 = root)
    t0 = 0
    a = 0
    ok = (entry_state >> 30) & 1 != 0
    eot = False
    newchar = True
    eps_state = 0
    eps_offset = 0
    sentence_end = (entry_state >> 28) & 1 != 0
    text_end = (entry_state >> 29) & 1 != 0
    # Absolute buffer registers: b = buffer base (rewind point),
    # ft = bufft (dropped leading chars), c = cursor (buffc, absolute).
    b = start
    ft = 0
    c = start
    nn = n if stop_at is None else min(n, stop_at)
    # last-rewind checkpoint (mirrors the device machine's ckpt):
    # the packed context at the most recent point where the buffer
    # restarted with zeroed registers — a valid exact resume point
    ck_ctx = entry_state
    ck_b = start
    if rewinds_box is not None:
        rewinds_box.append((ck_b, ck_ctx, 0))

    in_loop = True  # False = epilogue (post-EOF) section
    while True:
        if in_loop:
            if newchar:
                if c >= nn:
                    if stop_at is not None and c >= stop_at:
                        # cut walk: stop cleanly before reading stop_at
                        if registers_box is not None:
                            registers_box.append(
                                dict(
                                    t=t,
                                    ok=ok,
                                    sentence_end=sentence_end,
                                    text_end=text_end,
                                    b=b,
                                    ft=ft,
                                    c=c,
                                    eps_state=eps_state,
                                    eps_offset=eps_offset,
                                    ck_ctx=ck_ctx,
                                    ck_b=ck_b,
                                )
                            )
                        if exit_box is not None:
                            exit_box.append(
                                t
                                | (sentence_end << 28)
                                | (text_end << 29)
                                | (ok << 30)
                            )
                        return events
                    in_loop = False
                    continue
                cp = ord(text[c])
                eot = False
                if cp < 256:
                    eot = cp == _CP_EOT
                    a = int(ascii_tab[cp])
                else:
                    v = sigma.get(cp)
                    if v is None:
                        ok = False
                        a = identity if identity != -1 else 0
                    else:
                        ok = True
                        a = v
                t0 = t
                # Epsilon availability probe (backtrack register save)
                if is_da:
                    tc = int(base_arr[t0] & RESTBIT) + eps
                    probe = tc < arr_len and int(check_arr[tc] & RESTBIT) == t0
                else:
                    probe = arr[(eps - 1) * S + t0] != 0
                if probe:
                    eps_state = t0
                    eps_offset = c

            # Transition attempt
            if debug:
                ch = text[c] if c < n else "<EOF>"
                print(f"Check {t0} - {a} ( {ch!r} ) c={c} b={b} ft={ft}")
            if state_counter is not None:
                state_counter[t0] = state_counter.get(t0, 0) + 1
            if trace_box is not None:
                # one record per transition attempt (= per reference
                # loop iteration): source state, symbol, cursor — the
                # raw material for step-model analyses (see
                # bench_micro/steps_model.py)
                trace_box.append((t0, a, c))
            if is_da:
                tcell = int(base_arr[t0] & RESTBIT) + a
                valid = (
                    tcell <= size
                    and tcell < arr_len
                    and int(check_arr[tcell] & RESTBIT) == t0
                )
            else:
                traw = 0 if a == 0 else int(arr[(a - 1) * S + t0])
                valid = traw != 0

            if not valid:
                if not ok and a == identity:
                    # identity failed → retry with unknown
                    a = unknown
                    newchar = False
                    eot = False
                    continue
                if a != eps and eps_state != 0:
                    # backtrack to the last possible token end
                    t0 = eps_state
                    eps_state = 0
                    c = eps_offset
                    a = eps
                    newchar = False
                    eot = False
                    continue
                # Hard fail: force-emit pending buffer as a token and
                # restart at the root (never-fail invariant).
                if c - b - ft <= 0:
                    c += 1
                emit((EV_TOKEN, b + ft, c))
                sentence_end = False
                text_end = False
                b = c
                ft = 0
                eps_state = 0
                a = eps
                t = 1
                ck_ctx = 1 | (ok << 30)
                ck_b = b
                if rewinds_box is not None:
                    rewinds_box.append((ck_b, ck_ctx, len(events)))
                newchar = True
                continue

            # Transition successful
            rewind = False
            if is_da:
                cell_check = int(check_arr[tcell])
                nontoken = (cell_check & FIRSTBIT) != 0
            else:
                nontoken = (traw & FIRSTBIT) != 0

            if a == eps:
                if c - b > ft:
                    # token bound: flush the pending buffer
                    emit((EV_TOKEN, b + ft, c))
                    rewind = True
                    sentence_end = False
                    text_end = False
                else:
                    sentence_end = True
                    emit((EV_SENT, c, c))
            else:
                c += 1
                # Drop a leading non-word character from the surface
                if (c - b) - ft == 1 and nontoken:
                    ft += 1

            if eot:
                eot = False
                if not sentence_end:
                    sentence_end = True
                    emit((EV_SENT, c, c))
                text_end = True
                emit((EV_TEXT, c, c))
                rewind = True

            if rewind:
                b = c
                ft = 0
                eps_offset = 0
                eps_state = 0

            if is_da:
                t = tcell
                if base_arr[t] & FIRSTBIT:  # separate → representative
                    t = int(base_arr[t] & RESTBIT)
            else:
                t = traw & ~FIRSTBIT
            if rewind:
                ck_ctx = (
                    t | (sentence_end << 28) | (text_end << 29) | (ok << 30)
                )
                ck_b = b
                if rewinds_box is not None:
                    rewinds_box.append((ck_b, ck_ctx, len(events)))
            newchar = True
            continue

        # ---- epilogue: chase trailing epsilon transitions ----
        t0 = t
        a = eps
        newchar = False
        if is_da:
            tcell = int(base_arr[t0] & RESTBIT) + eps
            chase = tcell < arr_len and int(check_arr[tcell] & RESTBIT) == t0
        else:
            chase = arr[(eps - 1) * S + t0] != 0
        if chase:
            in_loop = True
            continue
        if eps_state != 0:
            t0 = eps_state
            eps_state = 0
            c = eps_offset
            in_loop = True
            continue
        break

    # Residual buffer flush + implicit sentence/text ends
    if c - b > ft:
        emit((EV_TOKEN, b + ft, c))
        sentence_end = False
        text_end = False
    if not sentence_end:
        emit((EV_SENT, c, c))
    if not text_end:
        emit((EV_TEXT, c, c))
    if exit_box is not None:
        exit_box.append(
            t | (sentence_end << 28) | (text_end << 29) | (ok << 30)
        )
    return events


def transduce_events_fast(
    tok, text: str, encoder=None, entry_state: int = 1, exit_box=None
) -> List[Event]:
    """Scalar transduce via the native C++ host runtime when available.

    Byte-identical to :func:`transduce_events` (verified by tests);
    ~4× the reference Go throughput on one host core.  Falls back to
    the Python oracle when the native library or representation is
    unavailable.
    """
    if tok.type() == "MATOK":
        try:
            from ..utils.native import native_encode, native_transduce_events

            if encoder is None:
                encoder = getattr(tok, "_sym_encoder", None)
                if encoder is None:
                    from .encode import SymbolEncoder

                    encoder = SymbolEncoder(tok)
                    tok._sym_encoder = encoder
            r = native_encode(encoder, text.encode("utf-8", "surrogatepass"))
            if r is not None:
                _cps, metas = r
                ev = native_transduce_events(
                    tok, metas, entry_state=entry_state, exit_box=exit_box
                )
                if ev is not None:
                    return ev
        except Exception:
            pass
    return transduce_events(
        tok, text, entry_state=entry_state, exit_box=exit_box
    )


def transduce_reader(
    tok, reader, writer: Optional[TokenWriter] = None, chunk_size: int = 1 << 16
):
    """Stream-transduce from a file-like object with bounded memory.

    The reference transduces an ``io.Reader`` through a 1024-rune ring
    buffer rewound at every token bound (matrix.go:348-371,608-627);
    this is the host-side equivalent: each chunk is processed up to its
    LAST buffer-rewind checkpoint — a point where every machine
    register is reset, so resuming there is exact — and only the
    un-checkpointed tail is carried into the next chunk.  Memory is
    O(chunk + longest token), independent of stream length.

    ``reader`` may be binary (bytes chunks; decoded incrementally as
    UTF-8 with ``errors="replace"``, split multi-byte sequences safe)
    or text mode.  With ``writer=None`` a ``SIMPLE`` writer is used and
    the formatted string is returned, else the writer is returned —
    mirroring :func:`transduce`.
    """
    import codecs

    own = writer is None
    w = TokenWriter(SIMPLE) if own else writer
    dec = codecs.getincrementaldecoder("utf-8")(errors="replace")
    ctx = 1
    tail = ""
    while True:
        data = reader.read(chunk_size)
        at_eof = not data
        if isinstance(data, bytes):
            new = dec.decode(data, final=at_eof)
        else:
            new = data or ""
        if at_eof:
            tail += new
            break
        if not new:  # pure UTF-8 continuation bytes
            continue
        text = tail + new
        rewinds: list = []
        events = transduce_events(
            tok, text, entry_state=ctx, stop_at=len(text),
            rewinds_box=rewinds,
        )
        pos, ck_ctx, n_final = rewinds[-1]
        replay_events(events[:n_final], text, w)
        tail = text[pos:]
        ctx = ck_ctx
    events = transduce_events(tok, tail, entry_state=ctx)
    replay_events(events, tail, w)
    w.flush()
    return w.getvalue() if own else w


def transduce(tok, text: str, writer: Optional[TokenWriter] = None):
    """Transduce ``text``; returns the output string (or the writer).

    With ``writer=None`` a ``SIMPLE`` writer is used and the formatted
    string is returned (the reference's ``Transduce``,
    matrix.go:340-342); otherwise events are replayed into ``writer``
    and the writer is returned (``TransduceTokenWriter``).
    """
    events = transduce_events(tok, text)
    own = writer is None
    w = TokenWriter(SIMPLE) if own else writer
    replay_events(events, text, w)
    w.flush()
    return w.getvalue() if own else w
