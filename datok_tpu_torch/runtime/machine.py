"""The plain machine: the reference transduce loop over lanes in torch.

Counterpart of the step of the JAX package's Pallas kernel
(datok_tpu/runtime/jax_engine.py: ``_make_step`` :230-602 with the run
skip and the fused boundaries, as ``pallas_engine._make_kernel`` runs
it) and of its general machine (``_make_step`` without them,
``_general_fetches`` :610-627, ``_init_carry`` :630-684, ``_finish``
:687-699 and ``_run_machine`` :702-735).  One loop iteration executes
one step for every live lane; divergence is handled with masks.  This
is the plain version of the CUDA kernel K1 (``csrc/transduce.cu``): the
kernel wrapper runs it for tensors on the CPU, and the smoke run holds
K1 against it on the card.

Two forms of the step (``form``):

- ``"full"``, the engine's: kernel 1's step.  A letter-absorbing state
  takes a whole run of the skip class in one step (run skip), and "no
  arc, backtrack, ε flush, re-read consume" is one step (a fused
  boundary; a sentence end where no token is pending).  Both read the
  tables' per-state word (:func:`datok_tpu_torch.runtime.rep.state_table`)
  and the run length in meta bits 19..23, which the engine's encoder
  stamps with the same skip class.  Unlike the Pallas kernel, which
  fuses only where the final target is in its hot set, every
  composition the gates let through fuses, so the full form may take
  fewer steps than the Pallas kernel on the same lane; its events and
  exit rows are the same.
- ``"general"``: the general machine's step, one character or one
  backtrack a step (a double-array model always runs it).

Unlike the JAX machine, events go to a per-lane compact buffer in step
order (a lane emits at most one event per step, so ``max_steps``
columns never overflow) instead of a step-indexed ``(steps, B)``
buffer that a later pass compacts.  Meta keeps the encoder's layout,
one row per lane, as K1 reads it.  Beside K1's outputs the machine
counts the steps whose state was cold (outside the tables' hot set),
as K1 does.
"""

from __future__ import annotations

from typing import Optional

import torch

from .encode import (META_A_MASK, META_EOT, META_FOUND, META_NONASCII,
                     META_RUN_MASK, META_RUN_SHIFT)
from .events import EV_SENT, EV_TEXT, EV_TOKEN
from .rep import (ST_EPS, ST_EPS_AT_TGT, ST_EPS_TGT, ST_LC, Tables, _take,
                  eps_avail, takes_hop, transition)

# Packed-event layout: kind(2) | start(15) | end(15) (jax_engine.py:73-76)
PACK_POS_BITS = 15
PACK_POS_MASK = (1 << PACK_POS_BITS) - 1
MAX_SEGMENT = PACK_POS_MASK - 2

ROOT = 1


def _pack(kind: int, start: torch.Tensor, end: torch.Tensor) -> torch.Tensor:
    v = kind | (start.long() << 2) | (end.long() << (2 + PACK_POS_BITS))
    # wrap to int32 like the JAX int32 arithmetic
    return (v - ((v >> 31) & 1) * (1 << 32)).to(torch.int32)


def _ctx(t, sflag, tflag, ok):
    """Packed context ``t | sflag<<28 | tflag<<29 | ok<<30``."""
    return (t | (sflag.to(torch.int32) << 28) | (tflag.to(torch.int32) << 29)
            | (ok.to(torch.int32) << 30))


FORMS = ("full", "general")


def run_machine(tb: Tables, meta: torch.Tensor, lengths: torch.Tensor,
                entries: torch.Tensor, stops: torch.Tensor, max_steps: int,
                form: str = "full", hop_count: Optional[torch.Tensor] = None):
    """Run every lane to completion or to ``max_steps`` steps, with the
    step of ``form`` (:data:`FORMS`; a double-array model, which has no
    per-state words, runs the general step in either).

    ``meta`` (B, L) int32: packed symbol metas, one row per lane
    (``SymbolEncoder.encode_batch``); ``lengths`` (B,)
    int32; ``entries`` (B,) int32 packed entry contexts
    ``t | sflag<<28 | tflag<<29 | ok<<30`` (1 = fresh root); ``stops``
    (B,) bool: cut lanes stop at their end without the EOF epilogue.

    Returns ``(events (B, max_steps) int32, counts (B,) int32,
    bad (B,) bool, state (B, 6) int32, steps (B,) int32, cold (2,)
    int64)``: lane i's
    packed events ``kind | start<<2 | end<<17`` are
    ``events[i, :counts[i]]`` in step order (later columns are 0);
    ``state`` rows are ``(ctx, ckpt, b, c, n_backtrack, n_force)`` as
    in ``_finish``; ``steps`` counts each lane's steps, and a lane is
    ``bad`` when it had not finished after ``max_steps`` of them.
    ``cold`` is (steps whose state was cold, all steps) over the wave: a
    step is cold when it reads the row of a state (``t`` on a new
    character and at the end, ``t0`` otherwise) outside ``tb.hot``;
    drain steps and cuts read no row.

    ``hop_count``, a (2,) int64 tensor on the same device, gains (the
    steps whose transition succeeded, those of them that took a
    separate-state hop) on a double array's tables.
    """
    if form not in FORMS:
        raise ValueError(f"form must be one of {FORMS}, got {form!r}")
    full = form == "full" and tb.state_bits is not None
    B, L = meta.shape
    dev = meta.device
    i32 = torch.int32
    zeros = torch.zeros(B, dtype=i32, device=dev)
    false = torch.zeros(B, dtype=torch.bool, device=dev)

    ctx = entries.to(i32)
    t = ctx & 0x0FFFFFFF
    t0 = t.clone()
    a = zeros.clone()
    ok = ((ctx >> 30) & 1) != 0
    eot = false.clone()
    newchar = ~false
    eps_s = zeros.clone()
    eps_o = zeros.clone()
    c = zeros.clone()
    b = zeros.clone()
    ft = zeros.clone()
    sflag = ((ctx >> 28) & 1) != 0
    tflag = ((ctx >> 29) & 1) != 0
    phase = zeros.clone()
    pend = zeros.clone()
    pend2 = zeros.clone()
    ckpt = ctx.clone()
    n_backtrack = zeros.clone()
    n_force = zeros.clone()
    steps = zeros.clone()
    length = lengths.to(i32)
    stop = stops.to(torch.bool)

    # one spare column takes the writes of lanes that emit nothing
    events = torch.zeros((B, max_steps + 1), dtype=i32, device=dev)
    counts = zeros.clone()
    lane = torch.arange(B, device=dev)
    eps, unknown, identity = tb.eps, tb.unknown, tb.identity
    hot_of = tb.hot.hot_of if tb.hot is not None else None
    n_cold = torch.zeros(B, dtype=torch.int64, device=dev)

    def w(m, x, y):
        return torch.where(m, x, y)

    for _ in range(max_steps):
        live = (phase == 0) | (pend != 0)
        if not bool(live.any()):
            break
        # Lanes with queued events drain one per step and do nothing else.
        m_drain = pend != 0
        running = (phase == 0) & ~m_drain
        m_new0 = running & newchar
        m_end = m_new0 & (c >= length)
        m_cut = m_end & stop
        m_eof = m_end & ~stop
        m_read = m_new0 & ~m_end
        m_old = running & ~newchar
        t_row, t0_row = t, t0

        # ---- newchar: symbol metadata -----------------------------------
        cc = c.clamp(0, L - 1).long()
        meta_v = meta.gather(1, cc[:, None])[:, 0]
        a_new = meta_v & META_A_MASK
        found_new = (meta_v & META_FOUND) != 0
        nonascii_new = (meta_v & META_NONASCII) != 0
        eot_new = (meta_v & META_EOT) != 0

        # stale ok: only the non-ASCII path reassigns it (matrix.go:426-434)
        ok = w(m_read, w(nonascii_new, found_new, ok), ok)
        a = w(m_read, a_new, a)
        eot = w(m_read, eot_new, eot)
        t0 = w(m_read, t, t0)

        valid, nontok, t_succ = transition(tb, t0, a)
        # ε probe (read) and epilogue chase share one predicate on t
        if full:
            word = _take(tb.state_bits, t.long())
            eps_here = (word & ST_EPS) != 0
            # run skip: a letter-absorbing state takes the run of the
            # skip class at c (length rl, capped at 31) in one step; the
            # leading-nontoken drop applies only to the first pending
            # character, which the gate excludes
            rl = (meta_v >> META_RUN_SHIFT) & META_RUN_MASK
            m_skip = (m_read & ((word & ST_LC) != 0) & (rl >= 2)
                      & ((c - b) - ft >= 1))
            # fused boundary: no arc, backtrack to t, ε flush, re-read
            # consume from the ε target e, in one step; the gates keep
            # EOT and the stale-ok identity retry (f1) on the slow path
            e = word & ST_EPS_TGT
            f_valid, f_nontok, f_tgt = transition(tb, e, a)
            bb = (m_read & ~m_skip & ~valid & (e != 0) & f_valid
                  & (a != eps) & ~eot & (ok | (a != identity)))
            m_bf = bb & ((c - b) > ft)  # a token is pending: flush it
            m_bs = bb & ~m_bf  # none is: the ε ends a sentence
        else:
            eps_here = eps_avail(tb, t)
            m_skip = m_bf = m_bs = bb = false
        probe = m_read & eps_here
        eps_s = w(probe, t, eps_s)
        # a skipped run probes at each of its characters: the register
        # holds the last
        eps_o = w(probe, w(m_skip, c + rl - 1, c) if full else c, eps_o)

        # ---- transition outcome -----------------------------------------
        m_trans = (m_read & ~m_skip & ~bb) | m_old
        m_fail = m_trans & ~valid
        f1 = m_fail & ~ok & (a == identity)
        f2 = m_fail & ~f1 & (a != eps) & (eps_s != 0)
        f3 = m_fail & ~f1 & ~f2

        m_succ = m_trans & valid
        if hop_count is not None and tb.kind == "DATOK":
            hop_count += torch.stack([m_succ.sum(),
                                      (m_succ & takes_hop(tb, t0, a)).sum()])
        is_eps = a == eps
        has_pending = (c - b) > ft
        flush = m_succ & is_eps & has_pending
        sent = m_succ & is_eps & ~has_pending
        cons = m_succ & ~is_eps

        c_cons = w(cons, c + 1, c)
        f3_bump = f3 & ((c - b) - ft <= 0)
        c_f3 = w(f3_bump, c + 1, c)

        # leading nontoken drop (matrix.go:579-591)
        lead = cons & ((c_cons - b) - ft == 1) & nontok
        ft_cons = w(lead, ft + 1, ft)

        # EOT after the consume/ε branch (matrix.go:593-605)
        sflag1 = ~flush & (sent | sflag)
        tflag1 = ~flush & tflag
        e_m = m_succ & eot
        sent2 = e_m & ~sflag1
        sflag2 = sflag1 | sent2
        tflag2 = e_m | tflag1
        rewind = flush | e_m

        # ---- epilogue entry (EOF, matrix.go:637-697) ---------------------
        echase = m_eof & eps_here
        ebt = m_eof & ~eps_here & (eps_s != 0)
        efin = m_eof & ~eps_here & (eps_s == 0)
        resid = efin & has_pending
        efin_sent = efin & ~(~resid & sflag)
        efin_text = efin & ~(~resid & tflag)

        # ---- events, always ordered T, S, X ------------------------------
        w_tok = flush | f3 | resid | m_bf
        w_sent = sent | sent2 | efin_sent | m_bs
        w_text = e_m | efin_text
        v_tok = _pack(EV_TOKEN, b + ft, w(f3, c_f3, c))
        sent_pos = w(sent2, c_cons, c)
        v_sent = _pack(EV_SENT, sent_pos, sent_pos)
        text_pos = w(e_m, c_cons, c)
        v_text = _pack(EV_TEXT, text_pos, text_pos)
        first = w(w_tok, v_tok, w(w_sent, v_sent, w(w_text, v_text, zeros)))
        second = w(w_tok & w_sent, v_sent,
                   w((w_tok | w_sent) & w_text, v_text, zeros))
        third = w(w_tok & w_sent & w_text, v_text, zeros)
        emit = w(m_drain, pend, w(running, first, zeros))
        pend = w(m_drain, pend2, w(running, second, pend))
        pend2 = w(m_drain, zeros, w(running, third, pend2))

        col = w(emit != 0, counts, max_steps).long()
        events[lane, col] = emit
        counts = counts + (emit != 0).to(i32)

        # ---- register updates (the paths are disjoint) -------------------
        # f2/ebt read the post-probe backtrack register, like the
        # reference (probe and failing transition share an iteration,
        # matrix.go:442-497)
        back = f2 | ebt
        rew = m_succ & rewind
        t_new = w(f3, ROOT, w(m_succ, t_succ, t))
        t0 = w(back, eps_s, w(echase, t, t0))
        a = w(f1, unknown, w(back | f3 | echase, eps, a))
        c_new = w(back, eps_o, w(f3, c_f3, w(m_succ, c_cons, c)))
        b = w(f3, c_f3, w(rew, c_cons, b))
        ft = w(f3 | rew, zeros, w(cons, ft_cons, ft))
        eps_s = w(back | f3 | rew, zeros, eps_s)
        eps_o = w(rew, zeros, eps_o)
        newchar = ~(f1 | back | echase) & (f3 | m_succ | newchar)
        eot = ~(f1 | f2 | m_succ) & eot
        sflag = ~f3 & w(m_succ, sflag2, sflag)
        tflag = ~f3 & w(m_succ, tflag2, tflag)
        phase = w(efin | m_cut, torch.ones_like(phase), phase)
        # checkpoint the context at rewinds: a later segment can resume
        # exactly by re-reading text from b in this context
        ckpt = w(f3 | rew, _ctx(t_new, sflag, tflag, ok), ckpt)
        if full:
            # the fused step ends where the three steps it stands for
            # end: the token (or sentence end) emitted above, a rewind
            # to c (m_bf), the consume to c + 1 with the leading-nontoken
            # drop, the backtrack register at e where ε is available
            # there, the checkpoint e's context with both flags cleared
            t_new = w(bb, f_tgt, t_new)
            c_new = w(m_skip, c + rl, w(bb, c + 1, c_new))
            ft = w(m_bf, f_nontok.to(i32), w(m_bs, ft + f_nontok.to(i32), ft))
            b = w(m_bf, c, b)
            eps_s = w(bb, w((word & ST_EPS_AT_TGT) != 0, e, zeros), eps_s)
            eps_o = w(bb, c, eps_o)
            newchar = newchar | bb
            sflag = w(m_bf, false, w(m_bs, ~false, sflag))
            tflag = tflag & ~m_bf
            ckpt = w(m_bf, e | (ok.to(i32) << 30), ckpt)
        t = t_new
        c = c_new
        n_backtrack = n_backtrack + (f2 | bb).to(i32)
        n_force = n_force + f3.to(i32)
        steps = steps + live.to(i32)
        # the state whose row the step read: t on a new character, t0
        # otherwise (the probe and the transition of m_read share it)
        reads = (m_new0 & ~m_cut) | m_old
        if hot_of is not None:
            hot = _take(hot_of, w(m_new0, t_row, t0_row).long()) != 0
            reads = reads & ~hot
        n_cold = n_cold + reads.to(torch.int64)

    bad = (phase == 0) | (pend != 0)
    state = torch.stack(
        [_ctx(t, sflag, tflag, ok), ckpt, b, c, n_backtrack, n_force], dim=-1
    )
    cold = torch.stack([n_cold.sum(), steps.to(torch.int64).sum()])
    return events[:, :max_steps], counts, bad, state, steps, cold
