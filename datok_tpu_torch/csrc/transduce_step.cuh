// One lane of the reference transduce loop (matrix.go:383-697), as a
// scalar state machine.  Single C++ source of the step semantics for
// the CUDA kernel (transduce.cu) and its host build (transduce_host.cpp,
// for tests).  It transcribes datok_tpu/runtime/jax_engine.py:_make_step
// (:230-602) in two forms, a template argument of ``step``:
// - the full form (kFull), the step the TPU kernel runs
//   (pallas_engine.py:536, enable_skip=True, with the fused entries of
//   :502-516): a letter-absorbing state takes a whole run of the skip
//   class in one step (run skip, jax_engine.py:325-340), and "no arc,
//   backtrack, ε flush, re-read consume" is one step (a fused boundary,
//   :367-391, 509-548; a sentence end where no token is pending).  The
//   engine always launches it;
// - the general form, one character or one backtrack a step: the
//   JAX general machine's (_run_machine, :702-735).  An engine built
//   with engine="general" launches it, and a double-array model runs
//   only it.
// The table's layout is the step's second template argument:
// - the dense matrix (MatrixRep, jax_engine.py:104-130), whose cell
//   (a-1)*S + t holds the target;
// - the double array (DoubleArrayRep, :133-171), general form only: a
//   double array has no per-state words, and the JAX package never
//   skips or fuses on one.  Its cells are interleaved (base word,
//   check) pairs, the .datok file's own layout (runtime/rep.py:
//   da_pairs), and the lane carries the base of each state it holds
//   (t, t0 and the backtrack register) beside its id.  What bounds
//   the step is its chain of dependent loads, as on the matrix: a
//   lane is latency bound.  So the probe's check cell (at base + eps)
//   and the transition's pair (at base + a) load at once from bases
//   in registers, and that one 8-byte load brings the transition's
//   check together with the word that says where the lane goes: a
//   plain cell's word is the next state's base itself (the state is
//   the cell), a separate cell's word indexes a hop table whose entry
//   holds the representative and its base, built on the host.  The
//   hop table is small (one entry a distinct representative, at most
//   the automaton's states, ~147 KB at DE size) and is read through
//   L1, so a hop that hits L1 adds a short load, not a second L2 load,
//   and the step has one dependent L2 load as a matrix step has (a hop
//   that misses L1 takes the L2 load back: PERF.md times tables whose
//   hops spread over many entries).  The base of an entry state is
//   read once a lane from the original base array; the root's is a
//   launch constant.
// Each predicate below is one of _make_step's disjoint masks, and the
// comments name them.  The full form's gates are the JAX kernel's.  It
// fuses every composition they let through, where the TPU kernel fuses
// only those whose final target is in its hot set, so it may take fewer
// steps; its events and exit rows are the same.  Where the TPU kernel
// keeps the lazy TAG_EPSOF sentinel, the lane holds the ε target.
//
// Where a lane's data comes from:
// - table cells: a state of the hot set (runtime/hot.py) reads its row
//   from ``Model::hot`` (shared memory in K1), any other state from the
//   whole table.  When the engine has a hot set both hold tagged cells:
//   bits 20..29 of a nonzero cell are the target's hot index + 1, so
//   the lane always knows whether its next state is hot (``h``).
//   Clearing the tag gives the original cell: every fetch is exact.
//   The full form reads the consume from the ε target from the whole
//   table, and the ε target's hot index from ``Model::hot_of``.
// - the full form's per-state word (runtime/rep.py:state_table): the ε
//   target where a boundary fuses, ε available at the state and at
//   that target, and letter-absorbing, read through L1.  It is also the
//   full form's ε probe.
// - meta: the lane's own row of the (B, L) meta array.  A lane keeps
//   the word at its cursor in a register (``Lane::mv``), and each step
//   loads the word where the cursor goes next before it needs it: one
//   character on, or past the run a skip takes (its length is in the
//   word held), so the meta load is off the step's dependent chain.
//   Only a jump (a backtrack, a forced bump) loads the word at the new
//   cursor.  Consecutive reads of a lane hit the same 128-byte line,
//   which stays in L1.  A register window of 16-byte loads was slower
//   on an H100: the lanes of a warp refill it at different steps, so
//   the warp runs the refill branch on most steps (PERF.md).
#pragma once

#include <stdint.h>

#if defined(__CUDACC__)
#define DT_HD __host__ __device__ __forceinline__
#else
#define DT_HD inline
#endif

namespace dt {

// packed symbol meta (runtime/encode.py)
constexpr int32_t META_A_MASK = 0xFFFF;
constexpr int32_t META_FOUND = 1 << 16;
constexpr int32_t META_NONASCII = 1 << 17;
constexpr int32_t META_EOT = 1 << 18;
// bits 19..23: length (capped at 31) of the skip-class run at this position
constexpr int META_RUN_SHIFT = 19;
constexpr int32_t META_RUN_MASK = 0x1F;
// the per-state word of the full form (runtime/rep.py)
constexpr int32_t ST_EPS_TGT = (1 << 28) - 1;
constexpr int32_t ST_EPS = 1 << 28;
constexpr int32_t ST_EPS_AT_TGT = 1 << 29;
constexpr int32_t ST_LC = 1 << 30;
// events (runtime/events.py), packed kind | start<<2 | end<<17
constexpr uint32_t EV_TOKEN = 1, EV_SENT = 2, EV_TEXT = 3;
constexpr int PACK_POS_BITS = 15;
constexpr uint32_t FIRSTBIT = 0x80000000u;
constexpr uint32_t RESTBIT = 0x3FFFFFFFu;  // a double array's ids and offsets
constexpr int32_t ROOT = 1;
// tagged cells (runtime/hot.py): the target's hot index + 1
constexpr int HOT_SHIFT = 20;

// The tables' layout, the step's second template argument.
enum class Layout { Matrix, DoubleArray };

// Dense matrix model: cell (a-1)*S + t, 0 = no arc, FIRSTBIT = nontoken.
// Cell indices are 32-bit: the wrapper takes tables of fewer than 2^31
// cells.  A double array keeps its original base in ``table`` (read
// only where a lane enters), its n_cells interleaved (word, check)
// pairs in ``pairs`` (fewer than 2^28: the wrapper refuses more, since
// a slot must fit an entry context), its hop table in ``hop`` (entry j:
// the representative, then its base), its size field in ``size``, the
// root's base in ``root_b``, and none of the hot set or the per-state
// words.
struct Model {
  const uint32_t* table;  // the whole table (a double array's base);
                          // tagged when tag_mask != 0
  const uint32_t* hot;    // hot rows: cell (h-1)*max_sym + (a-1)
  const int32_t* hot_of;  // (n_hot_of,) hot index + 1 per state, 0 = cold
  const int32_t* st;      // (n_st,) per-state words (the full form)
  int32_t n_st;
  int32_t n_cells;
  int32_t S, max_sym, eps, unknown, identity;
  int32_t n_hot_of, root_h;
  uint32_t tag_mask;  // bits 20..29 with a hot set, else 0
  const uint64_t* pairs;  // a double array's (word, check) pairs
  int32_t size;  // a double array's size field (check[1] & RESTBIT)
  const uint64_t* hop;  // a double array's hop table
  uint32_t root_b;  // the RESTBIT base of the root (a double array)
};

struct Lane {
  int32_t t, t0, a, c, b, ft, eps_s, eps_o, pend, pend2, ckpt;
  int32_t h, h0, eps_h;  // hot index + 1 of t, t0 and eps_s (0 = cold)
  uint32_t bt, bt0, beps;  // a double array's RESTBIT base of t, t0, eps_s
  int32_t mv;  // the meta word at the cursor c (clipped to the row)
  int32_t n_backtrack, n_force, n_cold, length;
  bool ok, eot, newchar, sflag, tflag, stop, done;  // done = phase 1
};

DT_HD int32_t pack(uint32_t kind, int32_t start, int32_t end) {
  return (int32_t)(kind | ((uint32_t)start << 2) |
                   ((uint32_t)end << (2 + PACK_POS_BITS)));
}

DT_HD int32_t ctx_of(int32_t t, bool sflag, bool tflag, bool ok) {
  return t | ((int32_t)sflag << 28) | ((int32_t)tflag << 29) |
         ((int32_t)ok << 30);
}

// out-of-range cells read as 0 (the JAX reps' mode="fill" gathers)
DT_HD uint32_t cell(const Model& m, int64_t idx) {
  return (idx >= 0 && idx < m.n_cells) ? m.table[idx] : 0u;
}

// The cell of state t on symbol a (1 <= a <= max_sym) from the whole
// table (cell_at), or from the hot rows when t is hot (row_cell, ``h``
// its hot index + 1).  A state is below 2^28 (entry contexts keep 28
// bits), so the unsigned index cannot wrap.
DT_HD uint32_t cell_at(const Model& m, int32_t t, int32_t a) {
  uint32_t idx = (uint32_t)(a - 1) * (uint32_t)m.S + (uint32_t)t;
  return idx < (uint32_t)m.n_cells ? m.table[idx] : 0u;
}

DT_HD uint32_t row_cell(const Model& m, int32_t h, int32_t t, int32_t a) {
  return h > 0 ? m.hot[(h - 1) * m.max_sym + (a - 1)] : cell_at(m, t, a);
}

// The ε cell of state t: nonzero when a token bound is available.
DT_HD uint32_t eps_cell(const Model& m, int32_t h, int32_t t) {
  if (m.eps >= 1 && m.eps <= m.max_sym) return row_cell(m, h, t, m.eps);
  return cell(m, (int64_t)(m.eps - 1) * m.S + t);
}

// Cell i of a double array's base (``arr``); 0 outside the array, as the
// mode="fill" gathers give.  ``i`` is 64-bit: a corrupt base may put
// base + a past 2^31.
DT_HD uint32_t da_cell(const Model& m, const uint32_t* arr, int64_t i) {
  return (i >= 0 && i < m.n_cells) ? arr[i] : 0u;
}

// The RESTBIT base of state t, from the original base array (a lane's
// entry state, which may name any slot, and the root).
DT_HD uint32_t da_base(const Model& m, int32_t t) {
  return da_cell(m, m.table, t) & RESTBIT;
}

// Entry j of the hop table, through L1 on the card.
DT_HD uint64_t hop_at(const Model& m, uint32_t j) {
#if defined(__CUDA_ARCH__)
  return __ldg(reinterpret_cast<const unsigned long long*>(m.hop) + j);
#else
  return m.hop[j];
#endif
}

// A double array's ε probe and transition (DoubleArrayRep.eps_avail
// and .transition, jax_engine.py:148-171) from ``bu``, the base of the
// state whose row the step reads: t on a new character (the probe
// reads only then, and a read's t0 is t), t0 otherwise.  The probe's
// check cell and the transition's (word, check) pair load at once;
// neither waits on a base.  No a == 0 guard (:158).  A separate cell
// (datok.go:1056-1063) hops once, to the representative of its hop
// table entry, whose base comes with it; a plain cell's word is the
// base of the cell's own state.  Cells outside the array read as 0.
// The indices are 32-bit: ``bu`` < 2^30, so base + x wraps past 2^31
// exactly where it is negative, and a negative index, like one past
// the end, names no cell (the JAX reps' mode="fill" gathers).
struct DaFetch {
  bool eps_here, valid, nontok;
  int32_t t_next;
  uint32_t b_next;  // the RESTBIT base of t_next
};

DT_HD DaFetch da_fetch(const Model& m, uint32_t bu, int32_t t, int32_t t0,
                       int32_t a) {
  const uint32_t n = (uint32_t)m.n_cells;
  const uint32_t te = bu + (uint32_t)m.eps;
  const uint32_t tc = bu + (uint32_t)a;
  const bool e_rng = te < n, in_rng = tc < n;
  const uint32_t* chk_of = reinterpret_cast<const uint32_t*>(m.pairs) + 1;
  const uint32_t chk_e = e_rng ? chk_of[2 * (uint64_t)te] : 0u;
  const uint64_t pair = in_rng ? m.pairs[tc] : 0ull;
  const uint32_t w = (uint32_t)pair, chk = (uint32_t)(pair >> 32);
  const bool sep = (w & FIRSTBIT) != 0;
  const uint64_t hop = sep ? hop_at(m, w & ~FIRSTBIT) : 0ull;
  // base + eps below 0 (eps < 0 only): no cell, below n_cells
  const bool e_neg = m.eps < 0 && bu < (uint32_t)(-(int64_t)m.eps);
  DaFetch d;
  // the probe has no size test, the transition has (:148-153)
  d.eps_here = e_rng ? (int32_t)(chk_e & RESTBIT) == t : (e_neg && t == 0);
  d.valid = in_rng && tc <= (uint32_t)m.size &&
            (int32_t)(chk & RESTBIT) == t0;
  d.nontok = (chk & FIRSTBIT) != 0;
  d.t_next = sep ? (int32_t)(uint32_t)hop : (int32_t)tc;
  d.b_next = sep ? (uint32_t)(hop >> 32) : (w & RESTBIT);
  return d;
}

// The per-state word of state t; 0 (no ε, not absorbing) outside 0..S.
DT_HD int32_t state_word(const Model& m, int32_t t) {
  return ((uint32_t)t < (uint32_t)m.n_st) ? m.st[t] : 0;
}

DT_HD int32_t hot_index(const Model& m, int32_t t) {
  return (m.hot_of != nullptr && t >= 0 && t < m.n_hot_of) ? m.hot_of[t] : 0;
}

// Word p of the lane's meta row of L words, p clipped to [0, L-1].
DT_HD int32_t meta_at(const int32_t* row, int32_t p, int32_t L) {
  p = p < 0 ? 0 : (p > L - 1 ? L - 1 : p);
#if defined(__CUDA_ARCH__)
  return __ldg(row + p);
#else
  return row[p];
#endif
}

template <Layout kLayout>
DT_HD void init_lane(Lane& s, const Model& m, const int32_t* row, int32_t L,
                     int32_t entry, int32_t length, bool stop) {
  // packed entry context: t | sflag<<28 | tflag<<29 | ok<<30 (1 = root)
  s.t = s.t0 = entry & 0x0FFFFFFF;
  s.h = s.h0 = hot_index(m, s.t);
  s.eps_h = 0;
  constexpr bool kDA = kLayout == Layout::DoubleArray;
  if (kDA) {
    s.bt = s.bt0 = da_base(m, s.t);
    s.beps = 0;
  }
  s.a = s.c = s.b = s.ft = s.eps_s = s.eps_o = s.pend = s.pend2 = 0;
  s.n_backtrack = s.n_force = s.n_cold = 0;
  s.mv = meta_at(row, 0, L);
  s.ckpt = entry;
  s.length = length;
  s.ok = ((entry >> 30) & 1) != 0;
  s.sflag = ((entry >> 28) & 1) != 0;
  s.tflag = ((entry >> 29) & 1) != 0;
  s.eot = false;
  s.newchar = true;
  s.stop = stop;
  s.done = false;
}

DT_HD bool live(const Lane& s) { return !s.done || s.pend != 0; }

// One step of a lane; returns the event it emits (0 for none).  The
// step is written as the plain machine (runtime/machine.py) writes it:
// every path's predicate is computed, and each register takes its new
// value through selects, so the lanes of a warp never branch apart
// within a step.  On mixed text this beat one early-return branch per
// path, which makes a warp run every path some lane takes; on a wave
// whose lanes all read the same text the branches win (PERF.md).
// ``row`` is the lane's meta row of ``L`` words (positions are clipped
// to [0, L-1]).  A step that reads the row of a cold state counts in
// ``n_cold``.  ``kFull`` picks the form and ``kLayout`` the tables'
// layout (the header above).
template <bool kFull, Layout kLayout>
DT_HD int32_t step(Lane& s, const Model& m, const int32_t* row, int32_t L) {
  constexpr bool kDA = kLayout == Layout::DoubleArray;
  static_assert(!(kFull && kDA), "the full form needs the dense matrix");
  // m_drain: a lane with queued events drains one and does nothing else
  const bool drain = s.pend != 0;
  const bool running = !s.done && !drain;
  const bool new0 = running && s.newchar;
  const bool end = new0 && s.c >= s.length;
  const bool cut = end && s.stop;  // m_cut: stop cleanly, no flush
  const bool eof = end && !s.stop;  // m_eof: the epilogue
  const bool read = new0 && !end;  // m_read
  const bool old = running && !s.newchar;  // m_old: t0 --a--> again
  // the state whose row the step reads: t on a new character, t0
  // otherwise (the ε probe and the transition of m_read share it)
  s.n_cold += ((new0 && !cut) || old) && (new0 ? s.h : s.h0) == 0;

  // the symbol; stale ok: only the non-ASCII path reassigns it
  // (matrix.go:426-434).  The state's word (full form) and the cells
  // are loaded before anything waits on them.
  const int32_t mv = s.mv;
  const int32_t word = kFull ? state_word(m, s.t) : 0;
  // the word where the cursor goes next, loaded ahead: the general form
  // moves on by one character at most, so its load goes first
  int32_t mv_next = kFull ? 0 : meta_at(row, s.c + 1, L);
  if (read) {
    if (mv & META_NONASCII) s.ok = (mv & META_FOUND) != 0;
    s.a = mv & META_A_MASK;
    s.eot = (mv & META_EOT) != 0;
    s.t0 = s.t;
    s.h0 = s.h;
    if (kDA) s.bt0 = s.bt;
  }
  // a double array's probe and transition, from the base of the state
  // whose row the step reads (none on the matrix)
  const DaFetch d =
      kDA ? da_fetch(m, new0 ? s.bt : s.bt0, s.t, s.t0, s.a)
          : DaFetch{};
  // the ε probe (read) and the epilogue's chase share one predicate on
  // t; the transition cell comes from the same row on a read
  const bool eps_here =
      kDA ? d.eps_here
          : (kFull ? (word & ST_EPS) != 0 : eps_cell(m, s.h, s.t) != 0);
  const bool a_in = s.a > 0 && s.a <= m.max_sym;
  const uint32_t traw = (!kDA && a_in) ? row_cell(m, s.h0, s.t0, s.a) : 0u;
  // the fused boundary (m_bf, m_bs): no arc at t, an ε arc to e whose
  // row takes a; the gates keep EOT and the stale-ok identity retry
  // (f1) on the slow path.  The consume cell from e is loaded beside
  // the transition cell, off its chain.
  const int32_t e = word & ST_EPS_TGT;
  const uint32_t fraw =
      (kFull && read && e != 0 && a_in) ? cell_at(m, e, s.a) : 0u;
  // m_skip: a letter-absorbing state takes the skip-class run at c
  // (length rl) in one step; the leading-nontoken drop applies only to
  // the first pending character, which the gate excludes
  const int32_t rl = (mv >> META_RUN_SHIFT) & META_RUN_MASK;
  const bool skip = kFull && read && (word & ST_LC) && rl >= 2 &&
                    s.c - s.b - s.ft >= 1;
  // the full form's next word, once the cell loads are on their way and
  // the skip gate is known: one load, at c + 1 or past the run
  if (kFull) mv_next = meta_at(row, s.c + (skip ? rl : 1), L);
  const bool bb = kFull && read && !skip && traw == 0 && fraw != 0 &&
                  s.a != m.eps && !s.eot && (s.ok || s.a != m.identity);
  const bool has_pending = s.c - s.b > s.ft;
  const bool bf = bb && has_pending;  // m_bf: flush the pending token
  const bool bs = bb && !has_pending;  // m_bs: the ε ends a sentence
  if (read && eps_here) {  // save the backtrack register
    s.eps_s = s.t;
    s.eps_h = s.h;
    if (kDA) s.beps = s.bt;
    // a skipped run probes at each of its characters: keep the last
    s.eps_o = skip ? s.c + rl - 1 : s.c;
  }

  // transition outcome; f2 reads the post-probe backtrack register
  const bool trans = (read && !skip && !bb) || old;
  const bool fail = trans && (kDA ? !d.valid : traw == 0);
  const bool f1 = fail && !s.ok && s.a == m.identity;  // retry unknown
  const bool f2 = fail && !f1 && s.a != m.eps && s.eps_s != 0;  // ε back
  const bool f3 = fail && !f1 && !f2;  // force-emit, restart at the root
  const bool succ = trans && (kDA ? d.valid : traw != 0);
  const bool nontok = kDA ? d.nontok : (traw & FIRSTBIT) != 0;
  const int32_t t_succ =
      kDA ? d.t_next : (int32_t)(traw & ~m.tag_mask & 0x7FFFFFFFu);
  const int32_t h_succ = (int32_t)((traw & m.tag_mask) >> HOT_SHIFT);
  const bool is_eps = s.a == m.eps;
  const bool flush = succ && is_eps && has_pending;
  const bool sent = succ && is_eps && !has_pending;
  const bool cons = succ && !is_eps;
  const int32_t c_cons = cons ? s.c + 1 : s.c;
  const int32_t c_f3 = (f3 && s.c - s.b - s.ft <= 0) ? s.c + 1 : s.c;
  // leading nontoken drop (matrix.go:579-591)
  const bool lead = cons && c_cons - s.b - s.ft == 1 && nontok;
  // EOT after the consume/ε branch (matrix.go:593-605)
  const bool sflag1 = !flush && (sent || s.sflag);
  const bool tflag1 = !flush && s.tflag;
  const bool e_m = succ && s.eot;
  const bool sent2 = e_m && !sflag1;
  const bool rew = flush || e_m;  // a rewind (on success only)

  // the epilogue (matrix.go:637-697); its exit context keeps the flags
  // as they were (jax_engine.py:428-432, 494-495)
  const bool echase = eof && eps_here;  // chase a trailing ε
  const bool ebt = eof && !eps_here && s.eps_s != 0;  // back to a bound
  const bool efin = eof && !eps_here && s.eps_s == 0;  // flush, end
  const bool resid = efin && has_pending;
  const bool efin_sent = efin && (resid || !s.sflag);
  const bool efin_text = efin && (resid || !s.tflag);

  // events, always ordered token, sentence, text: the first now, the
  // rest through the 2-deep queue (one event per step per lane)
  const bool w_tok = flush || f3 || resid || bf;
  const bool w_sent = sent || sent2 || efin_sent || bs;
  const bool w_text = e_m || efin_text;
  const int32_t v_tok = pack(EV_TOKEN, s.b + s.ft, f3 ? c_f3 : s.c);
  const int32_t sent_pos = sent2 ? c_cons : s.c;
  const int32_t v_sent = pack(EV_SENT, sent_pos, sent_pos);
  const int32_t text_pos = e_m ? c_cons : s.c;
  const int32_t v_text = pack(EV_TEXT, text_pos, text_pos);
  const int32_t first =
      w_tok ? v_tok : (w_sent ? v_sent : (w_text ? v_text : 0));
  const int32_t second = (w_tok && w_sent)
                             ? v_sent
                             : ((w_tok || w_sent) && w_text ? v_text : 0);
  const int32_t third = (w_tok && w_sent && w_text) ? v_text : 0;
  const int32_t emit = drain ? s.pend : (running ? first : 0);
  s.pend = drain ? s.pend2 : (running ? second : s.pend);
  s.pend2 = drain ? 0 : (running ? third : s.pend2);

  // register updates (the paths are disjoint).  The fused step ends
  // where the three steps it stands for end: the token (or sentence
  // end) emitted above, a rewind to c (m_bf), the consume to c + 1 with
  // the leading-nontoken drop, the backtrack register at e where ε is
  // available there, the checkpoint e's context with both flags clear.
  const bool back = f2 || ebt;
  const bool f_nontok = (fraw & FIRSTBIT) != 0;
  const bool avail_e = (word & ST_EPS_AT_TGT) != 0;
  const int32_t t_new =
      bb ? (int32_t)(fraw & ~m.tag_mask & 0x7FFFFFFFu)
         : (f3 ? ROOT : (succ ? t_succ : s.t));
  const int32_t h_new =
      bb ? (int32_t)((fraw & m.tag_mask) >> HOT_SHIFT)
         : (f3 ? m.root_h : (succ ? h_succ : s.h));
  if (back) {
    s.t0 = s.eps_s;
    s.h0 = s.eps_h;
    if (kDA) s.bt0 = s.beps;
  } else if (echase) {
    s.t0 = s.t;
    s.h0 = s.h;
    if (kDA) s.bt0 = s.bt;
  }
  s.a = f1 ? m.unknown : ((back || f3 || echase) ? m.eps : s.a);
  const int32_t c_new =
      skip ? s.c + rl
           : (bb ? s.c + 1
                 : (back ? s.eps_o : (f3 ? c_f3 : (succ ? c_cons : s.c))));
  s.b = bf ? s.c : (f3 ? c_f3 : (rew ? c_cons : s.b));
  s.ft = bf ? (int32_t)f_nontok
            : (bs ? s.ft + f_nontok
                  : ((f3 || rew) ? 0 : (lead ? s.ft + 1 : s.ft)));
  if (back || f3 || rew) s.eps_s = 0;
  if (rew) s.eps_o = 0;
  if (bb) {
    s.eps_s = avail_e ? e : 0;
    s.eps_h = avail_e ? hot_index(m, e) : 0;
    s.eps_o = s.c;
  }
  s.newchar = bb || (!(f1 || back || echase) && (f3 || succ || s.newchar));
  s.eot = !(f1 || f2 || succ) && s.eot;
  s.sflag = bs || (!bf && !f3 && (succ ? (sflag1 || sent2) : s.sflag));
  s.tflag = !bf && !f3 && (succ ? (e_m || tflag1) : s.tflag);
  s.done = s.done || efin || cut;
  // checkpoint the context at rewinds (a later segment resumes there)
  if (f3 || rew) s.ckpt = ctx_of(t_new, s.sflag, s.tflag, s.ok);
  if (bf) s.ckpt = ctx_of(e, false, false, s.ok);
  if (kDA) s.bt = f3 ? m.root_b : (succ ? d.b_next : s.bt);
  s.t = t_new;
  s.h = h_new;
  // the word at the new cursor: kept, loaded ahead, or loaded now
  if (c_new != s.c) {
    s.mv = c_new == s.c + (skip ? rl : 1) ? mv_next : meta_at(row, c_new, L);
  }
  s.c = c_new;
  s.n_backtrack += f2 || bb;
  s.n_force += f3;
  return emit;
}

// Run one lane (its meta ``row`` of ``L`` words) to completion or to
// ``max_steps`` steps and write its outputs:
// events in step order to ev_row (capacity max_steps: at most one event
// per step), the count, bad, the state row (ctx, ckpt, b, c,
// n_backtrack, n_force) and the step count.  Returns its cold steps.
template <bool kFull, Layout kLayout>
DT_HD int32_t run_lane(const Model& m, const int32_t* row, int32_t L,
                       int32_t length, int32_t entry, bool stop,
                       int32_t max_steps, int32_t* ev_row, int32_t* count,
                       uint8_t* bad, int32_t* state_row, int32_t* steps) {
  Lane s;
  init_lane<kLayout>(s, m, row, L, entry, length, stop);
  int32_t n = 0, k = 0;
  while (k < max_steps && live(s)) {
    int32_t e = step<kFull, kLayout>(s, m, row, L);
    if (e != 0) ev_row[n++] = e;
    ++k;
  }
  *count = n;
  *bad = live(s) ? 1 : 0;
  state_row[0] = ctx_of(s.t, s.sflag, s.tflag, s.ok);
  state_row[1] = s.ckpt;
  state_row[2] = s.b;
  state_row[3] = s.c;
  state_row[4] = s.n_backtrack;
  state_row[5] = s.n_force;
  *steps = k;
  return s.n_cold;
}

}  // namespace dt
