"""The instructions of a kernel's inner loop, read from its SASS.

A kernel's operations bound needs the instructions each of its steps
issues.  ``cuobjdump -sass`` lists what ``nvcc`` made of the step;
:func:`loop_min_instructions` finds a function's largest innermost loop
(the step loop of K1) and counts the fewest instructions one pass
through it can issue: every path through the body's forward branches is
tried and the shortest taken, so the count is a lower bound for any
step.  Instructions that a false predicate turns off still issue and
count; ``NOP`` padding does not.  :func:`k1_bound` is K1's bound on a
launch: the larger of its bytes over the memory rate and those
instructions, a step each, over the card's issue rate.
"""

from __future__ import annotations

import os
import re
import shutil
import subprocess
from typing import List, NamedTuple, Optional, Tuple

_LINE = re.compile(
    r"/\*([0-9a-f]{4,})\*/\s+(@!?U?P[T0-9]+\s+)?([A-Z][A-Z0-9_.]*)([^;]*);")
_TARGET = re.compile(r"0x([0-9a-f]+)\s*$")


class Instr(NamedTuple):
    addr: int
    guarded: bool  # a guard predicate (@P0, @!P1, ...)
    op: str  # the opcode with its modifiers
    operands: str

    @property
    def is_branch(self) -> bool:
        return self.op.split(".")[0] == "BRA"

    @property
    def target(self) -> Optional[int]:
        m = _TARGET.search(self.operands) if self.is_branch else None
        return int(m.group(1), 16) if m else None

    @property
    def always_jumps(self) -> bool:
        """An unguarded branch with no condition operand (``BRA P1, x``
        falls through when P1 is false)."""
        return self.is_branch and not self.guarded and "," not in self.operands


def functions(sass: str) -> dict:
    """The instructions of each function in a ``cuobjdump -sass``
    listing, by (mangled) name."""
    out, name = {}, None
    for line in sass.splitlines():
        if "Function :" in line:
            name = line.split("Function :", 1)[1].strip()
            out[name] = []
            continue
        m = _LINE.search(line)
        if m and name is not None:
            out[name].append(Instr(int(m.group(1), 16), bool(m.group(2)),
                                   m.group(3), m.group(4).strip()))
    return out


def innermost_loops(code: List[Instr]) -> List[Tuple[int, int]]:
    """(head, latch) index pairs of the loops (a branch back to an
    earlier address) that hold no other loop."""
    at = {ins.addr: i for i, ins in enumerate(code)}
    loops = [(at[ins.target], j) for j, ins in enumerate(code)
             if ins.target is not None and ins.target <= ins.addr
             and ins.target in at]
    return [(h, j) for h, j in loops
            if not any((h2, j2) != (h, j) and h <= h2 and j2 <= j
                       for h2, j2 in loops)]


def min_path(code: List[Instr], head: int, latch: int) -> int:
    """The fewest instructions from ``head`` to ``latch`` (both counted)
    along fall-throughs and forward branches inside the body; branches
    that leave the body end no pass and are not followed."""
    at = {ins.addr: i for i, ins in enumerate(code)}
    inf = len(code) + 1
    dist = [inf] * (latch + 1)
    dist[head] = 0 if code[head].op == "NOP" else 1
    for i in range(head, latch):
        if dist[i] == inf:
            continue
        ins = code[i]
        nxt = []
        if not ins.always_jumps:
            nxt.append(i + 1)
        t = at.get(ins.target) if ins.target is not None else None
        if t is not None and i < t <= latch:
            nxt.append(t)
        for k in nxt:
            cost = dist[i] + (code[k].op != "NOP")
            if cost < dist[k]:
                dist[k] = cost
    if dist[latch] == inf:
        raise ValueError("the loop's latch cannot be reached from its head")
    return dist[latch]


def loop_min_instructions(sass: str, function: str) -> Tuple[int, int]:
    """``(fewest, static)`` instructions of one pass through the largest
    innermost loop of the function whose name contains ``function``:
    the shortest path's count and the body's length."""
    names = [n for n in functions(sass) if function in n]
    if len(names) != 1:
        raise ValueError(f"{len(names)} functions match {function!r}")
    code = functions(sass)[names[0]]
    loops = innermost_loops(code)
    if not loops:
        raise ValueError(f"{names[0]} has no loop")
    head, latch = max(loops, key=lambda hl: hl[1] - hl[0])
    static = sum(code[i].op != "NOP" for i in range(head, latch + 1))
    return min_path(code, head, latch), static


# K1's kernel template (csrc/transduce.cu): transduce_kernel<threads,
# full, dt::Layout>, the layout mangled as an enum literal (L...E)
_K1 = re.compile(r"transduce_kernelILi(\d+)ELb([01])EL\w*?6LayoutE([01])E")


def k1_instances(sass: str) -> dict:
    """K1's instantiations in a listing: ``{(threads, full, double_array):
    mangled name}`` (``full`` and ``double_array`` as bools)."""
    out = {}
    for name in functions(sass):
        m = _K1.search(name)
        if m:
            out[(int(m.group(1)), m.group(2) == "1", m.group(3) == "1")] = name
    if not out:
        raise ValueError("no instantiation of K1's kernel in the listing")
    return out


def k1_step_instructions(sass: str) -> dict:
    """``{k1_key: (fewest, static)}``: :func:`loop_min_instructions` of
    each of K1's instantiations in a listing."""
    return {k1_key(*key): loop_min_instructions(sass, name)
            for key, name in sorted(k1_instances(sass).items())}


def max_sm_clock_hz() -> float:
    """The card's top SM clock (``nvidia-smi``), in Hz."""
    return 1e6 * float(subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm",
         "--format=csv,noheader,nounits"], check=True,
        capture_output=True, text=True).stdout.split()[0])


def cuobjdump(lib_path: str) -> str:
    """``cuobjdump -sass`` of a built library (the CUDA toolkit's)."""
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    if not os.path.exists(tool):
        raise RuntimeError("cuobjdump not found")
    return subprocess.run([tool, "-sass", lib_path], check=True,
                          capture_output=True, text=True).stdout


# ---- K1's bound ---------------------------------------------------------------

HBM_BYTES_PER_S = 3.35e12  # H100 SXM memory rate (the data sheet)
# thread-instructions an SM issues a clock: 4 schedulers, one warp each
ISSUE_PER_SM_CLOCK = 4 * 32


def bound_ms(n_bytes):
    """The least time to move ``n_bytes`` at the card's memory rate."""
    return n_bytes / HBM_BYTES_PER_S * 1e3


def k1_key(threads, full, da):
    """The name of one instantiation of K1 in the printed numbers:
    block size / form / layout."""
    return (f"{threads}/{'full' if full else 'general'}/"
            f"{'da' if da else 'matrix'}")


def k1_kernel(B, n_sm, form="full", layout="matrix"):
    """The instantiation of K1 that a launch of B lanes runs
    (transduce.cu): its blocks take ceil(B / SMs) lanes rounded up to a
    warp, at most 1024, and up to 256 run the 256-thread kernel; a
    double array always runs the 256-thread one."""
    per_sm = -(-B // n_sm)
    small = min(-(-per_sm // 32) * 32, 1024) <= 256 or layout == "da"
    return k1_key(256 if small else 1024, form == "full", layout == "da")


def k1_bound(meta_args, res, n_states, step_instr, n_sm, clock_hz,
             n_words=0):
    """K1's bound on one launch: the larger of its bytes over the memory
    rate and its instructions over the issue rate.  Bytes: each input
    read once (the meta words of each lane's length, the lane vectors,
    one 4-byte cell of each of the ``n_states`` states whose row the
    walk reads, the full form's ``n_words`` per-state words) and each
    output written once (the events each lane wrote, the lane vectors
    and state rows, the two counts).
    Instructions: the lanes' steps times ``step_instr``, the fewest one
    pass of K1's step loop issues (its SASS), at 128 a clock on each of
    ``n_sm`` SMs at ``clock_hz``.  Returns (ms, "bytes" or "operations",
    bytes, bytes ms, steps, instructions ms)."""
    _meta, lengths, _entries, _stops = meta_args
    B = int(lengths.numel())
    n = (4 * int(lengths.sum()) + 9 * B + 4 * n_states + 4 * n_words
         + 4 * int(res[1].sum()) + (4 + 1 + 24 + 4) * B + 16)
    steps = int(res[4].long().sum())
    ops_ms = steps * step_instr / (n_sm * ISSUE_PER_SM_CLOCK * clock_hz) * 1e3
    b_ms = bound_ms(n)
    return (max(b_ms, ops_ms), "bytes" if b_ms >= ops_ms else "operations",
            n, b_ms, steps, ops_ms)
