"""The SASS reader that counts the instructions of K1's step loop
(``datok_tpu_torch.kernels.sass``), on small listings in the form
``cuobjdump -sass`` prints.  It is a host tool of the port with no
counterpart in the JAX package."""

import pytest

from datok_tpu_torch.kernels import sass as S


def _listing(name, body):
    lines = [f"\t\tFunction : {name}", "\t.headerflags\t@\"EF_CUDA_SM90\""]
    for i, ins in enumerate(body):
        lines.append(f"        /*{16 * i:04x}*/                   {ins} ;"
                     "      /* 0x000000000000794d */")
        lines.append("                                             "
                     "/* 0x000fea0003800000 */")
    return "\n".join(lines) + "\n"


# an outer loop (1..11) around an inner one (3..9) with a branch that
# skips three instructions, a loop exit and a predicated instruction
KERNEL = [
    "MOV R1, c[0x0][0x28]",            # 0
    "IMAD.MOV.U32 R2, RZ, RZ, RZ",     # 1 outer head
    "ISETP.GE.AND P0, PT, R2, R3, PT",  # 2
    "LDG.E R4, desc[UR4][R6.64]",      # 3 inner head
    "@P1 BRA P2, 0xc0",                # 4 leaves the loop
    "@P0 BRA 0x90",                    # 5 skips 6..8
    "IADD3 R4, R4, 0x1, RZ",           # 6
    "SEL R5, R4, RZ, P0",              # 7
    "@!P3 IMAD R5, R5, 0x3, RZ",       # 8 issues even when P3 holds
    "@!P0 BRA 0x30",                   # 9 inner latch
    "VIADD R2, R2, 0x1",               # 10
    "@P4 BRA 0x10",                    # 11 outer latch
    "EXIT",                            # 12
    "BRA 0xd0",                        # 13 the trap after EXIT
    "NOP",                             # 14
]


def test_functions_reads_every_instruction():
    text = _listing("_Z1kv", KERNEL) + _listing("_Z1gv", ["EXIT", "NOP"])
    fns = S.functions(text)
    assert list(fns) == ["_Z1kv", "_Z1gv"]
    code = fns["_Z1kv"]
    assert [c.addr for c in code] == [16 * i for i in range(len(KERNEL))]
    assert code[4].op == "BRA" and code[4].guarded and code[4].target == 0xc0
    assert not code[4].always_jumps  # BRA P2, x falls through on !P2
    assert code[13].always_jumps and code[13].target == 0xd0
    assert code[8].guarded and code[8].op == "IMAD" and code[8].target is None
    assert code[3].op == "LDG.E"


def test_innermost_loop_and_its_shortest_pass():
    code = S.functions(_listing("_Z1kv", KERNEL))["_Z1kv"]
    # the trap that ends every listing is a loop of one instruction
    assert S.innermost_loops(code) == [(3, 9), (13, 13)]
    # 3, 4, 5 then the branch to 9: four instructions; the exit at 4
    # ends no pass, so it does not shorten it
    assert S.min_path(code, 3, 9) == 4
    # the outer loop's body, with the inner loop passed once
    assert S.min_path(code, 1, 11) == 8
    assert S.loop_min_instructions(_listing("_Z1kv", KERNEL), "_Z1k") == (4, 7)


def test_the_largest_innermost_loop_is_taken():
    body = ["MOV R1, RZ", "IADD3 R1, R1, 0x1, RZ", "@P0 BRA 0x0",
            "MOV R2, RZ", "IADD3 R2, R2, 0x1, RZ", "NOP",
            "LOP3.LUT R2, R2, 0xff, RZ, 0xc0, !PT", "@P1 BRA 0x30", "EXIT"]
    # loops 0..2 and 3..7; NOP neither issues nor counts
    assert S.loop_min_instructions(_listing("_Z2kv", body), "_Z2k") == (4, 4)


def test_unconditional_branches_are_followed_only():
    body = ["MOV R1, RZ", "BRA 0x40", "IADD3 R1, R1, 0x1, RZ",
            "IADD3 R1, R1, 0x2, RZ", "@P0 BRA 0x0", "EXIT"]
    code = S.functions(_listing("_Z3kv", body))["_Z3kv"]
    assert S.min_path(code, 0, 4) == 3
    # a latch that no path reaches is an error, not a count
    body[1] = "BRA 0x50"
    code = S.functions(_listing("_Z3kv", body))["_Z3kv"]
    with pytest.raises(ValueError, match="cannot be reached"):
        S.min_path(code, 0, 4)


@pytest.mark.parametrize("name", ["_Z9missing", "_Z"])
def test_a_function_name_must_match_once(name):
    text = _listing("_Z1kv", KERNEL) + _listing("_Z1gv", ["EXIT"])
    with pytest.raises(ValueError, match="functions match"):
        S.loop_min_instructions(text, name)


def test_a_function_without_a_loop_is_refused():
    with pytest.raises(ValueError, match="has no loop"):
        S.loop_min_instructions(_listing("_Z1gv", ["MOV R1, RZ", "EXIT"]),
                                "_Z1g")


def test_k1_instances_by_template_arguments():
    """K1's instantiations are found by their template arguments: block
    size, form and layout (an enum literal in the mangled name)."""
    names = {
        (256, False, False): "_ZN12_GLOBAL__N_116transduce_kernelILi256ELb0E"
                             "LN2dt6LayoutE0EEEvN2dt5ModelEPK5uint4i",
        (1024, True, False): "_ZN12_GLOBAL__N_116transduce_kernelILi1024ELb1E"
                             "LN2dt6LayoutE0EEEvN2dt5ModelEPK5uint4i",
        (256, False, True): "_ZN12_GLOBAL__N_116transduce_kernelILi256ELb0E"
                            "LN2dt6LayoutE1EEEvN2dt5ModelEPK5uint4i",
    }
    text = "".join(_listing(n, ["EXIT"]) for n in names.values())
    assert S.k1_instances(text + _listing("_Z1kv", ["EXIT"])) == names
    with pytest.raises(ValueError, match="no instantiation"):
        S.k1_instances(_listing("_Z1kv", ["EXIT"]))


def test_k1_step_instructions_by_key():
    """Each instantiation's step loop, counted, under its printed key."""
    text = (_listing("_ZN12_GLOBAL__N_116transduce_kernelILi256ELb1E"
                     "LN2dt6LayoutE0EEEvN2dt5ModelEPK5uint4i", KERNEL)
            + _listing("_ZN12_GLOBAL__N_116transduce_kernelILi256ELb0E"
                       "LN2dt6LayoutE1EEEvN2dt5ModelEPK5uint4i", KERNEL[:3]
                       + ["@P0 BRA 0x10", "EXIT"]))
    assert S.k1_step_instructions(text) == {
        "256/general/da": (3, 3), "256/full/matrix": (4, 7)}


@pytest.mark.parametrize("B, n_sm, form, layout, want", [
    (32768, 132, "full", "matrix", "256/full/matrix"),  # 249 lanes an SM
    (65536, 132, "full", "matrix", "1024/full/matrix"),
    (200_000, 132, "general", "matrix", "1024/general/matrix"),
    (200_000, 132, "general", "da", "256/general/da"),  # always 256
    (33793, 132, "full", "matrix", "1024/full/matrix"),  # 257 rounds to 288
])
def test_k1_kernel_picks_the_launchs_instantiation(B, n_sm, form, layout, want):
    assert S.k1_kernel(B, n_sm, form, layout) == want


def test_k1_bound_counts_bytes_and_instructions():
    """Bytes: the meta of each lane's length, the lane vectors, a cell of
    each state read, the per-state words and the outputs written;
    instructions: the steps at 128 a clock on each SM."""
    import torch

    lengths = torch.tensor([10, 0, 6], dtype=torch.int32)
    res = (None, torch.tensor([3, 0, 2], dtype=torch.int32), None, None,
           torch.tensor([12, 1, 7], dtype=torch.int32))
    ms, by, n, b_ms, steps, ops_ms = S.k1_bound(
        (None, lengths, None, None), res, 5, 100, 2, 1e9, n_words=4)
    assert n == 4 * 16 + 9 * 3 + 4 * 5 + 4 * 4 + 4 * 5 + 33 * 3 + 16
    assert steps == 20 and by == "operations"
    assert ops_ms == pytest.approx(20 * 100 / (2 * 128 * 1e9) * 1e3)
    assert b_ms == pytest.approx(n / 3.35e12 * 1e3) == S.bound_ms(n)
    assert ms == max(ops_ms, b_ms)
