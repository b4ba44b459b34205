"""The kernels' bounds and the SASS cross-check of chip_smoke.py, on small
listings laid out as cuobjdump prints them; no GPU needed."""

import pathlib
import re

import pytest

import chip_smoke as cs

CSRC = (pathlib.Path(__file__).resolve().parents[1]
        / "onbody_tpu_torch" / "ops" / "csrc")

# two kernels: the unpaired grav3d executor (hex branch targets, an outer
# loop around a staging loop and an unrolled pair loop) and the vort2d RM
# direct kernel (label branch targets)
LISTING = """
\tcode for sm_90a
\t\tFunction : _ZN6onbody9exec_runsINS_6Grav3dELb0EEEvPKfS3_PfPKiS6_S6_iiii
        /*0000*/                   LDC R1, c[0x0][0x28] ;            /* 0x0 */
                                                                    /* 0x0 */
        /*0010*/                   MOV R2, RZ ;                       /* 0x0 */
        /*0020*/                   LDG.E.CONSTANT R4, desc[UR4][R2.64] ;
        /*0030*/                   STS [R15], R4 ;
        /*0040*/              @!P1 BRA 0x20 ;
        /*0050*/                   LDS R6, [R5] ;
        /*0060*/                   FADD R7, R6, -R8 ;
        /*0070*/                   FFMA R9, R7, R7, R10 ;
        /*0080*/                   MUFU.RSQ R11, R9 ;
        /*0090*/                   FMUL R12, R11, R11 ;
        /*00a0*/                   FFMA R13, R12, R7, R13 ;
        /*00b0*/                   MUFU.RSQ R14, R9 ;
        /*00c0*/                   FSEL R15, R14, R12, P0 ;
        /*00d0*/                   FFMA R13, R15, R7, R13 ;
        /*00e0*/               @P2 BRA 0x50 ;
        /*00f0*/                   IADD3 R1, R1, 0x1, RZ ;
        /*0100*/              @!P3 BRA 0x10 ;
        /*0110*/                   EXIT ;
\t\tFunction : _ZN6onbody13direct_kernelINS_6Vort2dINS_6CoreRmEEEEEvPKfS5_Pfii
        /*0000*/                   MOV R2, RZ ;
.L_x_3:
        /*0010*/                   FADD R3, R2, R4 ;
        /*0020*/                   MUFU.RCP R5, R3 ;
        /*0030*/                   FFMA R6, R5, R3, -1 ;
        /*0040*/                   FMUL R7, R6, R5 ;
        /*0050*/               @P0 BRA `(.L_x_3) ;
        /*0060*/                   BRA `(.L_x_4) ;
.L_x_4:
        /*0070*/                   EXIT ;
"""


def test_parse_finds_innermost_loops():
    loops = cs.sass_loops(LISTING)
    assert len(loops) == 2
    grav = [v for k, v in loops.items() if "Grav3d" in k][0]
    # the staging loop [0x20, 0x40] and the pair loop [0x50, 0xe0]; the
    # outer loop [0x10, 0x100] holds them and is not innermost
    assert grav == [["LDG.E.CONSTANT", "STS", "BRA"],
                    ["LDS", "FADD", "FFMA", "MUFU.RSQ", "FMUL", "FFMA",
                     "MUFU.RSQ", "FSEL", "FFMA", "BRA"]]
    vort = [v for k, v in loops.items() if "Vort2d" in k][0]
    assert vort == [["FADD", "MUFU.RCP", "FFMA", "FMUL", "BRA"]]


def test_per_pair_counts_and_bound():
    loops = cs.sass_loops(LISTING)
    # pair loop: 2 RSQ (2 pairs), FADD + 3 FFMA + FMUL = 5 FP32, 1 LDS
    assert cs.sass_issued(loops, "exec", "grav3d") == dict(
        fp32=2.5, mufu=1.0, lds=0.5, pairs_per_iter=2)
    assert cs.sass_issued(loops, "direct", "vort2d") == dict(
        fp32=3.0, mufu=1.0, lds=0.0, pairs_per_iter=1)
    # the bound reads the needed operations, never the issued ones:
    # grav3d's 12 FP32 at 128 lanes outweigh its 1 MUFU at 16
    t, pipe = cs.bound_s(1e12, "grav3d", 2e9)
    assert pipe == "fp32"
    assert t == pytest.approx(1e12 * 12 / (132 * 128 * 2e9))
    t, pipe = cs.bound_s(1e12, "vortgrad3d", 2e9)
    assert pipe == "fp32"
    assert t == pytest.approx(1e12 * 37 / (132 * 128 * 2e9))
    # vort2d's 8 FP32 and 1 MUFU take the same time on their pipes
    t, _ = cs.bound_s(1e12, "vort2d", 2e9)
    assert t == pytest.approx(1e12 / (132 * 16 * 2e9))


def test_function_name_is_exact_per_instantiation():
    loops = cs.sass_loops(LISTING)
    with pytest.raises(LookupError):
        cs.sass_issued(loops, "exec_t2", "grav3d")     # not listed
    with pytest.raises(LookupError):
        cs.sass_issued(loops, "direct", "vort3d")      # not listed
    assert cs.SASS_SIG.get("vort2d") == "MUFU.RCP"
    assert set(cs.SASS_BODY) == set(cs.PAIR_OPS) == set(cs.WORKLOADS)


@pytest.mark.parametrize("name", ["grav3d", "vort3d", "vortgrad3d",
                                  "vort2d"])
def test_needed_ops_match_body_header(name):
    """The bound's per-pair operations are the count derived in the
    body's header."""
    text = (CSRC / f"{name}_body.cuh").read_text()
    m = re.search(r"needs[\s/]+(\d+)[\s/]+FP32-pipe[\s/]+operations"
                  r"[\s/]+and[\s/]+(\d+)[\s/]+MUFU", text)
    assert m is not None
    assert (int(m.group(1)), int(m.group(2))) == cs.PAIR_OPS[name]


def test_other_instructions_per_pair():
    """sass_other: every instruction of the pair loop per pair, and those
    that are not FP32, MUFU or LDS (the branches, checks and calls an
    IEEE operation adds) by opcode."""
    loops = cs.sass_loops(LISTING)
    assert cs.sass_other(loops, "exec", "grav3d") == {
        "all": 5.0, "FSEL": 0.5, "BRA": 0.5}
    assert cs.sass_other(loops, "direct", "vort2d") == {"all": 5.0,
                                                        "BRA": 1.0}


def test_every_kernel_kind_has_a_sass_name():
    """sass_report walks every kind with a pair loop (all of
    cuda_lib.KINDS but K8/K9's, K4's and K4-f64's reductions): each names
    its template (the fp64 kernels in SASS_KIND64), and the segment
    kernels on pre-gathered sources (exec_pre_segs) are told apart from
    the id-fetching executors (exec_runs)."""
    from onbody_tpu_torch.ops import cuda_lib
    assert set(cs.SASS_KIND) == set(cuda_lib.KINDS) - {
        "exec_pre_reduce", "direct_reduce"} - set(cuda_lib.F64_KINDS)
    assert set(cs.SASS_KIND64) == set(cuda_lib.F64_KINDS) - {
        "direct64_reduce"}
    assert set(cs.SASS_BODY64) == set(cs.WORKLOADS)
    assert set(cs.SOURCE) == set(cs.REPLACES) == set(cuda_lib.KINDS)
    pre = LISTING.replace("9exec_runsINS_6Grav3dELb0EEEvPKfS3_PfPKiS6_S6_",
                          "13exec_pre_segsINS_6Grav3dELb0EEEvPKfS3_PfS4_"
                          "PKiS6_S6_S6_S6_S6_iiii")
    loops = cs.sass_loops(pre)
    got = cs.sass_issued(loops, "exec_pre_seg", "grav3d")
    assert got["pairs_per_iter"] == 2
    with pytest.raises(LookupError):
        cs.sass_issued(loops, "exec", "grav3d")
    with pytest.raises(LookupError):
        cs.sass_issued(loops, "exec_pre_t2_seg", "grav3d")


@pytest.mark.parametrize("mode", ["dma", "d2", "norsqrt", "full"])
def test_ablate_ops_match_body_header(mode):
    """K13's bounds read the per-pair operations counted in
    grav3d_ablate_body.cuh for each mode."""
    text = (CSRC / "grav3d_ablate_body.cuh").read_text()
    m = re.search(rf"{mode}:\s+needs\s+(\d+)\s+FP32-pipe\s+operations\s+"
                  rf"and\s+(\d+)\s+MUFU", text)
    assert m is not None
    assert ((int(m.group(1)), int(m.group(2)))
            == cs.ABLATE_OPS[f"ablate_{mode}"])
    assert set(cs.ABLATE_BODY) == {"dma", "d2", "norsqrt", "full"}


def _ablate_listing(lds_in_dma: bool) -> str:
    """Four K13 functions as cuobjdump prints them: a pair loop for the
    arithmetic modes, the dma body's lane loads in its block loop."""
    out = ["\tcode for sm_90a"]
    for body in cs.ABLATE_BODY.values():
        out.append(f"\t\tFunction : _ZN6onbody15exec_fetch_runsINS_{body}"
                   "ELb0EEEvPKfS3_PfPKiS6_S6_iiiii")
        ops = ["LDS R6, [R5]", "FADD R7, R6, -R8", "FFMA R9, R7, R7, R9"]
        if "Dma" in body and not lds_in_dma:
            ops = ["FADD R7, R6, -R8"]
        for i, op in enumerate(ops + ["@P2 BRA 0x0"]):
            out.append(f"        /*{i * 16:04x}*/                   {op} ;")
        out.append(f"        /*{len(ops) * 16 + 16:04x}*/  EXIT ;")
    return "\n".join(out) + "\n"


def test_sass_ablate_reports_and_checks_shared_loads(capsys):
    cs.sass_ablate(_ablate_listing(True))
    text = capsys.readouterr().out
    assert text.count("sass exec_ablate_") == 4
    assert "needed per pair 12 FP32 + 1 MUFU" in text
    with pytest.raises(AssertionError, match="no shared loads"):
        cs.sass_ablate(_ablate_listing(False))


def test_ablate_bound_is_bytes_for_dma():
    t, pipe = cs.bound_s(1e12, "ablate_dma", 2e9)
    assert t == 0.0
    b = cs._bound("ablate_dma", 1e12, 3.35e9, 2e9)
    assert b["bound_by"] == "bytes" and b["bound_ms"] == pytest.approx(1.0)
    t, pipe = cs.bound_s(1e12, "ablate_norsqrt", 2e9)
    assert pipe == "fp32"
    assert t == pytest.approx(1e12 * 10 / (132 * 128 * 2e9))
    assert cs.bound_s(1e12, "ablate_full", 2e9) == cs.bound_s(1e12,
                                                              "grav3d", 2e9)


def test_kernel_sass_compares_code_not_label_numbers():
    """--parent's gate applies where the parent's compiled kernel differs:
    the same instructions compare equal under other label numbers (a
    listing numbers them across the whole library), another instruction
    does not."""
    same = cs._kernel_sass(LISTING, "direct", "vort2d")
    renumbered = LISTING.replace(".L_x_3", ".L_x_13").replace(".L_x_4",
                                                              ".L_x_7")
    assert cs._kernel_sass(renumbered, "direct", "vort2d") == same
    assert [op for op, _ in same] == ["MOV", "FADD", "MUFU.RCP", "FFMA",
                                      "FMUL", "BRA", "BRA", "EXIT"]
    other = LISTING.replace("FMUL R7, R6, R5", "FADD R7, R6, R5")
    assert cs._kernel_sass(other, "direct", "vort2d") != same
    assert cs._kernel_sass(other, "exec", "grav3d") == cs._kernel_sass(
        LISTING, "exec", "grav3d")
    with pytest.raises(LookupError):
        cs._kernel_sass(LISTING, "exec_t2", "grav3d")


@pytest.mark.parametrize("name", ["vort3d", "vortgrad3d", "vort2d"])
def test_exp_ops_match_body_header(name):
    """The exp core's bounds read the per-pair operations counted for it
    in each vortex body's header."""
    text = (CSRC / f"{name}_body.cuh").read_text()
    m = re.search(r"exponential core.*?needs[\s/]+(\d+)[\s/]+FP32-pipe"
                  r"[\s/]+operations[\s/]+and[\s/]+(\d+)[\s/]+MUFU",
                  text, re.S)
    assert m is not None
    assert ((int(m.group(1)), int(m.group(2)))
            == cs.PAIR_OPS_EXP[f"{name}_exp"])


def test_v2_ops_match_body_header():
    """K6-v2's bound reads the per-pair operations counted for the
    Vatistas core in vort3d_body.cuh."""
    text = (CSRC / "vort3d_body.cuh").read_text()
    m = re.search(r"Vatistas core.*?needs[\s/]+(\d+)[\s/]+FP32-pipe"
                  r"[\s/]+operations[\s/]+and[\s/]+(\d+)[\s/]+MUFU",
                  text, re.S)
    assert m is not None
    assert (int(m.group(1)), int(m.group(2))) == cs.PAIR_OPS_V2["vort3d_v2"]


@pytest.mark.parametrize("name", ["grav3d", "vort3d", "vortgrad3d",
                                  "vort2d"])
def test_f64_ops_match_body_header(name):
    """K1-f64's and K4-f64's bounds read the per-pair FP64 operations
    listed in body64.cuh: the fp32 count plus the refinement's 5 (the
    double rsqrt) or 3 (vort2d's double reciprocal)."""
    text = (CSRC / "body64.cuh").read_text()
    m = re.search(rf"//\s+{name}\s+(\d+) FP64-pipe operations and (\d+) "
                  r"MUFU", text)
    assert m is not None
    assert (int(m.group(1)), int(m.group(2))) == cs.PAIR_OPS64[name]
    newton = cs.F64_NEWTON["rcp" if name == "vort2d" else "rsqrt"]
    assert cs.PAIR_OPS64[name][0] == cs.PAIR_OPS[name][0] + newton


def test_f64_and_v2_bounds():
    """The fp64 bodies are bound on the FP64 pipe (64 lanes an SM), K6-v2
    on the FP32 pipe with its own count."""
    t, pipe = cs.bound_s(1e12, "grav3d_f64", 2e9)
    assert pipe == "fp64"
    assert t == pytest.approx(1e12 * 17 / (132 * 64 * 2e9))
    t, pipe = cs.bound_s(1e12, "vort3d_v2", 2e9)
    assert pipe == "fp32"
    assert t == pytest.approx(1e12 * 18 / (132 * 128 * 2e9))
    assert cs.bound_name("vort3d", "v2") == "vort3d_v2"
    assert cs.bound_name("vort2d", f64=True) == "vort2d_f64"
    assert cs.bound_name("grav3d") == "grav3d"
    # the exp core's counts; the fp64 exp and v2 cores' (PAIR_OPS64_CORES)
    assert cs.bound_name("vortgrad3d", "exp") == "vortgrad3d_exp"
    assert cs.bound_name("vort3d", "exp", f64=True) == "vort3d_exp_f64"
    assert cs.bound_name("vort3d", "v2", f64=True) == "vort3d_v2_f64"
    assert cs.bound_name("vort2d", "v2", f64=True) is None
    t, pipe = cs.bound_s(1e12, "vortgrad3d_exp_f64", 2e9)
    assert pipe == "fp64"
    assert t == pytest.approx(1e12 * 70 / (132 * 64 * 2e9))
    # every fp64 instantiation of an exp or v2 core has a bound
    assert {f"{k}_{c}" for k, c in cs.cuda_lib.INSTANCE_CORES
            if c != "rm"} == set(cs.PAIR_OPS64_CORES) == set(
        cs.SASS_BODY64_CORES)
    t, pipe = cs.bound_s(1e12, "vort3d_exp", 2e9)
    assert pipe == "fp32"
    assert t == pytest.approx(1e12 * 29 / (132 * 128 * 2e9))
    # vort2d's exp core: 3 MUFU at 16 lanes outweigh 21 FP32 at 128
    t, pipe = cs.bound_s(1e12, "vort2d_exp", 2e9)
    assert pipe == "mufu"
    assert t == pytest.approx(1e12 * 3 / (132 * 16 * 2e9))


def test_f64_core_ops_match_body_header():
    """The fp64 exp and v2 cores' bounds count the pair's arithmetic plus
    the cheapest forms of the double operations it calls (F64_FUNCS), as
    body64.cuh's header lists them, and stay below what the library's
    forms issue (LIBRARY_OPS64_CORES)."""
    text = (CSRC / "body64.cuh").read_text()
    m = re.search(r"//\s+vort3d exp (\d+), vortgrad3d exp (\d+), vort2d exp "
                  r"(\d+), vort3d v2 (\d+)\s*//\s*FP64-pipe operations and "
                  r"(\d+), (\d+), (\d+), (\d+) MUFU", text)
    assert m is not None
    keys = ("vort3d_exp", "vortgrad3d_exp", "vort2d_exp", "vort3d_v2")
    got = [int(g) for g in m.groups()]
    assert {k: (got[i], got[4 + i]) for i, k in enumerate(keys)} \
        == cs.PAIR_OPS64_CORES
    assert cs.F64_FUNCS["sqrt"][0] == cs.F64_FUNCS["rsqrt"][0] + 1
    assert cs.F64_FUNCS["div"][0] == cs.F64_FUNCS["rcp"][0] + 1
    assert set(cs.LIBRARY_OPS64_CORES) == set(cs.PAIR_OPS64_CORES)
    for k, (ops, _) in cs.PAIR_OPS64_CORES.items():
        assert ops < cs.LIBRARY_OPS64_CORES[k]


def test_per_pair_counts_fp64_and_v2_loops():
    """_per_pair on an fp64 pair loop (DFMA/DMUL/DADD per MUFU.RSQ64H)
    and on a v2 loop (two MUFU.RSQ a pair)."""
    listing = LISTING.replace(
        "9exec_runsINS_6Grav3dELb0EEEvPKfS3_PfPKiS6_S6_",
        "11exec64_runsINS_9Grav3dF64EEEvPKdS3_PdPKiS6_S6_").replace(
        "FADD", "DADD").replace("FFMA", "DFMA").replace(
        "FMUL", "DMUL").replace("MUFU.RSQ", "MUFU.RSQ64H")
    loops = cs.sass_loops(listing)
    got = cs._per_pair(loops, cs.SASS_KIND64["exec64"]
                       + cs.SASS_BODY64["grav3d"], "MUFU.RSQ64H", 1,
                       cs.FP64_OPS)
    assert got["pairs_per_iter"] == 2
    assert got["ops"] == 2.5 and got["mufu"] == 1.0
    v2 = LISTING.replace("6Grav3dE", "6Vort3dINS_6CoreV2EEE")
    got = cs._per_pair(cs.sass_loops(v2), cs.SASS_KIND["exec"]
                       + ("6Vort3d", "6CoreV2"), "MUFU.RSQ", 2,
                       cs.FP32_OPS)
    assert got["pairs_per_iter"] == 1 and got["mufu"] == 2.0


# a pair loop with an IEEE division's slow path: the check of the
# quotient (FCHK), a test and jump around the call, the call, and the
# convergence barrier around them, as a correctly rounded 1.f / x
# compiles without -ftz
SLOW_PATH = ["FCHK P0, R7, R3", "BSSY B0, `(.L_x_5)",
             "@!P0 BRA `(.L_x_6)", "CALL.REL.NOINC `(.L_x_9)", "BSYNC B0"]
# the exp core's pair but its FP32 work and its compares and selects: its
# square root, reciprocal and expf's EX2 and exponent
EXP_REST = ["MUFU.SQRT R10, R5", "MUFU.RCP R11, R5", "MUFU.EX2 R12, R5",
            "SHF.L.U32 R13, R13, 0x17, RZ"]


def _exp_selects(n: int) -> list:
    """n compares and selects: a guard, the thresholds' compares, the
    close branch's select."""
    return (["FMNMX R5, R5, R6", "FSEL R7, R8, R9, P0"]
            + ["FSETP.GT P0, R5, 16"] * (n - 2))


FAST_BODIES = {"vort2d": ("6Vort2dINS_6CoreRmEE",
                          ["FADD R3, R2, -R4", "FADD R5, R6, -R7",
                           "FADD R8, R9, R10", "FFMA R11, R3, R3, R8",
                           "FFMA R11, R5, R5, R11", "MUFU.RCP R12, R11",
                           "FMUL R12, R13, R12",
                           "FFMA R14, -R12, R5, R14",
                           "FFMA R15, R12, R3, R15"]),
               "vort3d_v2": ("6Vort3dINS_6CoreV2EE",
                             ["FADD R3, R2, -R4"] * 3
                             + ["FMUL R5, R3, R3", "FFMA R5, R3, R3, R5",
                                "FFMA R5, R3, R3, R5",
                                "FFMA R6, R5, R5, R7", "FMNMX R6, R6, 1e-30",
                                "MUFU.RSQ R8, R6", "MUFU.SQRT R9, R8",
                                "FMUL R8, R8, R9"]
                             + ["FMUL R10, R3, R3", "FFMA R10, R3, R3, R10"]
                             * 3 + ["FFMA R11, R8, R10, R11"] * 3),
               # the exp core: FP32 work, its selects, and expf's EX2 once
               **{f"{k}_exp": (f"{n}INS_7CoreExpEE",
                               ["FADD R3, R2, -R4"] * f + _exp_selects(sel)
                               + EXP_REST)
                  for k, n, f, sel in (("vort3d", "6Vort3d", 24, 5),
                                       ("vortgrad3d", "10Vortgrad3d", 50, 6),
                                       ("vort2d", "6Vort2d", 17, 4))}}
# K1-f64's and K4-f64's RM pair loops: their FP64 work and the MUFU once
# a pair
FAST_F64 = {"grav3d": ("9Grav3dF64E", "MUFU.RSQ64H", 17),
            "vort3d": ("9Vort3dF64INS_9CoreRmF64EEE", "MUFU.RSQ64H", 22),
            "vortgrad3d": ("13Vortgrad3dF64INS_9CoreRmF64EEE",
                           "MUFU.RSQ64H", 42),
            "vort2d": ("9Vort2dF64INS_9CoreRmF64EEE", "MUFU.RCP64H", 11)}


def _fast_function(name: str, loop) -> list:
    """One function as cuobjdump prints it: a loop of `loop`."""
    out = [f"\t\tFunction : {name}",
           "        /*0000*/                   MOV R2, RZ ;", ".L_x_3:"]
    for i, op in enumerate(loop + ["@P1 BRA `(.L_x_3)", "EXIT"]):
        out.append(f"        /*{(i + 1) * 16:04x}*/                   {op} ;")
    return out


def _fast_listing(slow=()) -> str:
    """One function per pair-loop template (SASS_KIND) of K5, K6-v2 and
    the exp cores, and K1-f64 and K4-f64 of each RM body, as cuobjdump
    prints them, each a loop of one pair; the (template fragments, key)
    pairs in `slow` (("exec64" or "direct64", workload) for the fp64
    kernels) carry SLOW_PATH in their loop."""
    out = ["\tcode for sm_90a"]
    for frag in sorted(set(cs.SASS_KIND.values())):
        for key, (body, ops) in FAST_BODIES.items():
            tail = frag[1] if len(frag) > 1 else "E"
            loop = ops + (SLOW_PATH if (frag, key) in slow else [])
            out += _fast_function(f"_ZN6onbody{frag[0]}INS_{body}{tail}"
                                  "EvPKfS3_Pfii", loop)
    for name, (body, sig, n) in FAST_F64.items():
        loop = ["DFMA R4, R2, R2, R4"] * n + [f"{sig} R5, R4"]
        out += _fast_function(
            f"_ZN6onbody11exec64_runsINS_{body}EEvPKdS3_PdPKiS6_S6_S6_iiii",
            loop + (SLOW_PATH if ("exec64", name) in slow else []))
        out += _fast_function(
            f"_ZN6onbody15direct64_kernelINS_{body}ELi128ELi512EEEvPKdS3_"
            "Pdiii", loop + (SLOW_PATH if ("direct64", name) in slow
                             else []))
    return "\n".join(out) + "\n"


def test_fast_cores_pair_loops_have_no_slow_path():
    """sass_fast / check_fast: every pair loop of K5 (vort2d, RM), K6-v2
    (vort3d, v2) and the exp cores read per kind, and K1-f64's and
    K4-f64's of each RM body; one with a division's slow path (a call and
    the jump around it, beside the back edge), more FP32 a pair than
    FAST_FP32 (FP64 than PAIR_OPS64), or fewer FP32 (FP64) or compares
    and selects than the bound counts as needed fails the check."""
    fast = cs.sass_fast(cs.sass_loops(_fast_listing()))
    assert set(fast) == {(k, key) for k in cs.SASS_KIND
                         for key in FAST_BODIES} | {
        (k, f"{name}_f64") for k in ("exec64", "direct64")
        for name in FAST_F64}
    fp32 = {"vort2d": 8.0, "vort3d_v2": 17.0, "vort3d_exp": 24.0,
            "vortgrad3d_exp": 50.0, "vort2d_exp": 17.0}
    selects = {"vort2d": 0.0, "vort3d_v2": 1.0, "vort3d_exp": 5.0,
               "vortgrad3d_exp": 6.0, "vort2d_exp": 4.0}
    for (kind, key), c in fast.items():
        assert c["branches"] == {}
        if kind in ("exec64", "direct64"):
            assert c["fp64"] == FAST_F64[key[:-4]][2] and c["mufu"] == 1.0
            continue
        # K6-v2's guard is an FMNMX, not an FP32 instruction
        assert c["fp32"] == fp32[key] and c["selects"] == selects[key]
        assert c["mufu"] == {"vort2d": 1.0, "vort3d_v2": 2.0}.get(key, 3.0)
    cs.check_fast(fast)
    slow = cs.sass_fast(cs.sass_loops(_fast_listing({("exec64",
                                                      "vort2d")})))
    assert slow[("exec64", "vort2d_f64")]["branches"] == {"BRA": 1,
                                                           "CALL": 1}
    with pytest.raises(AssertionError, match="exec64 vort2d_f64"):
        cs.check_fast(slow)
    # K4-f64's loop: a slow path, or FP64 a pair off the count, fails
    slow = cs.sass_fast(cs.sass_loops(_fast_listing({("direct64",
                                                      "grav3d")})))
    assert slow[("direct64", "grav3d_f64")]["branches"] == {"BRA": 1,
                                                             "CALL": 1}
    assert slow[("exec64", "grav3d_f64")]["branches"] == {}
    with pytest.raises(AssertionError, match="direct64 grav3d_f64"):
        cs.check_fast(slow)
    for fp64 in (41.0, 43.0):
        off = dict(fast)
        off[("direct64", "vortgrad3d_f64")] = dict(
            fast[("direct64", "vortgrad3d_f64")], fp64=fp64)
        with pytest.raises(AssertionError, match="direct64 vortgrad3d_f64"):
            cs.check_fast(off)
    more = dict(fast)
    more[("exec64", "grav3d_f64")] = dict(fast[("exec64", "grav3d_f64")],
                                          fp64=18.0)
    with pytest.raises(AssertionError, match="exec64 grav3d_f64"):
        cs.check_fast(more)
    k4 = (cs.SASS_KIND["direct"], "vort2d")
    slow = cs.sass_fast(cs.sass_loops(_fast_listing({k4})))
    assert slow[("direct", "vort2d")]["branches"] == {"BRA": 1, "CALL": 1}
    assert slow[("exec", "vort2d")]["branches"] == {}
    with pytest.raises(AssertionError, match="direct vort2d"):
        cs.check_fast(slow)
    more = dict(fast)
    more[("exec_t2", "vort3d_v2")] = dict(fast[("exec_t2", "vort3d_v2")],
                                          fp32=21.0)
    with pytest.raises(AssertionError, match="exec_t2 vort3d_v2"):
        cs.check_fast(more)
    # a loop that issues less than its bound counts as needed fails: the
    # count would be too high
    for field, value in (("fp32", 23.0), ("selects", 4.0)):
        fewer = dict(fast)
        fewer[("exec", "vort3d_exp")] = dict(fast[("exec", "vort3d_exp")],
                                             **{field: value})
        with pytest.raises(AssertionError, match="exec vort3d_exp"):
            cs.check_fast(fewer)
    fewer = dict(fast)
    fewer[("exec64", "vort3d_f64")] = dict(fast[("exec64", "vort3d_f64")],
                                           fp64=21.0)
    with pytest.raises(AssertionError, match="exec64 vort3d_f64"):
        cs.check_fast(fewer)
    # the back edge alone is no slow path; a branch before it is
    assert cs.loop_branches(["FADD", "MUFU.RCP", "BRA"]) == {}
    assert cs.loop_branches(["FADD", "BRA.U", "FMUL", "BRA"]) == {"BRA": 1}
    need = {**cs.PAIR_OPS, **cs.PAIR_OPS_V2, **cs.PAIR_OPS_EXP}
    assert all(cs.FAST_FP32[k] >= need[k][0] - cs.PAIR_SELECTS.get(k, 0)
               for k in cs.FAST_FP32)


def test_sass_changed_names_the_functions_that_differ():
    """sass_changed (--parent's list of the functions whose SASS differs
    from the parent's): label numbers alone are no change; another
    instruction, or a function the parent lacks, is."""
    renumbered = LISTING.replace(".L_x_3", ".L_x_13").replace(".L_x_4",
                                                              ".L_x_7")
    assert cs.sass_changed(LISTING, renumbered) == []
    other = LISTING.replace("FMUL R7, R6, R5", "FADD R7, R6, R5")
    vort = [f for f in cs._sass_functions(LISTING) if "Vort2d" in f]
    assert cs.sass_changed(LISTING, other) == vort
    grav_only = LISTING[:LISTING.index("\t\tFunction : _ZN6onbody13direct")]
    assert cs.sass_changed(grav_only, LISTING) == vort


def test_parent_tree_times_and_gates_only_changed_kernels(monkeypatch,
                                                          capsys):
    """--parent: ParentTree.for_kernel keeps the parent for a kernel whose
    SASS differs from this tree's and drops it (logged once) where it is
    the same; the gate records a slower kernel only where the SASS
    differs."""
    tree = object.__new__(cs.ParentTree)
    tree.sass, tree.sass_kind = LISTING, dict(cs.SASS_KIND)
    tree.untimed, tree.slower = set(), []
    other = LISTING.replace("FMUL R7, R6, R5", "FADD R7, R6, R5")
    monkeypatch.setattr(cs, "_sass_text", lambda lib: other)
    assert tree.for_kernel("direct", "vort2d") is tree
    assert tree.for_kernel("exec", "grav3d") is None
    assert tree.for_kernel("exec", "grav3d") is None
    assert capsys.readouterr().out.count("not timed in turns") == 1
    tree.gate("direct", "vort2d", "K4", [2.0, 2.1], [1.9, 2.0])
    tree.gate("exec", "grav3d", "K1", [2.0, 2.1], [1.0, 1.0])
    tree.gate("direct", "vort2d", "K4 faster", [1.0, 1.1], [1.9, 2.0])
    assert tree.slower == ["K4"]


def test_parent_turns_take_rounds():
    """ParentTree.turns: `rounds` rounds of parent, this, this, parent,
    each time the median of its reps; the parent's output from its first
    call."""
    tree = object.__new__(cs.ParentTree)
    calls = []

    def times(name, reps, op="direct", **extra):
        calls.append("parent")
        return [float(len(calls))] * reps, f"out{len(calls)}", None

    def mine():
        calls.append("this")
        return [0.5, 0.25, 0.75]
    tree.times = times
    p_ms, this, out = tree.turns("grav3d", "direct_reduce", mine, 3,
                                 rounds=2)
    assert calls == ["parent", "this", "this", "parent"] * 2
    assert p_ms == [1.0, 4.0, 5.0, 8.0]
    assert this == [0.5] * 4 and out == "out1"
    assert tree.turns("grav3d", "direct", mine, 3)[0] == [9.0, 12.0]


def test_split_reduce_sass_and_parent_gate(monkeypatch, capsys):
    """K4's and K4-f64's reduction (split_reduce on floats or doubles, one
    function per scalar type and vector width, not per body): found by
    its scalar type; a parent without it, or with other code, differs,
    so --parent times and gates it; the same code does not."""
    def red(name, t, v, op):
        return _fast_function(f"_ZN6onbody{name}I{t}Li{v}ELi128EEEvPT_PKS1_"
                              "liii", [op, "LDS.128 R4, [R2]"])
    def listing_of(stream_op):
        return "\n".join(
            ["\tcode for sm_90a"] + red("12split_reduce", "f", 4, "FADD R5")
            + red("12split_reduce", "f", 1, "FADD R5")
            + red("19split_reduce_stream", "f", 4, stream_op)
            + red("12split_reduce", "d", 2, "DADD R6")) + "\n"
    listing = listing_of("FADD R5")
    floats = cs._split_reduce_sass(listing, "direct_reduce")
    assert [f for f, _ in floats] == sorted(
        f for f in cs._sass_functions(listing) if "IfLi" in f)
    assert len(floats) == 3
    assert len(cs._split_reduce_sass(listing, "direct64_reduce")) == 1
    with pytest.raises(LookupError):
        cs._split_reduce_sass(LISTING, "direct_reduce")
    tree = object.__new__(cs.ParentTree)
    tree.sass_kind, tree.untimed, tree.slower = dict(cs.SASS_KIND), set(), []
    monkeypatch.setattr(cs, "_sass_text", lambda lib: listing)
    for parent, differs in ((LISTING, True), (listing, False), (
            listing.replace("DADD R6", "DMUL R6"), True)):
        tree.sass = parent
        assert tree.same_kernel("direct64_reduce", "grav3d") is not differs
    # a change in the streaming pass alone is a change
    tree.sass = listing_of("FMUL R5")
    assert not tree.same_kernel("direct_reduce", "grav3d")
    assert tree.same_kernel("direct64_reduce", "grav3d")
    tree.sass = LISTING
    assert tree.for_kernel("direct_reduce", "vort2d") is tree
    tree.gate("direct_reduce", "vort2d", "reduce", [0.011], [0.010])
    assert tree.slower == ["reduce"]
