"""Count the SASS instructions of the sphere- and quad-candidate loops in
the kernel library.

    python -m raytracer_tpu_torch.utils.sass_loop [--out out/sass] [--csrc DIR]

Builds the library as ops/build.py does (or reuses it), disassembles it with
`cuobjdump -sass`, and in every kernel finds the innermost loops that test
candidates: a backward branch whose body holds a table load (LDG or LDS)
and, in the body or in an out-of-line block a branch of the body reaches,
MUFU.RSQ (the reciprocal-root step of the IEEE square root, once per sphere
candidate: a "sphere" loop) or MUFU.RCP (the reciprocal step of the IEEE
division, once per quad candidate: a "quad" loop). For each such loop it
reports its static instructions, the candidates per trip (those MUFU
counts), instructions per candidate, the subroutine calls and convergence
barriers (BSSY/BSYNC) inside it, each branch that leaves it with the
length of the out-of-line block it reaches (the slow paths of the root and
the division sit in such blocks or in called subroutines), and the
instructions a trip issues when its group skips everything it can: the
shortest way through the body that takes one forward branch within it
(`skip_path`). Static counts: a path the data never takes costs nothing,
so the slow paths are reported beside the loop, not in it. Prints one JSON
line; with --out also writes each kernel's SASS there.

With --marble it also compiles a probe of csrc/textures.cuh's marble
(`marble_probe`: one kernel that fills the Perlin tables, syncs its block
and evaluates one octave of perlin_noise, one that evaluates the whole
7-octave marble) with the library's flags and counts the SASS instructions
after the block barrier by class (FP32, integer, conversions, MUFU,
shared and global loads, other), and per lattice corner (an octave's
instructions over its 8 corners), with ptxas's registers.
"""

from __future__ import annotations

import argparse
import json
import re
import subprocess
from pathlib import Path

_INSTR = re.compile(r"/\*([0-9a-f]{4,})\*/\s+(.*?)\s*;")
_LABEL = re.compile(r"^\s*([.$][\w.$]+):\s*$")
# A branch or call target: a label, or an absolute address (newer cuobjdump).
_TARGET = re.compile(r"`\(([^)]+)\)|\b(0x[0-9a-f]+)\b")
_FUNC = re.compile(r"Function\s*:\s*(\S+)")


def parse_functions(sass: str) -> dict[str, tuple[list, dict]]:
    """{mangled name: (instructions [(address, text)], labels {name or
    address: index of the instruction it marks})} of a cuobjdump -sass
    listing."""
    funcs, name = {}, None
    for line in sass.splitlines():
        m = _FUNC.search(line)
        if m:
            name = m.group(1)
            funcs[name] = ([], {})
            continue
        if name is None:
            continue
        instrs, labels = funcs[name]
        m = _LABEL.match(line)
        if m:
            labels[m.group(1)] = len(instrs)
            continue
        m = _INSTR.search(line)
        if m:
            addr = int(m.group(1), 16)
            labels[hex(addr)] = len(instrs)
            instrs.append((addr, m.group(2).strip()))
    return funcs


def _target(text: str):
    """The label or address a branch or call names (None if none)."""
    if not _opcode(text).startswith(("BRA", "CALL")):
        return None
    m = _TARGET.search(text)
    if not m:
        return None
    return m.group(1) if m.group(1) else hex(int(m.group(2), 16))


def _opcode(text: str) -> str:
    parts = text.split()
    if parts and parts[0].startswith("@"):
        parts = parts[1:]
    return parts[0] if parts else ""


def _block(instrs, labels, start: int) -> dict:
    """The out-of-line block at `start`, up to the first unconditional BRA,
    RET or EXIT: its instructions, the length of each subroutine it calls
    (up to its RET), and its MUFU reciprocal and root counts."""
    end = len(instrs) - 1
    for i in range(start, len(instrs)):
        text = instrs[i][1]
        op = _opcode(text)
        if op.startswith(("RET", "EXIT")) or (op.startswith("BRA") and not text.startswith("@")):
            end = i
            break
    calls = {}
    ops = [_opcode(text) for _, text in instrs[start : end + 1]]
    for _, text in instrs[start : end + 1]:
        tgt = _target(text)
        if _opcode(text).startswith("CALL") and tgt in labels:
            calls[tgt] = _block(instrs, labels, labels[tgt])["instructions"]
    return dict(instructions=end - start + 1, calls=calls,
                rsq=sum(op.startswith("MUFU.RSQ") for op in ops),
                rcp=sum(op.startswith("MUFU.RCP") for op in ops))


def _skip_path(instrs, labels, start: int, end: int) -> int:
    """Instructions issued by the shortest way from `start` to the back
    branch at `end` that takes one forward branch inside [start, end] (the
    whole body when there is none); NOPs not counted."""
    def real(lo, hi):
        return sum(_opcode(t) != "NOP" for _, t in instrs[lo : hi + 1])

    best = real(start, end)
    for i in range(start, end):
        text = instrs[i][1]
        j = labels.get(_target(text))
        if _opcode(text).startswith("BRA") and j is not None and i < j <= end:
            best = min(best, real(start, i) + real(j, end))
    return best


def candidate_loops(instrs, labels) -> list[dict]:
    """The innermost loops holding a table load and MUFU.RSQ (sphere loops)
    or MUFU.RCP (quad loops) in the body or its out-of-line blocks."""
    loops = []
    for end, (_, text) in enumerate(instrs):
        tgt = _target(text)
        if not _opcode(text).startswith("BRA") or tgt not in labels:
            continue
        start = labels[tgt]
        if start > end:
            continue
        body = [t for _, t in instrs[start : end + 1]]
        ops = [_opcode(t) for t in body]
        if not any(op.startswith(("LDG", "LDS", "LD.")) for op in ops):
            continue
        exits, called = [], {}
        for t in body:
            tgt = _target(t)
            if tgt not in labels or start <= labels[tgt] <= end:
                continue
            blk = _block(instrs, labels, labels[tgt])
            if _opcode(t).startswith("CALL"):
                called[tgt] = blk["instructions"]
            else:
                exits.append(dict(op=_opcode(t), target=tgt, **blk))
        rsq = sum(op.startswith("MUFU.RSQ") for op in ops) + sum(e["rsq"] for e in exits)
        rcp = sum(op.startswith("MUFU.RCP") for op in ops) + sum(e["rcp"] for e in exits)
        if not rsq and not rcp:
            continue
        real = [op for op in ops if op != "NOP"]
        per_trip = rsq or rcp
        loops.append(dict(
            kind="sphere" if rsq else "quad", instructions=len(real),
            candidates_per_trip=per_trip, instructions_per_candidate=len(real) / per_trip,
            skip_path=_skip_path(instrs, labels, start, end),
            calls=sum(op.startswith("CALL") for op in ops), called=called,
            convergence=sum(op.startswith(("BSSY", "BSYNC")) for op in ops),
            loads=sorted({op for op in ops if op.startswith(("LDG", "LDS", "LD."))}),
            exits=exits, span=(start, end)))
    # A loop whose body holds another such loop is an outer loop.
    inner = [lp for lp in loops if not any(
        o["span"] != lp["span"] and lp["span"][0] <= o["span"][0] and o["span"][1] <= lp["span"][1]
        for o in loops)]
    for lp in inner:
        lo, hi = lp.pop("span")
        lp["address"] = f"{instrs[lo][0]:04x}-{instrs[hi][0]:04x}"
    return sorted(inner, key=lambda lp: lp["address"].zfill(16))


# The marble probe: the Perlin tables filled and synced as the textured
# kernels fill them, then one octave of noise or the whole marble per thread.
_MARBLE_PROBE = r"""
#include "textures.cuh"

extern "C" __global__ void noise_probe(const float4* __restrict__ p, float* __restrict__ out,
                                       int n) {
  __shared__ rt::PerlinTables tab;
  rt::fill_perlin_tables(tab);
  __syncthreads();
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i < n) out[i] = rt::perlin_noise(tab, p[i].x, p[i].y, p[i].z);
}

extern "C" __global__ void marble_probe(const float4* __restrict__ p, float* __restrict__ out,
                                        int n) {
  __shared__ rt::PerlinTables tab;
  rt::fill_perlin_tables(tab);
  __syncthreads();
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i < n) out[i] = rt::marble(tab, p[i].x, p[i].y, p[i].z, p[i].w);
}
"""
# SASS opcode classes (by prefix; the first match wins).
_CLASSES = (
    ("mufu", ("MUFU",)),
    ("convert", ("I2F", "F2I", "F2F", "I2I", "FRND")),
    ("fp32", ("FADD", "FMUL", "FFMA", "FMNMX", "FSETP", "FSEL", "FSET", "FCHK", "FSWZ")),
    ("int", ("IMAD", "IADD", "LOP", "SHF", "ISETP", "LEA", "IMNMX", "SEL", "PRMT", "IABS",
             "SGXT", "BMSK", "POPC", "IMUL", "MOV", "FLO", "BREV", "VIADD", "ISCADD", "SHL",
             "SHR", "UIADD", "UIMAD", "ULOP", "USHF", "UMOV", "ULEA", "USEL")),
    ("shared_load", ("LDS",)),
    ("global_load", ("LDG", "LD.", "LDC", "ULDC")),
)


def _opclass(op: str) -> str:
    for name, prefixes in _CLASSES:
        if op.startswith(prefixes):
            return name
    return "other"


def marble_probe(out_dir: Path) -> dict:
    """Compile the marble probe against build.CSRC_DIR's textures.cuh and
    count each probe kernel's SASS after its block barrier by class."""
    from raytracer_tpu_torch.ops import build

    out_dir.mkdir(parents=True, exist_ok=True)
    src, cubin = out_dir / "marble_probe.cu", out_dir / "marble_probe.cubin"
    src.write_text(_MARBLE_PROBE)
    nvcc = build.find_nvcc()
    flags = [f for f in build.NVCC_FLAGS if f not in ("-Xcompiler", "-fPIC")]
    log = subprocess.run([nvcc, *flags, "-I", str(build.CSRC_DIR), "-cubin", "-o", str(cubin),
                          str(src)], capture_output=True, text=True)
    if log.returncode != 0:
        raise RuntimeError(f"marble probe: nvcc failed\n{log.stdout}{log.stderr}")
    sass = subprocess.run([str(Path(nvcc).parent / "cuobjdump"), "-sass", str(cubin)],
                          capture_output=True, text=True, check=True).stdout
    (out_dir / "marble_probe.sass").write_text(sass)
    regs = {m.group(1): int(m.group(2)) for m in re.finditer(
        r"Function properties for (\w+)[\s\S]*?Used (\d+) registers", log.stdout + log.stderr)}
    report = {}
    for name, (instrs, labels) in parse_functions(sass).items():
        ops = [_opcode(t) for _, t in instrs]
        start = next((i + 1 for i, op in enumerate(ops) if op.startswith("BAR")), 0)
        body = [op for op in ops[start:] if op != "NOP"]
        classes: dict = {}
        for op in body:
            classes[_opclass(op)] = classes.get(_opclass(op), 0) + 1
        back = [i for i, (_, t) in enumerate(instrs[start:], start)
                if _opcode(t).startswith("BRA") and labels.get(_target(t), i + 1) <= i]
        report[name] = dict(instructions=len(body), classes=classes, backward_branches=len(back),
                            registers=regs.get(name))
    if "noise_probe" in report:
        octave = report["noise_probe"]
        report["per_corner"] = dict(
            instructions=octave["instructions"] / 8,
            **{k: v / 8 for k, v in octave["classes"].items()})
    return report


def _demangle(names: list[str], tool_dir: Path) -> dict[str, str]:
    filt = tool_dir / "cu++filt"
    if not filt.exists():
        return {n: n for n in names}
    out = subprocess.run([str(filt)], input="\n".join(names), capture_output=True, text=True,
                         check=True).stdout.splitlines()
    return dict(zip(names, out)) if len(out) == len(names) else {n: n for n in names}


def main(argv=None) -> dict:
    from raytracer_tpu_torch.ops import build

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default=None, help="directory for the library's SASS")
    ap.add_argument("--sass", default=None,
                    help="read this saved listing instead of building and disassembling")
    ap.add_argument("--csrc", default=None,
                    help="build these sources instead of the package's csrc/ (a variant's "
                         "copy, utils/time_kernels.py)")
    ap.add_argument("--marble", action="store_true",
                    help="also count the marble probe's SASS (into --out, default out/sass)")
    args = ap.parse_args(argv)
    if args.csrc:
        build.CSRC_DIR = Path(args.csrc)
    if args.sass:
        so, tool_dir = Path(args.sass), Path("/nonexistent")
        sass = so.read_text()
    else:
        so = build.build_library()
        tool_dir = Path(build.find_nvcc()).parent
        sass = subprocess.run([str(tool_dir / "cuobjdump"), "-sass", str(so)],
                              capture_output=True, text=True, check=True).stdout
    funcs = parse_functions(sass)
    names = _demangle(sorted(funcs), tool_dir)
    report = {}
    for mangled, (instrs, labels) in sorted(funcs.items()):
        loops = candidate_loops(instrs, labels)
        if loops:
            report[names[mangled]] = dict(instructions=len(instrs), candidate_loops=loops)
    if args.out:
        out = Path(args.out)
        out.mkdir(parents=True, exist_ok=True)
        (out / f"{so.stem}.sass").write_text(sass)
    line = dict(library=so.name, kernels=report)
    if args.marble:
        line["marble"] = marble_probe(Path(args.out or "out/sass"))
    print(json.dumps(line), flush=True)
    return line


if __name__ == "__main__":
    main()
