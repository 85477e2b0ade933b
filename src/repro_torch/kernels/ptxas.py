"""Registers and spills of every kernel instance, as ``ptxas -v`` reports
them, for the decode sources of this checkout and optionally of another
one (a parent commit unpacked beside it), side by side; with ``--sass``,
also how many SASS instructions of each named opcode every instance
holds (``cuobjdump -sass``; ``I2F`` counts ``I2F.S8``, ``I2FP.F32.S32``
and every other opcode that starts with it).

    PYTHONPATH=src python -m repro_torch.kernels.ptxas \\
        [--against OTHER/src/repro_torch/csrc] \\
        [--sources decode_attn.cu ...] [--sass I2F F2FP PRMT ...]

Runs on the machine with ``nvcc`` (one process per source and tree, all
started together), with the flags of ``runtime.NVCC_FLAGS``.  Prints one
line per instance (demangled) and, with ``--against``, marks the
instances whose registers or spills differ; exits 1 if a build fails.
"""
from __future__ import annotations

import argparse
import re
import subprocess
import sys
import tempfile
from pathlib import Path

from . import runtime

_ENTRY = re.compile(r"Compiling entry function '([^']+)'")
_USED = re.compile(r"Used (\d+) registers")
_SPILL = re.compile(r"(\d+) bytes spill stores, (\d+) bytes spill loads")
_FUNCTION = re.compile(r"Function : (\S+)")
_OPCODE = re.compile(
    r"/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P\w+\s+)?([A-Z][A-Z0-9_.]*)")


def parse(text: str) -> dict:
    """{mangled instance: (registers, spill stores, spill loads)}"""
    out, name, spill = {}, None, (0, 0)
    for line in text.splitlines():
        m = _ENTRY.search(line)
        if m:
            name, spill = m.group(1), (0, 0)
            continue
        m = _SPILL.search(line)
        if m and name:
            spill = (int(m[1]), int(m[2]))
        m = _USED.search(line)
        if m and name:
            out[name] = (int(m[1]),) + spill
    return out


def sass_counts(text: str, ops) -> dict:
    """{mangled instance: {op: instructions whose opcode starts with op}}
    from ``cuobjdump -sass`` output"""
    out, counts = {}, None
    for line in text.splitlines():
        m = _FUNCTION.search(line)
        if m:
            counts = out[m.group(1)] = dict.fromkeys(ops, 0)
            continue
        m = _OPCODE.search(line)
        if m and counts is not None:
            for op in ops:
                counts[op] += m.group(1).startswith(op)
    return out


def _demangle(names):
    text = subprocess.run(["c++filt"], input="\n".join(names),
                          capture_output=True, text=True, check=True).stdout
    return [re.sub(r"\(anonymous namespace\)::", "", d).split("(")[0]
            .replace("void ", "") for d in text.splitlines()]


def report(csrc: Path, sources, ops=()) -> dict:
    """{(source, demangled instance): (registers, stores, loads)}, each
    followed by {op: SASS count} when ``ops`` names opcodes"""
    procs = {}
    with tempfile.TemporaryDirectory() as tmp:
        for src in sources:
            cmd = [runtime._nvcc(), *runtime.NVCC_FLAGS, "-Xptxas", "-v",
                   "-I", str(csrc), "-c", str(csrc / src), "-o",
                   str(Path(tmp) / (src + ".o"))]
            procs[src] = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                          stderr=subprocess.STDOUT,
                                          text=True)
        out = {}
        for src, p in procs.items():
            text, _ = p.communicate()
            if p.returncode:
                raise RuntimeError(f"nvcc {csrc / src} failed:\n{text}")
            found = parse(text)
            ops_of = {}
            if ops:
                ops_of = sass_counts(subprocess.run(
                    [str(runtime.cuda_tool("cuobjdump")),
                     "-sass", str(Path(tmp) / (src + ".o"))],
                    capture_output=True, text=True, check=True).stdout, ops)
            for name, short in zip(found, _demangle(list(found))):
                out[src, short] = found[name] + (
                    (ops_of.get(name, {}),) if ops else ())
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--against", type=Path, default=None,
                    help="another checkout's csrc directory")
    ap.add_argument("--sources", nargs="+",
                    default=["decode_attn.cu", "paged_decode_attn.cu"])
    ap.add_argument("--sass", nargs="*", default=[],
                    help="opcodes to count in each instance's SASS")
    args = ap.parse_args(argv)
    here = report(runtime.CSRC, args.sources, args.sass)
    other = report(args.against, args.sources) if args.against else {}
    changed = 0
    for key in sorted(here):
        regs, st, ld = here[key][:3]
        line = f"{key[1]}: {regs} registers, spill {st}/{ld} B"
        if args.sass:
            line += "; SASS " + ", ".join(f"{op} {c}" for op, c in
                                          here[key][3].items())
        if other:
            was = other.get(key)
            if was != here[key][:3]:
                changed += 1
                line += (f"  [was {was[0]} registers, spill {was[1]}/"
                         f"{was[2]} B]" if was else "  [new]")
        print(line)
    if other:
        print(f"{changed} of {len(here)} instances differ from "
              f"{args.against}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
