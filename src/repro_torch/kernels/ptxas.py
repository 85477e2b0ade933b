"""Registers and spills of every kernel instance, as ``ptxas -v`` reports
them, for the decode sources of this checkout and optionally of another
one (a parent commit unpacked beside it), side by side.

    PYTHONPATH=src python -m repro_torch.kernels.ptxas \\
        [--against OTHER/src/repro_torch/csrc] [--sources decode_attn.cu ...]

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


def _demangle(names):
    text = subprocess.run(["c++filt"], input="\n".join(names),
                          capture_output=True, text=True, check=True).stdout
    return [re.sub(r"\(anonymous namespace\)::", "", d).split("(")[0]
            .replace("void ", "") for d in text.splitlines()]


def report(csrc: Path, sources) -> dict:
    """{(source, demangled instance): (registers, stores, loads)}"""
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
            for name, short in zip(found, _demangle(list(found))):
                out[src, short] = found[name]
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--against", type=Path, default=None,
                    help="another checkout's csrc directory")
    ap.add_argument("--sources", nargs="+",
                    default=["decode_attn.cu", "paged_decode_attn.cu"])
    args = ap.parse_args(argv)
    here = report(runtime.CSRC, args.sources)
    other = report(args.against, args.sources) if args.against else {}
    changed = 0
    for key in sorted(here):
        regs, st, ld = here[key]
        line = f"{key[1]}: {regs} registers, spill {st}/{ld} B"
        if other:
            was = other.get(key)
            if was != here[key]:
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
