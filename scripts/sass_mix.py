#!/usr/bin/env python3
"""Count the SASS instructions of the port's kernels by opcode, from the
library ``repro_torch.kernels`` builds (``cuobjdump -sass``): the static
instruction mix of each kernel whose name holds one of the arguments.

    python3 scripts/sass_mix.py attention_dkdv_tf32 attention_dq_tf32

Needs the CUDA toolkit (``cuobjdump`` beside ``nvcc``), so it runs on the
machine with the card.  Prints, per kernel, the instruction count and the
opcodes (first word, modifiers dropped) that take most of it.  A static
count says what the compiler emitted for the unrolled loops, not how
often each runs.
"""

from __future__ import annotations

import collections
import re
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
TOP = 24


def functions(sass: str) -> dict[str, list[str]]:
    """The opcodes of each function of ``cuobjdump -sass``'s output."""
    out: dict[str, list[str]] = {}
    name = None
    for line in sass.splitlines():
        head = re.match(r"\s*Function : (\S+)", line)
        if head:
            name = head.group(1)
            out[name] = []
            continue
        ins = re.match(r"\s*/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P\w+\s+)?([A-Z][A-Z0-9_]*)", line)
        if name and ins:
            out[name].append(ins.group(1))
    return out


def main() -> None:
    wanted = sys.argv[1:]
    if not wanted:
        sys.exit(__doc__)
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.kernels import _lib

    lib = _lib.build().path
    tool = Path(_lib._nvcc()).with_name("cuobjdump")
    sass = subprocess.run([str(tool), "-sass", str(lib)], capture_output=True, text=True,
                          check=True).stdout
    for name, ops in sorted(functions(sass).items()):
        if not any(w in name for w in wanted):
            continue
        count = collections.Counter(ops)
        mix = ", ".join(f"{op} {n}" for op, n in count.most_common(TOP))
        print(f"{name}: {len(ops)} instructions; {mix}", flush=True)


if __name__ == "__main__":
    main()
