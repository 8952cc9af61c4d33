"""Read what ``nvcc`` compiled: the SASS of a built kernel library, and
the opcodes of one loop of it.

``cuobjdump -sass`` prints each instruction as ``/*addr*/ OPCODE operands ;``.
A loop is a backward branch; its body is every instruction from the
branch's target to the branch.  Used by ``chip_smoke.py`` to count K2's
compression loop per round.  Run as a script to count it for any version
of ``csrc/sha256.cu``, built on the spot (the card's toolkit is needed):

    python -m pbs_plus_tpu_torch.ops.sass path/to/sha256.cu
"""

from __future__ import annotations

import argparse
import json
import os
import re
import shutil
import subprocess
import tempfile
from collections import Counter
from pathlib import Path

_INSN = re.compile(r"\s*/\*([0-9a-f]{4,})\*/\s+(.*?)\s*;")
_BRA = re.compile(r"\bBRA\b.*?0x([0-9a-f]+)")
_PRED = re.compile(r"^@!?U?P\w+\s+")


def cuobjdump() -> str | None:
    """The toolkit's ``cuobjdump`` beside ``nvcc``, or None."""
    from ._build import KernelBuildError, _nvcc
    try:
        cand = Path(_nvcc()).with_name("cuobjdump")
    except KernelBuildError:
        cand = None
    if cand is not None and cand.is_file():
        return str(cand)
    return shutil.which("cuobjdump")


def sass_text(library: str | os.PathLike) -> str | None:
    """``cuobjdump -sass`` of a built library, or None without the tool."""
    tool = cuobjdump()
    if tool is None:
        return None
    return subprocess.run([tool, "-sass", str(library)], capture_output=True,
                          text=True, check=True, timeout=120).stdout


def functions(text: str) -> dict[str, list[tuple[int, str]]]:
    """Each function's instructions as ``(address, text)``."""
    out: dict[str, list[tuple[int, str]]] = {}
    name = None
    for line in text.splitlines():
        if "Function :" in line:
            name = line.split("Function :", 1)[1].strip()
            out[name] = []
            continue
        m = _INSN.match(line)
        if m and name is not None:
            out[name].append((int(m.group(1), 16), m.group(2)))
    return out


def opcode(insn: str) -> str:
    return _PRED.sub("", insn).split()[0]


def loops(insns: list[tuple[int, str]]) -> list[Counter]:
    """Opcode counts of every loop body, in the order of the loops' back
    branches."""
    found = []
    for addr, t in insns:
        m = _BRA.search(t)
        if m and int(m.group(1), 16) <= addr:
            lo = int(m.group(1), 16)
            found.append(Counter(opcode(x) for a, x in insns if lo <= a <= addr))
    return found


def compression_loop(text: str, kernel: str = "sha256_kernel"
                     ) -> Counter | None:
    """The opcode counts of the SHA-256 compression loop of ``kernel``: the
    loop with the most funnel-shift rotates (``SHF.R.W.U32``), or None."""
    bodies = [b for name, insns in functions(text).items() if kernel in name
              for b in loops(insns)]
    return max(bodies, key=lambda b: b.get("SHF.R.W.U32", 0), default=None)


def per_round(body: Counter, rounds: int = 64) -> dict:
    """Counts of a loop that runs ``rounds`` rounds per trip, per round."""
    return {"per_round": {k: round(v / rounds, 2)
                          for k, v in body.most_common()},
            "instructions_per_round": round(sum(body.values()) / rounds, 2)}


def main() -> None:
    from ._build import NVCC_FLAGS, _nvcc
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("source", help="a version of csrc/sha256.cu")
    args = ap.parse_args()
    with tempfile.TemporaryDirectory() as d:
        lib = Path(d) / "k.so"
        subprocess.run([_nvcc(), *NVCC_FLAGS, "-o", str(lib), args.source],
                       check=True, capture_output=True, timeout=600)
        text = sass_text(lib)
    body = compression_loop(text) if text is not None else None
    print(json.dumps({"source": args.source,
                      **(per_round(body) if body else {"sass": "not available"})}))


if __name__ == "__main__":
    main()
