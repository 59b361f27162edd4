"""What nvcc compiled: the SASS of each kernel in a built library.

  python -m adanerf_tpu_torch.ops.kernels.sass LIB.so [OTHER.so]

Prints each kernel's instruction count and its count of HGMMA (warpgroup
matrix multiply) instructions; given a second library, whether each kernel
that both hold compiled to the same instructions, how many differ, and the
first of the differing lines.
Needs ``cuobjdump`` from the CUDA toolkit.
"""

from __future__ import annotations

import difflib
import os
import re
import subprocess
import sys
from typing import Dict, List

from .build import find_nvcc

DIFF_LINES = 60  # differing lines shown per kernel
_FUNC = re.compile(r"^\s*Function : (\S+)")
_INSTR = re.compile(r"^\s*/\*[0-9a-f]{4,}\*/\s+(.*?)\s*;")
_HGMMA = re.compile(r"(^|\s)HGMMA\.")
_ANON = re.compile(r"_ZN(\d+)_GLOBAL__N_")


def find_cuobjdump() -> str:
    """cuobjdump beside nvcc; raises RuntimeError where there is none."""
    path = os.path.join(os.path.dirname(find_nvcc()), "cuobjdump")
    if not os.path.isfile(path):
        raise RuntimeError(f"cuobjdump not found beside nvcc ({path})")
    return path


def _unhash(name: str) -> str:
    """A mangled name without its anonymous namespace's per-build id, so
    that two builds of one source name their kernels alike."""
    m = _ANON.match(name)
    return name if not m else "_ZN12_GLOBAL__N_1" + name[m.end(1) + int(m.group(1)):]


def kernel_sass(lib: str) -> Dict[str, List[str]]:
    """{mangled kernel name (anonymous namespace id dropped): its SASS
    instructions, in order}."""
    out = subprocess.run([find_cuobjdump(), "-sass", lib], capture_output=True, text=True,
                         check=True, timeout=300).stdout
    kernels: Dict[str, List[str]] = {}
    name = None
    for line in out.splitlines():
        m = _FUNC.match(line)
        if m:
            name = _unhash(m.group(1))
            kernels[name] = []
            continue
        m = _INSTR.match(line)
        if m and name is not None:
            kernels[name].append(m.group(1))
    return kernels


def hgmma_count(instrs: List[str]) -> int:
    return sum(_HGMMA.search(i) is not None for i in instrs)


def main(argv=None) -> int:
    args = sys.argv[1:] if argv is None else argv
    if len(args) not in (1, 2):
        print(__doc__, file=sys.stderr)
        return 2
    a = kernel_sass(args[0])
    b = kernel_sass(args[1]) if len(args) == 2 else {}
    for name, instrs in a.items():
        line = f"{name}: {len(instrs)} instructions, {hgmma_count(instrs)} HGMMA"
        if b:
            if name not in b:
                line += "; not in the second library"
            elif b[name] == instrs:
                line += "; identical in the second library"
            else:
                sm = difflib.SequenceMatcher(a=instrs, b=b[name], autojunk=False)
                same = sum(blk.size for blk in sm.get_matching_blocks())
                line += (f"; the second library has {len(b[name])} instructions, "
                         f"{len(instrs) - same} of these differ or are missing there")
                diff = list(difflib.unified_diff(instrs, b[name], lineterm="", n=0))[2:]
                line += "".join(f"\n    {d}" for d in diff[:DIFF_LINES])
        print(line)
    for name in b:
        if name not in a:
            print(f"{name}: only in the second library, {len(b[name])} instructions")
    return 0


if __name__ == "__main__":
    sys.exit(main())
