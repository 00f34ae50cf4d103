#!/usr/bin/env python3
"""Compare the SASS of the blend kernels' narrow instances, or of K4's
staging kernel (R <= 41), in two builds.

    python3 scripts/torch_sass_diff.py OLD.so NEW.so

OLD and NEW are built kernel libraries of K1, K3 or K4 (say the parent's
and this tree's `splatter_a_video_tpu_torch/_build/blend_forward-<hash>.so`,
each built by `ops._build.build()` in its own checkout). Disassembles both
with `cuobjdump -sass` (the CUDA toolkit's; needs no GPU) and compares the
instructions of each `blend_forward_kernel<CB, NT>` /
`blend_backward_kernel<CB, NT>` instance, found by its template arguments
whatever the rest of its name, and of `reduce_gaussians_kernel` (shown as
CB = NT = 0), with addresses and encodings stripped.
Prints one line per instance, "identical" or how many instructions differ;
exits 1 if any differs or is missing from one side.
"""

from __future__ import annotations

import re
import shutil
import subprocess
import sys
from pathlib import Path

NARROW = re.compile(r"(blend_forward_kernel|blend_backward_kernel)ILi(\d+)ELi(\d+)E(Lb0E)?E"
                    r"|\d(reduce_gaussians_kernel)E")


def cuobjdump() -> str:
    found = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    if not Path(found).exists():
        raise RuntimeError("cuobjdump not found: it comes with the CUDA toolkit")
    return found


def instances(lib: str) -> dict:
    """{(kernel, CB, NT): [instruction, ...]} of a library's narrow instances."""
    out = subprocess.run([cuobjdump(), "-sass", lib], capture_output=True, text=True, check=True).stdout
    parts = re.split(r"\n\s*Function : (\S+)\n", out)
    found = {}
    for name, body in zip(parts[1::2], parts[2::2]):
        m = NARROW.search(name)
        if not m:
            continue
        code = []
        for line in body.splitlines():
            line = line.strip()
            if line.startswith("/*") and "*/" in line:
                ins = line.split("*/", 1)[1].split(";")[0].strip()
                if ins:
                    code.append(ins)
        key = (m.group(5), 0, 0) if m.group(5) else (m.group(1), int(m.group(2)), int(m.group(3)))
        found[key] = code
    return found


def main() -> int:
    if len(sys.argv) != 3:
        print(__doc__, file=sys.stderr)
        return 2
    old, new = instances(sys.argv[1]), instances(sys.argv[2])
    bad = 0
    for key in sorted(set(old) | set(new)):
        a, b = old.get(key), new.get(key)
        if a is None or b is None:
            print(*key, "missing in", "OLD" if a is None else "NEW")
            bad += 1
            continue
        diff = sum(x != y for x, y in zip(a, b)) + abs(len(a) - len(b))
        print(*key, "identical" if diff == 0 else f"differs in {diff} of {len(a)} / {len(b)} instructions")
        bad += diff > 0
    print(f"{len(old)} / {len(new)} narrow instances, {bad} differ or are missing")
    return 1 if bad or not old else 0


if __name__ == "__main__":
    sys.exit(main())
