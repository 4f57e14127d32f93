"""Whether one CUDA source of the port compiles to the same machine code in
two trees: each tree's ``src/repro_torch/csrc/<source>`` is compiled with the
port's own flags (``_cuda.COMPILE_FLAGS``) to a cubin, and the SASS of every
kernel is compared, names and addresses left out (a template that gained
parameters with defaults keeps its code but not its mangled name).

  python3 tools/sass_same.py --src build/parent/src --source wilson_normal.cu

Prints one JSON line: the source, each tree's kernel count, and ``same``:
whether the two trees' kernels are the same multiset of instruction
sequences.  Exits with 1 where they differ.  Needs ``nvcc`` and ``cuobjdump``.
"""

from __future__ import annotations

import argparse
import collections
import json
import re
import subprocess
import sys
import tempfile
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
from repro_torch import _cuda  # noqa: E402

_ADDR = re.compile(r"/\*[0-9a-f]{4,}\*/")


def kernels(source: Path, out: Path) -> collections.Counter:
    """The multiset of the source's kernels, each as its tuple of SASS
    instructions."""
    subprocess.run([_cuda._nvcc(), *_cuda.COMPILE_FLAGS, "-cubin", "-o", str(out), str(source)],
                   check=True)
    sass = subprocess.run([str(Path(_cuda._nvcc()).parent / "cuobjdump"), "-sass", str(out)],
                          check=True, capture_output=True, text=True).stdout
    found, body = collections.Counter(), None
    for line in sass.splitlines():
        if line.strip().startswith("Function :"):
            if body is not None:
                found[tuple(body)] += 1
            body = []
        elif body is not None and _ADDR.search(line):
            body.append(_ADDR.sub("", line).split(";")[0].strip())
    if body is not None:
        found[tuple(body)] += 1
    return found


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--src", required=True, help="the other tree's src directory")
    ap.add_argument("--source", required=True, help="a file name under csrc/")
    args = ap.parse_args()
    with tempfile.TemporaryDirectory() as tmp:
        mine = kernels(ROOT / "src/repro_torch/csrc" / args.source, Path(tmp) / "mine.cubin")
        theirs = kernels(Path(args.src) / "repro_torch/csrc" / args.source,
                         Path(tmp) / "theirs.cubin")
    same = mine == theirs
    print(json.dumps({"source": args.source, "kernels": sum(mine.values()),
                      "other_kernels": sum(theirs.values()), "same": same}))
    return 0 if same else 1


if __name__ == "__main__":
    sys.exit(main())
