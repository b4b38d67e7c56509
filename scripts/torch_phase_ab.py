#!/usr/bin/env python3
"""Run one serve phase of ``chip_smoke.py`` from several checkouts in
turn, on one card, to compare two versions of the port inside one call.

    python3 scripts/torch_phase_ab.py --phase serve_quantized \\
        --trees build/parent . . build/parent

Each tree is a checkout of the repository (``build/parent`` an unpacked
``git archive`` of another commit).  For each, in the order given, a fresh
process imports that tree's ``chip_smoke.py`` and its ``src/repro_torch``,
builds the tree's kernels into the tree's own ``build/kernels/`` and runs
``<phase>_phase`` (its JSON lines: the phase's rounds with TTFT and TPOT,
the main-path kernel checks with their times, and its ``profile`` line of
device busy time), each line tagged with the run's index and tree.  It
exits non-zero if a run fails.  Needs one CUDA card.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

CHILD = r"""
import json, sys
from pathlib import Path
tree = Path(sys.argv[1]).resolve()
sys.path[:0] = [str(tree / "src"), str(tree)]
import torch
import chip_smoke as cs
import repro_torch  # noqa: F401
from repro_torch.kernels import _build
_build.build_all()
getattr(cs, sys.argv[2] + "_phase")(torch, cs.Timer(torch))
"""


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--phase", required=True,
                    help="a chip_smoke phase with a (torch, timer) "
                         "function, e.g. serve_quantized")
    ap.add_argument("--trees", nargs="+", required=True,
                    help="checkouts to run, in order")
    ap.add_argument("--timeout", type=float, default=900.0,
                    help="seconds each run may take")
    args = ap.parse_args(argv)
    failed = 0
    for i, tree in enumerate(args.trees):
        if not (Path(tree) / "chip_smoke.py").is_file():
            raise SystemExit(f"{tree}: no chip_smoke.py")
        proc = subprocess.run(
            [sys.executable, "-c", CHILD, tree, args.phase],
            capture_output=True, text=True, timeout=args.timeout)
        for line in proc.stdout.splitlines():
            if line.startswith("{"):
                print(json.dumps({"run": i, "tree": tree,
                                  **json.loads(line)}), flush=True)
        if proc.returncode:
            failed += 1
            print(json.dumps({"run": i, "tree": tree, "failed":
                              proc.stderr[-4000:]}), flush=True)
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
