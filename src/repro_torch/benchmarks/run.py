"""Benchmark runner of the port: one section per paper figure (the HALO
analytic model, ``paper_figs``) and the kernel micro-benchmarks
(``kernel_micro``).  Prints ``name,value,unit,paper`` CSV.

  PYTHONPATH=src python -m repro_torch.benchmarks.run [--only fig5,kernels]
      [--device cuda|cpu]

The kernel rows run on the card (``cuda``, the default) or, asked for, on
the plain versions on the CPU.  A suite that fails raises: the run stops
with a non-zero exit code and prints no row for it.
"""

from __future__ import annotations

import argparse
import functools
import sys
import time


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--only", default=None,
                    help="comma-separated substring filters on suite names")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                    help="where the kernel rows run (default: the card)")
    args = ap.parse_args(argv)

    from repro_torch.benchmarks import kernel_micro, paper_figs

    suites = [(f"paper_figs.{fn.__name__}", fn) for fn in paper_figs.ALL]
    suites += [(f"kernel_micro.{fn.__name__}",
                functools.partial(fn, device=args.device))
               for fn in kernel_micro.ALL]
    if args.only:
        keys = [k.strip() for k in args.only.split(",")]
        suites = [(n, f) for n, f in suites if any(k in n for k in keys)]

    print("name,value,unit,paper")
    n_rows = 0
    for name, fn in suites:
        t0 = time.time()
        rows = fn()
        for rname, value, unit, paper in rows:
            if isinstance(value, float):
                print(f"{rname},{value:.6g},{unit},{paper}")
            else:
                print(f"{rname},{value},{unit},{paper}")
            n_rows += 1
        print(f"# {name}: {len(rows)} rows in {time.time()-t0:.1f}s",
              file=sys.stderr)
    print(f"# total rows: {n_rows}", file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
