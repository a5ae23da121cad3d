"""python3 -m rmbench.run --workload NAME --seed N --seconds S --trace 0|1

One run of one cell of `BENCHMARK.json` on the CUDA card this process
sees: set-up (timed as `setup_s`), a warm-up at the cell's own shapes,
`--seconds` of the cell's traffic, the check against the plain
reference, and one JSON line on standard output, last, with `correct`,
`attempted`, `failed`, `metrics` and `device` (`--trace 1`: the per-layer
metrics, the device's busy seconds and a `breakdown`, read from a
profiler trace of the window written to `rmbench/out/`).  Each number
the check compares is printed beside its limit on standard error, last,
and in the line under `checks`.  Without a card, or with `jax` or the
JAX package loaded once the window has closed, it prints no result and
exits with 2 or 3.
"""
from __future__ import annotations

import time

_T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402

from rmbench import harness  # noqa: E402


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="python3 -m rmbench.run",
                                description=__doc__.splitlines()[2])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)
    spec = harness.Spec()
    run = harness.Run(spec, args.workload, args.seed, bool(args.trace))
    try:
        result = harness.execute(run, args.seconds, _T_START)
    except harness.NoCard as e:
        print(f"rmbench: {e}", file=sys.stderr)
        return 2
    found = harness.forbidden_modules()
    if found:
        print(f"rmbench: the run loaded {', '.join(found)}: nothing the "
              "benchmark runs may import jax or the JAX package",
              file=sys.stderr)
        return 3
    harness.OUT.mkdir(parents=True, exist_ok=True)
    (harness.OUT / f"{args.workload}-{args.seed}-trace{args.trace}.json"
     ).write_text(json.dumps(result, indent=1) + "\n")
    for name, c in result["checks"].items():
        print(f"check {name}: {c['value']!r} (limit {c['limit']!r})",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
