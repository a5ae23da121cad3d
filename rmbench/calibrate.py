"""python3 -m rmbench.calibrate --workload NAME --seeds A,B,... \
       --control-seeds C,D,E [--seconds S]

The readings a cell's limits are set from, in one process on the card:
the check's numbers of sound runs of the program on each of `--seeds`
(each a short window at the cell's own load, checking as many pixels as
a run does), and of the control, the reference at bfloat16 in the
program's place, on each of `--control-seeds`.  Prints one JSON line per
run and, last, for each number the lower reading (the largest of the
sound runs) and the upper one (the smallest of the control's).  With
`--fault`, the program's runs carry that planted fault
(`rmbench.faults`; a train fault leaves the set-up's `first_steps`
sound), and their readings stand as the lower ones.  The
benchmark's own runs never run the control or a fault.
"""
from __future__ import annotations

import argparse
import contextlib
import json
import sys
import time

from rmbench import faults, harness


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="python3 -m rmbench.calibrate")
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--control-seeds", default="")
    p.add_argument("--seconds", type=float, default=3.0)
    p.add_argument("--fault", default=None,
                   help="plant this fault (rmbench.faults) under the "
                        "program's runs")
    args = p.parse_args(argv)
    spec = harness.Spec()
    readings = {"program": [], "control": []}
    runs = [(int(s), False) for s in args.seeds.split(",")]
    runs += [(int(s), True) for s in args.control_seeds.split(",") if s]
    for seed, control in runs:
        run = harness.Run(spec, args.workload, seed, trace=False)
        t0 = time.perf_counter()
        planted = (faults.plant(run.traffic["driver"], args.fault,
                                int(run.traffic.get("first_steps", 0)))
                   if args.fault and not control
                   else contextlib.nullcontext())
        try:
            with planted:
                result = harness.execute(run, args.seconds, t0, control)
        except harness.NoCard as e:
            print(f"rmbench: {e}", file=sys.stderr)
            return 2
        side = "control" if control else (
            f"fault {args.fault}" if args.fault else "program")
        readings["control" if control else "program"].append(run.readings)
        print(json.dumps({"seed": seed, "side": side,
                          "readings": run.readings,
                          "attempted": result["attempted"],
                          "seconds": time.perf_counter() - t0}), flush=True)
    names = sorted({k for r in readings["program"] for k in r})
    summary = {k: {"lower": max(r[k] for r in readings["program"]),
                   "upper": (min(r[k] for r in readings["control"])
                             if readings["control"] else None)}
               for k in names}
    print(json.dumps({"workload": args.workload, "numbers": summary}),
          flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
