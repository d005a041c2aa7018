"""Read the numbers that decide ``correct`` over many seeds in one process:
the program's (its lower readings) or its control's (the mix's
lower-precision path in the program's place: its upper readings).

    python3 benchmark/calibrate.py --workload <cell> --seeds 1,2,3 --seconds 3 [--control]
        [--converged-only]

Each seed gets the set-up and a short window of the cell's own batch and
load, then the same judgement as a run; one JSON line per seed, then the
largest and smallest reading of each number. The problem is built once.
"""

import argparse
import json
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True, help="comma-separated")
    ap.add_argument("--seconds", type=float, default=3.0)
    ap.add_argument("--control", action="store_true")
    ap.add_argument("--converged-only", action="store_true",
                    help="judge only the lanes that converged")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--batch", type=int, default=None)
    args = ap.parse_args(argv)

    import numpy as np

    from benchmark import harness

    cell = harness.load_cell(args.workload)
    problem = cell.port.build(cell.cfg)
    rows = []
    for seed in (int(s) for s in args.seeds.split(",")):
        t0 = time.perf_counter()
        drv = harness.CellRun(cell, seed, device=args.device, batch=args.batch,
                             control=args.control, problem=problem)
        drv.setup()
        recs, span = drv.window(args.seconds)
        answers = harness.host_arrays(recs)
        del recs
        status = np.concatenate([a["status"] for a in answers])
        its = np.concatenate([a["iterations"] for a in answers])
        j = harness.judge(cell, drv, answers, seed, converged_only=args.converged_only)
        row = {"workload": args.workload, "mode": "control" if args.control else "program",
               "seed": seed, "calls": len(answers), "attempted": int(len(status)),
               "failed": int(np.sum(status != 0)), "iters_mean": float(its.mean()),
               "call_s": span / len(answers), "judged": j["judged_lanes"],
               "reference_kkt_norm": j["reference_kkt_norm"], "checks": j["checks"],
               "part_gaps": j["part_gaps"],
               "seconds": time.perf_counter() - t0}
        rows.append(row)
        print(json.dumps(row), flush=True)
    keys = rows[0]["checks"]
    print(json.dumps({"workload": args.workload, "mode": rows[0]["mode"], "seeds": len(rows),
                      "max": {k: max(r["checks"][k] for r in rows) for k in keys},
                      "min": {k: min(r["checks"][k] for r in rows) for k in keys}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
