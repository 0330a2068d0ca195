"""The readings a correctness limit is set from: one cell run on several
seeds in one process, each with a short window, printing one JSON line a
seed with the port's compared numbers, and with ``--control 1`` the
control's (the reference computed with fp8 products in the port's place),
or with ``--fault <name>`` the port's numbers under a planted fault
(``bench_port/faults.py``).

    python3 bench_port/tools/readings.py --workload <name> --seeds 1,2,3 \\
        --seconds 5 [--control 1] [--fault half_batch]
"""
import contextlib
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
sys.path.insert(0, ROOT)

from bench_port import harness  # noqa: E402
from bench_port.faults import FAULTS  # noqa: E402


def main() -> int:
    import argparse

    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, default=5.0)
    ap.add_argument("--control", type=int, default=0)
    ap.add_argument("--fault", choices=sorted(FAULTS))
    args = ap.parse_args()
    for seed in (int(s) for s in args.seeds.split(",")):
        t = time.monotonic()
        with FAULTS[args.fault]() if args.fault else contextlib.nullcontext():
            run = harness.run_cell(args.workload, seed, args.seconds, False, "cuda",
                                   control=bool(args.control))
        line = dict(workload=args.workload, seed=seed, fault=args.fault, readings=run.readings,
                    checks=run.checks, setup_s=run.setup_s, attempted=run.attempted,
                    metrics=harness.read_metrics(run, run.spec["end_to_end"]),
                    memory_peak_bytes=run.memory_peak_bytes, seconds=time.monotonic() - t)
        print("readings " + json.dumps(line), flush=True)
        del run
    return 0


if __name__ == "__main__":
    sys.exit(main())
