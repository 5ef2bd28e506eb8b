"""The control and the readings that set the limits of ``correct``.

    python3 portbench/control.py --workload <cell> --seeds 1,2,3 \\
        --seconds 5 [--out control.jsonl]

For each seed, one run of the cell (a short window) with the control
switched on: the program's compared numbers (the lower readings), and the
same numbers with the control in the program's place (the reference in the
next precision below the configuration's: bfloat16 state for the brain,
float8 matrix products for the LM), which must fail them (the upper
readings). With ``--fault <name>`` the program runs with that fault of
``bench/faults.py`` planted instead, and its numbers are the fault's
readings. One JSON line a seed; the benchmark's own runs never run it."""
import json
import pathlib
import sys
import time

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))

from portbench.bench import harness  # noqa: E402


def main(argv=None) -> int:
    import argparse
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, default=5.0)
    ap.add_argument("--out", default=None)
    ap.add_argument("--fault", default=None,
                    help="plant this fault of bench/faults.py instead of "
                         "running the control")
    args = ap.parse_args(argv)
    spec = harness.load_spec()
    cell = harness.find_cell(spec, args.workload)
    sys.path.insert(0, str(harness.ROOT / "src"))
    import torch
    if not torch.cuda.is_available():
        print("control: no CUDA device", file=sys.stderr)
        return 2
    out = open(args.out, "a") if args.out else None
    try:
        for seed in (int(s) for s in args.seeds.split(",")):
            run = harness.Run(spec, cell, seed, args.seconds, 0,
                              torch.device("cuda", 0), time.perf_counter())
            if args.fault:
                from portbench.bench import faults
                with faults.FAULTS[run.traffic["driver"]][args.fault]():
                    line = harness.run_cell(run)
                run.control_checks = {}
            else:
                run.control = True
                line = harness.run_cell(run)
            rec = {"workload": cell["name"], "seed": seed,
                   "fault": args.fault,
                   "correct": line["correct"],
                   "program": {k: v["value"]
                               for k, v in line["compared"].items()},
                   "control": {k: v for k, (v, _) in
                               run.control_checks.items()},
                   "metrics": line["metrics"],
                   "readings": getattr(run, "readings", None)}
            print(json.dumps(rec), flush=True)
            if out:
                out.write(json.dumps(rec) + "\n")
                out.flush()
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
    finally:
        if out:
            out.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
