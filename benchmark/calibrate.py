"""The readings the limits of ``limits/<cell>.json`` are set from, in one process:

    python3 benchmark/calibrate.py --workload <cell> --seeds 1,2,... [--control-seeds ...] [--fault-seeds ...]

- sound runs: the program's compared iterations against the reference's, one
  line a seed (the lower readings are their largest);
- the control: the reference computed with TF32 operands in the program's place;
- faults planted in the program (``faults.py``); under the copy rule the
  program runs on past its first target copy under ``nocopy``, whose numbers
  are the copy's (under the Polyak rule the compared iterations read it).
Each line is JSON: {"kind", "seed", <number>: <reading>, ...}; the last line
holds each kind's largest (sound) or least (control, faults) reading of each
number.  The benchmark's own runs never run this."""

import argparse
import json
import sys
from pathlib import Path

sys.path[0] = str(Path(__file__).resolve().parent.parent)

from benchmark import check, faults, harness  # noqa: E402


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", default="")
    ap.add_argument("--control-seeds", default="")
    ap.add_argument("--fault-seeds", default="")
    ap.add_argument("--faults", default=",".join(faults.FAULTS))
    args = ap.parse_args(argv)
    seeds = lambda s: [int(x) for x in s.split(",") if x]  # noqa: E731
    root = harness.BENCH_DIR.parent
    harness.pin_process(root)
    import torch

    device = torch.device("cuda")
    cell = harness.load_cell(root, args.workload)
    rows = []

    def emit(kind, seed, gaps):
        row = {"kind": kind, "seed": seed, **gaps}
        rows.append(row)
        print(json.dumps(row), flush=True)

    def program(seed, copy=False):
        """The program's readings, and with ``copy`` its target copy's numbers (under the copy rule)."""
        agent, state, readings, probe = harness.program_setup(cell, seed, device)
        copied = {}
        if copy and probe is not None:
            step = harness.hook(harness.algorithm(cell.config["algorithm"]), "step")
            harness.drive_to_copy(agent, state, probe, harness.first_learning_iteration(cell) - 1 + harness.COMPARED, step)
            copied = probe.gaps()
        del agent, state, probe
        torch.cuda.empty_cache()
        return readings, copied

    def against_reference(readings, seed, copied=None):
        draws = readings.drawn if cell.traffic["per"] else None
        return check.compare(readings, harness.reference_readings(cell, seed, device, draws=draws)) | (copied or {})

    for seed in seeds(args.seeds):
        emit("sound", seed, against_reference(program(seed)[0], seed))
    for seed in seeds(args.control_seeds):
        emit("control", seed, against_reference(harness.reference_readings(cell, seed, device, "tf32"), seed))
    for fault in [f for f in args.faults.split(",") if f]:
        for seed in seeds(args.fault_seeds):
            with faults.planted(fault):
                readings, copied = program(seed, copy=fault == "nocopy")
            emit(fault, seed, against_reference(readings, seed, copied))
    summary = {}
    for kind in dict.fromkeys(r["kind"] for r in rows):
        pick = max if kind == "sound" else min
        mine = [r for r in rows if r["kind"] == kind]
        summary[kind] = {k: pick(r[k] for r in mine) for k in check.NUMBERS if k in mine[0]}
    print(json.dumps({"workload": args.workload, "summary": summary}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
