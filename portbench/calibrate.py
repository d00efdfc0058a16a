"""The readings that a cell's limits are set from, on the card, at the
cell's own sizes, in one process: the program's numbers over several
seeds (sound runs), the control's (the reference in the precision below
the configuration's, put in the program's place) and, where asked, those
of a fault planted under the timed path.

    python3 portbench/calibrate.py --workload train-b16-b256 --seeds 11,12,13 \
        --control fp8 --control-seeds 21,22,23 --faults half_batch --fault-seeds 31 \
        --seconds 2

Each reading is one JSON line, with what lies under its numbers (each
checked step's loss gap and the leaves with the widest change gaps; each
checked image's gap at several quantiles of its pixels); the last line
has, per number, the largest program reading and the smallest control and
fault readings.
"""
from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from portbench import run as bench  # noqa: E402


def _ints(text: str):
    return [int(x) for x in text.split(",") if x]


def reading(cell, kind, seed, device, seconds, fault=None, control=None) -> dict:
    import torch
    runner = bench.cell_kinds()[cell.traffic["kind"]](cell, seed, device, fault)
    runner.setup()
    runner.window(seconds, False)
    runner.release()
    numbers = runner.control_numbers(control) if control else runner.numbers()
    under = details(runner.compared)
    del runner
    if device.type == "cuda":
        torch.cuda.empty_cache()
    return {"kind": kind, "seed": seed, "fault": fault, "control": control, "numbers": numbers,
            "details": under}


def details(compared) -> dict:
    from portbench.lib import judge
    if isinstance(compared, tuple):                 # a training cell's (program, reference)
        prog, ref = compared
        gaps = judge.change_gaps(prog, ref)
        return {"step_loss_gaps": [abs(p - r) / abs(r) for p, r in
                                   zip(prog["losses"], ref["losses"])],
                "widest_change_gaps": sorted(gaps.items(), key=lambda kv: -kv[1])[:5]}
    return {"image_gaps_q50_q90_q99_max": [
        [judge.image_gaps(pl, rl, q) for q in (0.5, 0.9, 0.99, 1.0)]
        for pl, rl, _, _ in compared]}


def main(argv=None) -> int:
    bench.use_checkout_caches()
    import torch
    from portbench.lib import manifest
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=_ints, default=[])
    ap.add_argument("--control", default=None, help="tf32 or fp8")
    ap.add_argument("--control-seeds", type=_ints, default=[])
    ap.add_argument("--faults", default="")
    ap.add_argument("--fault-seeds", type=_ints, default=[])
    ap.add_argument("--seconds", type=float, default=2.0)
    args = ap.parse_args(argv)
    cell = manifest.cell(args.workload)
    device = torch.device("cuda", 0)
    rows = []
    plan = [("program", s, None, None) for s in args.seeds]
    plan += [("control", s, None, args.control) for s in args.control_seeds]
    plan += [("fault", s, f, None) for f in args.faults.split(",") if f for s in args.fault_seeds]
    for kind, seed, fault, control in plan:
        row = reading(cell, kind, seed, device, args.seconds, fault, control)
        rows.append(row)
        print(json.dumps(row), flush=True)
    summary = {}
    for kind, pick in (("program", max), ("control", min), ("fault", min)):
        got = [r["numbers"] for r in rows if r["kind"] == kind]
        if got:
            summary[kind] = {k: pick(n[k] for n in got) for k in got[0]}
    print(json.dumps({"workload": args.workload, "summary": summary,
                      "card": torch.cuda.get_device_name(device)}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
