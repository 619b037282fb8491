"""The control of the check: the plain reference in bfloat16 (the
precision below the configurations' float32: its tables and states kept
in bfloat16, each sweep and stage computed in float32), put in the port's
place and judged as the port's outputs are. A sound check reads it as not
correct.

    python3 benchmark/control.py --workload <cell> --seeds 1 2 3

prints each seed's numbers beside the cell's limits and whether any limit
fails (it must), and exits 1 when a seed's control passes every limit.
With ``--program`` it reads the port's numbers instead, for the first
request each seed draws (the lower readings the limits are set above),
and exits 1 when one fails a limit.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

import torch

_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if _ROOT not in sys.path:
    sys.path.insert(0, _ROOT)

from benchmark import harness, traffic  # noqa: E402


def control_numbers(cell, seed: int, store=torch.bfloat16) -> dict:
    """The numbers the check reads off the control's outputs for the first
    request drawn from ``seed``."""
    entry = harness.load_module("entries", cell.mix["entry"])
    params = traffic.Generator(cell.mix, cell.config, seed).next()
    return entry.check(cell, [entry.control(cell, params, store)])


def program_numbers(cell, seeds) -> list:
    """The numbers the check reads off the port's outputs for the first
    request each of ``seeds`` draws, one set-up for all."""
    entry = harness.load_module("entries", cell.mix["entry"])
    state = entry.setup(cell)
    out = []
    for seed in seeds:
        params = traffic.Generator(cell.mix, cell.config, seed).next()
        item = entry.keep(state, entry.request(state, params), params)
        out.append(entry.check(cell, [item]))
    return out


def fails(numbers: dict, limits: dict) -> list:
    return [k for k, lim in limits.items()
            if not numbers.get(k, float("inf")) <= lim]


def main(argv) -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--program", action="store_true")
    args = ap.parse_args(argv)
    cell = harness.load_cell(args.workload, device=args.device)
    limits = cell.mix["check"]["limits"]
    if args.program:
        rows = program_numbers(cell, args.seeds)
    else:
        rows = [control_numbers(cell, seed) for seed in args.seeds]
    wrong = 0
    for seed, nums in zip(args.seeds, rows):
        bad = fails(nums, limits)
        wrong += bool(bad) if args.program else not bad
        print(json.dumps({"workload": args.workload, "seed": seed,
                          "side": "program" if args.program else "control",
                          "numbers": nums, "fails": bad}), flush=True)
    return 1 if wrong else 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
