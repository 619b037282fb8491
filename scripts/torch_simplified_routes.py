#!/usr/bin/env python3
"""Hold the simplified attitude solve's three routes to one another on one
CUDA device: the row/lane backup (``impl='rowlane'``, kernel B.2), the
banded one (``auto``, B.6) and the gather oracle (``impl='gather'``).

    python3 scripts/torch_simplified_routes.py [--sweeps 300,1000,5999]

For ``AttitudeConfig()`` and ``AttitudeConfig(n_mesh_t=1000)``, after each
count of sweeps and on each axis, prints for each pair of routes the
largest per-cell relative distance of the values (and the |V| of that
cell), the largest distance over the table's max |V|, the share of cells
past a relative 2e-5, and the share of equal torque tables. The routes sum
the interpolation in different orders, so they part by rounding only; the
numbers say how far, cell by cell and against the table's scale. Prints
the card's name and power limit first. Needs a CUDA device.
"""

import argparse
import subprocess
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import torch  # noqa: E402

from ocdp_tpu_torch.models import attitude  # noqa: E402

CONFIGS = {"AttitudeConfig()": {}, "n_mesh_t=1000": {"n_mesh_t": 1000}}
ROUTES = ("rowlane", "auto", "gather")


def distance(a, b, ua, ub) -> str:
    d = (a - b).abs()
    rel = d / b.abs().clamp_min(1e-30)
    i = int(rel.argmax())
    return (f"max relative {float(rel.max()):.3e} (|V| "
            f"{float(b.flatten()[i]):.4g}), max |dV| / max |V| "
            f"{float(d.max() / b.abs().max()):.3e}, share past 2e-5 "
            f"{float((rel > 2e-5).double().mean()):.2e}, equal torques "
            f"{float((ua == ub).double().mean()):.6f}")


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--sweeps", default="300,1000,5999")
    opts = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA device")
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip())
    for label, kw in CONFIGS.items():
        cfg = attitude.AttitudeConfig(**kw)
        for n in (int(x) for x in opts.sweeps.split(",")):
            sol = {r: attitude.solve_simplified(cfg, num_sweeps=n, impl=r)
                   for r in ROUTES}
            for axis in range(3):
                for x, y in (("rowlane", "auto"), ("gather", "auto"),
                             ("rowlane", "gather")):
                    print(f"{label}, {n} sweeps, axis {axis}, {x} vs {y}: "
                          + distance(sol[x].values[axis],
                                     sol[y].values[axis],
                                     sol[x].u_tables[axis],
                                     sol[y].u_tables[axis]), flush=True)


if __name__ == "__main__":
    main()
