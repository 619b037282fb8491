"""The harness's tests: CPU only, small sizes; ``cuda`` tests skip without
a card (decided inside each test). Run from the root of the checkout:
``python -m pytest benchmark/tests -q``."""

import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

# small configurations the CPU can run in seconds
SMALL = {
    "pos_att-solve": ({"n_mesh_x": 10, "n_mesh_v": 10, "n_mesh_t": 8,
                       "n_mesh_w": 7, "T_final": 0.5}, None),
    "attitude6d-solve": ({"n_mesh_w": 5, "n_mesh_q": 4, "T_final": 0.25},
                         None),
    "pos_att-fleet": ({"n_mesh_x": 10, "n_mesh_v": 10, "n_mesh_t": 8,
                       "n_mesh_w": 7, "T_final": 0.5},
                      {"draws": {"x0s": {"rows": 4}}, "fixed": {"t_final": 0.1},
                       "warmup": {"count": 1, "set": {"t_final": 0.02}},
                       "trace": {"requests": 1, "set": {"t_final": 0.05}}}),
}


def bench_with_waiting() -> dict:
    """``BENCHMARK.json`` with the cells of ``benchmark/waiting/`` (cells
    measured and left out for now) added, so that their files stay
    tested."""
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    for f in sorted((ROOT / "benchmark" / "waiting").glob("*.json")):
        w = json.loads(f.read_text())
        for key in ("workloads", "end_to_end", "per_layer"):
            bench[key] = bench[key] + w[key]
    return bench


ALL = bench_with_waiting()
CELLS = [w["name"] for w in ALL["workloads"]]
