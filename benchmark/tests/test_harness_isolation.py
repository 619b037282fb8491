"""Nothing the harness runs loads JAX or the JAX package, and the
reference loads nothing of the port. Each check runs in a fresh process,
so modules other tests loaded do not count."""

import ast
import json
import subprocess
import sys

from benchmark import harness

ROOT = harness.ROOT

RUN = """
import json, sys, time
sys.path.insert(0, {root!r})
from benchmark import harness
from benchmark.tests.conftest import SMALL
t0 = time.perf_counter()
over, mix = SMALL["pos_att-solve"]
r = harness.run_cell("pos_att-solve", 11, 0.2, False, t0=t0, device="cpu",
                     config_overrides=over, mix_overrides=mix)
print(json.dumps({{"correct": r["correct"],
                   "tops": sorted({{m.split(".")[0] for m in sys.modules}})}}))
"""

REF = """
import json, sys
sys.path.insert(0, {root!r})
from benchmark.reference import attitude, compare, dp, flight, pos_att
from benchmark.rooflines import backup6d, rowlane
from benchmark.tests.conftest import SMALL
cfg = json.load(open({root!r} + "/benchmark/configs/attitude6d-ref.json"))["params"]
cfg.update(SMALL["attitude6d-solve"][0])
dp.solve(attitude.problem(cfg, "cpu"), 5)
backup6d.attitude_sweep(cfg)
print(json.dumps(sorted({{m.split(".")[0] for m in sys.modules}})))
"""


def _tops(code):
    out = subprocess.run([sys.executable, "-c", code.format(root=str(ROOT))],
                         capture_output=True, text=True, timeout=600,
                         cwd=str(ROOT))
    assert out.returncode == 0, out.stderr[-3000:]
    return json.loads(out.stdout.strip().splitlines()[-1])


def test_a_harness_run_loads_no_jax():
    got = _tops(RUN)
    assert got["correct"] is True
    assert not set(got["tops"]) & {"jax", "jaxlib", "flax", "ocdp_tpu"}
    assert "ocdp_tpu_torch" in got["tops"]


def test_the_reference_loads_nothing_of_the_port():
    tops = set(_tops(REF))
    assert not tops & {"jax", "jaxlib", "flax", "ocdp_tpu", "ocdp_tpu_torch"}


def test_reference_sources_import_nothing_of_the_port():
    for kind in ("reference", "rooflines"):
        for path in (ROOT / "benchmark" / kind).glob("*.py"):
            for node in ast.walk(ast.parse(path.read_text())):
                names = []
                if isinstance(node, ast.Import):
                    names = [a.name for a in node.names]
                elif isinstance(node, ast.ImportFrom) and node.module \
                        and node.level == 0:
                    names = [node.module]
                for n in names:
                    assert n.split(".")[0] not in (
                        "jax", "jaxlib", "flax", "ocdp_tpu",
                        "ocdp_tpu_torch"), (path, n)


def test_no_harness_file_reads_the_tpu_records():
    for path in (ROOT / "benchmark").rglob("*.py"):
        if "tests" in path.parts:
            continue
        src = path.read_text()
        for name in ("BENCH_r0", "BASELINE.json", "MULTICHIP_r0",
                     "ocdp_tpu_torch.bench", "import bench"):
            assert name not in src, (path, name)
