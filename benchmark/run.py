"""The benchmark's one command: one run of one cell on one H100.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> \\
        --trace <0|1>

(or ``python3 -m benchmark.run ...``) from the root of a checkout. It sets
up the cell (imports, the CUDA context, the port's kernel library from the
checkout's build directory, plans, warm-up requests), runs closed-loop
requests for ``--seconds`` (finishing the one in flight), judges a sample
of them, drawn from the seed, against the plain reference in
``benchmark/reference/``, and prints one JSON line last: ``correct``,
``attempted``, ``failed``, ``metrics`` (the cell's end-to-end metrics, or
with ``--trace 1`` its per-layer metrics), ``device`` (and with ``--trace
1`` a ``breakdown``), and ``checks``, each number compared beside its
limit, which also end standard error. Without enough CUDA devices, or
without the port beside it, it prints no result and exits non-zero.
"""

import os
import sys
import time

_T0 = time.perf_counter()
_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# compile caches at fixed paths inside the checkout
_CACHE = os.path.join(_ROOT, "benchmark", ".cache")
os.environ["TRITON_CACHE_DIR"] = os.path.join(_CACHE, "triton")
os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(_CACHE, "torch_extensions")
os.environ["CUDA_CACHE_PATH"] = os.path.join(_CACHE, "nv")
if _ROOT not in sys.path:
    sys.path.insert(0, _ROOT)

from benchmark import harness  # noqa: E402

if __name__ == "__main__":
    sys.exit(harness.main(sys.argv[1:], t0=_T0))
