"""Device-idle time a solve spends in the engines' runs of sweeps (the
host's eager enqueue of each sweep, or a graph's replay): the idle time
the profile pass charges to the port's ``ocdp.engine.sweeps`` span, each
gap to the innermost span open at its start, per profiled solve. Nothing
where the device ran nothing (a CPU run).

It declares no ``SPANS`` of its own: the port's spans are collected by
``idle_unspanned_pct`` (``benchmark.ocdp.TARGETS``), which every cell of
this metric reports, so that a gap is charged to the same span for both
metrics. A metric outside the three of the port-span tests that names an
``ocdp.`` target would change what those tests hold to be read alike."""

LAYER = "engine: sweep loops, graphs and checks"
UNIT = "ms"
MOVES = "solve_s"
NAME = "ocdp.engine.sweeps"


def read(t):
    if not t.requests or t.busy_s <= 0:
        return None
    return 1e3 * t.idle.get(NAME, 0.0) / t.requests
