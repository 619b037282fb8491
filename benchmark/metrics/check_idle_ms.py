"""Device-idle time a solve spends in the converged engine's stop-rule
checks (the natural-order copies, the sums, their read to the host, the
stop rule and the check rows): the idle time the profile pass charges to
the port's ``ocdp.engine.check`` span, each gap to the innermost span open
at its start, per profiled solve. Nothing without the port's spans."""

from benchmark import ocdp

LAYER = "engine: sweep loops, graphs and checks"
UNIT = "ms"
MOVES = "solve_s"
SPANS = ocdp.TARGETS
NAME = "ocdp.engine.check"


def read(t):
    if not t.requests or not ocdp.recorded(t):
        return None
    return 1e3 * t.idle.get(NAME, 0.0) / t.requests
