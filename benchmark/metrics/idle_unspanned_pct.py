"""The share of the device-idle time inside the port's calls that the
profile pass puts down to none of the port's layer spans: each gap is
charged to the innermost span open at its start, and a gap counts as
named when that span is an ``ocdp.`` span other than ``ocdp.solve``
(whose own time names no layer). Gaps charged to the port's call itself
or to a harness wrapper count as unnamed. Nothing without the port's
spans."""

from benchmark import ocdp
from benchmark.tracing import REQUEST

LAYER = "device"
UNIT = "%"
MOVES = "solve_s"
SPANS = ocdp.TARGETS


def read(t):
    if not ocdp.recorded(t):
        return None
    inside = {n: s for n, s in t.idle.items() if n != REQUEST}
    total = sum(inside.values())
    if total <= 0:
        return None
    named = sum(s for n, s in inside.items()
                if n.startswith(ocdp.PREFIX) and n != ocdp.SOLVE)
    return 100.0 * (total - named) / total
