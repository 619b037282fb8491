"""CUDA graphs a solve captures: the stream captures the runtime begins
inside the port's ``ocdp.engine.capture`` spans (one an
``engine.SweepGraph``), over the profiled solves. An exact count, so
``graph_capture_ms`` over it is the time of one capture. Nothing without
the port's spans."""

from benchmark import ocdp

LAYER = "engine: sweep loops, graphs and checks"
UNIT = "captures"
MOVES = "solve_s"
SPANS = ocdp.TARGETS
NAME = "ocdp.engine.capture"
CAPTURE_CALLS = ("cudaStreamBeginCapture",)


def read(t):
    if not t.requests or not ocdp.recorded(t):
        return None
    return sum(t.in_span.get((NAME, c), 0) for c in CAPTURE_CALLS) \
        / t.requests
