"""Device-idle time a solve spends in the segmented engine's checkpoints
(``ocdp_tpu_torch.io.save_values`` as the engine calls it: the table's
copy to the host and the file's write): the idle time the profile pass
charges to the span this metric wraps round that call, each gap to the
innermost span open at its start, per profiled solve. The copy itself is
device time, so this reads the write and the host work around it. Nothing
where no checkpoint was written."""

from benchmark import tracing

LAYER = "engine: sweep loops, graphs and checks"
UNIT = "ms"
MOVES = "solve_s"
SPANS = ("ocdp_tpu_torch.engine:save_values",)
NAME = tracing.span_name(SPANS[0])


def read(t):
    if not t.requests or not any(s == NAME for s, _ in t.in_span):
        return None
    return 1e3 * t.idle.get(NAME, 0.0) / t.requests
