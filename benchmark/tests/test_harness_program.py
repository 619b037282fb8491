"""The port's own spans in the traced run. ``benchmark/ocdp.py`` names them
as ``SPANS`` targets, so the accepted reduction collects them: every
existing field but ``idle`` and every existing metric read alike with
them collected, ``idle`` names them, and the three metrics that read them
do so, and read nothing without them."""

import ast
import time
from collections import Counter

import pytest

from benchmark import harness, ocdp, tracing
from benchmark.tests.conftest import ALL, SMALL

NEW = ("check_idle_ms", "graph_captures_per_solve", "idle_unspanned_pct")
WRAPPER = "pos_att.build_channel"
PKG = harness.ROOT / "ocdp_tpu_torch"


class Event:
    """What ``tracing._events`` reads of a kineto event."""

    def __init__(self, name, start, end, device=False, annotation=False):
        self._name, self._s, self._e = name, start, end
        self._dev, self._ann = device, annotation

    def name(self):
        return self._name

    def device_type(self):
        return "DeviceType.CUDA" if self._dev else "DeviceType.CPU"

    def is_user_annotation(self):
        return self._ann

    def start_ns(self):
        return self._s

    def duration_ns(self):
        return self._e - self._s


class Profile:
    def __init__(self, events):
        self.profiler = type("P", (), {})()
        self.profiler.kineto_results = type("K", (), {})()
        self.profiler.kineto_results.events = lambda: list(events)


# one request, in ns: the harness's spans, a wrapper the metrics put
# round a module attribute, the port's spans, kernels and runtime calls
HARNESS = [("bench.request", 0, 1000), ("bench.call", 10, 900),
           (WRAPPER, 25, 205)]
PORT = [("ocdp.solve", 20, 880), ("ocdp.build", 30, 200),
        ("ocdp.rowlane.analyse", 210, 400), ("ocdp.engine.capture", 410, 450),
        ("ocdp.engine.sweeps", 450, 470), ("ocdp.engine.check", 600, 700),
        ("ocdp.engine.finish", 700, 720)]
# the profiler's device-side copies of annotations
PORT_DEVICE = [("ocdp.build", 40, 60), ("ocdp.engine.sweeps", 460, 650)]
KERNELS = [("elementwise_kernel", 40, 60), ("{kernel}", 460, 650),
           ("Memcpy_DtoH", 720, 990)]
RUNTIME = [("cudaLaunchKernel", 35), ("cudaMemcpy", 300),
           ("cudaStreamBeginCapture", 420), ("cudaGraphLaunch", 455),
           ("cudaStreamSynchronize", 620), ("cudaLaunchKernel", 715),
           ("cudaStreamSynchronize", 905)]


def _events(kernel="rowlane_tiles", requests=1, port=True, loop=None):
    out = []
    for r in range(requests):
        t0 = r * 2000
        spans = HARNESS + (PORT if port else [])
        if loop:
            spans = spans + [(loop, 15, 890)]
        out += [Event(n, t0 + s, t0 + e) for n, s, e in spans]
        if port:
            out += [Event(n, t0 + s, t0 + e, device=True, annotation=True)
                    for n, s, e in PORT_DEVICE]
        out += [Event(n.format(kernel=kernel), t0 + s, t0 + e, device=True)
                for n, s, e in KERNELS]
        out += [Event(n, t0 + t, t0 + t + 2) for n, t in RUNTIME]
    return out


def _reduce(events, span_names=(WRAPPER,), context=(), config=None,
            timed=()):
    return tracing.reduce_profile(Profile(events), list(span_names),
                                  list(context), config or {},
                                  {t: 0.01 for t in timed},
                                  {t: 2 for t in timed}, 2)


def _port_names():
    """The literal names the package passes to ``span``, and the solve's."""
    found = {"ocdp.solve"}
    for path in PKG.rglob("*.py"):
        for node in ast.walk(ast.parse(path.read_text())):
            if isinstance(node, ast.Call) and getattr(
                    node.func, "id", None) == "span" and node.args and \
                    isinstance(node.args[0], ast.Constant):
                found.add(node.args[0].value)
    return found


def test_the_targets_name_every_span_the_port_records():
    assert set(ocdp.NAMES) == _port_names()
    assert [tracing.span_name(t) for t in ocdp.TARGETS] == list(ocdp.NAMES)
    for m in NEW:
        assert harness.load_module("metrics", m).SPANS == ocdp.TARGETS


def test_the_targets_are_wrapped_and_put_back():
    before = {t: getattr(ocdp, t.split(":")[1]) for t in ocdp.TARGETS}
    with tracing.wrapped(ocdp.TARGETS, tracing.spanner):
        for t, f in before.items():
            assert getattr(ocdp, t.split(":")[1]) is not f
    assert {t: getattr(ocdp, t.split(":")[1]) for t in ocdp.TARGETS} \
        == before
    with pytest.raises(RuntimeError):
        getattr(ocdp, "engine.check")()


def test_idle_names_the_port_spans_at_a_gap_start():
    ns = 1e-9
    names = [WRAPPER, *ocdp.NAMES]
    with_port = _reduce(_events(), span_names=names).idle
    uncollected = _reduce(_events(), span_names=[WRAPPER]).idle
    parent = _reduce(_events(port=False), span_names=names).idle
    # gaps [0, 40], [60, 460], [650, 720], [990, 1000]: each charged to
    # the innermost span open at its start
    assert with_port == pytest.approx({"bench.request": 50 * ns,
                                       "ocdp.build": 400 * ns,
                                       "ocdp.engine.check": 70 * ns})
    want = {"bench.request": 50 * ns, WRAPPER: 400 * ns,
            "bench.call": 70 * ns}
    assert uncollected == pytest.approx(want)
    assert parent == pytest.approx(want)


def test_the_port_spans_hold_their_runtime_calls():
    t = _reduce(_events(requests=2), span_names=[WRAPPER, *ocdp.NAMES])
    assert t.in_span[("ocdp.engine.capture", "cudaStreamBeginCapture")] == 2
    assert t.in_span[("ocdp.solve", "cudaStreamSynchronize")] == 2
    assert t.in_span[("ocdp.engine.check", "cudaStreamSynchronize")] == 2
    assert ocdp.recorded(t)
    assert not ocdp.recorded(_reduce(_events(requests=2, port=False),
                                     span_names=[WRAPPER, *ocdp.NAMES]))


def _cell_trace(cell, names):
    """A synthetic profile of two requests of ``cell`` with the port's
    spans in it, reduced with the spans ``names(mods)`` collects, and the
    metrics the cell reports."""
    over, mix = SMALL[cell]
    c = harness.load_cell(cell, device="cpu", config_overrides=over,
                          mix_overrides=mix, bench=ALL)
    mods = {m["name"]: harness.load_module("metrics", m["name"])
            for m in c.per_layer}
    if cell == "pos_att-solve":
        kernel, ctx = "rowlane_tiles", {"sweeps": {"x": 40, "y": 50,
                                                   "z": 50, "x_failure": 30}}
    elif cell == "attitude6d-solve":
        kernel, ctx = "backup6d_sweep", {"sweeps": 49}
    else:
        kernel, ctx = "rk4_kernel", {"stages": 10}
    loop = "pos_att._closed_loop" if "fleet" in cell else None
    events = _events(kernel, requests=2, loop=loop)
    timed = [t for m in mods.values() for t in getattr(m, "TIMED", ())]
    return (_reduce(events, span_names=names(mods), context=[ctx, ctx],
                    config=c.config, timed=timed), mods)


def _span_names(mods, skip=()):
    return [tracing.span_name(t) for n, m in mods.items() if n not in skip
            for t in getattr(m, "SPANS", ())]


@pytest.mark.parametrize("cell", list(SMALL))
def test_existing_fields_and_metrics_read_alike_with_port_spans(cell):
    with_port, mods = _cell_trace(cell, _span_names)
    without, _ = _cell_trace(cell, lambda m: _span_names(m, skip=NEW))
    for field in tracing.Trace._fields:
        if field == "in_span":
            # the new names add their own keys and change no other
            assert {k: v for k, v in with_port.in_span.items()
                    if not k[0].startswith(ocdp.PREFIX)} \
                == dict(without.in_span), field
        elif field != "idle":
            assert getattr(with_port, field) == getattr(without, field), \
                field
    # the port's device-side annotations are no kernels either way
    assert not any(n.startswith(ocdp.PREFIX) for n in with_port.kernels)
    read = 0
    for name, mod in mods.items():
        if name in NEW:
            continue
        a, b = mod.read(with_port), mod.read(without)
        assert a == b, name
        read += a is not None
    assert read == len([n for n in mods if n not in NEW])


def _trace(idle, in_span=(), requests=3):
    return tracing.Trace({}, {}, 0, requests, 1.0, 0.5, {}, Counter(),
                         Counter(dict(in_span)), dict(idle), [], {})


def _read(name, t):
    return harness.load_module("metrics", name).read(t)


def test_new_metrics_read_the_port_spans():
    in_span = {("ocdp.solve", "cudaLaunchKernel"): 300,
               ("ocdp.engine.capture", "cudaStreamBeginCapture"): 6,
               ("ocdp.engine.capture", "cudaLaunchKernel"): 12,
               (tracing.CALL, "cudaStreamBeginCapture"): 6}
    idle = {tracing.REQUEST: 0.01, tracing.CALL: 0.002, WRAPPER: 0.001,
            "ocdp.solve": 0.003, "ocdp.build": 0.02,
            "ocdp.rowlane.analyse": 0.05, "ocdp.engine.check": 0.024}
    t = _trace(idle, in_span)
    assert _read("check_idle_ms", t) == pytest.approx(8.0)
    assert _read("graph_captures_per_solve", t) == 2.0
    # inside the calls 0.1 s of idle: 0.094 under a layer span, 0.006
    # under the call, a wrapper or the solve's own time
    assert _read("idle_unspanned_pct", t) == pytest.approx(6.0)


def test_new_metrics_read_nothing_without_the_port_spans():
    parent = _trace({tracing.REQUEST: 0.01, tracing.CALL: 0.09},
                    {(tracing.CALL, "cudaLaunchKernel"): 300,
                     (tracing.CALL, "cudaStreamBeginCapture"): 3})
    assert all(_read(n, parent) is None for n in NEW)
    # a solve without checks or captures reads zero of them
    solo = _trace({"ocdp.solve": 0.01},
                  {("ocdp.solve", "cudaLaunchKernel"): 3})
    assert _read("check_idle_ms", solo) == 0
    assert _read("graph_captures_per_solve", solo) == 0
    assert _read("idle_unspanned_pct", solo) == 100.0
    idle_free = _trace({}, {("ocdp.solve", "cudaLaunchKernel"): 3})
    assert _read("idle_unspanned_pct", idle_free) is None


@pytest.mark.parametrize("cell", ["pos_att-solve", "attitude6d-solve"])
def test_a_traced_cpu_run_collects_the_port_spans_and_stays_correct(
        cell, monkeypatch):
    """The CPU profile has no runtime calls, so the new metrics find
    nothing there; the spans are collected all the same."""
    kept = []
    reduce_profile = tracing.reduce_profile

    def keep(prof, span_names, *args, **kwargs):
        kept.append(set(span_names))
        return reduce_profile(prof, span_names, *args, **kwargs)

    monkeypatch.setattr(tracing, "reduce_profile", keep)
    over, mix = SMALL[cell]
    r = harness.run_cell(cell, 2147491801, 0.2, True,
                         t0=time.perf_counter(), device="cpu",
                         config_overrides=over, mix_overrides=mix)
    assert kept and set(ocdp.NAMES) <= kept[0]
    assert not set(NEW) & set(r["metrics"]), r["metrics"]
    assert r["correct"], r["checks"]
