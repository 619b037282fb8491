"""The port's own profiler spans (``ocdp_tpu_torch.profiling.span``): what
a solve records while ``torch.profiler`` runs, how the spans nest, their
exact counts, and that they change nothing: the same tables, argmins and
check rows with the profiler on and off, and no ``record_function`` at
all while no profiler runs. On the CPU at small sizes; the last test
needs a card (graph captures and replays) and skips without one. This
file imports no jax:

    python -m pytest --noconftest tests/test_torch_spans.py -q
"""

import ast
import contextlib
from pathlib import Path

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from ocdp_tpu_torch import engine, profiling
from ocdp_tpu_torch.models import attitude, kirk, pos_att, position
from ocdp_tpu_torch.ops import backup6d as b6
from ocdp_tpu_torch.ops import rowlane as rl

PKG = Path(__file__).resolve().parents[1] / "ocdp_tpu_torch"

# every span the port records, and where
NAMES = {"ocdp.solve", "ocdp.build", "ocdp.rowlane.analyse",
         "ocdp.backup6d.analyse", "ocdp.backup6d.read",
         "ocdp.engine.prepare", "ocdp.engine.capture", "ocdp.engine.sweeps",
         "ocdp.engine.check", "ocdp.engine.finish"}

# four channels that stop at their 1st, 4th, 6th and 1st check (x, y, z,
# x_failure): the batch engine drops channels between checks
POS_ATT = pos_att.PosAttConfig(n_mesh_x=10, n_mesh_v=10, n_mesh_t=8,
                               n_mesh_w=7, T_final=0.5, check_every=10,
                               tol=6970.0)
ATT6D = attitude.AttitudeConfig(n_mesh_w=5, n_mesh_q=4, T_final=0.25)


def _profiled(fn):
    """``fn()``'s result and the port's spans it recorded, ``(name,
    start, end)`` in start order."""
    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    with profile(activities=acts) as prof:
        out = fn()
        if torch.cuda.is_available():
            torch.cuda.synchronize()
    spans = sorted(((e.name(), e.start_ns(), e.start_ns() + e.duration_ns())
                    for e in prof.profiler.kineto_results.events()
                    if e.name().startswith("ocdp.")
                    and not str(e.device_type()).endswith("CUDA")),
                   key=lambda s: (s[1], -s[2]))
    return out, spans


def _named(spans, name):
    return [s for s in spans if s[0] == name]


def _inside(inner, outer):
    return outer[1] <= inner[1] and inner[2] <= outer[2]


def _parents(spans, child, parent):
    """Each ``child`` span lies inside one ``parent`` span."""
    outers = _named(spans, parent)
    return all(any(_inside(c, o) for o in outers)
               for c in _named(spans, child))


def _no_self_nesting(spans):
    for name in {s[0] for s in spans}:
        own = _named(spans, name)
        for a, b in zip(own, own[1:]):
            assert a[2] <= b[1], name


def _pos_att_solve():
    return pos_att.solve(POS_ATT, device="cpu", impl="rowlane")


def _att6d_solve():
    return attitude.solve_full(ATT6D, device="cpu", impl="auto")


@pytest.fixture(scope="module")
def pos_att_traced():
    return _profiled(_pos_att_solve)


@pytest.fixture(scope="module")
def att6d_traced():
    return _profiled(_att6d_solve)


def test_span_is_a_shared_null_context_without_a_profiler():
    a = profiling.span("ocdp.x")
    assert a is profiling.span("ocdp.y", "3")
    assert isinstance(a, contextlib.nullcontext)
    with profile(activities=[ProfilerActivity.CPU]):
        got = profiling.span("ocdp.x", "3")
    assert isinstance(got, torch.profiler.record_function)


def test_every_span_name_in_the_port_is_listed_and_prefixed():
    """The literal names passed to ``span`` in the package are the ones
    the benchmark's metrics read, each under ``ocdp.``."""
    found = set()
    for path in PKG.rglob("*.py"):
        for node in ast.walk(ast.parse(path.read_text())):
            if isinstance(node, ast.Call) and getattr(
                    node.func, "id", None) == "span" and node.args and \
                    isinstance(node.args[0], ast.Constant):
                found.add(node.args[0].value)
    assert found | {"ocdp.solve"} == NAMES
    assert all(n.startswith("ocdp.") for n in found)


def test_pos_att_spans_nest_and_count(pos_att_traced):
    sol, spans = pos_att_traced
    count = {n: len(_named(spans, n)) for n in NAMES}
    assert count["ocdp.solve"] == 1
    solve = _named(spans, "ocdp.solve")[0]
    assert all(_inside(s, solve) for s in spans)
    for child in ("ocdp.build", "ocdp.rowlane.analyse", "ocdp.engine.sweeps",
                  "ocdp.engine.check", "ocdp.engine.finish"):
        assert count[child] and _parents(spans, child, "ocdp.solve"), child
    _no_self_nesting(spans)
    assert count["ocdp.build"] == count["ocdp.rowlane.analyse"] == 4
    # one check covers every running channel: as many checks as the
    # channel that ran longest filled rows
    rows = {n: int((r.checks[:, 0] != 0).sum()) for n, r in
            sol.results.items()}
    assert sorted(rows.values()) == [1, 1, 4, 6]
    assert count["ocdp.engine.check"] == max(rows.values())
    # on the CPU every run of sweeps is eager: one span a run, each a check
    assert count["ocdp.engine.sweeps"] == max(rows.values())
    assert count["ocdp.engine.finish"] == 4
    assert count["ocdp.engine.capture"] == count["ocdp.engine.prepare"] == 0
    # a stopping channel's result is cast inside the check that stops it
    assert sum(any(_inside(f, c) for c in _named(spans, "ocdp.engine.check"))
               for f in _named(spans, "ocdp.engine.finish")) == 4


def test_att6d_spans_nest_and_count(att6d_traced):
    _, spans = att6d_traced
    count = {n: len(_named(spans, n)) for n in NAMES}
    assert {n for n, c in count.items() if c} == {
        "ocdp.solve", "ocdp.build", "ocdp.backup6d.analyse",
        "ocdp.backup6d.read", "ocdp.engine.sweeps", "ocdp.engine.finish"}
    assert all(c in (0, 1) for c in count.values())
    for child in ("ocdp.build", "ocdp.backup6d.analyse",
                  "ocdp.engine.sweeps", "ocdp.engine.finish"):
        assert _parents(spans, child, "ocdp.solve"), child
    assert _parents(spans, "ocdp.backup6d.read", "ocdp.backup6d.analyse")
    _no_self_nesting(spans)


def _equal_results(a, b):
    for k in a:
        assert torch.equal(a[k][0], b[k][0]), k
        assert torch.equal(a[k][1], b[k][1]), k
        if a[k][2] is not None:
            assert torch.equal(a[k][2], b[k][2]), k


def _pos_att_tables(sol):
    return {n: (r.values, r.argmin, r.checks) for n, r in sol.results.items()}


def _att6d_tables(sol):
    return {"6d": (sol.result.values, sol.result.argmin, None)}


def test_results_are_bitwise_equal_with_the_profiler_on(pos_att_traced,
                                                        att6d_traced):
    _equal_results(_pos_att_tables(pos_att_traced[0]),
                   _pos_att_tables(_pos_att_solve()))
    _equal_results(_att6d_tables(att6d_traced[0]),
                   _att6d_tables(_att6d_solve()))


@pytest.fixture
def no_record_function(monkeypatch):
    """``record_function`` raises: a span made while no profiler runs
    would fail the solve."""
    class Refused:
        def __init__(self, *args, **kwargs):
            raise AssertionError("record_function entered with no profiler")

    monkeypatch.setattr(torch.profiler, "record_function", Refused)
    monkeypatch.setattr(torch.autograd.profiler, "record_function", Refused)


@pytest.mark.parametrize("solve", [
    _pos_att_solve, _att6d_solve,
    lambda: kirk.solve(kirk.KirkConfig(N=5, dx=11, du=7), device="cpu"),
    lambda: position.solve(position.PositionConfig(n_mesh_x=11, n_mesh_v=9),
                           num_sweeps=3, device="cpu"),
    lambda: attitude.solve_simplified(attitude.AttitudeConfig(
        n_mesh_w=11, n_mesh_t=9), num_sweeps=3, device="cpu"),
], ids=["pos_att", "attitude6d", "kirk", "position", "simplified"])
def test_no_record_function_without_a_profiler(no_record_function, solve):
    solve()


def test_solve_spans_carry_the_process_solve_number(monkeypatch):
    """Every public solve opens one ``ocdp.solve`` span whose ``args`` is
    the next number of the process's solves."""
    seen = []
    real = torch.profiler.record_function

    def recorded(name, args=None):
        seen.append((name, args))
        return real(name, args)

    monkeypatch.setattr(torch.profiler, "record_function", recorded)
    solves = [
        lambda: kirk.solve(kirk.KirkConfig(N=5, dx=11, du=7), device="cpu"),
        lambda: position.solve(position.PositionConfig(
            n_mesh_x=11, n_mesh_v=9), num_sweeps=3, device="cpu"),
        lambda: attitude.solve_simplified(attitude.AttitudeConfig(
            n_mesh_w=11, n_mesh_t=9), num_sweeps=3, device="cpu"),
        lambda: pos_att.solve_channel(POS_ATT, "x", device="cpu",
                                      max_sweeps=10),
    ]
    for solve in solves:
        _, spans = _profiled(solve)
        assert len(_named(spans, "ocdp.solve")) == 1
    numbers = [int(a) for n, a in seen if n == "ocdp.solve"]
    assert len(numbers) == len(solves)
    assert numbers == list(range(numbers[0], numbers[0] + len(solves)))
    sweeps = [a for n, a in seen if n == "ocdp.engine.sweeps"]
    assert sweeps and all(int(a) > 0 for a in sweeps)


@pytest.mark.parametrize("tol", [None, 6970.0])
def test_single_converged_engine_spans(tol):
    """The one-channel converged engine: one ``sweeps`` span a run, one
    ``check`` span a check, and the same result profiled or not."""
    cfg = POS_ATT if tol else pos_att.PosAttConfig(
        n_mesh_x=10, n_mesh_v=10, n_mesh_t=8, n_mesh_w=7, T_final=0.5,
        check_every=10)
    p = pos_att.build_channel(cfg, "y", with_cost=False, device="cpu")
    bk = pos_att.build_channel_rowlane_backup(cfg, p)

    def run():
        return engine.value_iteration_converged(
            p.plan, None, cfg.n_stage - 1, check_every=cfg.check_every,
            tol=cfg.tol, backup=bk)

    res, spans = _profiled(run)
    plain = run()
    assert torch.equal(res.values, plain.values)
    assert torch.equal(res.argmin, plain.argmin)
    assert torch.equal(res.checks, plain.checks)
    assert res.num_sweeps == plain.num_sweeps
    checks = int((res.checks[:, 0] != 0).sum())
    assert len(_named(spans, "ocdp.engine.check")) == checks
    runs = [n for n, _, _ in engine.converged_schedule(cfg.n_stage - 1,
                                                       cfg.check_every)]
    done = sum(1 for i in range(len(runs))
               if sum(runs[:i]) < res.num_sweeps)
    assert len(_named(spans, "ocdp.engine.sweeps")) == done
    assert len(_named(spans, "ocdp.engine.finish")) == 1
    assert (res.num_sweeps, res.converged) == ((40, True) if tol
                                               else (99, False))


def test_segmented_engine_checks_are_spanned():
    cfg = attitude.AttitudeConfig(n_mesh_w=5, n_mesh_q=4, T_final=0.25)

    def run():
        return attitude.solve_full(cfg, device="cpu", segment_size=10,
                                   tol=1e-30)

    sol, spans = _profiled(run)
    assert torch.equal(sol.result.values, run().result.values)
    # 49 sweeps in segments ending at the converged engine's check sweeps
    # (after sweeps 10, 20, 30, 40): four checks, none stops
    assert len(_named(spans, "ocdp.engine.check")) == 4
    assert _parents(spans, "ocdp.engine.check", "ocdp.solve")
    assert len(_named(spans, "ocdp.engine.sweeps")) == 5


@pytest.mark.cuda
def test_card_recompute_launches_one_a_sweep():
    """On a card: a segmented solve on the recompute plan counts one B.5
    launch a sweep in ``backup6d_recompute_cuda.launches``, a solve on the
    broadcast plan none (the stand-in library's count of each wrapper:
    ``tests/test_torch_backup6d_tiles.py``)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    cfg = attitude.AttitudeConfig(n_mesh_w=5, n_mesh_q=4, T_final=0.05)
    for kw, want in ((dict(lane_mode="recompute", segment_size=4,
                           tol=1e-6, tol_mode="rel"), 9), ({}, 0)):
        before = b6.backup6d_recompute_cuda.launches
        sol = attitude.solve_full(cfg, device="cuda", **kw)
        torch.cuda.synchronize()
        assert sol.result.num_sweeps == 9
        assert b6.backup6d_recompute_cuda.launches - before == want


@pytest.mark.cuda
def test_card_pos_att_captures_and_replays_are_spanned(monkeypatch):
    """On a card: one ``capture`` span a CUDA graph, one ``sweeps`` span a
    replay or eager run, and the launch counters as without a profiler."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    made, replays, runs = [], [0], [0]
    graph_init, graph_replay = engine.SweepGraph.__init__, \
        engine.SweepGraph.replay
    real_ping_pong = engine.ping_pong

    def init(self, *args, **kwargs):
        made.append(self)
        graph_init(self, *args, **kwargs)

    def replay(self):
        replays[0] += 1
        graph_replay(self)

    def ping_pong(*args):
        runs[0] += 1
        real_ping_pong(*args)

    monkeypatch.setattr(engine.SweepGraph, "__init__", init)
    monkeypatch.setattr(engine.SweepGraph, "replay", replay)
    monkeypatch.setattr(engine, "ping_pong", ping_pong)
    cfg = pos_att.PosAttConfig(check_every=10, tol=6970.0, n_mesh_x=10,
                               n_mesh_v=10, n_mesh_t=8, n_mesh_w=7,
                               T_final=0.5)
    pos_att.solve(cfg, device="cuda")                      # builds, warms
    before = rl.rowlane_backup_cuda.launches
    plain = pos_att.solve(cfg, device="cuda")
    launches = rl.rowlane_backup_cuda.launches - before
    made.clear()
    replays[0] = runs[0] = 0
    before = rl.rowlane_backup_cuda.launches
    sol, spans = _profiled(lambda: pos_att.solve(cfg, device="cuda"))
    assert rl.rowlane_backup_cuda.launches - before == launches
    assert len(_named(spans, "ocdp.engine.capture")) == len(made) >= 1
    assert len(_named(spans, "ocdp.engine.prepare")) == len(made)
    # each capture runs ping_pong once inside the graph; the rest are eager
    eager = runs[0] - len(made)
    assert len(_named(spans, "ocdp.engine.sweeps")) == replays[0] + eager
    assert _parents(spans, "ocdp.engine.capture", "ocdp.solve")
    _equal_results(_pos_att_tables(sol), _pos_att_tables(plain))
