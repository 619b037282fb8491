"""The segmented engine's checkpoints written on a host thread
(ocdp_tpu_torch/io.py::CheckpointWriter, engine.py::
value_iteration_segmented), on the CPU.

* With each file's write held until the test releases it, a plain and a
  carry-mode solve each write every segment's own table, sweep index and
  ``prev_f``, bitwise, although the next segment sweeps (and carry mode's
  ping-pong overwrites the table) meanwhile; while a write is held the
  path holds the previous checkpoint whole; the solve returns only once
  the last file is complete, bitwise the returned table, and leaves no
  temporary file.
* A path without ``.npz`` ends under ``np.savez``'s name.
* A failed write is raised from the solve, whether a later segment or the
  end of the solve finds it, and no writer thread outlives the call; an
  error already on its way out is not masked by it.
* A kill during a later segment's sweeps, or a write that fails half-way,
  leaves the previous checkpoint whole at the path, and the resume from it
  is bitwise the uninterrupted solve.
* The counters: a two-segment solve starts 2 writes, of which 1 is hidden
  when it is complete before the second checkpoint, 0 when it is not.
"""

import os
import threading

import numpy as np
import pytest
import torch

from ocdp_tpu_torch import io as tio
from ocdp_tpu_torch.engine import (value_iteration_finite,
                                   value_iteration_segmented)
from ocdp_tpu_torch.models import attitude as tatt
from ocdp_tpu_torch.models import kirk as tkirk
from ocdp_tpu_torch.ops import backup6d as b6
from ocdp_tpu_torch.ops.interp import PlanShape

torch.set_num_threads(2)

TIMEOUT = 60.0
NEVER = dict(tol=1e-30, tol_mode="abs")     # checks that never stop


class Killed(Exception):
    pass


@pytest.fixture(scope="module")
def plain():
    """A Kirk problem on its plain gather backup: ``value_iteration_finite``
    returns a new table every segment."""
    p = tkirk.build(tkirk.KirkConfig(N=14, dx=12, du=9), device="cpu")
    return dict(plan=p.plan, stage_cost=p.stage_cost, axes=p.grid.axes)


@pytest.fixture(scope="module")
def carry():
    """The 6-D envelope path at 5^3 x 4^3: flat recompute plan, uint8
    argmin, carry mode, whose two tables every segment ping-pongs."""
    grid, plan, cost = tatt.build_full(
        tatt.AttitudeConfig(n_mesh_w=5, n_mesh_q=4), device="cpu",
        lane_mode="recompute")
    bk = b6.Backup6D(plan, cost, argmin_dtype=torch.uint8,
                     carry_padded=True)
    return dict(plan=PlanShape.of(plan), stage_cost=None, backup=bk,
                axes=grid.axes)


@pytest.fixture(params=["plain", "carry"])
def problem(request):
    return request.getfixturevalue(request.param)


def _solve(prob, num_sweeps, **kw):
    return value_iteration_segmented(
        prob["plan"], prob["stage_cost"], num_sweeps,
        backup=prob.get("backup"), checkpoint_axes=prob["axes"], **kw)


def _table(prob, sweeps):
    return value_iteration_finite(prob["plan"], prob["stage_cost"], sweeps,
                                  backup=prob.get("backup")).values


def _writer_threads():
    return [t for t in threading.enumerate()
            if t.name == "ocdp.checkpoint" and t.is_alive()]


def _wait_for_writes():
    for t in _writer_threads():
        t.join(TIMEOUT)


class Held:
    """``io._write_npz`` with each write held until :meth:`release`; the
    writes that started and ended, in order."""

    def __init__(self, monkeypatch, fail_at=None):
        self.real = tio._write_npz
        self.gates = [threading.Event() for _ in range(16)]
        self.started = [threading.Event() for _ in range(16)]
        self.ended = [threading.Event() for _ in range(16)]
        self.n = 0
        self.fail_at = fail_at
        monkeypatch.setattr(tio, "_write_npz", self)

    def __call__(self, path, values, arrays):
        k = self.n
        self.n += 1
        self.started[k].set()
        assert self.gates[k].wait(TIMEOUT)
        try:
            if k == self.fail_at:
                raise OSError(f"write {k} failed")
            self.real(path, values, arrays)
        finally:
            self.ended[k].set()

    def release(self, k):
        self.gates[k].set()
        assert self.ended[k].wait(TIMEOUT)


def _in_thread(f):
    out = {}

    def run():
        try:
            out["result"] = f()
        except BaseException as e:      # handed to the test's thread
            out["error"] = e

    t = threading.Thread(target=run, daemon=True)
    t.start()
    return t, out


def _assert_checkpoint(path, prob, sweep, prev_f):
    ck = tio.load_values(path)
    assert ck.sweep_index == sweep
    assert ck.prev_f == prev_f
    assert torch.equal(ck.values, _table(prob, sweep))
    assert len(ck.axes) == len(prob["axes"])


@pytest.mark.parametrize("name", ["c.npz", "c"])
def test_every_segment_writes_its_own_table(problem, name, tmp_path,
                                            monkeypatch):
    """9 sweeps in segments of 4 with checks: segment ends 2, 6, 9 (checks
    at 2 and 6). Each write is held while the solve goes on; each file,
    once released, is its own sweep's table, and until then the path holds
    the one before. A path without ``.npz`` ends as ``np.savez`` names
    it."""
    held = Held(monkeypatch)
    path = str(tmp_path / name)
    final = str(tmp_path / "c.npz")
    t, out = _in_thread(lambda: _solve(problem, 9, segment_size=4,
                                       checkpoint_path=path, **NEVER))
    ends = [2, 6, 9]
    prev_f = {2: _table(problem, 2).sum(dtype=torch.float32)}
    prev_f[6] = _table(problem, 6).sum(dtype=torch.float32)
    prev_f[9] = prev_f[6]
    for k, sweep in enumerate(ends):
        assert held.started[k].wait(TIMEOUT)
        if k:
            # the write in flight has its own copy; the path holds the
            # previous checkpoint whole
            _assert_checkpoint(final, problem, ends[k - 1],
                               float(prev_f[ends[k - 1]]))
        else:
            assert not os.path.exists(final)
        if k == len(ends) - 1:
            assert t.is_alive()         # the last write is waited for
        held.release(k)
        _assert_checkpoint(final, problem, sweep, float(prev_f[sweep]))
    t.join(TIMEOUT)
    assert not t.is_alive()
    assert "error" not in out, out.get("error")
    assert torch.equal(out["result"].values, _table(problem, 9))
    assert torch.equal(tio.load_values(final).values, out["result"].values)
    assert os.listdir(tmp_path) == ["c.npz"]
    assert not _writer_threads()


@pytest.mark.parametrize("fail_at", [0, 2], ids=["next_segment", "last"])
def test_a_failed_write_is_raised_from_the_solve(plain, fail_at, tmp_path,
                                                 monkeypatch):
    """The first write's error is raised when the second checkpoint waits
    for it, the last one's at once; no writer thread is left and no
    temporary file."""
    held = Held(monkeypatch, fail_at=fail_at)
    for g in held.gates:
        g.set()
    with pytest.raises(OSError, match=f"write {fail_at} failed"):
        _solve(plain, 9, segment_size=4, checkpoint_path=str(
            tmp_path / "c.npz"), **NEVER)
    assert not _writer_threads()
    assert all(not f.endswith(".tmp") for f in os.listdir(tmp_path))


def test_an_unwritable_directory_is_raised_from_the_solve(plain, tmp_path):
    path = str(tmp_path / "missing" / "c.npz")
    with pytest.raises(FileNotFoundError):
        _solve(plain, 9, segment_size=4, checkpoint_path=path)
    assert not _writer_threads()


def test_an_error_on_its_way_out_is_not_masked(plain, tmp_path):
    def kill(k, _v):
        raise Killed(k)

    with pytest.raises(Killed):
        _solve(plain, 9, segment_size=4, on_segment=kill,
               checkpoint_path=str(tmp_path / "missing" / "c.npz"))
    assert not _writer_threads()


class KillAt:
    """A backup whose sweep raises :class:`Killed` at its ``n``-th call."""

    def __init__(self, backup, n):
        self.backup, self.n, self.calls = backup, n, 0

    def __getattr__(self, name):
        return getattr(self.backup, name)

    def sweep_into(self, *a):
        self.calls += 1
        if self.calls == self.n:
            raise Killed(self.calls)
        return self.backup.sweep_into(*a)


@pytest.mark.parametrize("held_write", [False, True])
def test_a_kill_in_a_later_segment_leaves_the_previous_checkpoint(
        carry, held_write, tmp_path, monkeypatch):
    """A carry-mode solve killed in its second segment's sweeps, with the
    first write complete or still held: the call ends only once that write
    is, the path holds sweep 4's table, and the resume from it is bitwise
    the uninterrupted solve."""
    path = str(tmp_path / "c.npz")
    if held_write:
        held = Held(monkeypatch)
        threading.Timer(0.3, held.gates[0].set).start()
    prob = dict(carry, backup=KillAt(carry["backup"], 6))
    with pytest.raises(Killed):
        _solve(prob, 9, segment_size=4, checkpoint_path=path)
    assert not _writer_threads()
    _assert_checkpoint(path, carry, 4, None)
    ck = tio.load_values(path)
    got = _solve(carry, 9, segment_size=4, init_values=ck.values,
                 start_sweep=ck.sweep_index)
    assert got.num_sweeps == 5
    assert torch.equal(got.values, _table(carry, 9))


def test_a_write_that_fails_half_way_leaves_the_previous_checkpoint(
        plain, tmp_path, monkeypatch):
    """The second file's write breaks off after some bytes: the path still
    holds the first checkpoint whole and no temporary file is left."""
    path = str(tmp_path / "c.npz")
    real = np.savez
    calls = []

    def savez(f, **arrays):
        calls.append(int(arrays["sweep_index"]))
        if len(calls) == 2:
            f.write(b"PK\x03\x04 a truncated zip")
            raise OSError("no space left")
        real(f, **arrays)

    monkeypatch.setattr(tio.np, "savez", savez)
    with pytest.raises(OSError, match="no space left"):
        _solve(plain, 9, segment_size=4, checkpoint_path=path)
    monkeypatch.undo()
    assert calls == [4, 8]
    _assert_checkpoint(path, plain, 4, None)
    assert os.listdir(tmp_path) == ["c.npz"]


@pytest.mark.parametrize("first_done, hidden", [(True, 1), (False, 0)],
                         ids=["complete", "held"])
def test_the_counters(plain, first_done, hidden, tmp_path, monkeypatch):
    """Two segments: 2 writes; the first is hidden when it is complete
    before the second checkpoint waits for it; the last, waited for at
    once, never is. ``wait_s`` holds the waits."""
    for name, zero in (("writes", 0), ("hidden", 0), ("wait_s", 0.0)):
        monkeypatch.setattr(tio.save_values, name, zero)
    if first_done:
        on_segment = (lambda k, v: _wait_for_writes() if k == 4 else None)
    else:
        held = Held(monkeypatch)
        held.gates[1].set()
        threading.Timer(0.2, held.gates[0].set).start()
        on_segment = None
    _solve(plain, 8, segment_size=4, on_segment=on_segment,
           checkpoint_path=str(tmp_path / "c.npz"))
    assert tio.save_values.writes == 2
    assert tio.save_values.hidden == hidden
    assert tio.save_values.wait_s > (0.0 if first_done else 0.1)
    _assert_checkpoint(str(tmp_path / "c.npz"), plain, 8, None)


def test_the_last_checkpoint_is_complete_when_its_call_returns(
        plain, tmp_path, monkeypatch):
    """The engine's own ``save_values`` call of the last segment returns
    with the file complete (so a wrapper round it, as the benchmark's
    checkpoint span, holds the unhidden write); the earlier ones return
    with their writes still held."""
    from ocdp_tpu_torch import engine

    held = Held(monkeypatch)
    threading.Timer(0.3, lambda: [g.set() for g in held.gates]).start()
    real, seen = engine.save_values, []

    def save(path, values, sweep, axes, **kw):
        real(path, values, sweep, axes, **kw)
        seen.append((sweep, bool(_writer_threads()),
                     os.path.exists(path) and
                     tio.load_values(path).sweep_index == sweep))

    monkeypatch.setattr(engine, "save_values", save)
    _solve(plain, 8, segment_size=4, checkpoint_path=str(tmp_path / "c.npz"))
    assert seen == [(4, True, False), (8, False, True)]


def test_save_values_without_a_writer_writes_at_once(tmp_path):
    """Every other caller: the file is complete when the call returns, a
    CPU table is copied (the caller may overwrite it), nothing is
    counted."""
    v = torch.arange(12, dtype=torch.float32).reshape(3, 4)
    before = tio.save_values.writes
    tio.save_values(str(tmp_path / "v"), v, 3, (np.arange(3),), prev_f=2.0)
    v.zero_()
    ck = tio.load_values(str(tmp_path / "v.npz"))
    assert torch.equal(ck.values,
                       torch.arange(12, dtype=torch.float32).reshape(3, 4))
    assert (ck.sweep_index, ck.prev_f) == (3, 2.0)
    assert tio.save_values.writes == before
    assert os.listdir(tmp_path) == ["v.npz"]
