"""Port segmented engine (ocdp_tpu_torch/engine.py::value_iteration_segmented)
and checkpoints (ocdp_tpu_torch/io.py), on the CPU.

* Segments with streamed host policies are bitwise the one-shot finite
  solve; a checkpointed solve killed mid-way and resumed is bitwise the
  uninterrupted one.
* With ``tol``, the stop decision, the sweep count, the values and the
  argmin are those of ``value_iteration_converged(check_every=
  segment_size)``, also after a kill one check before the stop (the stop
  rule's last checksum ``prev_f`` travels in the checkpoint) and after a
  resume that lands between two checks.
* The segmented stop rule is evaluated only at the converged engine's check
  sweeps: a horizon whose last segment does not end on one does not stop
  there (the fault ROADMAP C.1 records in the JAX package's engine).
* Checkpoints load in both packages, and the full 6-D ``solve_full``
  segmented, killed and resumed equals the one-shot solve bitwise.
* ``policy_dtype`` as the JAX engine takes it: by default the narrowest
  that holds the actions, a wider one on request, and one too narrow
  refused by both.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ocdp_tpu import io as jio
from ocdp_tpu.engine import value_iteration_segmented as jax_segmented
from ocdp_tpu.models import kirk as jkirk
from ocdp_tpu_torch import io as tio
from ocdp_tpu_torch.engine import (value_iteration_converged,
                                   value_iteration_finite,
                                   value_iteration_segmented)
from ocdp_tpu_torch.models import attitude as tatt
from ocdp_tpu_torch.models import kirk as tkirk
from ocdp_tpu_torch.models import pos_att as tpa
from ocdp_tpu_torch.profiling import SweepTimer

torch.set_num_threads(2)

CHECK = 20       # check_every == segment_size
TOL = dict(tol=2e-2, tol_mode="rel")
HORIZON = 1000


class Killed(Exception):
    pass


def _kill_after(sweep):
    def on_segment(k, v):
        if k >= sweep:
            raise Killed(k)
    return on_segment


@pytest.fixture(scope="module")
def kirk_problem():
    return tkirk.build(tkirk.KirkConfig(N=14, dx=12, du=9), device="cpu")


@pytest.fixture(scope="module")
def channel():
    """A small pos-att channel and its plain row/lane backup: converges
    under the relative stop rule well inside the horizon."""
    cfg = tpa.PosAttConfig(n_mesh_x=8, n_mesh_v=8, n_mesh_t=6, n_mesh_w=5,
                           T_final=2.0)
    p = tpa.build_channel(cfg, "x", with_cost=False, device="cpu")
    return p, tpa.build_channel_rowlane_backup(cfg, p).plain


@pytest.fixture(scope="module")
def converged_ref(channel):
    p, bk = channel
    ref = value_iteration_converged(p.plan, None, HORIZON, check_every=CHECK,
                                    backup=bk, **TOL)
    assert ref.converged and ref.num_sweeps < HORIZON
    return ref


def _bitwise(got, want):
    assert torch.equal(got.values, want.values)
    assert torch.equal(got.argmin, want.argmin)


def test_segments_equal_one_shot_with_streamed_policies(kirk_problem):
    p = kirk_problem
    ref = value_iteration_finite(p.plan, p.stage_cost, 13,
                                 store_policies=True)
    got = value_iteration_segmented(p.plan, p.stage_cost, 13, segment_size=5,
                                    store_policies=True)
    _bitwise(got, ref)
    assert isinstance(got.policies, np.ndarray)       # host-resident
    np.testing.assert_array_equal(got.policies, ref.policies.numpy())
    assert got.num_sweeps == 13 and not got.converged


def test_checkpoint_kill_and_resume(kirk_problem, tmp_path):
    p = kirk_problem
    ckpt = str(tmp_path / "vi.npz")
    ref = value_iteration_finite(p.plan, p.stage_cost, 12)
    seen = []
    timer = SweepTimer()
    with pytest.raises(Killed):
        value_iteration_segmented(
            p.plan, p.stage_cost, 12, segment_size=4, checkpoint_path=ckpt,
            checkpoint_axes=p.grid.axes,
            on_segment=lambda k, v: (seen.append(k), timer.on_segment(k, v),
                                     _kill_after(7)(k, v)))
    assert seen == [4, 8] and timer.total_sweeps == 8
    ck = tio.load_values(ckpt)
    assert ck.sweep_index == 8 and len(ck.axes) == 2 and ck.prev_f is None
    got = value_iteration_segmented(p.plan, p.stage_cost, 12, segment_size=4,
                                    init_values=ck.values,
                                    start_sweep=ck.sweep_index)
    _bitwise(got, ref)
    assert got.num_sweeps == 4


def test_tol_stop_equals_converged_engine(channel, converged_ref):
    p, bk = channel
    got = value_iteration_segmented(p.plan, None, HORIZON,
                                    segment_size=CHECK, backup=bk, **TOL)
    assert got.converged
    assert got.num_sweeps == converged_ref.num_sweeps
    _bitwise(got, converged_ref)


def test_kill_one_check_before_the_stop_and_resume(channel, converged_ref,
                                                   tmp_path):
    """The first check after the resume stops the solve only if it compares
    against the checksum of the check before the kill, which the checkpoint
    carries."""
    p, bk = channel
    ckpt = str(tmp_path / "tol.npz")
    kill_at = converged_ref.num_sweeps - CHECK
    with pytest.raises(Killed):
        value_iteration_segmented(p.plan, None, HORIZON, segment_size=CHECK,
                                  backup=bk, checkpoint_path=ckpt,
                                  on_segment=_kill_after(kill_at), **TOL)
    ck = tio.load_values(ckpt)
    assert ck.sweep_index == kill_at and ck.prev_f is not None
    got = value_iteration_segmented(p.plan, None, HORIZON, segment_size=CHECK,
                                    backup=bk, init_values=ck.values,
                                    start_sweep=ck.sweep_index,
                                    prev_f=ck.prev_f, **TOL)
    assert got.converged and got.num_sweeps == CHECK
    _bitwise(got, converged_ref)
    # without the checksum the resumed solve runs on past the stop
    lost = value_iteration_segmented(p.plan, None, kill_at + CHECK + 1,
                                     segment_size=CHECK, backup=bk,
                                     init_values=ck.values,
                                     start_sweep=ck.sweep_index,
                                     **TOL)
    assert not lost.converged


def test_resume_between_two_checks(channel, converged_ref, tmp_path):
    p, bk = channel
    last_check = converged_ref.num_sweeps - CHECK       # a check sweep
    start = last_check + CHECK // 2                     # between two checks
    prev = value_iteration_finite(p.plan, None, last_check, backup=bk)
    mid = value_iteration_finite(p.plan, None, start, backup=bk)
    ckpt = str(tmp_path / "mid.npz")
    tio.save_values(ckpt, mid.values, start, p.grid.axes,
                    prev_f=float(prev.values.sum(dtype=torch.float32)))
    ck = tio.load_values(ckpt)
    got = value_iteration_segmented(p.plan, None, HORIZON, segment_size=CHECK,
                                    backup=bk, init_values=ck.values,
                                    start_sweep=ck.sweep_index,
                                    prev_f=ck.prev_f, **TOL)
    assert got.converged
    assert start + got.num_sweeps == converged_ref.num_sweeps
    _bitwise(got, converged_ref)


@pytest.mark.parametrize("num_sweeps", [10, 47])
def test_no_stop_at_a_final_boundary_that_is_no_check(channel, num_sweeps):
    """A tolerance every check meets: the segmented solve stops exactly
    where the converged engine does, and never at a horizon end that is not
    one of its check sweeps."""
    p, bk = channel
    loose = dict(tol=1e30, tol_mode="abs")
    ref = value_iteration_converged(p.plan, None, num_sweeps,
                                    check_every=CHECK, backup=bk, **loose)
    got = value_iteration_segmented(p.plan, None, num_sweeps,
                                    segment_size=CHECK, backup=bk, **loose)
    assert got.converged == ref.converged
    assert got.num_sweeps == ref.num_sweeps
    _bitwise(got, ref)
    if num_sweeps < CHECK - 1:          # the converged engine never checks
        assert not got.converged and got.num_sweeps == num_sweeps


def test_checkpoints_load_in_both_packages(tmp_path):
    v = np.random.default_rng(0).uniform(0, 1, (4, 5)).astype(np.float32)
    axes = (np.linspace(0, 1, 4), np.linspace(-1, 1, 5))
    path = str(tmp_path / "port.npz")
    tio.save_values(path, torch.from_numpy(v), 9, axes, prev_f=12.5)
    jv, js, jaxes = jio.load_values(path)
    np.testing.assert_array_equal(np.asarray(jv), v)
    assert js == 9 and len(jaxes) == 2
    path = str(tmp_path / "jax.npz")
    jio.save_values(path, v, 3, axes)
    ck = tio.load_values(path)
    np.testing.assert_array_equal(ck.values.numpy(), v)
    assert ck.sweep_index == 3 and ck.prev_f is None


def test_solve_full_segmented_kill_and_resume(tmp_path):
    cfg = tatt.AttitudeConfig(n_mesh_w=5, n_mesh_q=4)
    ref = tatt.solve_full(cfg, num_sweeps=8, device="cpu")
    ckpt = str(tmp_path / "att6.npz")
    tatt.solve_full(cfg, num_sweeps=5, segment_size=3, checkpoint_path=ckpt,
                    device="cpu")
    ck = tio.load_values(ckpt)
    assert ck.sweep_index == 5 and len(ck.axes) == 6
    got = tatt.solve_full(cfg, num_sweeps=8, segment_size=3,
                          init_values=ck.values, start_sweep=ck.sweep_index,
                          prev_f=ck.prev_f, verbose=True, device="cpu")
    np.testing.assert_array_equal(got.values_6d(), ref.values_6d())
    np.testing.assert_array_equal(got.argmin_6d(), ref.argmin_6d())


@pytest.mark.parametrize("dtypes", [(None, None),
                                    (torch.int16, jnp.int16),
                                    (torch.int32, jnp.int32)],
                         ids=["default", "int16", "int32"])
def test_policy_dtype_as_the_jax_engine(kirk_problem, dtypes):
    """The streamed policies in ``policy_dtype`` (default: uint8 for 9
    actions, ``policy_dtype_for``) with the JAX engine's values and
    policies on the same Kirk problem (its plain gather backup; XLA:CPU
    contracts and fuses, so values to 2e-6 * max |V|, the envelope parity
    tests' Kirk tolerance; policies equal)."""
    tdt, jdt = dtypes
    p = kirk_problem
    jp = jkirk.build(jkirk.KirkConfig(N=14, dx=12, du=9))
    want = jax_segmented(jp.plan, jp.stage_cost, 13, segment_size=5,
                         store_policies=True, policy_dtype=jdt)
    got = value_iteration_segmented(p.plan, p.stage_cost, 13, segment_size=5,
                                    store_policies=True, policy_dtype=tdt)
    assert got.policies.dtype == np.asarray(want.policies).dtype
    assert got.policies.dtype == (np.uint8 if tdt is None
                                  else np.dtype(str(tdt).split(".")[1]))
    want_v = np.asarray(want.values)
    np.testing.assert_allclose(got.values.numpy(), want_v, rtol=0,
                               atol=2e-6 * float(np.abs(want_v).max()))
    np.testing.assert_array_equal(got.policies, np.asarray(want.policies))


def test_policy_dtype_too_narrow_is_refused(kirk_problem):
    """300 actions do not fit uint8: both engines refuse it."""
    p = tkirk.build(tkirk.KirkConfig(N=3, dx=6, du=300), device="cpu")
    jp = jkirk.build(jkirk.KirkConfig(N=3, dx=6, du=300))
    with pytest.raises(ValueError, match="cannot hold 300 actions"):
        jax_segmented(jp.plan, jp.stage_cost, 2, policy_dtype=jnp.uint8)
    with pytest.raises(ValueError, match="cannot hold 300 actions"):
        value_iteration_segmented(p.plan, p.stage_cost, 2,
                                  policy_dtype=torch.uint8)
    got = value_iteration_segmented(p.plan, p.stage_cost, 2,
                                    store_policies=True)
    assert got.policies.dtype == np.int16
