"""Port 6-D coupled-lane backup (ocdp_tpu_torch/ops/backup6d.py) vs the JAX
package's ``PallasBackup6D`` (interpret mode, as the JAX tests run it on the
CPU) and the port's gather oracle.

Both backups get the same plan: the port's ``build_full`` plan, carried to
JAX as numpy. The port's gather oracle runs in float64 on that plan (the
float32 gather sums in another order and can flip a near tie). Tolerances are the JAX package's own for its kernel against
its oracle (tests/test_pallas_backup6.py:32-41): values rtol 1e-6, atol
1e-5, argmins equal; XLA:CPU contracts products into FMAs where PyTorch
rounds every op, so the agreement is to f32 rounding, not bitwise. On a
card, the kernel equals ``backup6d_plain`` bitwise (tests/test_torch_cuda.py).
The generic action phase and the coupled cost buckets are in
tests/test_torch_backup6d_actions.py (each JAX interpret-mode sweep takes
about 10 s on the CPU).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ocdp_tpu.ops.interp import InterpPlan as JaxPlan
from ocdp_tpu.ops.pallas_backup6 import PallasBackup6D
from ocdp_tpu_torch.models import attitude as tatt
from ocdp_tpu_torch.ops import backup6d as b6
from ocdp_tpu_torch.ops.backup import bellman_backup
from ocdp_tpu_torch.ops.interp import InterpPlan

torch.set_num_threads(2)

SMALL = dict(n_mesh_w=5, n_mesh_q=4)


def _problem(case):
    """(plan, cost_terms) of one one-sweep case, on the CPU."""
    kw = dict(SMALL)
    edge = "extrapolate"
    if case == "clamp":
        edge = "clamp"
    elif case == "asymmetric":
        kw = dict(n_mesh_w=4, n_mesh_q=3, yaw_range_deg=(-40.0, 25.0),
                  pitch_range_deg=(-15.0, 20.0))
    elif case == "tie":
        kw["h"] = 0.0
    _, plan, cost = tatt.build_full(tatt.AttitudeConfig(**kw), edge=edge,
                                    device="cpu")
    cost = list(cost)
    rng = np.random.default_rng(3)
    if case == "tie":
        # every query on its own grid point and no cost: all 27 actions tie
        cost = [torch.zeros_like(t) for t in cost]
    elif case == "permuted":
        perm = torch.from_numpy(rng.permutation(27))
        plan = InterpPlan(
            tuple(x[..., perm] if x.shape[-1] > 1 else x for x in plan.lo),
            tuple(x[..., perm] if x.shape[-1] > 1 else x for x in plan.frac),
            plan.grid_shape)
        cost[2] = cost[2][..., perm]
    elif case == "rowact":
        nw, nq = SMALL["n_mesh_w"], SMALL["n_mesh_q"]
        cost.append(torch.from_numpy(rng.uniform(
            0, 2, (nw,) * 3 + (1, 1, 1, 27)).astype(np.float32)))
        cost.append(torch.from_numpy(rng.uniform(
            0, 2, (nw,) * 3 + (nq,) * 3 + (1,)).astype(np.float32)))
    return plan, cost


def _jax_plan(plan):
    return JaxPlan(tuple(jnp.asarray(x.numpy()) for x in plan.lo),
                   tuple(jnp.asarray(x.numpy()) for x in plan.frac),
                   plan.grid_shape)


def check_one_sweep(case):
    """One sweep of the port's plain backup against its float64 gather
    oracle and the JAX kernel, on the same plan and table."""
    plan, cost = _problem(case)
    bk = b6.Backup6D(plan, cost)
    assert (bk.action_digits is None) == (case == "permuted")
    assert (bk.args.c_rowact is not None) == (case == "rowact")
    v = np.random.default_rng(11).uniform(
        0.0, 1.0, plan.grid_shape).astype(np.float32)
    got = bk(torch.from_numpy(v))
    gv, ga = got.values.numpy(), got.argmin.numpy()
    assert got.argmin.dtype == torch.int32

    # the port's gather oracle, in float64 on the same plan: the float32
    # gather sums in another order and can flip a near tie
    ref = bellman_backup(torch.from_numpy(v).double(), InterpPlan(
        plan.lo, tuple(f.double() for f in plan.frac), plan.grid_shape),
        [t.double() for t in cost])
    np.testing.assert_allclose(gv, ref.values.numpy(), rtol=1e-6, atol=1e-5)
    np.testing.assert_array_equal(ga, ref.argmin.numpy())

    jterms = [jnp.asarray(t.numpy()) for t in cost]
    jbk = PallasBackup6D(_jax_plan(plan), jterms, interpret=True)
    assert not jbk.lane_separable
    assert (jbk.w_taps, jbk.row_combos, jbk.lane_combos,
            jbk.action_digits) == (bk.w_taps, bk.row_combos, bk.lane_combos,
                                   bk.action_digits)
    want = jbk(jnp.asarray(v))
    np.testing.assert_allclose(gv, np.asarray(want.values), rtol=1e-6,
                               atol=1e-5)
    np.testing.assert_array_equal(ga, np.asarray(want.argmin))
    if case == "tie":
        assert int(ga.max()) == 0          # the first of the tied actions
        np.testing.assert_allclose(gv, v, atol=2e-6)


@pytest.mark.parametrize("case", ["extrapolate", "clamp", "tie",
                                  "asymmetric"])
def test_one_sweep_matches_jax_kernel_and_oracle(case):
    check_one_sweep(case)


def test_cost_split_and_args():
    plan, cost = _problem("extrapolate")
    bk = b6.Backup6D(plan, cost)
    nw, nq = SMALL["n_mesh_w"], SMALL["n_mesh_q"]
    a = bk.args
    assert (bk.NW, bk.NE) == (nw**3, nq**3)
    assert a.row_off.shape == (3, nw**3, 27) and a.row_off.dtype == torch.int32
    assert all(t.shape == (nw**3, nq**3) for t in a.lane_off + a.lane_frac)
    np.testing.assert_array_equal(bk.c_row, cost[0].numpy().reshape(-1))
    np.testing.assert_array_equal(bk.c_lane, cost[1].numpy().reshape(-1))
    np.testing.assert_array_equal(bk.c_act, cost[2].numpy().reshape(-1))
    assert a.c_rowact is None and a.c_rowlane is None
    # 27 row combos x 27 lane combos, actions factor with digit base 3
    assert len(bk.row_combos) == len(bk.lane_combos) == 27
    assert bk.action_digits == 3
    assert len(a.row_deltas()) == len(a.lane_deltas()) == 27


def test_plain_equals_itself_through_the_wrapper_and_args():
    """``Backup6D`` on a CPU tensor is ``backup6d_plain`` on its args, and
    ``.plain`` is the same on any device."""
    plan, cost = _problem("extrapolate")
    bk = b6.Backup6D(plan, cost)
    v = torch.rand(plan.grid_shape, generator=torch.Generator().manual_seed(0))
    r1 = bk(v)
    r2 = b6.backup6d_plain(v.reshape(bk.NW, bk.NE), bk.args)
    r3 = bk.plain(v)
    assert torch.equal(r1.values.reshape(bk.NW, bk.NE), r2.values)
    assert torch.equal(r1.argmin, r3.argmin)


def test_rejections():
    plan, cost = _problem("extrapolate")
    nq = SMALL["n_mesh_q"]
    with pytest.raises(ValueError, match="lane and action"):
        b6.Backup6D(plan, cost + [torch.ones((1, 1, 1, nq, nq, nq, 27))])
    lo, frac = list(plan.lo), list(plan.frac)
    bad = InterpPlan(tuple([lo[0].expand(5, 5, 5, 4, 4, 4, 27)] + lo[1:]),
                     tuple(frac), plan.grid_shape)
    with pytest.raises(ValueError, match="row axis 0 query varies along"):
        b6.Backup6D(bad, cost)
    bad = InterpPlan(tuple(lo[:3] + [lo[3].expand(5, 5, 5, 4, 4, 4, 27)]
                           + lo[4:]), tuple(frac), plan.grid_shape)
    with pytest.raises(ValueError, match="varies with the action"):
        b6.Backup6D(bad, cost)
    # more than 40 live row combos (7 taps an axis): a coarse omega grid, a
    # big step
    _, wide, wcost = tatt.build_full(
        tatt.AttitudeConfig(n_mesh_w=5, n_mesh_q=3, u_max=5.0),
        device="cpu")
    with pytest.raises(ValueError, match="exceed the kernel"):
        b6.Backup6D(wide, wcost)
    # the kernel wrapper takes CUDA tensors only; nothing is launched
    bk = b6.Backup6D(plan, cost)
    before = b6.backup6d_cuda.launches
    with pytest.raises(ValueError, match="CUDA device"):
        b6.backup6d_cuda(torch.zeros((bk.NW, bk.NE)), bk.args)
    assert b6.backup6d_cuda.launches == before


def test_detect_action_digits():
    rng = np.random.default_rng(0)
    cols = rng.integers(-1, 1, (3, 4, 3))            # (axis, row, digit)
    a = np.arange(27)
    digit = [a // 9, (a // 3) % 3, a % 3]
    off = [cols[k][:, digit[k]] for k in range(3)]
    frac = [o.astype(np.float32) / 4 for o in off]
    assert b6._detect_action_digits(off, frac, 3) == 3
    off[1] = off[1][:, rng.permutation(27)]
    assert b6._detect_action_digits(off, frac, 3) is None
