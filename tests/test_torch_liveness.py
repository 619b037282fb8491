"""The tap analysis where the plan lies (ocdp_tpu_torch/ops/liveness.py and
the analyses of ``RowLaneBackup`` and ``Backup6D``) against the host
analysis in numpy (``tests/host_analysis.py``), on the CPU.

* The live tap sets, combos and action digits equal the host analysis's,
  set for set, on each pos-att channel at its published size (``x_failure``
  too), the three simplified attitude axes, the 6-D attitude plans at
  11^3 x 10^3 and 5^3 x 4^3, a flat stored plan analysed in row blocks, a
  flat recompute plan, the JAX fuzz suite's random 4-D plans and a plan
  whose lane offsets need more than 2**24 encode bins.
* Every argument tensor of ``RowLaneBackup.args`` and ``Backup6D.args`` is
  bitwise the host analysis's, on the same plans; the wide plan is
  analysed through ``torch.unique``, not refused.
* ``live_sets`` on groups of its own (random offsets and exact 0 and 1
  fracs, codes past 31 bits, row blocks, several groups in one call)
  equals ``corner_live_sets`` group by group.
* The counters: an analysis moves ``live_sets.calls`` by one and reads
  back only bounds, codes and a few flags and costs.
"""

import functools

import numpy as np
import pytest
import torch

import host_analysis as host
from ocdp_tpu_torch import convert
from ocdp_tpu_torch.models import attitude as tatt
from ocdp_tpu_torch.models import pos_att as tpa
from ocdp_tpu_torch.ops import backup6d as b6
from ocdp_tpu_torch.ops import liveness
from ocdp_tpu_torch.ops import rowlane as rl
from ocdp_tpu_torch.ops.interp import InterpPlan
from test_fuzz_rowlane_4d import _random_4d_problem

torch.set_num_threads(2)


class _Calls:
    """Wraps ``torch.<name>`` and counts its calls."""

    def __init__(self, mp, name):
        self.n, fn = 0, getattr(torch, name)

        def counted(*a, **kw):
            self.n += 1
            return fn(*a, **kw)

        mp.setattr(torch, name, counted)


def _pos_att(channel, failure):
    cfg = tpa.PosAttConfig()
    p = tpa.build_channel(cfg, channel, failure=failure, with_cost=False,
                          device="cpu")
    seen = []

    class Capture(rl.RowLaneBackup):
        def __init__(self, plan, terms, perm, *, row_axes):
            seen.append((plan, terms, perm, row_axes))
            super().__init__(plan, terms, perm, row_axes=row_axes)

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(tpa, "RowLaneBackup", Capture)
        bk = tpa.build_channel_rowlane_backup(cfg, p)
    plan, terms, perm, row_axes = seen[0]
    return bk, host.rowlane_args(plan, terms, perm, row_axes)


def _simplified(axis):
    _, plan, terms = tatt.build_simplified_axis(tatt.AttitudeConfig(), axis,
                                                device="cpu")
    bk = rl.RowLaneBackup(plan, terms, perm=(0, 1), row_axes=1)
    return bk, host.rowlane_args(plan, terms, (0, 1), 1)


def _random(seed):
    _, plan, terms, _, _ = _random_4d_problem(
        np.random.default_rng(1000 + seed), False)
    tplan = convert.plan_from_numpy(
        [np.asarray(x) for x in plan.lo], [np.asarray(x) for x in plan.frac],
        plan.grid_shape, device="cpu")
    terms = [np.array(t) for t in terms]
    bk = rl.RowLaneBackup(tplan, terms, perm=(1, 3, 0, 2), row_axes=2)
    return bk, host.rowlane_args(tplan, terms, (1, 3, 0, 2), 2)


def _wide_lanes():
    """Rows (2, 2), lanes (1300, 1300), 3 actions; each lane axis's
    offsets are -600 or +600, so the lane encode spans 1201^2 x 16 bins,
    past 2**24. Every cost part is present, ``c_rowact`` and ``c_rowlane``
    too."""
    rng = np.random.default_rng(7)
    n_l, n_a = 1300, 3
    own = np.arange(n_l, dtype=np.int32)
    shift = np.where(own < n_l // 2, 600, -600).astype(np.int32)
    lo = [rng.integers(0, 1, (2, 1, 1, 1, n_a)).astype(np.int32),
          rng.integers(0, 1, (1, 2, 1, 1, n_a)).astype(np.int32),
          (own + shift).reshape(1, 1, n_l, 1, 1),
          (own + shift).reshape(1, 1, 1, n_l, 1)]
    fr = [rng.uniform(-0.2, 1.2, a.shape).astype(np.float32) for a in lo]
    fr[2][0, 0, :5, 0, 0] = (0.0, 1.0, 0.0, 1.0, 0.5)
    plan = convert.plan_from_numpy(lo, fr, (2, 2, n_l, n_l), device="cpu")
    terms = [rng.uniform(0, 1, (2, 1, 1, 1, 1)),
             rng.uniform(0, 1, (1, 1, n_l, 1, 1)),
             rng.uniform(0, 1, (1, 1, 1, 1, n_a)),
             rng.uniform(0, 1, (2, 2, 1, 1, n_a)),
             rng.uniform(0, 1, (1, 2, 1, n_l, 1)),
             rng.uniform(0, 1, (1, 1, 1, n_l, 1))]
    with pytest.MonkeyPatch.context() as mp:
        unique = _Calls(mp, "unique")
        bk = rl.RowLaneBackup(plan, terms, perm=(0, 1, 2, 3), row_axes=2)
    assert unique.n >= 1
    return bk, host.rowlane_args(plan, terms, (0, 1, 2, 3), 2)


def _attitude6d(size, **kw):
    _, plan, cost = tatt.build_full(tatt.AttitudeConfig(**size),
                                    device="cpu", **kw)
    if b6.plan_is_flat(plan):
        return b6.Backup6D(plan, cost), host.backup6d_flat_args(plan, cost)
    return b6.Backup6D(plan, cost), host.backup6d_args(plan, cost)


def _flat_in_blocks():
    """The 7^3 x 5^3 flat stored plan, its lanes encoded in 9 row blocks
    of 40 rows, the last one overlapping backward."""
    _, plan, cost = tatt.build_full(tatt.AttitudeConfig(n_mesh_w=7,
                                                        n_mesh_q=5),
                                    device="cpu", flat=True)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(liveness, "_LIVE_BLOCK_ELEMS", 2 * 125 * 40)
        assert liveness._row_blocks(343, 125) == (40, [
            0, 40, 80, 120, 160, 200, 240, 280, 303])
        bk = b6.Backup6D(plan, cost)
    return bk, host.backup6d_flat_args(plan, cost)


CASES = {
    **{f"pos_att-{c}{'_failure' if f else ''}": functools.partial(
        _pos_att, c, f)
       for c, f in [("x", False), ("y", False), ("z", False), ("x", True)]},
    **{f"simplified-{k}": functools.partial(_simplified, k)
       for k in range(3)},
    "attitude6d-11x10": functools.partial(_attitude6d,
                                          dict(n_mesh_w=11, n_mesh_q=10)),
    "attitude6d-5x4": functools.partial(_attitude6d,
                                        dict(n_mesh_w=5, n_mesh_q=4)),
    "flat-7x5-blocks": _flat_in_blocks,
    "recompute-7x5": functools.partial(_attitude6d,
                                       dict(n_mesh_w=7, n_mesh_q=5),
                                       lane_mode="recompute"),
    **{f"random-{s}": functools.partial(_random, s) for s in range(6)},
    "wide_lanes": _wide_lanes,
}


@functools.lru_cache(maxsize=None)
def _case(name):
    return CASES[name]()


def _bits(a):
    a = host.as_numpy(a)
    return a.view(np.uint32) if a.dtype == np.float32 else a


@pytest.mark.parametrize("name", list(CASES))
def test_live_sets_equal_the_host_analysis(name):
    bk, want = _case(name)
    if isinstance(want, tuple):          # a RowLaneBackup
        want, extra = want
        assert bk.w_taps == extra["w_taps"]
        assert bk.lane_combos == extra["lane_combos"]
        assert bk.e_taps == want["lane_taps"]
    else:
        assert bk.w_taps == want["w_taps"]
        assert bk.lane_combos == want["lane_combos"]
        assert bk.action_digits == want["action_digits"]
        assert bk.e_taps == tuple(tuple(sorted({c[k] for c in
                                                want["lane_combos"]}))
                                  for k in range(3))
    assert bk.row_combos == want["row_combos"]


@pytest.mark.parametrize("name", list(CASES))
def test_args_bitwise_the_host_analysis(name):
    bk, want = _case(name)
    if isinstance(want, tuple):
        want = want[0]
    got = bk.args._asdict()
    for field, w in want.items():
        g = got[field]
        if isinstance(w, np.ndarray) or w is None:
            if w is None:
                assert g is None, field
                continue
            assert g.device.type == "cpu" and g.is_contiguous(), field
            assert tuple(g.shape) == w.shape, field
            assert g.dtype == {np.dtype(np.int32): torch.int32,
                               np.dtype(np.float32): torch.float32}[w.dtype]
            np.testing.assert_array_equal(_bits(g), _bits(w), err_msg=field)
        elif field in ("lane_off", "lane_frac"):
            assert len(g) == len(w), field
            for gk, wk in zip(g, w):
                assert gk.is_contiguous()
                np.testing.assert_array_equal(_bits(gk), _bits(wk),
                                              err_msg=field)
        else:
            assert tuple(g) == tuple(w) if isinstance(w, tuple) \
                else g == w, field


def _groups(rng, k, shape, span, n):
    """``n`` random groups of ``k`` axes broadcasting to ``shape``: offsets
    in ``[-span, span]``, fracs with exact 0s and 1s."""
    out = []
    for _ in range(n):
        offs, fracs = [], []
        for i in range(k):
            sh = tuple(s if rng.uniform() < 0.7 or j == i else 1
                       for j, s in enumerate(shape))
            offs.append(rng.integers(-span, span + 1, sh).astype(np.int32))
            f = rng.uniform(-0.3, 1.3, sh).astype(np.float32)
            f[rng.uniform(size=sh) < 0.2] = 0.0
            f[rng.uniform(size=sh) < 0.2] = 1.0
            fracs.append(f)
        out.append((offs, fracs))
    return out


@pytest.mark.parametrize("case", ["two_axes", "three_groups", "int64_codes",
                                  "row_blocks"])
def test_live_sets_of_groups(case, monkeypatch):
    rng = np.random.default_rng(len(case))
    if case == "two_axes":
        groups = _groups(rng, 2, (9, 7, 5), 2, 1)
    elif case == "three_groups":
        groups = _groups(rng, 3, (6, 5, 4), 3, 2) + \
            _groups(rng, 1, (40,), 5, 1)
    elif case == "int64_codes":
        # 3 axes of 4001 offsets each: 36 + 6 bits, past int32 and 2**24
        groups = _groups(rng, 3, (50, 40), 2000, 1)
        unique = _Calls(monkeypatch, "unique")
    else:
        monkeypatch.setattr(liveness, "_LIVE_BLOCK_ELEMS", 6 * 11 * 5)
        groups = _groups(rng, 3, (23, 11, 5), 2, 2)
    before = liveness.live_sets.calls
    got = liveness.live_sets(*(
        ([torch.from_numpy(o) for o in offs],
         [torch.from_numpy(f) for f in fracs]) for offs, fracs in groups))
    assert liveness.live_sets.calls == before + 1
    for (offs, fracs), (taps, combos) in zip(groups, got):
        want_taps, want_combos = host.corner_live_sets(offs, fracs)
        assert (taps, combos) == (want_taps, want_combos)
        assert len(combos) > 1
    if case == "int64_codes":
        assert unique.n >= 1


def test_detect_action_digits_on_the_plan_device():
    """The device check of the digit base is the host one, on a plan that
    factors and on the same plan with one column broken."""
    _, plan, cost = tatt.build_full(tatt.AttitudeConfig(n_mesh_w=5,
                                                        n_mesh_q=4),
                                    device="cpu")
    bk = b6.Backup6D(plan, cost)
    off, frac = list(bk.args.row_off), list(bk.args.row_frac)
    assert b6._detect_action_digits(off, frac, 3) == 3 == \
        host.detect_action_digits([o.numpy() for o in off],
                                  [f.numpy() for f in frac], 3)
    frac[2] = frac[2].clone()
    frac[2][7, 4] = -frac[2][7, 4] + 0.25
    assert b6._detect_action_digits(off, frac, 3) is None is \
        host.detect_action_digits([o.numpy() for o in off],
                                  [f.numpy() for f in frac], 3)


def test_counters_of_a_cpu_analysis():
    """A 6-D and a pos-att analysis each run ``live_sets`` once and read
    back only the offsets' bounds, the present codes, the digit flag and
    the action costs: a few hundred bytes, nothing of the plan."""
    _, plan, cost = tatt.build_full(tatt.AttitudeConfig(n_mesh_w=5,
                                                        n_mesh_q=4),
                                    device="cpu")
    calls, read = liveness.live_sets.calls, liveness.live_sets.read_bytes
    bk = b6.Backup6D(plan, cost)
    assert liveness.live_sets.calls == calls + 1
    n6 = liveness.live_sets.read_bytes - read
    # bounds of 6 axes, 27 + 27 combos' codes at most 4 corners, the flag,
    # 27 action costs
    assert 0 < n6 <= 8 * 12 + 8 * 4 * 54 + 1 + 4 * 27
    assert n6 < bk.args.row_off.numel()
    cfg = tpa.PosAttConfig(n_mesh_x=7, n_mesh_v=7, n_mesh_t=6, n_mesh_w=5)
    p = tpa.build_channel(cfg, "x", with_cost=False, device="cpu")
    calls, read = liveness.live_sets.calls, liveness.live_sets.read_bytes
    tpa.build_channel_rowlane_backup(cfg, p)
    assert liveness.live_sets.calls == calls + 1
    assert 0 < liveness.live_sets.read_bytes - read < 2048


def test_non_separable_plans_still_raise():
    """The shape checks run before any analysis, on the device plan."""
    cfg = tpa.PosAttConfig(n_mesh_x=7, n_mesh_v=7, n_mesh_t=6, n_mesh_w=5)
    p = tpa.build_channel(cfg, "x", device="cpu")
    lo = list(p.plan.lo)
    bad = InterpPlan(tuple([lo[0], lo[1].expand(7, 7, 1, 1, 9)] + lo[2:]),
                     tuple(p.plan.frac), p.plan.grid_shape)
    calls = liveness.live_sets.calls
    with pytest.raises(ValueError, match="row axis 0 query varies along"):
        rl.RowLaneBackup(bad, [p.stage_cost], perm=(1, 3, 0, 2), row_axes=2)
    assert liveness.live_sets.calls == calls
