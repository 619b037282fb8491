"""Port 6-D envelope plans and sweeps (ocdp_tpu_torch/models/attitude.py's
flat, chunked and recompute builds; ops/backup6d.py's plain versions of
kernels B.4 and B.5) vs the JAX package, on the CPU.

* The flat plan against JAX ``build_full(flat=True)``: ``lo`` equal except
  where the JAX frac lies within 2e-6 of 0 or 1 (``atan2``/``asin`` differ
  by an ulp between XLA:CPU and PyTorch, so the two may take the
  neighbouring cell at the same point), ``frac`` within 2e-6; the cost
  terms bitwise.
* The chunked build equals the one-shot flat build bitwise, with
  ``block_rows`` that do not divide NW (the overlapping tail block); the
  lane count, 64, is a multiple of the CPU's vector width, because
  PyTorch's CPU ``atan2`` rounds its vector loop and its scalar tail
  differently (on the card every element rounds alike).
* The live tap sets equal JAX's ``PallasBackup6D(..., analyze_only=True)``
  for flat and recompute plans.
* One sweep of the plain versions on a flat plan (JAX's, carried over) and a
  recompute plan against JAX's kernel in interpret mode: rtol 1e-6, atol
  1e-5, argmins equal (the bar of tests/test_torch_backup6d.py); the
  recompute on a smooth table, because each side's trig moves a frac by
  ~1e-6.
* Recompute against the stored plan: within 3e-5 * max(max|V|, 1), >= 99.9%
  equal argmins (tests/test_pallas_backup6.py:236-254).
* uint8 argmin equals int32; a min-only sweep's values are bitwise the
  tracking sweep's and its argmin is zero; every lane offset of the plain
  recompute lies inside the admitted taps; the flat plan's liveness in row
  blocks equals the one-shot encode.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ocdp_tpu.models import attitude as jatt
from ocdp_tpu.ops.pallas_backup6 import PallasBackup6D
from ocdp_tpu_torch import convert
from ocdp_tpu_torch.models import attitude as tatt
from ocdp_tpu_torch.ops import backup6d as b6
from ocdp_tpu_torch.ops import liveness

torch.set_num_threads(2)

SMALL = dict(n_mesh_w=5, n_mesh_q=4)
MID = dict(n_mesh_w=7, n_mesh_q=5)


def _table(shape, seed=0, scale=100.0):
    return np.random.default_rng(seed).uniform(0.0, scale, shape) \
        .astype(np.float32)


def _cpu_build(size, **kw):
    return tatt.build_full(tatt.AttitudeConfig(**size), device="cpu", **kw)


@pytest.mark.parametrize("size", [SMALL, MID], ids=["5x4", "7x5"])
def test_flat_plan_matches_jax(size):
    _, jp, jcost = jatt.build_full(jatt.AttitudeConfig(**size), flat=True)
    grid, tp, tcost = _cpu_build(size, flat=True)
    assert tatt.plan_is_flat(tp) and tp.query_shape == tuple(jp.query_shape)
    for k in range(6):
        jl, jf = np.asarray(jp.lo[k]), np.asarray(jp.frac[k])
        tl, tf = tp.lo[k].numpy(), tp.frac[k].numpy()
        assert tl.shape == jl.shape and tl.dtype == np.int32
        same = tl == jl
        np.testing.assert_allclose(tf[same], jf[same], rtol=0, atol=2e-6)
        edge = np.minimum(np.abs(jf), np.abs(1.0 - jf)) <= 2e-6
        assert np.all(edge[~same]) and np.all(np.abs(tl - jl) <= 1)
    for t, j in zip(tcost, jcost):
        np.testing.assert_array_equal(t.numpy(), np.asarray(j))


@pytest.mark.parametrize("block_rows", [80, 216, None])
def test_chunked_build_equals_one_shot(block_rows):
    size = dict(n_mesh_w=6, n_mesh_q=4)
    _, p1, c1 = _cpu_build(size, flat=True, chunked=False)
    _, p2, c2 = _cpu_build(size, flat=True, chunked=True,
                           block_rows=block_rows)
    for a, b in zip(p1.lo + p1.frac + c1, p2.lo + p2.frac + c2):
        assert a.shape == b.shape and a.dtype == b.dtype
        assert torch.equal(a, b)
    _, pe, _ = _cpu_build(size, flat=True, chunked=True, block_rows=80,
                          edge="clamp")
    assert float(pe.frac[3].min()) >= 0.0 and float(pe.frac[3].max()) <= 1.0


def _taps(bk):
    return (tuple(map(tuple, bk.w_taps)), tuple(map(tuple, bk.row_combos)),
            tuple(map(tuple, bk.e_taps)), tuple(map(tuple, bk.lane_combos)))


@pytest.mark.parametrize("lane_mode", ["plan", "recompute"])
def test_tap_sets_match_jax(lane_mode):
    kw = dict(flat=True) if lane_mode == "plan" else dict(lane_mode=lane_mode)
    _, jp, jc = jatt.build_full(jatt.AttitudeConfig(**MID), **kw)
    _, tp, tc = _cpu_build(MID, **kw)
    want = PallasBackup6D(jp, jc, interpret=True, analyze_only=True)
    got = b6.Backup6D(tp, tc)
    assert _taps(got) == _taps(want)
    assert got.flat and got.recompute == (lane_mode == "recompute")


def test_flat_liveness_in_row_blocks(monkeypatch):
    """The row-block accumulation past the element limit (the last block
    overlapping backward) finds the one-shot encode's taps."""
    _, plan, cost = _cpu_build(MID, flat=True)
    one = b6.Backup6D(plan, cost)
    monkeypatch.setattr(liveness, "_LIVE_BLOCK_ELEMS", 2 * 125 * 40)
    rows, r0s = liveness._row_blocks(one.NW, one.NE)
    assert rows == 40 and len(r0s) == 9 and r0s[-1] == one.NW - 40
    assert _taps(b6.Backup6D(plan, cost)) == _taps(one)


@pytest.fixture(scope="module")
def jax_sweeps():
    """One sweep of JAX's kernel in interpret mode on a flat and on a
    recompute plan (5^3 x 4^3), and its inputs."""
    cfg = jatt.AttitudeConfig(**SMALL)
    grid, jp, jc = jatt.build_full(cfg, flat=True)
    _, jr, jrc = jatt.build_full(cfg, lane_mode="recompute")
    v = _table(grid.shape, seed=7)
    # a smooth table for the recompute: the state cost's shape, scaled
    smooth = (10.0 * (np.asarray(jc[0]) + np.asarray(jc[1]))).reshape(
        grid.shape).astype(np.float32)
    flat = PallasBackup6D(jp, jc, interpret=True)(jnp.asarray(v))
    rec = PallasBackup6D(jr, jrc, interpret=True,
                         argmin_dtype=jnp.uint8)(jnp.asarray(smooth))
    return dict(plan=jp, cost=jc, v=v, smooth=smooth,
                flat=jax.device_get(flat), rec=jax.device_get(rec))


def _assert_sweep_close(got, want):
    np.testing.assert_allclose(got.values.numpy(), np.asarray(want.values),
                               rtol=1e-6, atol=1e-5)
    np.testing.assert_array_equal(got.argmin.numpy().astype(np.int32),
                                  np.asarray(want.argmin).astype(np.int32))


def test_flat_sweep_matches_jax_kernel(jax_sweeps):
    """The plain B.4 sweep on JAX's own flat plan (carried over)."""
    jp = jax_sweeps["plan"]
    plan = convert.plan_from_numpy(
        [np.asarray(x) for x in jp.lo], [np.asarray(x) for x in jp.frac],
        jp.grid_shape, device="cpu")
    cost = [torch.tensor(np.asarray(c)) for c in jax_sweeps["cost"]]
    bk = b6.Backup6D(plan, cost, argmin_dtype=torch.uint8)
    got = bk(torch.from_numpy(jax_sweeps["v"]))
    assert got.argmin.dtype == torch.uint8
    _assert_sweep_close(got, jax_sweeps["flat"])


def test_recompute_sweep_matches_jax_kernel(jax_sweeps):
    """Each side recomputes its lanes with its own trig, an ulp apart, so a
    frac may move by ~1e-6 and a lo flip at a cell boundary; the sweep is
    held to the bar on a smooth table (a random one moves it by 1e-6 times
    the jump between neighbouring cells)."""
    _, plan, cost = _cpu_build(SMALL, lane_mode="recompute")
    bk = b6.Backup6D(plan, cost, argmin_dtype=torch.uint8)
    got = bk(torch.from_numpy(jax_sweeps["smooth"]))
    assert float(got.values.max()) > 50.0
    _assert_sweep_close(got, jax_sweeps["rec"])


def test_recompute_matches_stored_plan():
    grid, pp, cp = _cpu_build(MID, flat=True)
    _, pr, cr = _cpu_build(MID, lane_mode="recompute")
    bp, br = b6.Backup6D(pp, cp), b6.Backup6D(pr, cr,
                                              argmin_dtype=torch.uint8)
    assert len(br.lane_combos) <= len(bp.lane_combos) + 8
    v = torch.from_numpy(np.random.default_rng(0).normal(0, 3, grid.shape)
                         .astype(np.float32))
    rp, rr = bp(v), br(v)
    scale = float(rp.values.abs().max())
    assert float((rp.values - rr.values).abs().max()) < 3e-5 * max(scale,
                                                                   1.0)
    assert float((rp.argmin == rr.argmin.int()).float().mean()) > 0.999


@pytest.mark.parametrize("lane_mode", ["plan", "recompute"])
def test_narrow_and_min_only_sweeps(lane_mode):
    kw = dict(flat=True) if lane_mode == "plan" else dict(lane_mode=lane_mode)
    grid, plan, cost = _cpu_build(SMALL, **kw)
    v = torch.from_numpy(_table(grid.shape, seed=3))
    r32 = b6.Backup6D(plan, cost)(v)
    r8 = b6.Backup6D(plan, cost, argmin_dtype=torch.uint8)(v)
    rm = b6.Backup6D(plan, cost, argmin_dtype=torch.uint8,
                     track_argmin=False)(v)
    assert r32.argmin.dtype == torch.int32 and r8.argmin.dtype == torch.uint8
    assert torch.equal(r8.values, r32.values)
    assert torch.equal(r8.argmin.int(), r32.argmin)
    assert int(r32.argmin.max()) > 0
    assert torch.equal(rm.values, r32.values)
    assert rm.argmin.dtype == torch.uint8 and int(rm.argmin.max()) == 0


def test_recompute_offsets_lie_in_the_admitted_taps():
    _, plan, cost = _cpu_build(MID, lane_mode="recompute")
    bk = b6.Backup6D(plan, cost)
    offs, fracs = plan.spec.lane_block(0, bk.NW)
    combos = set(bk.lane_combos)
    trip = torch.unique(torch.stack([o.reshape(-1) for o in offs], 1), dim=0)
    for o0, o1, o2 in trip.tolist():
        assert all((o0 + i, o1 + j, o2 + k) in combos
                   for i in (0, 1) for j in (0, 1) for k in (0, 1))
    assert all(f.dtype == torch.float32 and f.shape == (bk.NW, bk.NE)
               for f in fracs)
