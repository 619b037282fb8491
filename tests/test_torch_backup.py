"""Port backups vs the JAX package's, on the Kirk golden problem.

* the plain gather backup (ops/backup.py) and the fused backup's plain
  version (ops/fused_backup2d.py, what ``FusedBackup2D`` runs on a CPU
  tensor) vs JAX ``bellman_backup`` and vs the interpret-mode Pallas kernel
  the fused backup replaces (``PallasShearBackup``, action_chunk=10):
  |dV| <= 2e-6 * max(|V|, 1) and argmin >= 99.9% equal (XLA:CPU fuses and
  contracts the weight algebra; PyTorch rounds every op);
* within the port, on one device: plain gather == fused plain version ==
  separable-cost path, bitwise.

The CUDA kernel itself runs only on a card: tests/test_torch_cuda.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ocdp_tpu.models import kirk as jkirk
from ocdp_tpu.ops.backup import bellman_backup as j_backup
from ocdp_tpu.ops.pallas_shear import build_pallas_shear_backup
from ocdp_tpu_torch.models import kirk as tkirk
from ocdp_tpu_torch.ops import fused_backup2d as fb
from ocdp_tpu_torch.ops.backup import bellman_backup
from ocdp_tpu_torch.ops.interp import build_plan

torch.set_num_threads(2)

GOLDEN = tkirk.KirkConfig.golden()


@pytest.fixture(scope="module")
def problems():
    return (tkirk.build(GOLDEN, device="cpu"),
            jkirk.build(jkirk.KirkConfig.golden()))


def _values(seed, shape=(35, 35)):
    return np.random.default_rng(seed).uniform(0.0, 400.0, shape) \
        .astype(np.float32)


def _assert_close_backup(got, want_v, want_a, scale):
    dv = np.abs(got.values.numpy().astype(np.float64) - np.asarray(want_v))
    assert dv.max() <= 2e-6 * max(float(np.abs(scale).max()), 1.0)
    assert (got.argmin.numpy() == np.asarray(want_a)).mean() >= 0.999
    assert got.argmin.dtype == torch.int32


@pytest.mark.parametrize("seed", [0, 1])
def test_plain_sweep_matches_jax_gather(problems, seed):
    pt, pj = problems
    v = _values(seed)
    want = j_backup(jnp.asarray(v), pj.plan, pj.stage_cost)
    got = bellman_backup(torch.from_numpy(v), pt.plan, pt.stage_cost)
    _assert_close_backup(got, want.values, want.argmin, want.values)


def test_fused_plain_matches_pallas_shear_interpret(problems):
    """The fused backup (CPU tensor -> its plain version) vs the TPU kernel
    it replaces, run in interpret mode as tests/test_pallas_shear.py runs
    it, separable cost on both sides."""
    pt, pj = problems
    bk_j = build_pallas_shear_backup(
        pj.plan, pj.stage_cost, action_chunk=10,
        cost_terms=jkirk._separable_cost_terms(jkirk.KirkConfig.golden()))
    v = _values(3)
    want = jax.jit(lambda b, v_: b(v_))(bk_j, jnp.asarray(v))
    bk_t = fb.FusedBackup2D(
        pt.plan, pt.stage_cost,
        cost_terms=tkirk._separable_cost_terms(GOLDEN, device="cpu"))
    got = bk_t(torch.from_numpy(v))
    _assert_close_backup(got, want.values, want.argmin, want.values)


def test_fused_paths_bitwise_within_port(problems):
    """Gather oracle, fused plain version with the full cost stack, and with
    the separable split: bitwise equal on one device."""
    pt, _ = problems
    v = torch.from_numpy(_values(4))
    ref = bellman_backup(v, pt.plan, pt.stage_cost)
    full = fb.FusedBackup2D(pt.plan, pt.stage_cost)(v)
    sep = fb.FusedBackup2D(
        pt.plan, pt.stage_cost,
        cost_terms=tkirk._separable_cost_terms(GOLDEN, device="cpu"))(v)
    for out in (full, sep):
        assert torch.equal(out.values, ref.values)
        assert torch.equal(out.argmin, ref.argmin)


def test_extrapolating_queries_are_kept(problems):
    """Controls at the ends of [-40, 10] send next states off the grid: the
    plan keeps those fracs outside [0, 1] (no clamp), and the backup's
    result there matches JAX."""
    pt, pj = problems
    f0, f1 = pt.plan.frac
    assert float(f0.min()) < 0 or float(f1.min()) < 0
    assert float(f0.max()) > 1 or float(f1.max()) > 1
    v = _values(5)
    want = j_backup(jnp.asarray(v), pj.plan, pj.stage_cost)
    got = fb.FusedBackup2D(pt.plan, pt.stage_cost)(torch.from_numpy(v))
    _assert_close_backup(got, want.values, want.argmin, want.values)


def test_wrong_split_is_rejected(problems):
    pt, _ = problems
    s_c, a_c = tkirk._separable_cost_terms(GOLDEN, device="cpu")
    with pytest.raises(ValueError, match="recompose"):
        fb.FusedBackup2D(pt.plan, pt.stage_cost, cost_terms=(s_c + 1e-3, a_c))
    with pytest.raises(ValueError, match="shapes"):
        fb.FusedBackup2D(pt.plan, pt.stage_cost, cost_terms=(s_c, a_c[:-1]))


def test_exact_ties_take_the_first_action():
    """Duplicated action columns tie exactly; the first of them wins, as
    MATLAB's min does."""
    axis = np.linspace(-1.0, 1.0, 6).astype(np.float32)
    rng = np.random.default_rng(6)
    base = rng.uniform(-1.2, 1.2, (2, 6, 6, 4)).astype(np.float32)
    q = np.concatenate([base, base], axis=-1)            # actions 4..7 = 0..3
    plan = build_plan((axis, axis), tuple(torch.from_numpy(x) for x in q))
    cost = torch.zeros((6, 6, 8))
    v = torch.zeros((6, 6))                              # every total ties
    for out in (bellman_backup(v, plan, cost),
                fb.FusedBackup2D(plan, cost)(v)):
        assert torch.equal(out.argmin, torch.zeros((6, 6), dtype=torch.int32))
    v = torch.from_numpy(rng.uniform(0, 1, (6, 6)).astype(np.float32))
    ref = bellman_backup(v, plan, cost)
    assert int(ref.argmin.max()) < 4                     # never the copy
    out = fb.FusedBackup2D(plan, cost)(v)
    assert torch.equal(out.argmin, ref.argmin)
    assert torch.equal(out.values, ref.values)


def test_fused_backup_rejects_unsupported_plans():
    ax = np.linspace(0.0, 1.0, 4).astype(np.float32)
    q = torch.full((4, 4, 4, 2), 0.5)
    plan3 = build_plan((ax, ax, ax), (q, q, q))
    with pytest.raises(ValueError, match="2-D"):
        fb.FusedBackup2D(plan3, torch.zeros(4, 4, 4, 2))
    flat = build_plan((ax, ax), (torch.full((16, 3), 0.5),) * 2)
    with pytest.raises(ValueError, match="shaped"):
        fb.FusedBackup2D(flat, torch.zeros(16, 3))


def test_cuda_wrapper_refuses_what_it_cannot_launch(problems):
    """The kernel's wrapper never computes on the CPU: CPU tensors, a table
    too large for shared memory, and a wrong layout all raise."""
    pt, _ = problems
    bk = fb.FusedBackup2D(pt.plan, pt.stage_cost)
    v = torch.zeros(35, 35)
    args = (bk.lo0, bk.lo1, bk.f0, bk.f1, bk.cost)
    with pytest.raises(ValueError, match="CUDA"):
        fb.fused_backup2d_cuda(v, *args)
    with pytest.raises(ValueError, match="shared memory"):
        fb.fused_backup2d_cuda(torch.zeros(300, 300), *args)
    with pytest.raises(ValueError, match="lo0"):
        fb.fused_backup2d_cuda(v, bk.lo0.long(), *args[1:])
    with pytest.raises(ValueError, match="cost"):
        fb.fused_backup2d_cuda(v, *args[:4])
    assert fb.fused_backup2d_cuda.launches == 0


def test_build_is_keyed_by_sources_and_needs_nvcc(tmp_path, monkeypatch):
    """The library name follows the sources' content; without a CUDA
    toolkit the build raises instead of falling back."""
    import torch.utils.cpp_extension as cpp

    from ocdp_tpu_torch import _build

    real = _build.library_path()
    assert real.parent == _build.BUILD_DIR and real.suffix == ".so"
    assert _build.library_path() == real                 # deterministic
    src = tmp_path / "k.cu"
    src.write_text("// one\n")
    monkeypatch.setattr(_build, "CSRC", tmp_path)
    first = _build.library_path()
    src.write_text("// two\n")
    assert _build.library_path() != first != real
    monkeypatch.setattr(cpp, "CUDA_HOME", None)
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build._nvcc()
