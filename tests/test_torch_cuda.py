"""The fused 2-D backup's CUDA kernel vs its plain PyTorch version, on a card.

Both round every multiply and add separately and take the first minimum,
so on one device they must agree bitwise: values and argmin. Every test
here needs a CUDA device and skips without one. This file imports no jax,
so it also runs where only PyTorch is installed:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py -q
"""

import numpy as np
import pytest
import torch

from ocdp_tpu_torch.models import kirk
from ocdp_tpu_torch.ops import fused_backup2d as fb
from ocdp_tpu_torch.ops.interp import build_plan
from ocdp_tpu_torch.profiling import cuda_time_ms

pytestmark = pytest.mark.cuda


@pytest.fixture(scope="module")
def device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _bitwise(a, b):
    assert torch.equal(a.values, b.values)
    assert torch.equal(a.argmin, b.argmin)


def _kernel_vs_plain(bk, v):
    args = (v, bk.lo0, bk.lo1, bk.f0, bk.f1, bk.cost, bk.state_cost,
            bk.action_cost)
    before = fb.fused_backup2d_cuda.launches
    got = bk(v)
    torch.cuda.synchronize()
    assert fb.fused_backup2d_cuda.launches == before + 1
    _bitwise(got, fb.fused_backup2d_plain(*args))


@pytest.mark.parametrize("cfg", [kirk.KirkConfig.golden(),
                                 kirk.KirkConfig(N=3)],
                         ids=["golden", "full"])
@pytest.mark.parametrize("separable", [True, False])
def test_one_sweep_bitwise(device, cfg, separable):
    p = kirk.build(cfg, device=device)
    terms = kirk._separable_cost_terms(cfg, device=device) if separable \
        else None
    bk = fb.FusedBackup2D(p.plan, p.stage_cost, cost_terms=terms)
    rng = np.random.default_rng(cfg.dx)
    v = torch.from_numpy(rng.uniform(0, 400, (cfg.dx, cfg.dx))
                         .astype(np.float32)).to(device)
    _kernel_vs_plain(bk, v)


def test_exact_ties_take_the_first_action(device):
    axis = np.linspace(-1.0, 1.0, 6).astype(np.float32)
    rng = np.random.default_rng(6)
    base = rng.uniform(-1.2, 1.2, (2, 6, 6, 40)).astype(np.float32)
    q = np.concatenate([base, base], axis=-1)      # actions 40..79 = 0..39
    plan = build_plan((axis, axis),
                      tuple(torch.from_numpy(x).to(device) for x in q))
    bk = fb.FusedBackup2D(plan, torch.zeros((6, 6, 80), device=device))
    zero = torch.zeros((6, 6), device=device)
    assert torch.equal(bk(zero).argmin, torch.zeros_like(zero, dtype=torch.int32))
    _kernel_vs_plain(bk, torch.rand((6, 6), device=device))


def test_solve_kernel_equals_gather(device):
    cfg = kirk.KirkConfig(N=20, dx=40, du=300)
    before = fb.fused_backup2d_cuda.launches
    sk = kirk.solve(cfg, device=device, impl="kernel")
    assert fb.fused_backup2d_cuda.launches == before + cfg.N - 1
    sg = kirk.solve(cfg, device=device, impl="gather")
    assert torch.equal(sk.result.values, sg.result.values)
    assert torch.equal(sk.result.policies, sg.result.policies)


def test_wrapper_refuses_mixed_devices(device):
    p = kirk.build(kirk.KirkConfig.golden(), device="cpu")
    bk = fb.FusedBackup2D(p.plan, p.stage_cost)
    with pytest.raises(ValueError, match="CUDA device"):
        bk(torch.zeros((35, 35), device=device))


def test_cuda_time_ms(device):
    ms = cuda_time_ms(lambda: torch.ones(1 << 20, device=device).sum(),
                      inner=3, repeats=3)
    assert 0.0 < ms < 1000.0
