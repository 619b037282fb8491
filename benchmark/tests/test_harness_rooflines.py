"""The rooflines' counts, from the taps the benchmark derives itself,
equal ``chip_smoke.py``'s counts from the port's backup objects for the
same plan."""

import dataclasses

import pytest

from benchmark.rooflines import backup6d, rowlane


def _params(cfg):
    return {f.name: getattr(cfg, f.name) for f in dataclasses.fields(cfg)}


@pytest.mark.parametrize("kw", [
    dict(n_mesh_x=10, n_mesh_v=10, n_mesh_t=8, n_mesh_w=7),
    dict(n_mesh_x=12, n_mesh_v=9, n_mesh_t=6, n_mesh_w=5, h=0.02),
])
@pytest.mark.parametrize("channel,failure", [("x", False), ("y", False),
                                             ("z", False), ("x", True)])
def test_rowlane_counts(kw, channel, failure):
    import chip_smoke
    from ocdp_tpu_torch.models import pos_att

    cfg = pos_att.PosAttConfig(**kw)
    prob = pos_att.build_channel(cfg, channel, failure=failure,
                                 with_cost=False, device="cpu")
    want = chip_smoke.rowlane_bound(
        pos_att.build_channel_rowlane_backup(cfg, prob))
    got = rowlane.sweep(*rowlane.pos_att_channel(
        _params(cfg), "xyz".index(channel), failure))
    assert got == (want["flops"], want["bytes"])


@pytest.mark.parametrize("kw", [dict(n_mesh_w=5, n_mesh_q=4),
                                dict(n_mesh_w=6, n_mesh_q=5, h=0.01)])
def test_backup6d_counts(kw):
    import chip_smoke
    from ocdp_tpu_torch.models import attitude
    from ocdp_tpu_torch.ops.backup6d import Backup6D

    cfg = attitude.AttitudeConfig(**kw)
    _, plan, cost = attitude.build_full(cfg, device="cpu")
    bk = Backup6D(plan, cost)
    want = chip_smoke.backup6d_args_bound(bk.args, bk.NE)
    got = backup6d.attitude_sweep(_params(cfg))
    assert got == (want["flops"], want["bytes"])
    s = backup6d.attitude_structure(_params(cfg))
    assert tuple(s[3]) == tuple(bk.row_combos)
    assert s[6] == bk.action_digits
