"""Port 6-D backup vs the JAX kernel (interpret mode) and the port's float64
gather oracle, for the action-phase variants: a plan whose actions are
permuted, so that they no longer factor digit by digit and the generic
action phase runs, and the row x action / row x lane cost buckets
(tests/test_pallas_backup6.py:289). Same tolerances as
tests/test_torch_backup6d.py, whose helpers this file uses.
"""

import pytest

from test_torch_backup6d import check_one_sweep


@pytest.mark.parametrize("case", ["permuted", "rowact"])
def test_one_sweep_matches_jax_kernel_and_oracle(case):
    check_one_sweep(case)
