"""Port grids (ocdp_tpu_torch/grids.py) vs the JAX package's, bitwise; and
the port's import boundary (it never imports jax)."""

import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from ocdp_tpu import grids as jgrids
from ocdp_tpu_torch import grids as tgrids

torch.set_num_threads(2)

REPO = Path(__file__).resolve().parent.parent


@pytest.mark.parametrize("fn", ["linspace_axis", "sym_linspace_inclusive",
                                "sym_linspace_exact"])
@pytest.mark.parametrize("n", [2, 7, 35, 100, 200, 201])
def test_axes_bitwise(fn, n):
    rng = np.random.default_rng(n)
    a = -float(rng.uniform(0.5, 40.0))
    b = float(rng.uniform(0.5, 40.0))
    want = getattr(jgrids, fn)(a, b, n)
    got = getattr(tgrids, fn)(a, b, n)
    assert got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)


def test_sym_axes_reject_positive_minimum():
    for fn in ("sym_linspace_inclusive", "sym_linspace_exact"):
        with pytest.raises(ValueError, match="non-positive"):
            getattr(tgrids, fn)(1.0, 2.0, 10)


def test_grid_properties_match():
    axes = (tgrids.linspace_axis(-2.5, 3.0, 35),
            tgrids.sym_linspace_exact(-1.0, 2.0, 10))
    tg, jg = tgrids.Grid(axes), jgrids.Grid(axes)
    assert (tg.ndim, tg.shape, tg.num_cells) == (jg.ndim, jg.shape,
                                                 jg.num_cells)
    assert [tg.is_uniform(k) for k in range(2)] == \
        [jg.is_uniform(k) for k in range(2)] == [True, False]
    for a, b in zip(tg.meshgrid(), jg.meshgrid()):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(
        tgrids.Grid.from_axes([0.0, 1.0, 3.0]).axes[0], [0.0, 1.0, 3.0])


@pytest.mark.parametrize("axis", [[0.0], [0.0, 0.0, 1.0], [[0.0, 1.0]]])
def test_grid_rejects_bad_axes(axis):
    with pytest.raises(ValueError):
        tgrids.Grid((np.asarray(axis),))


def test_import_leaves_jax_out():
    """``import ocdp_tpu_torch`` (and its Kirk model) pulls in no jax."""
    code = ("import sys, ocdp_tpu_torch, ocdp_tpu_torch.models.kirk, "
            "ocdp_tpu_torch.convert, ocdp_tpu_torch._build; "
            "bad = sorted(m for m in sys.modules "
            "if m in ('jax', 'ocdp_tpu') or m.startswith(('jax.', 'ocdp_tpu.'))); "
            "print(bad); sys.exit(1 if bad else 0)")
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr
