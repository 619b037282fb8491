"""The port's plotters (``ocdp_tpu_torch/viz.py``) against the JAX package's
(``ocdp_tpu/viz.py``): the same seeded arrays (tensors for the port) give
the same artists, compared exactly — line data, surface vertices and
colours, panel counts, titles and labels; the animation the same GIF."""

import matplotlib

matplotlib.use("Agg")

import matplotlib.pyplot as plt  # noqa: E402
import numpy as np  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402

from ocdp_tpu import viz as jviz  # noqa: E402
from ocdp_tpu_torch import viz as tviz  # noqa: E402

torch.set_num_threads(2)


def _inputs():
    rng = np.random.default_rng(7)
    n_t = 40
    return {
        "u_star": rng.normal(size=(5, 6, 7)).astype(np.float32),
        "axes": (np.linspace(-2.5, 3.0, 6).astype(np.float32),
                 np.linspace(-1.0, 1.0, 7).astype(np.float32)),
        "T": (np.arange(n_t) * 0.005).astype(np.float32),
        "X": rng.normal(size=(n_t, 4)).astype(np.float32),
        "U": rng.normal(size=(n_t - 1, 2)).astype(np.float32),
        "F": rng.choice([-0.13, 0.0, 0.13], size=(n_t - 1, 12))
        .astype(np.float32),
        "FM": rng.normal(size=(n_t - 1, 6)).astype(np.float32),
    }


def _tensors(d):
    return {k: (tuple(torch.from_numpy(a) for a in v) if k == "axes"
                else torch.from_numpy(v)) for k, v in d.items()}


def _calls(d):
    return {
        "plot_policy_surface": lambda m, path=None: m.plot_policy_surface(
            d["u_star"][2], d["axes"], stage=2, path=path),
        "plot_policy_stages": lambda m, path=None: m.plot_policy_stages(
            d["u_star"], d["axes"], path=path),
        "plot_rollout": lambda m, path=None: m.plot_rollout(
            d["T"], d["X"], d["U"], path=path),
        "plot_thruster_dashboard": lambda m, path=None:
            m.plot_thruster_dashboard(d["T"], d["F"], path=path),
        "plot_forces_moments": lambda m, path=None: m.plot_forces_moments(
            d["T"], d["FM"], path=path),
    }


def _artists(fig) -> list:
    """Everything a figure draws, as comparable values."""
    out = [len(fig.axes), fig._suptitle.get_text() if fig._suptitle else ""]
    for ax in fig.axes:
        out.append((ax.get_title(), ax.get_xlabel(), ax.get_ylabel(),
                    ax.get_ylim(), len(ax.lines), len(ax.collections)))
        out += [(ln.get_label(), ln.get_drawstyle(), ln.get_xydata())
                for ln in ax.lines]
        out += [(c._vec, c.get_facecolor()) for c in ax.collections]
    return out


def _same(a, b) -> bool:
    if isinstance(a, (list, tuple)):
        return len(a) == len(b) and all(_same(x, y) for x, y in zip(a, b))
    if isinstance(a, np.ndarray) or isinstance(b, np.ndarray):
        return np.array_equal(np.asarray(a), np.asarray(b))
    return a == b


@pytest.mark.parametrize("name", ["plot_policy_surface",
                                  "plot_policy_stages", "plot_rollout",
                                  "plot_thruster_dashboard",
                                  "plot_forces_moments"])
def test_plotter_draws_what_the_jax_one_draws(name, tmp_path):
    arrays = _inputs()
    path = tmp_path / f"{name}.png"
    want = _calls(arrays)[name](jviz)
    got = _calls(_tensors(arrays))[name](tviz, path=str(path))
    try:
        assert _same(_artists(got), _artists(want))
        assert path.stat().st_size > 0
    finally:
        plt.close(got)
        plt.close(want)


def test_animation_is_the_same_gif(tmp_path):
    from PIL import Image

    arrays = _inputs()
    t = _tensors(arrays)
    want = jviz.animate_policy_surface(arrays["u_star"], arrays["axes"],
                                       str(tmp_path / "jax.gif"))
    got = tviz.animate_policy_surface(t["u_star"], t["axes"],
                                      str(tmp_path / "port.gif"))
    with Image.open(got) as im:
        assert im.n_frames == arrays["u_star"].shape[0]
    assert (tmp_path / "port.gif").read_bytes() == \
        (tmp_path / "jax.gif").read_bytes()
    assert want == str(tmp_path / "jax.gif")
