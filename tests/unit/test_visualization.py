"""Smoke tests: every plotting function renders and writes files."""
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest

pytest.importorskip("matplotlib")  # plotting is an optional extra

from camera_linearity import CameraConfig, Measurand  # noqa: E402
from camera_linearity.models.image_set import ImageSet  # noqa: E402
from camera_linearity.utils import visualization as viz  # noqa: E402

CFG = CameraConfig()


def test_plot_icrf(tmp_path, rng):
    icrf = np.sort(rng.uniform(0, 1, (256, 3)), axis=0)
    viz.plot_ICRF(icrf, "icrf.png", tmp_path, CFG)
    assert (tmp_path / "icrf.png").stat().st_size > 0


def test_plot_noise_profiles(tmp_path, rng):
    data = rng.integers(0, 50, (256, 256, 3))
    viz.plot_noise_profiles_3d(data, "prof3d.png", tmp_path, CFG)
    viz.plot_noise_profiles_2d(data, 4, 10, 200, "prof2d.png", tmp_path, CFG)
    assert (tmp_path / "prof3d blue.png").exists()
    assert (tmp_path / "prof2d red.png").exists()


def test_plot_channels(tmp_path, rng):
    s = ImageSet(tmp_path / "5ms BF s 50x.tif",
                 value=jnp.asarray(rng.uniform(0, 1, (16, 16, 3))),
                 std=jnp.asarray(rng.uniform(0, 0.1, (16, 16, 3))))
    out = viz.plot_image_set_channels_separately(s)
    assert Path(out).exists()
    out2 = viz.plot_image_set_channels_separately(
        s, use_std=True, save_path=tmp_path / "std_panels.png")
    assert Path(out2).exists()


def test_create_linearity_plots(tmp_path, rng):
    n_pairs = 6
    stats = {"ratios": rng.uniform(0.1, 1.0, n_pairs),
             "means": rng.normal(0, 0.01, (n_pairs, 3)),
             "stds": rng.uniform(0.001, 0.01, (n_pairs, 3)),
             "errors": rng.uniform(0.001, 0.005, (n_pairs, 3))}
    viz.create_linearity_plots(stats, tmp_path / "lin.png", True,
                               "Relative diff", "R", CFG)
    assert (tmp_path / "lin.png").stat().st_size > 0
    stats["errors"] = None
    viz.create_linearity_plots(stats, tmp_path / "lin2.png", False,
                               "Relative diff", "R", CFG)
    assert (tmp_path / "lin2.png").exists()


def _import_scipy_odr():
    """scipy.odr is deprecated (removed in SciPy 1.19); import it quietly
    as a parity oracle while it still exists, else return None."""
    import warnings
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", DeprecationWarning)
        try:
            from scipy import odr
        except ImportError:
            return None
    return odr


def test_linearity_odr_fit_coefficients(tmp_path, rng):
    """Data-level ODR parity (reference data_visualization.py:201-206):
    the returned fit coefficients must match a direct scipy.odr run with
    the reference's exact construction (RealData(x, y, sy=std), linear
    model, beta0=[0,0]) at ODRPACK's own convergence tolerance — the
    production fit is the closed-form orthogonal_line_fit, exact at the
    stationary point, while ODRPACK stops at sstol≈√eps — and recover an
    analytic line on synthetic stats."""
    n_pairs = 10
    x = np.linspace(0.1, 1.0, n_pairs)
    A, B = 0.004, -0.012
    noise = rng.normal(0, 1e-4, (n_pairs, 3))
    means = (A + B * x)[:, None] + noise
    stds = rng.uniform(0.002, 0.01, (n_pairs, 3))
    stats = {"ratios": x, "means": means, "stds": stds,
             "errors": rng.uniform(0.001, 0.005, (n_pairs, 3))}
    fits = viz.create_linearity_plots(stats, tmp_path / "lin.png", True,
                                      "Relative diff", "R", CFG)
    assert set(fits) == set(CFG.ch_chars)
    odr = _import_scipy_odr()
    for c, cc in enumerate(CFG.ch_chars):
        if odr is not None:
            ref = odr.ODR(
                odr.RealData(x, means[:, c], sy=stds[:, c]),
                odr.Model(lambda beta, xx: beta[0] + beta[1] * xx),
                beta0=[0.0, 0.0]).run()
            np.testing.assert_allclose(fits[cc]["beta"], ref.beta,
                                       rtol=1e-5)
            np.testing.assert_allclose(fits[cc]["sd_beta"], ref.sd_beta,
                                       rtol=1e-4)
        # the fit recovers the analytic line from the synthetic stats
        np.testing.assert_allclose(fits[cc]["beta"], [A, B], atol=5e-4)
    # fit_line=False and <2 points return no fits
    assert viz.create_linearity_plots(stats, tmp_path / "l2.png", False,
                                      "d", "R", CFG) == {}
    one = {k: (v[:1] if k == "ratios" else
               (None if v is None else v[:1])) for k, v in stats.items()}
    assert viz.create_linearity_plots(one, tmp_path / "l3.png", True,
                                      "d", "R", CFG) == {}


def test_orthogonal_line_fit_exact_cases():
    """Closed-form oracles independent of scipy.odr: exact collinear
    points are recovered exactly (any weighting), and the heteroscedastic
    fit satisfies the profiled stationarity condition dS/dB = 0 of the
    ODR objective S = Σ(y−A−Bx)²/(sy²+B²)."""
    x = np.linspace(0.0, 2.0, 7)
    fit = viz.orthogonal_line_fit(x, 0.25 - 1.75 * x,
                                  np.full(7, 0.03))
    np.testing.assert_allclose(fit["beta"], [0.25, -1.75], atol=1e-12)
    np.testing.assert_allclose(fit["sd_beta"], [0.0, 0.0], atol=1e-9)

    r = np.random.default_rng(5)
    y = 0.1 + 0.7 * x + r.normal(0, 0.05, x.size)
    sy = r.uniform(0.01, 0.2, x.size)
    a, b = viz.orthogonal_line_fit(x, y, sy)["beta"]
    s2 = sy ** 2
    w = 1.0 / (s2 + b * b)
    resid = y - a - b * x
    # stationarity in A and (via the envelope theorem) in B
    assert abs(np.sum(w * resid)) < 1e-10
    assert abs(np.sum(-2 * x * resid * w
                      - 2 * b * resid ** 2 * w ** 2)) < 1e-10


def test_orthogonal_line_fit_steep_slopes_beyond_scan_grid():
    """Slopes beyond the angle-scan grid's range (|B| > tan(pi/2 -
    pi/2048) ~ 652) put the argmin on a grid edge; the bracket must
    expand geometrically to capture the optimum instead of crashing or
    handing scipy its default (0, 1) bracket."""
    x = np.linspace(0.0, 1e-3, 9)
    for slope in (2000.0, -5e4):
        fit = viz.orthogonal_line_fit(x, 0.5 + slope * x,
                                      np.full(9, 0.01))
        np.testing.assert_allclose(fit["beta"], [0.5, slope], rtol=1e-6,
                                   atol=1e-9)


def test_orthogonal_line_fit_matches_or_beats_scipy_odr(rng):
    """Against scipy.odr (while it exists) on deliberately noisy,
    heteroscedastic data: our fit's ODR objective is never worse than
    ODRPACK's (ODRPACK can stall in a local minimum from beta0=[0,0]; the
    grid-scanned closed form cannot), and where both land on the same
    optimum the coefficients agree to ODRPACK's stopping tolerance."""
    odr = _import_scipy_odr()
    if odr is None:
        import pytest
        pytest.skip("scipy.odr removed (expected in SciPy>=1.19); "
                    "exact-case oracles still cover orthogonal_line_fit")

    def s_obj(a, b, x, y, sy):
        return np.sum((y - a - b * x) ** 2 / (sy ** 2 + b * b))

    for _ in range(25):
        n = int(rng.integers(3, 30))
        x = rng.uniform(-2, 2, n)
        y = rng.normal(0, 1) + rng.normal(0, 1) * x \
            + rng.normal(0, rng.uniform(1e-4, 0.3), n)
        sy = rng.uniform(1e-3, 0.5, n)
        ref = odr.ODR(odr.RealData(x, y, sy=sy),
                      odr.Model(lambda b, xx: b[0] + b[1] * xx),
                      beta0=[0.0, 0.0]).run()
        mine = viz.orthogonal_line_fit(x, y, sy)
        s_ref = s_obj(ref.beta[0], ref.beta[1], x, y, sy)
        s_mine = s_obj(*mine["beta"], x, y, sy)
        assert s_mine <= s_ref * (1 + 1e-9)
        if s_mine >= s_ref * (1 - 1e-9):  # same optimum -> coefficients
            np.testing.assert_allclose(mine["beta"], ref.beta, rtol=5e-3,
                                       atol=1e-8)
            np.testing.assert_allclose(mine["sd_beta"], ref.sd_beta,
                                       rtol=1e-3)


def test_plot_histograms_and_kde(tmp_path, rng):
    m = Measurand(jnp.asarray(rng.uniform(0, 1, (32, 32, 3))))
    hists = m.compute_channel_histogram(16, (0.0, 1.0))
    viz.plot_histograms(hists, tmp_path, "hist", CFG)
    assert (tmp_path / "hist green.png").exists()
    kdes = m.compute_kernel_density_estimate(32, (0.0, 1.0), channels=[0])
    viz.plot_kde(kdes, tmp_path, "kde", CFG)
    assert (tmp_path / "kde blue.png").exists()
