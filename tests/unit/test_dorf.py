"""DoRF import + PCA basis tests, including sklearn parity."""
import numpy as np
import pytest

from camera_linearity import CameraConfig
from camera_linearity.models import dorf


def _write_dorf(tmp_path, curves_named, datapoints=32):
    """Synthesize a dorfCurves.txt: 6-line records (name, type, info, 'I =',
    irradiance row, 'B =' row? — reference format: line6 = values)."""
    lines = []
    x = np.linspace(0, 1, datapoints)
    for name, gamma in curves_named:
        y = x ** gamma
        lines += [name, "type", "info", "I = ",
                  "  " + " ".join(f"{v:.6f}" for v in x),
                  "  " + " ".join(f"{v:.6f}" for v in y)]
    p = tmp_path / "dorfCurves.txt"
    p.write_text("\n".join(lines) + "\n")
    return p


def test_read_dorf_classifies_channels(tmp_path):
    p = _write_dorf(tmp_path, [("cam1Red", 2.0), ("cam1Green", 2.2),
                               ("cam1Blue", 2.4), ("gammaCurve", 1.8)])
    blue, green, red = dorf.read_dorf_data(p, include_gamma=False,
                                           color_split=True,
                                           dorf_datapoints=32)
    assert red.shape == (1, 32)
    assert green.shape == (1, 32)
    assert blue.shape == (1, 32)
    # with gamma included, the unclassified curve joins all channels
    blue2, green2, red2 = dorf.read_dorf_data(p, include_gamma=True,
                                              color_split=True,
                                              dorf_datapoints=32)
    assert red2.shape == (2, 32)
    assert blue2.shape == (2, 32)


def test_invert_recovers_icrf(tmp_path):
    datapoints = 256
    x = np.linspace(0, 1, 1024)
    crf = x ** (1 / 2.2)
    inv = dorf.invert_and_interpolate([crf[None, :]], datapoints,
                                      dorf_datapoints=1024)[0]
    x_new = np.linspace(0, 1, datapoints)
    np.testing.assert_allclose(inv[0], x_new ** 2.2, atol=5e-3)


def test_principal_components_match_sklearn():
    from sklearn.decomposition import PCA
    local = np.random.default_rng(42)
    cov = local.normal(size=(64, 64))
    cov = cov @ cov.T
    k = 5
    ours = np.asarray(dorf.principal_components(cov, k))

    skl = PCA(n_components=k)
    skl.fit(cov)
    expect = skl.transform(cov)
    for n in range(k):
        col = expect[:, n] / np.linalg.norm(expect[:, n])
        anchored = col - col[0]
        # PCA component sign is arbitrary; the svd_flip tie-break can land
        # differently between the jnp and LAPACK SVDs, so compare up to a
        # per-column sign (flip-then-anchor == -anchored).
        direct = np.max(np.abs(ours[:, n] - anchored))
        flipped = np.max(np.abs(ours[:, n] + anchored))
        # f64 on the CPU parity gate; an f32 SVD (accelerator mode) is
        # good to ~1e-5 per component against LAPACK's f64
        tol = 1e-6 if ours.dtype == np.float64 else 1e-4
        assert min(direct, flipped) < tol, (n, direct, flipped)


def test_process_crf_data_end_to_end(tmp_path, rng):
    p = _write_dorf(tmp_path, [("aRed", 2.0), ("bRed", 2.1),
                               ("aGreen", 2.2), ("bGreen", 2.3),
                               ("aBlue", 2.4), ("bBlue", 2.5)])
    cfg = CameraConfig(
        data_path=str(tmp_path), dorf_file="dorfCurves.txt",
        dorf_datapoints=32, datapoints=64, num_of_pca_params=2,
        icrf_files=("ICRF_b.txt", "ICRF_g.txt", "ICRF_r.txt"),
        mean_icrf_files=("mean_b.txt", "mean_g.txt", "mean_r.txt"),
        pca_files=("pca_b.txt", "pca_g.txt", "pca_r.txt"))
    processed, means = dorf.process_CRF_data(cfg, dorf_path=p)
    assert processed[0].shape == (2, 64)
    assert means[0].shape == (64,)
    assert (tmp_path / "ICRF_b.txt").exists()
    assert (tmp_path / "mean_r.txt").exists()

    bases = dorf.analyze_principal_components(cfg)
    assert bases[0].shape == (64, 2)
    assert (tmp_path / "pca_g.txt").exists()
    # components are unit-norm before anchoring; anchored at zero
    np.testing.assert_allclose(bases[1][0], 0.0, atol=1e-12)
