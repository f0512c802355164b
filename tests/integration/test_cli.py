"""End-to-end CLI tests: synthetic captures -> merge / linearity /
calibrate / dorf through `python -m camera_linearity`."""
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest

from camera_linearity import CameraConfig, Measurand
from camera_linearity.__main__ import main
from camera_linearity.models.image_set import ImageSet


@pytest.fixture
def capture_dir(tmp_path, rng):
    """A small exposure series + ICRF file on disk."""
    d = tmp_path / "captures"
    d.mkdir()
    base = rng.uniform(0.2, 0.7, (32, 32, 3))
    for ms in (4, 8, 16):
        val = np.clip(base * (ms / 16), 0, 1)
        s = ImageSet(d / f"{ms}ms BF scene 50x.tif", value=jnp.asarray(val),
                     std=jnp.asarray(rng.uniform(0.004, 0.01, (32, 32, 3))))
        s.save_8bit(d / f"{ms}ms BF scene 50x.tif")
    icrf = np.linspace(0, 1, 256)[:, None].repeat(3, 1)
    icrf_path = tmp_path / "icrf.txt"
    np.savetxt(icrf_path, icrf)
    return d, icrf_path


def test_cli_merge(capture_dir, tmp_path):
    d, icrf_path = capture_dir
    out = tmp_path / "hdr_out"
    rc = main(["merge", "--images", str(d), "--icrf", str(icrf_path),
               "--out", str(out), "--std", "--no-flat"])
    assert rc == 0
    produced = list(out.glob("*.tif"))
    assert any("HDR" in p.name for p in produced)
    assert any("STD" in p.name for p in produced)


def test_cli_linearity(capture_dir, tmp_path):
    d, icrf_path = capture_dir
    out = tmp_path / "lin_out"
    out.mkdir()
    rc = main(["linearity", "--images", str(d), "--icrf", str(icrf_path),
               "--out", str(out)])
    assert rc == 0
    assert (out / "linearity_relative_0.png").exists()


def _calibration_workspace(tmp_path, rng):
    # synthetic gamma stack + PCA files + config.ini; data files live next
    # to the ini (from_ini sets data_path to the ini's directory)
    data = tmp_path
    images = tmp_path / "images"
    images.mkdir()
    x = np.linspace(0, 1, 256)
    curves = np.stack([x ** g for g in np.linspace(1.8, 2.6, 15)])
    mean_icrf = curves.mean(axis=0)
    _, _, vt = np.linalg.svd(curves - mean_icrf, full_matrices=False)
    pca = vt[:3].T
    for ch in "bgr":
        np.savetxt(data / f"pca_{ch}.txt", pca)
        np.savetxt(data / f"mean_{ch}.txt", mean_icrf)

    radiance = rng.uniform(0.05, 0.4, (24, 24, 3))
    for i, ms in enumerate((2, 4, 8, 16)):
        lin = np.clip(radiance * (ms / 16), 0, 1)
        dn = np.around(np.clip(lin ** (1 / 2.2), 0, 1) * 255) / 255
        s = ImageSet(images / f"{ms}ms BF cal 50x.tif",
                     value=jnp.asarray(dn))
        s.save_8bit(images / f"{ms}ms BF cal 50x.tif")

    ini = tmp_path / "config.ini"
    ini.write_text(f"""
[Integer data]
channels = 3
bit depth = 8
final datapoints = 256
number of principal components = 3

[String data]
principal components = pca_b.txt,pca_g.txt,pca_r.txt
mean ICRFs = mean_b.txt,mean_g.txt,mean_r.txt
""")
    return ini, images


def test_cli_calibrate(tmp_path, rng):
    ini, images = _calibration_workspace(tmp_path, rng)
    out_file = tmp_path / "icrf_solved.txt"
    rc = main(["--config", str(ini), "calibrate", "--images", str(images),
               "--out", str(out_file), "--spacing", "1",
               "--maxiter", "60"])
    assert rc == 0
    solved = np.loadtxt(out_file)
    assert solved.shape == (256, 3)
    assert np.all(np.diff(solved, axis=0) >= -1e-9)
    # endpoint renormalization (reference ICRF_calibration_exposure.py:388-396)
    np.testing.assert_allclose(solved[0], 0.0, atol=1e-12)
    np.testing.assert_allclose(solved[-1], 1.0, atol=1e-12)


def test_cli_calibrate_strict(tmp_path, rng):
    """--strict routes through the host float64 SciPy-parity solver
    (models/scipy_strict.py) end to end."""
    ini, images = _calibration_workspace(tmp_path, rng)
    out_file = tmp_path / "icrf_strict.txt"
    rc = main(["--config", str(ini), "calibrate", "--images", str(images),
               "--out", str(out_file), "--spacing", "1",
               "--maxiter", "2", "--strict"])
    assert rc == 0
    solved = np.loadtxt(out_file)
    assert solved.shape == (256, 3)
    assert solved.min() >= 0.0 and solved.max() <= 1.0


def test_cli_dorf(tmp_path):
    data = tmp_path / "data"
    data.mkdir()
    x = np.linspace(0, 1, 64)
    lines = []
    for name, g in [("aRed", 2.0), ("aGreen", 2.2), ("aBlue", 2.4),
                    ("bRed", 2.1), ("bGreen", 2.3), ("bBlue", 2.5)]:
        y = x ** g
        lines += [name, "t", "i", "I =",
                  " ".join(f"{v:.5f}" for v in x),
                  " ".join(f"{v:.5f}" for v in y)]
    (data / "dorfCurves.txt").write_text("\n".join(lines) + "\n")
    ini = tmp_path / "config.ini"
    ini.write_text("""
[Integer data]
channels = 3
bit depth = 8
final datapoints = 64
original DoRF datapoints = 64
number of principal components = 1

[String data]
source DoRF data = dorfCurves.txt
ICRFs = icrf_b.txt,icrf_g.txt,icrf_r.txt
mean ICRFs = mean_b.txt,mean_g.txt,mean_r.txt
principal components = pca_b.txt,pca_g.txt,pca_r.txt
""")
    rc = main(["--config", str(ini), "dorf", "--data", str(data)])
    assert rc == 0
    assert (data / "pca_g.txt").exists()


def test_cli_video(tmp_path, rng):
    import cv2 as cv
    vdir = tmp_path / "videos"
    vdir.mkdir()
    frames = rng.integers(60, 200, (12, 24, 32, 3), dtype=np.uint8)
    w = cv.VideoWriter(str(vdir / "scene 5ms.avi"),
                       cv.VideoWriter_fourcc(*"FFV1"), 10, (32, 24))
    for f in frames:
        w.write(f)
    w.release()
    cap = cv.VideoCapture(str(vdir / "scene 5ms.avi"))
    ok, _ = cap.read()
    cap.release()
    if not ok:
        pytest.skip("no usable codec")
    rc = main(["video", "--videos", str(vdir)])
    assert rc == 0
    assert (vdir / "mean" / "scene 5ms.tif").exists()
    assert (vdir / "std" / "scene 5ms STD.tif").exists()


def test_cli_doctor(capsys):
    rc = main(["doctor"])
    assert rc == 0
    out = capsys.readouterr().out
    assert "backend=" in out and "native staging library" in out
    assert "host->device" in out
