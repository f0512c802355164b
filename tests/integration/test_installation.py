"""What an installation needs: the main path imports with only the core
packages, and the GPU bring-up script refuses to run without a GPU."""
import json
import os
import shutil
import subprocess
import sys
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parents[2]

# A meta-path finder that makes the optional packages unimportable, as on
# a machine with only numpy, scipy, optax, chex, einops, pytest,
# hypothesis and JAX.
_BLOCK = """
import sys
class _Blocked:
    names = ("cv2", "imageio", "matplotlib", "orbax", "sklearn")
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in self.names:
            raise ImportError(f"{name} is blocked")
sys.meta_path.insert(0, _Blocked())
"""


@pytest.mark.parametrize("module", [
    "camera_linearity",
    "camera_linearity.ops.hdr",
    "camera_linearity.ops.hdr_triton",
    "camera_linearity.models.calibration",
    "camera_linearity.models.exposure_series",
    "camera_linearity.models.image_set",
    "camera_linearity.models.pipeline",
    "camera_linearity.models.video",
    "camera_linearity.parallel.sharded",
])
def test_main_path_imports_without_optional_packages(module):
    code = _BLOCK + f"import {module}\nprint('imported')\nimport cv2\n"
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               PYTHONPATH=str(REPO) + os.pathsep
               + os.environ.get("PYTHONPATH", ""))
    proc = subprocess.run([sys.executable, "-c", code], env=env, cwd=REPO,
                          capture_output=True, text=True, timeout=120)
    assert proc.stdout.strip() == "imported", proc.stderr[-2000:]
    # the final `import cv2` proves the block held
    assert "ImportError: cv2 is blocked" in proc.stderr, proc.stderr[-2000:]


def _run_smoke(cwd, script):
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    return subprocess.run([sys.executable, str(script)], cwd=cwd, env=env,
                          capture_output=True, text=True, timeout=300)


def _has_ok_line(stdout: str) -> bool:
    for line in stdout.splitlines():
        try:
            if json.loads(line).get("ok") is True:
                return True
        except (ValueError, AttributeError):
            continue
    return False


def test_chip_smoke_fails_without_gpu():
    proc = _run_smoke(REPO, REPO / "chip_smoke.py")
    assert proc.returncode != 0
    assert not _has_ok_line(proc.stdout)
    assert "needs a GPU" in proc.stderr


def test_chip_smoke_fails_alone_outside_a_checkout(tmp_path):
    shutil.copy(REPO / "chip_smoke.py", tmp_path / "chip_smoke.py")
    proc = _run_smoke(tmp_path, tmp_path / "chip_smoke.py")
    assert proc.returncode != 0
    assert not _has_ok_line(proc.stdout)
