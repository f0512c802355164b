"""camera_linearity — a JAX/XLA/Pallas framework for camera linearity
analysis, ICRF calibration, uncertainty-tracked linearization and HDR
exposure-stack merging, with NVIDIA GPUs as its accelerator.

Ground-up redesign of the capabilities of ``samivout/camera_linearity``
(mounted read-only at /root/reference; see SURVEY.md for the layer map):
the NumPy/CuPy dual-backend Measurand becomes a single JAX pytree, pipelines
compile under jit, the HDR merge runs as a fused GPU kernel, the calibration
objective as batched device computations, and multi-device scaling goes
through jax.sharding meshes.
"""
from .config import CameraConfig, DEFAULT_CONFIG  # noqa: F401
from .measurand import Measurand  # noqa: F401

__version__ = "0.3.0"
