"""Frozen, explicit configuration for the camera-linearity framework.

The reference package materializes a mutable class of import-time globals parsed
from ``data/config.ini`` (reference: modules/global_settings.py:9-81 and
modules/read_config.py:12-67).  Import-time global state is hostile to jit
tracing, testability and multi-config use, so here configuration is an explicit
frozen dataclass passed to constructors.  All fields are hashable so a
``CameraConfig`` can be used as a jit-static argument.

The ``from_ini`` constructor understands the same ini grammar as the reference
(`Float data` / `Integer data` section names coerce types, comma-separated
lists), so existing ``config.ini`` files keep working.
"""
from __future__ import annotations

import configparser
import dataclasses
from dataclasses import dataclass, field
from pathlib import Path
from typing import Optional, Tuple

__all__ = ["CameraConfig", "DEFAULT_CONFIG"]


def _as_tuple(x) -> Tuple:
    if x is None:
        return tuple()
    if isinstance(x, (list, tuple)):
        return tuple(x)
    return (x,)


@dataclass(frozen=True)
class CameraConfig:
    """Static camera / pipeline configuration.

    Field list mirrors the reference ``GlobalSettings``
    (modules/global_settings.py:9-81); paths are optional because the compute
    core never touches the filesystem itself.
    """

    # --- image geometry -------------------------------------------------
    im_size_x: int = 1920
    im_size_y: int = 1200
    # --- channels -------------------------------------------------------
    num_of_chs: int = 3
    ch_names: Tuple[str, ...] = ("blue", "green", "red")
    # --- bit depth ------------------------------------------------------
    bit_depth: int = 8
    # --- ICRF data points ----------------------------------------------
    datapoints: int = 256
    datapoint_multiplier: int = 1
    # --- DoRF -----------------------------------------------------------
    dorf_datapoints: int = 1024
    num_of_pca_params: int = 5
    # --- thresholds / correction parameters -----------------------------
    dark_threshold: float = 0.035
    flat_field_mid_percentage: float = 0.05
    hot_pixel_threshold: float = 0.035
    median_filter_kernel_size: int = 3
    lower_linearity_limit: int = 5
    upper_linearity_limit: int = 250
    # --- per-channel background levels (reference global_settings.py:81) -
    ch_bg_levels: Tuple[float, ...] = (0.14, 0.27, 0.18)
    # --- compute policy (new) --------------------------------------------
    # Working dtype for device compute: float32 on the GPU; float64 is
    # available on CPU for bit-parity testing against the NumPy reference
    # semantics.
    dtype: str = "float32"
    # 'corrected' uses first-order GUM propagation formulas where the
    # reference has documented bugs (SURVEY.md §7.7); 'reference' replicates
    # the reference's exact arithmetic for parity testing.
    compat_mode: str = "corrected"
    # --- paths (host-side IO only) ---------------------------------------
    data_path: Optional[str] = None
    output_path: Optional[str] = None
    default_img_src_path: Optional[str] = None
    default_flat_path: Optional[str] = None
    default_dark_path: Optional[str] = None
    uncalibrated_flat_path: Optional[str] = None
    uncalibrated_dark_path: Optional[str] = None
    icrf_calibrated_file: Optional[str] = None
    std_file_name: Optional[str] = None
    dorf_file: Optional[str] = None
    icrf_files: Tuple[str, ...] = ()
    mean_icrf_files: Tuple[str, ...] = ()
    pca_files: Tuple[str, ...] = ()
    mean_data_files: Tuple[str, ...] = ()
    base_data_files: Tuple[str, ...] = ()
    # pixel-size tables (reference global_settings.py:71-78)
    pixel_size: Tuple[Tuple[str, float], ...] = (
        ("5x", 0.9235), ("10x", 0.4617), ("20x", 0.2309), ("50x", 0.0923),
        ("1000x", 0.05464480874), ("3000x", 0.01724137931),
        ("8000x", 0.006756756757),
    )
    pixel_size_u: Tuple[Tuple[str, float], ...] = (
        ("5x", 0.0088), ("10x", 0.0044), ("20x", 0.0022), ("50x", 0.0009),
        ("1000x", 0.002732240437), ("3000x", 0.0008620689655),
        ("8000x", 0.0003378378379),
    )

    # --- derived --------------------------------------------------------
    @property
    def bits(self) -> int:
        return 2 ** self.bit_depth

    @property
    def max_dn(self) -> int:
        return self.bits - 1

    @property
    def min_dn(self) -> int:
        return 0

    @property
    def pixel_count(self) -> int:
        # The reference has IM_SIZE_Y * IM_SIZE_Y (global_settings.py:18, a
        # typo); the corrected product is used here.
        return self.im_size_x * self.im_size_y

    @property
    def ch_chars(self) -> Tuple[str, ...]:
        return tuple(name[0] for name in self.ch_names)

    def pixel_size_for(self, magnification: str) -> Optional[float]:
        return dict(self.pixel_size).get(magnification)

    def replace(self, **kwargs) -> "CameraConfig":
        return dataclasses.replace(self, **kwargs)

    # --- ini loading ----------------------------------------------------
    @classmethod
    def from_ini(cls, ini_path: str | Path, **overrides) -> "CameraConfig":
        """Build a config from a reference-format ``config.ini``.

        Section names drive coercion exactly as the reference reader does
        (modules/read_config.py:30-36,59-65): values in a section named
        ``Float data`` parse as floats, ``Integer data`` as ints, everything
        else stays a string.  Comma-separated values become tuples.
        """
        ini_path = Path(ini_path)
        parser = configparser.ConfigParser()
        parser.read(ini_path)

        flat: dict[str, object] = {}
        for section in parser.sections():
            for key, raw in parser[section].items():
                parts = [p for p in raw.split(",")]
                if section == "Float data":
                    vals = [float(p) for p in parts]
                elif section == "Integer data":
                    vals = [int(p) for p in parts]
                else:
                    vals = parts
                flat[key] = vals[0] if len(vals) == 1 else tuple(vals)

        def get(key, default=None):
            # configparser lowercases option names (optionxform); the
            # reference relies on the same case-insensitive lookup.
            return flat.get(key.lower(), default)

        kwargs: dict[str, object] = {}

        def put(field_name, ini_key, cast=None, tupled=False):
            v = get(ini_key)
            if v is None:
                return
            if tupled:
                v = _as_tuple(v)
                if cast is not None:
                    v = tuple(cast(e) for e in v)
            elif cast is not None:
                v = cast(v)
            kwargs[field_name] = v

        put("im_size_x", "image size x", int)
        put("im_size_y", "image size y", int)
        put("num_of_chs", "channels", int)
        put("ch_names", "channel names", str, tupled=True)
        put("bit_depth", "bit depth", int)
        put("datapoints", "final datapoints", int)
        put("datapoint_multiplier", "datapoint multiplier", int)
        put("dorf_datapoints", "original DoRF datapoints", int)
        put("num_of_pca_params", "number of principal components", int)
        put("dark_threshold", "dark threshold", float)
        put("flat_field_mid_percentage", "flat field middle zone percentage",
            float)
        put("hot_pixel_threshold", "hot pixel threshold", float)
        put("median_filter_kernel_size", "median filter kernel size", int)
        put("lower_linearity_limit", "lower linearity limit", int)
        put("upper_linearity_limit", "upper linearity limit", int)
        put("default_img_src_path", "acquired images path", str)
        put("default_flat_path", "flat fields path", str)
        put("default_dark_path", "dark frames path", str)
        put("uncalibrated_flat_path", "original flat fields path", str)
        put("uncalibrated_dark_path", "original dark frames path", str)
        put("icrf_calibrated_file", "calibrated ICRFs", str)
        put("std_file_name", "STD data", str)
        put("dorf_file", "source DoRF data", str)
        put("icrf_files", "ICRFs", str, tupled=True)
        put("mean_icrf_files", "mean ICRFs", str, tupled=True)
        put("pca_files", "principal components", str, tupled=True)
        put("mean_data_files", "camera mean data", str, tupled=True)
        put("base_data_files", "camera base data", str, tupled=True)

        kwargs.setdefault("data_path", str(ini_path.parent))
        kwargs.update(overrides)
        return cls(**kwargs)


DEFAULT_CONFIG = CameraConfig()
