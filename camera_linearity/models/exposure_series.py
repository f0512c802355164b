"""ExposureSeries: exposure stacks — linearity analysis and HDR merging.

Pipeline layer mirroring the reference ExposureSeries / ExposurePair
(reference: modules/exposure_series.py:18-476).  The structural redesign for
the device: instead of driving per-image Measurand chains from Python loops, the
series materializes its images as a single ``(N, H, W, C)`` device stack plus
an ``(N,)`` exposure vector; merging and pair statistics are jitted batch
computations over that stack (ops/hdr.py, ops/linearity.py).  The
ImageSet-list interface and the ExposurePair stats objects are preserved so
reference users find the same API surface.
"""
from __future__ import annotations

from functools import partial
from pathlib import Path
from typing import Dict, List, Optional, Tuple, Union

import jax
import jax.numpy as jnp
import numpy as np

from ..config import CameraConfig, DEFAULT_CONFIG
from ..measurand import Measurand
from ..ops import hdr as hdr_ops
from ..ops import stats as stats_ops
from ..utils import general as gf
from ..utils import io
from .image_set import ImageSet

Array = jnp.ndarray

__all__ = ["ExposurePair", "ExposureSeries"]


class ExposurePair:
    """A (short, long) exposure pairing with its computed statistics
    (exposure_series.py:18-76)."""

    def __init__(self, short_exposure: ImageSet, long_exposure: ImageSet):
        self.short_exposure = short_exposure
        self.long_exposure = long_exposure
        self.exposure_ratio = (short_exposure.features["exposure"]
                               / long_exposure.features["exposure"])
        self.absolute_difference: Optional[ImageSet] = None
        self.relative_difference: Optional[ImageSet] = None
        self.absolute_stats: Optional[Dict] = None
        self.relative_stats: Optional[Dict] = None

    def compute_difference(self) -> None:
        self.absolute_difference, self.relative_difference = \
            ImageSet.compute_difference(self.short_exposure,
                                        self.long_exposure)

    def compute_stats(self, axis=None, release_memory_after: bool = True
                      ) -> None:
        self.absolute_stats = (self.absolute_difference.measurand
                               .compute_dimension_statistics(axis=axis))
        self.relative_stats = (self.relative_difference.measurand
                               .compute_dimension_statistics(axis=axis))
        if release_memory_after:
            self.absolute_difference = None
            self.relative_difference = None

    def process_linearity_distribution(self, bins: int,
                                       included_range=None, channels=None,
                                       use_std: bool = False):
        """Histograms of the difference images (exposure_series.py:56-76)."""
        abs_h = self.absolute_difference.measurand.compute_channel_histogram(
            bins, included_range, channels, use_std)
        rel_h = self.relative_difference.measurand.compute_channel_histogram(
            bins, included_range, channels, use_std)
        return abs_h, rel_h


# ---------------------------------------------------------------------------
# jitted pair-statistics kernel: one (short, long) comparison over space
# ---------------------------------------------------------------------------

@partial(jax.jit, static_argnames=("use_std",))
def _pair_stats(short_val: Array, long_val: Array,
                short_std: Optional[Array], long_std: Optional[Array],
                ratio: Array, use_std: bool):
    s_std = short_std if use_std else None
    l_std = long_std if use_std else None
    from ..ops.uncertainty import scale_difference
    (av, astd), (rv, rstd) = scale_difference(short_val, s_std, long_val,
                                              l_std, ratio)
    abs_stats = stats_ops.dimension_statistics(av, astd, axis=(0, 1))
    rel_stats = stats_ops.dimension_statistics(rv, rstd, axis=(0, 1))
    return abs_stats, rel_stats


@partial(jax.jit, static_argnames=("use_std",))
def _pair_stats_all(stack_val: Array, stack_std: Optional[Array],
                    short_idx: Array, long_idx: Array, ratios: Array,
                    use_std: bool):
    """All K exposure-pair statistics in ONE device call.

    The reference loops Python-side over its ExposurePair list
    (exposure_series.py:443-446); dispatching one jitted call per pair
    pays a dispatch per pair — 45 pairs for a 10-exposure series.  Here
    the pairs ride a
    ``lax.map`` over (short, long) gathers from the (N, H, W, C) stack;
    ``batch_size`` bounds live memory at a few pair-planes instead of
    materializing all K difference images at once.
    """
    from ..ops.uncertainty import scale_difference

    def one(args):
        si, li, r = args
        sv = stack_val[si]
        lv = stack_val[li]
        s_std = stack_std[si] if use_std else None
        l_std = stack_std[li] if use_std else None
        (av, astd), (rv, rstd) = scale_difference(
            sv, s_std, lv, l_std, r.astype(stack_val.dtype))
        return (stats_ops.dimension_statistics(av, astd, axis=(0, 1)),
                stats_ops.dimension_statistics(rv, rstd, axis=(0, 1)))

    return jax.lax.map(one, (short_idx, long_idx, ratios), batch_size=8)


class ExposureSeries:
    """Manager of an exposure-matched image stack
    (exposure_series.py:79-476)."""

    def __init__(self, merged_image_set: Optional[ImageSet] = None,
                 directory_path: Optional[Path] = None,
                 input_image_sets: Optional[List[ImageSet]] = None,
                 config: CameraConfig = DEFAULT_CONFIG):
        self.merged_image_set = merged_image_set
        self.input_image_sets: List[ImageSet] = input_image_sets or []
        if isinstance(directory_path, Path) and directory_path.suffix != "":
            self.directory_path: Optional[Path] = directory_path.parent
        else:
            self.directory_path = directory_path
        self.exposure_pairs: Optional[List[ExposurePair]] = None
        self.config = config

    # --- constructors ---------------------------------------------------
    @classmethod
    def from_image_set(cls, reference_image_set: ImageSet,
                       directory_path: Optional[Path] = None,
                       config: CameraConfig = DEFAULT_CONFIG
                       ) -> "ExposureSeries":
        """Collect exposure matches of a reference image from a directory
        (exposure_series.py:117-145)."""
        search_path = directory_path if directory_path is not None \
            else reference_image_set.path.parent
        found = ImageSet.multiple_from_path(search_path, config=config)
        matches = [s for s in found
                   if reference_image_set.is_exposure_match(s)]
        matches.sort(key=lambda s: s.features["exposure"])
        return cls(directory_path=search_path, input_image_sets=matches,
                   config=config)

    @classmethod
    def from_dir_path(cls, directory_path: Path,
                      config: CameraConfig = DEFAULT_CONFIG
                      ) -> List["ExposureSeries"]:
        """One ExposureSeries per distinct feature group in a directory
        (exposure_series.py:147-161)."""
        sets = ImageSet.multiple_from_path(directory_path, config=config)
        return cls.from_multiple_image_sets(sets, config=config)

    @classmethod
    def from_multiple_image_sets(cls, list_of_image_sets: List[ImageSet],
                                 config: CameraConfig = DEFAULT_CONFIG
                                 ) -> List["ExposureSeries"]:
        """Greedy grouping of ImageSets into exposure-matched series
        (exposure_series.py:163-203)."""
        sublists: List[List[ImageSet]] = []
        for image_set in list_of_image_sets:
            for sublist in sublists:
                if sublist[0].is_exposure_match(image_set):
                    sublist.append(image_set)
                    break
            else:
                sublists.append([image_set])
        out = []
        for sublist in sublists:
            sublist.sort(key=lambda s: s.features["exposure"])
            out.append(cls(input_image_sets=sublist, config=config))
        return out

    # --- loading --------------------------------------------------------
    def load_value_images(self, bit_64: bool = False) -> None:
        for image_set in self.input_image_sets:
            image_set.load_value_image(bit64=bit_64)

    def load_std_images(self, bit_64: bool = True) -> None:
        for image_set in self.input_image_sets:
            image_set.load_std_image(bit64=bit_64)

    @property
    def exposures(self) -> np.ndarray:
        return np.array([s.features["exposure"]
                         for s in self.input_image_sets])

    def stack(self, with_std: bool = False
              ) -> Tuple[Array, Optional[Array], Array]:
        """Materialize the series as device arrays:
        (N,H,W,C) values, optional (N,H,W,C) stds, (N,) exposures."""
        vals = jnp.stack([s.measurand.val for s in self.input_image_sets])
        stds = None
        if with_std:
            stds = jnp.stack([s.measurand.std for s in self.input_image_sets])
        return vals, stds, jnp.asarray(self.exposures)

    # --- transforms -----------------------------------------------------
    def linearize(self, icrf: Array, icrf_diff: Optional[Array] = None,
                  release_memory: bool = False) -> "ExposureSeries":
        """Linearize every input image (exposure_series.py:226-250).

        FUNCTIONAL, unlike the reference's in-place variant: returns a NEW
        series and leaves ``self`` untouched — use the return value
        (``series = series.linearize(icrf)``).  In-place mutation is
        incompatible with jit/pytree semantics throughout this framework.
        """
        new_sets = []
        for s in self.input_image_sets:
            new_sets.append(s.linearize(icrf, icrf_diff))
            if release_memory:
                s.release()
        return ExposureSeries(merged_image_set=self.merged_image_set,
                              directory_path=self.directory_path,
                              input_image_sets=new_sets, config=self.config)

    def extract(self, channels: Optional[Union[int, List[int]]] = None,
                release_memory: bool = False) -> "ExposureSeries":
        """Channel extraction across the series (exposure_series.py:252-281).

        Functional like :meth:`linearize` — returns a new series; use the
        return value."""
        merged = None if self.merged_image_set is None else \
            self.merged_image_set.extract(channels)
        new_sets = []
        for s in self.input_image_sets:
            new_sets.append(s.extract(channels))
            if release_memory:
                s.release()
        return ExposureSeries(merged_image_set=merged,
                              directory_path=self.directory_path,
                              input_image_sets=new_sets, config=self.config)

    # --- pairing --------------------------------------------------------
    def initialize_exposure_pairs(self, min_ratio: float = 0.1) -> None:
        """All i<j pairs with exposure ratio >= min_ratio
        (exposure_series.py:283-304)."""
        valid = []
        sets = self.input_image_sets
        for i, x in enumerate(sets):
            for j, y in enumerate(sets):
                if i >= j:
                    continue
                if x.features["exposure"] / y.features["exposure"] < min_ratio:
                    continue
                valid.append(ExposurePair(x, y))
        self.exposure_pairs = valid

    # --- HDR merge ------------------------------------------------------
    def _stacks_with_darks(self,
                           list_of_dark_fields: Optional[List[ImageSet]],
                           with_std: bool
                           ) -> Tuple[Array, Optional[Array], Array, Array]:
        """Load the raw stack plus a per-exposure dark-frame stack for the
        fused corrections prologue (exposure_series.py:317-345,371-381).

        Host code only selects which dark matches each exposure
        (exact-or-scale-down, image_set.py:157-198); exposures without a
        match get an all-zero dark plane, making the fused bad-pixel
        repair an exact no-op there (the reference skips those images).
        """
        vals, stds, darks = [], [], []
        for s in self.input_image_sets:
            if s.measurand is None or s.measurand.val is None:
                s.load_value_image()
            if with_std and s.measurand.std is None:
                s.load_std_image()
            vals.append(s.measurand.val)
            if with_std:
                stds.append(s.measurand.std)
            dark = s.get_dark_field(list_of_dark_fields)
            darks.append(jnp.zeros_like(s.measurand.val) if dark is None
                         else dark.measurand.val)
        stack_val = jnp.stack(vals)
        stack_std = jnp.stack(stds) if with_std else None
        return (stack_val, stack_std, jnp.stack(darks),
                jnp.asarray(self.exposures))

    def process_HDR_image(self, ICRF: Optional[Array] = None,
                          ICRF_diff: Optional[Array] = None,
                          list_of_dark_fields: Optional[List[ImageSet]]
                          = None,
                          use_std: bool = True,
                          flat_field: Optional[ImageSet] = None,
                          apply_flat_field: bool = True
                          ) -> ImageSet:
        """Merge the series into an HDR image (exposure_series.py:399-419).

        Loads the calibrated ICRF from config when none is given; applies the
        bad-pixel prologue against matched dark frames; merges with the fused
        kernel; optionally flat-field-corrects the result.
        """
        cfg = self.config
        if ICRF is None:
            icrf_np, icrf_diff_np = io.read_icrf_file(
                Path(cfg.data_path).joinpath(cfg.icrf_calibrated_file),
                cfg.bits)
            ICRF, ICRF_diff = jnp.asarray(icrf_np), jnp.asarray(icrf_diff_np)
        elif ICRF_diff is None:
            from ..ops.linearize import icrf_derivative
            ICRF_diff = icrf_derivative(jnp.asarray(ICRF), cfg.bits)

        if list_of_dark_fields is None and cfg.default_dark_path is not None:
            list_of_dark_fields = ImageSet.multiple_from_path(
                cfg.default_dark_path, config=cfg)

        stack_val, stack_std, dark_stack, exposures = \
            self._stacks_with_darks(list_of_dark_fields, use_std)

        first = self.input_image_sets[0]
        flat_val = flat_std = None
        flat = None
        if apply_flat_field:
            flat = flat_field if flat_field is not None \
                else first.get_flat_field()
            # unconditional when a flat exists, matching the reference
            # (exposure_series.py:415-417); value-only merges flat-field
            # the value and keep std None.
            if flat is not None:
                if flat.measurand is None or flat.measurand.val is None:
                    flat.load_value_image()
                if flat.measurand.std is None:
                    flat.load_std_image()
                flat_val = flat.measurand.val
                flat_std = flat.measurand.std

        hdr_val, hdr_std = hdr_ops.merge_corrected(
            stack_val, stack_std, dark_stack, exposures, jnp.asarray(ICRF),
            jnp.asarray(ICRF_diff),
            jnp.asarray(cfg.dark_threshold, dtype=jnp.float32),
            flat_val, flat_std,
            mid_percentage=cfg.flat_field_mid_percentage,
            compat=cfg.compat_mode
            if cfg.compat_mode in ("corrected", "reference")
            else "corrected",
            kernel_size=cfg.median_filter_kernel_size)

        hdr_set = ImageSet(
            file_path=first.get_file_path_without_exposure(),
            features=first.features,
            measurand=Measurand(hdr_val, hdr_std), config=cfg)
        hdr_set.is_hdr = True

        self.merged_image_set = hdr_set
        return hdr_set

    # --- linearity analysis ----------------------------------------------
    def process_linearity(self, ICRF: Optional[Array] = None,
                          linearity_limit: Optional[int] = None,
                          use_std: bool = False) -> None:
        """Per-pair linearity statistics (exposure_series.py:421-446).

        Thresholds each image via ICRF-mapped limits, then computes the
        absolute/relative difference statistics for EVERY exposure pair in
        one jitted device call (``_pair_stats_all``): the pairs index into
        the materialized (N, H, W, C) stack and a ``lax.map`` scans them,
        so a K-pair series costs O(1) dispatches instead of K.
        """
        cfg = self.config
        lower, upper = gf.map_linearity_limits(linearity_limit,
                                               linearity_limit, ICRF, cfg)
        for s in self.input_image_sets:
            if s.measurand is None or s.measurand.val is None:
                s.load_value_image()
            if use_std and s.measurand.std is None:
                s.load_std_image()
            s.measurand = s.measurand.apply_thresholds(lower, upper)

        if self.exposure_pairs is None:
            self.initialize_exposure_pairs()
        if not self.exposure_pairs:
            return

        sets = self.input_image_sets
        index_of = {id(s): i for i, s in enumerate(sets)}
        if any(id(p.short_exposure) not in index_of
               or id(p.long_exposure) not in index_of
               for p in self.exposure_pairs):
            # hand-built pairs referencing sets outside this series: fall
            # back to one dispatch per pair
            for pair in self.exposure_pairs:
                sm = pair.short_exposure.measurand
                lm = pair.long_exposure.measurand
                pair.absolute_stats, pair.relative_stats = _pair_stats(
                    sm.val, lm.val,
                    sm.std if use_std else None,
                    lm.std if use_std else None,
                    jnp.asarray(pair.exposure_ratio, dtype=sm.val.dtype),
                    use_std and sm.std is not None)
            return
        short_idx = np.array([index_of[id(p.short_exposure)]
                              for p in self.exposure_pairs], np.int32)
        long_idx = np.array([index_of[id(p.long_exposure)]
                             for p in self.exposure_pairs], np.int32)
        ratios = np.array([p.exposure_ratio for p in self.exposure_pairs])

        effective_std = use_std and all(s.measurand.std is not None
                                        for s in sets)
        stack_val, stack_std, _ = self.stack(with_std=effective_std)
        abs_all, rel_all = _pair_stats_all(
            stack_val, stack_std, jnp.asarray(short_idx),
            jnp.asarray(long_idx), jnp.asarray(ratios), effective_std)

        for k, pair in enumerate(self.exposure_pairs):
            pair.absolute_stats = {key: (None if v is None else v[k])
                                   for key, v in abs_all.items()}
            pair.relative_stats = {key: (None if v is None else v[k])
                                   for key, v in rel_all.items()}

    def collect_exposure_pair_stats(self) -> Tuple[Dict, Dict]:
        """Stack per-pair stats into (pairs, channels) arrays
        (exposure_series.py:448-476)."""
        def collect(kind):
            out = {"ratios": [], "means": [], "stds": [], "errors": []}
            for pair in self.exposure_pairs:
                stats = (pair.absolute_stats if kind == "abs"
                         else pair.relative_stats)
                out["ratios"].append(pair.exposure_ratio)
                out["means"].append(np.asarray(stats["mean"]))
                out["stds"].append(np.asarray(stats["std"]))
                err = stats["error"]
                out["errors"].append(None if err is None
                                     else np.asarray(err))
            for key in out:
                if all(e is None for e in out[key]):
                    out[key] = None
                else:
                    out[key] = np.asarray(out[key])
            return out
        return collect("abs"), collect("rel")
