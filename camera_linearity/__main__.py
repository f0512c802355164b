"""Command-line interface for the main pipelines.

The reference has no entry point at all — users drive it from scripts
(SURVEY.md §1; every reference module ends in an empty __main__ guard).
Here the four flagship pipelines are runnable directly:

    python -m camera_linearity merge     --images DIR --icrf FILE
    python -m camera_linearity linearity --images DIR [--icrf FILE]
    python -m camera_linearity calibrate --images DIR --out FILE
    python -m camera_linearity video     --videos DIR [--separately]
    python -m camera_linearity dorf      --data DIR

All commands take --config pointing at a reference-format config.ini.
"""
from __future__ import annotations

import argparse
import sys
from pathlib import Path

import numpy as np


def _load_config(args):
    from .config import CameraConfig
    if args.config:
        return CameraConfig.from_ini(args.config)
    return CameraConfig()


def _load_icrf(path, cfg):
    import jax.numpy as jnp
    from .utils import io
    icrf, icrf_diff = io.read_icrf_file(path, cfg.bits)
    return jnp.asarray(icrf), jnp.asarray(icrf_diff)


def cmd_merge(args) -> int:
    from .models.exposure_series import ExposureSeries
    from .utils.observability import get_logger, timed
    log = get_logger()
    cfg = _load_config(args)
    icrf, icrf_diff = _load_icrf(args.icrf, cfg)
    series_list = ExposureSeries.from_dir_path(Path(args.images), config=cfg)
    log.info("found %d exposure series", len(series_list))
    for series in series_list:
        series.load_value_images()
        if args.std:
            series.load_std_images()
        with timed(f"merge {series.input_image_sets[0].features['subject']}",
                   log):
            hdr = series.process_HDR_image(
                ICRF=icrf, ICRF_diff=icrf_diff, use_std=args.std,
                apply_flat_field=not args.no_flat)
        out_dir = Path(args.out) if args.out else Path(args.images) / "hdr"
        hdr.save_64bit(out_dir / hdr.path.name, is_hdr=True)
        log.info("wrote %s", out_dir / hdr.path.name)
    return 0


def cmd_linearity(args) -> int:
    from .models.exposure_series import ExposureSeries
    from .utils import visualization as viz
    from .utils.observability import get_logger
    log = get_logger()
    cfg = _load_config(args)
    icrf = None
    if args.icrf:
        icrf, _ = _load_icrf(args.icrf, cfg)
    series_list = ExposureSeries.from_dir_path(Path(args.images), config=cfg)
    for k, series in enumerate(series_list):
        series.load_value_images()
        if args.std:
            series.load_std_images()
        series.initialize_exposure_pairs()
        series.process_linearity(ICRF=icrf, use_std=args.std)
        abs_stats, rel_stats = series.collect_exposure_pair_stats()
        out = Path(args.out) if args.out else Path(args.images)
        for name, stats in (("absolute", abs_stats), ("relative",
                                                      rel_stats)):
            fits = viz.create_linearity_plots(
                stats, out / f"linearity_{name}_{k}.png", fit_line=True,
                ylabel=f"{name} difference", symbol="R", config=cfg)
            for cc, fit in fits.items():
                log.info("series %d %s ODR fit %s: A=%.5g±%.2g "
                         "B=%.5g±%.2g", k, name, cc, fit["beta"][0],
                         fit["sd_beta"][0], fit["beta"][1],
                         fit["sd_beta"][1])
        log.info("series %d: %d pairs, mean |rel| = %s", k,
                 len(series.exposure_pairs),
                 np.abs(rel_stats["means"]).mean(axis=0))
    return 0


def cmd_calibrate(args) -> int:
    from .models import calibration as cal
    from .utils import io
    from .utils.observability import get_logger, timed
    log = get_logger()
    cfg = _load_config(args)
    if args.strict or args.hybrid:
        # host float64 parity modes: reproduce the reference's SciPy solve
        # to the RNG draw, cold (--strict) or seeded by a fast device
        # solve (--hybrid) (models/scipy_strict.py)
        import numpy as _np
        from .models import scipy_strict
        stacks, stds, exposures, _ratio = \
            cal.initialize_channel_image_stacks(Path(args.images),
                                                args.std, args.spacing,
                                                config=cfg)
        pca = _np.stack([io.read_txt_to_array(cfg.pca_files[c],
                                              cfg.data_path)
                         for c in range(cfg.num_of_chs)])
        mean = _np.stack([io.read_txt_to_array(cfg.mean_icrf_files[c],
                                               cfg.data_path)
                          for c in range(cfg.num_of_chs)])
        channel_stacks = (_np.asarray(stacks, _np.int32),
                          None if stds is None else _np.asarray(stds),
                          _np.asarray(exposures))
        if args.hybrid:
            device_kwargs = dict(maxiter=args.maxiter,
                                 energy_form=args.energy_form)
            if args.checkpoint:
                # the device phase supports checkpoint/resume; the strict
                # phase (a short seeded polish) does not
                device_kwargs.update(checkpoint_path=args.checkpoint,
                                     checkpoint_every=100)
            with timed("calibration_hybrid", log):
                icrf, dev_e, e0, e1, iters = scipy_strict.calibration_hybrid(
                    args.lower, args.upper, channel_stacks=channel_stacks,
                    pca_arrays=pca, mean_icrf_arrays=mean,
                    rng_seed=args.seed, config=cfg,
                    strict_maxiter=args.strict_maxiter,
                    strict_stall_limit=args.strict_stall_limit,
                    device_kwargs=device_kwargs)
            log.info("hybrid mode: device energies (f32 objective): %s",
                     dev_e)
            log.info("hybrid mode: %s strict iterations per channel", iters)
        else:
            if args.checkpoint:
                log.warning("--checkpoint is ignored in --strict mode "
                            "(the reference's SciPy solve has no resume)")
            with timed("calibration_strict", log):
                icrf, e0, e1, iters = scipy_strict.calibration_strict(
                    args.lower, args.upper, channel_stacks=channel_stacks,
                    pca_arrays=pca, mean_icrf_arrays=mean,
                    rng_seed=args.seed, maxiter=args.maxiter, config=cfg)
            log.info("strict mode: %s iterations per channel", iters)
        log.info("initial energies: %s", e0)
        log.info("final energies:   %s", e1)
        out = args.out or (Path(cfg.data_path or ".")
                           / (cfg.icrf_calibrated_file
                              or "ICRF_calibrated.txt"))
        io.save_txt(out, icrf)
        log.info("wrote %s", out)
        return 0
    with timed("calibration", log):
        icrf, e0, e1, ratio = cal.calibration(
            args.lower, args.upper, data_spacing=args.spacing,
            use_std=args.std, image_path=Path(args.images),
            rng_seed=args.seed, config=cfg, maxiter=args.maxiter,
            checkpoint_path=args.checkpoint,
            checkpoint_every=100 if args.checkpoint else 0,
            energy_form=args.energy_form)
    log.info("initial energies: %s", e0)
    log.info("final energies:   %s", e1)
    out = args.out or (Path(cfg.data_path or ".")
                       / (cfg.icrf_calibrated_file or "ICRF_calibrated.txt"))
    io.save_txt(out, icrf)
    log.info("wrote %s", out)
    return 0


def cmd_video(args) -> int:
    from .models import video
    cfg = _load_config(args)
    icrf = None
    if args.icrf:
        icrf, _ = _load_icrf(args.icrf, cfg)
    video.process_directory(Path(args.videos), ICRF=icrf,
                            separately=args.separately, config=cfg,
                            decoder=args.decoder)
    return 0


def cmd_dorf(args) -> int:
    from .models import dorf
    cfg = _load_config(args)
    if args.data:
        cfg = cfg.replace(data_path=args.data)
    dorf.process_CRF_data(cfg)
    dorf.analyze_principal_components(cfg)
    return 0


def cmd_doctor(args) -> int:
    """Environment diagnostic: what will this install actually run on?

    Probes the pieces whose availability/performance decide every
    pipeline's behavior — JAX backend and devices, x64 mode, the native
    staging library, host parallelism, device transfer rate, and (when a
    video is given) the decode rate that ceilings the video pipelines.
    """
    import os
    import time

    from . import __version__, native

    print(f"camera_linearity {__version__}")
    import jax
    import jax.numpy as jnp
    print(f"jax {jax.__version__}  backend={jax.default_backend()}  "
          f"x64={'on' if jax.config.jax_enable_x64 else 'off'}")
    if jax.process_count() > 1:
        print(f"multi-host: process {jax.process_index()} of "
              f"{jax.process_count()}, {jax.local_device_count()} local / "
              f"{len(jax.devices())} global devices")
    for dev in jax.devices():
        print(f"  device: {dev}")
    print(f"host: {os.cpu_count()} cpu core(s)")
    ok = native.available()
    print(f"native staging library: {'built' if ok else 'NumPy fallback'}")
    if ok:
        batch = np.random.default_rng(0).integers(
            0, 255, (8, 540, 960, 3), np.uint8)
        s = np.zeros((540, 960, 3), np.uint64)
        q = np.zeros_like(s)
        native.accum_moments_u8(batch, s, q)  # warm
        t0 = time.perf_counter()
        native.accum_moments_u8(batch, s, q)
        rate = batch.shape[0] * 540 * 960 / 1e6 / (time.perf_counter() - t0)
        print(f"  exact-moment accumulation: {rate:.0f} MP/s "
              f"({native._NTHREADS} thread(s))")
    # one-time costs (first transfer of this size, jit compiles) are paid
    # BEFORE each timed window — the point is the steady rate
    from .utils.general import stage_to_device
    payload = np.ones((16 << 20) // 4, np.float32)
    jax.block_until_ready(stage_to_device(payload))  # transfer-path setup
    t0 = time.perf_counter()
    jax.block_until_ready(stage_to_device(payload))
    mbps = payload.nbytes / 1e6 / (time.perf_counter() - t0)
    print(f"host->device: {mbps:.0f} MB/s (16 MB probe, steady rate)")
    x = jnp.ones((256, 256))
    float(jnp.sum(x @ x))  # compile outside the window
    t0 = time.perf_counter()
    float(jnp.sum(x @ x))
    print(f"device dispatch+matmul round trip: "
          f"{(time.perf_counter() - t0) * 1e3:.1f} ms (warm)")
    if args.video:
        from .models import video as video_mod
        h, w = video_mod.probe_geometry(Path(args.video))
        n = 0
        t0 = time.perf_counter()
        for frame in video_mod.video_frame_generator(Path(args.video)):
            if frame is None:
                break
            n += 1
            if n >= 120:
                break
        rate = n * h * w / 1e6 / (time.perf_counter() - t0)
        print(f"decode (cv2): {rate:.0f} MP/s ({w}x{h}; decode bounds the "
              "video pipelines)")
        if native.mjpeg_available():
            from .utils import avi
            if avi.probe_mjpg(Path(args.video)) == (h, w):
                dst = np.empty((h, w, 3), np.uint8)
                for fast in (False, True):
                    n = 0
                    t0 = time.perf_counter()
                    for chunk in avi.mjpg_chunks(Path(args.video)):
                        native.jpeg_decode_bgr(chunk, dst, fast=fast)
                        n += 1
                        if n >= 120:
                            break
                    rate = n * h * w / 1e6 / (time.perf_counter() - t0)
                    name = "turbo_fast" if fast else "turbo"
                    print(f"decode ({name}): {rate:.0f} MP/s "
                          f"(decoder='{name}' selects this path)")
    return 0


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="camera_linearity",
                                description=__doc__,
                                formatter_class=
                                argparse.RawDescriptionHelpFormatter)
    p.add_argument("--config", help="path to a config.ini")
    p.add_argument("--coordinator",
                   help="multi-host: coordinator address host:port "
                        "(or env CL_COORDINATOR_ADDRESS); see "
                        "parallel/distributed.py")
    p.add_argument("--num-processes", type=int,
                   help="multi-host: total process count "
                        "(or env CL_NUM_PROCESSES)")
    p.add_argument("--process-id", type=int,
                   help="multi-host: this process's id "
                        "(or env CL_PROCESS_ID)")
    sub = p.add_subparsers(dest="command", required=True)

    m = sub.add_parser("merge", help="HDR-merge exposure stacks")
    m.add_argument("--images", required=True)
    m.add_argument("--icrf", required=True)
    m.add_argument("--out")
    m.add_argument("--std", action="store_true",
                   help="propagate uncertainty images")
    m.add_argument("--no-flat", action="store_true")
    m.set_defaults(fn=cmd_merge)

    li = sub.add_parser("linearity", help="exposure-pair linearity analysis")
    li.add_argument("--images", required=True)
    li.add_argument("--icrf")
    li.add_argument("--out")
    li.add_argument("--std", action="store_true")
    li.set_defaults(fn=cmd_linearity)

    c = sub.add_parser("calibrate", help="solve the ICRF")
    c.add_argument("--images", required=True)
    c.add_argument("--out")
    c.add_argument("--lower", type=float, default=-1.0)
    c.add_argument("--upper", type=float, default=1.0)
    c.add_argument("--spacing", type=int, default=150)
    c.add_argument("--maxiter", type=int, default=1000)
    c.add_argument("--seed", type=int, default=7)
    c.add_argument("--std", action="store_true")
    c.add_argument("--checkpoint")
    c.add_argument("--energy-form", default="auto",
                   choices=["auto", "onehot", "hist", "chunked"],
                   help="pin the objective formulation (default: auto "
                        "by memory footprint)")
    mode = c.add_mutually_exclusive_group()
    mode.add_argument("--strict", action="store_true",
                      help="host float64 parity mode: reproduce the "
                           "reference's seeded SciPy solve to the RNG draw")
    mode.add_argument("--hybrid", action="store_true",
                      help="fast-then-exact: device solve finds the basin, "
                           "then seeds the strict float64 SciPy solver")
    c.add_argument("--strict-maxiter", type=int, default=100,
                   help="iteration cap for the hybrid's strict polish "
                        "phase (--maxiter caps the device phase)")
    c.add_argument("--strict-stall-limit", type=int, default=None,
                   help="hybrid polish early stop: end when the best "
                        "energy has not improved for this many "
                        "iterations (the match-or-improve guarantee is "
                        "unaffected; ~10 cuts the audit cost ~5x)")
    c.set_defaults(fn=cmd_calibrate)

    v = sub.add_parser("video", help="video mean/std frames")
    v.add_argument("--videos", required=True)
    v.add_argument("--icrf")
    v.add_argument("--separately", action="store_true", default=True)
    v.add_argument("--decoder", default="auto",
                   choices=["auto", "cv2", "turbo", "turbo_fast"],
                   help="host video decoder: cv2 (reference path) or the "
                        "native libjpeg MJPG path (turbo/turbo_fast; "
                        "auto = env CL_DECODER, default cv2)")
    v.set_defaults(fn=cmd_video)

    d = sub.add_parser("dorf", help="build the DoRF PCA basis")
    d.add_argument("--data")
    d.set_defaults(fn=cmd_dorf)

    dr = sub.add_parser("doctor", help="diagnose the runtime environment")
    dr.add_argument("--video", help="also probe decode rate on this file")
    dr.set_defaults(fn=cmd_doctor)
    return p


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    # multi-host wiring must precede the first backend-touching jax call;
    # with no --coordinator/--num-processes/--process-id args and no CL_*
    # environment this is a no-op (single-process mode)
    from .parallel import distributed
    distributed.initialize(coordinator_address=args.coordinator,
                           num_processes=args.num_processes,
                           process_id=args.process_id)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
