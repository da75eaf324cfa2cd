"""Command-line interface of the port.

Counterpart of ``mlvfs_tpu/cli.py`` for the ported slice:

    python -m mlvfs_tpu_torch convert CLIP.MLV -o /out [--device cuda|cpu]
    python -m mlvfs_tpu_torch convert --mlv-dir=/path/to/clips -o /out
    python -m mlvfs_tpu_torch info CLIP.MLV

The flag surface is the reference's, plus ``--device``. Ported: the
processing flags ``--deflicker``, ``--fix-pattern-noise``,
``--dual-iso-preview``, ``--dual-iso`` with either interpolation
(amaze-edge, the default, or ``--mean23``; with ``--no-alias-map``,
``--no-fullres``), ``--cs2x2/--cs3x3/--cs5x5``, ``--stripes`` (with
``--stripes-batch-cal``), ``--bad-pix`` and ``--really-bad-pix``.
``--devices N>1``, whose slice is not ported yet, parses, then the command
fails with a message naming the flag.
"""

from __future__ import annotations

import argparse
import os
import sys
import time

from . import __version__
from .pipeline.config import ProcessingConfig


def _add_processing_flags(p: argparse.ArgumentParser):
    p.add_argument("--resolve-naming", action="store_true", help="DNG file names compatible with DaVinci Resolve")
    p.add_argument("--cs2x2", action="store_true", help="2x2 chroma smoothing")
    p.add_argument("--cs3x3", action="store_true", help="3x3 chroma smoothing")
    p.add_argument("--cs5x5", action="store_true", help="5x5 chroma smoothing")
    p.add_argument("--bad-pix", action="store_true", help="Fix bad pixels (autodetected)")
    p.add_argument("--really-bad-pix", action="store_true", help="Aggressive bad pixel fix")
    p.add_argument("--fix-pattern-noise", action="store_true", help="Fix row/column noise in shadows")
    p.add_argument("--stripes", action="store_true", help="Vertical stripe correction in highlights")
    p.add_argument("--stripes-batch-cal", action="store_true",
                   help="Calibrate stripes from the whole first batch on device instead of frame 0 on host")
    p.add_argument("--deflicker", type=int, default=0, metavar="N", help="Per-frame exposure compensation target median")
    p.add_argument("--dual-iso-preview", action="store_true", help="Preview Dual ISO files (fast; frames not detected as dual-ISO are converted normally)")
    p.add_argument("--dual-iso", action="store_true", help="Render Dual ISO files (high quality)")
    p.add_argument("--amaze-edge", action="store_true", help="Dual ISO interpolation: high quality (default)")
    p.add_argument("--mean23", action="store_true", help="Dual ISO interpolation: fast")
    p.add_argument("--no-alias-map", action="store_true", help="Dual ISO: disable alias map")
    p.add_argument("--alias-map", action="store_true", help="Dual ISO: enable alias map (default)")
    p.add_argument("--no-fullres", action="store_true", help="Dual ISO: disable full-res reconstruction")
    p.add_argument("--fps", type=float, default=0.0, help="FPS override for the DNG FrameRate tag")
    p.add_argument("--batch-size", type=int, default=16, help="Frames per device batch")
    p.add_argument("--prefetch", type=int, default=2, help="Host->device pipeline depth")
    p.add_argument("--no-idx", action="store_true", help="Do not read/write .IDX sidecar indexes")
    p.add_argument("--fpm-dir", default=None, help="Directory containing focus pixel maps (.fpm)")
    p.add_argument(
        "--compress-dng",
        action="store_true",
        help="Write lossless-compressed (LJ92) DNGs instead of uncompressed",
    )
    p.add_argument(
        "-v", "--verbose", action="store_true",
        help="Trace the conversion (spans of each take, batch and reconstruction stage, with "
             "device times on a card), print the spans' report and the counters after it, "
             "and log at debug level",
    )
    p.add_argument("--devices", type=int, default=0, help="Shard frame batches over N devices (not ported yet)")
    p.add_argument("--resume", action="store_true", help="Skip frames whose DNG already exists")
    p.add_argument("--device", default="cuda", help="Torch device of the batch pipeline: cuda[:N] or cpu")


def config_from_args(args) -> ProcessingConfig:
    chroma = 5 if args.cs5x5 else 3 if args.cs3x3 else 2 if args.cs2x2 else 0
    bad_pix = 2 if args.really_bad_pix else 1 if args.bad_pix else 0
    dual_iso = 2 if args.dual_iso else 1 if args.dual_iso_preview else 0
    return ProcessingConfig(
        chroma_smooth=chroma,
        fix_bad_pixels=bad_pix,
        fix_stripes=args.stripes,
        fix_pattern_noise=args.fix_pattern_noise,
        dual_iso=dual_iso,
        hdr_interpolation_method=1 if args.mean23 else 0,
        hdr_no_fullres=args.no_fullres,
        hdr_no_alias_map=args.no_alias_map and not args.alias_map,
        deflicker=args.deflicker,
        fps=args.fps,
        name_scheme=1 if args.resolve_naming else 0,
        batch_size=args.batch_size,
        prefetch=args.prefetch,
        use_sidecar_idx=not args.no_idx,
        focus_pixel_dir=args.fpm_dir,
        compress="lj92" if args.compress_dng else "none",
        resume=args.resume,
        export_all=getattr(args, "all", False),
        stripes_batch_cal=args.stripes_batch_cal,
        device=args.device,
    )


def _iter_clips(path: str):
    from .format.reader import is_mlv_name

    if os.path.isdir(path):
        for name in sorted(os.listdir(path)):
            if is_mlv_name(name):
                yield os.path.join(path, name)
    elif is_mlv_name(path):
        yield path


def cmd_convert(args) -> int:
    from .pipeline.convert import convert_clip
    from .utils import metrics

    config = config_from_args(args)
    if args.verbose:
        metrics.log.setLevel("DEBUG")
        metrics.enable(device=config.device)
    if args.devices > 1:
        print(
            f"error: --devices {args.devices} (multi-GPU batches) is not ported to "
            "mlvfs_tpu_torch yet; use mlvfs_tpu for it",
            file=sys.stderr,
        )
        return 2
    src = args.mlv_dir or args.input
    if not src:
        print("no input: pass a clip/directory or --mlv-dir", file=sys.stderr)
        return 1
    total_frames = 0
    t0 = time.time()
    clips = list(_iter_clips(src))
    if not clips:
        print(f"no MLV clips found under {src}", file=sys.stderr)
        return 1
    for clip_path in clips:
        base = os.path.basename(clip_path)
        outdir = os.path.join(args.output, base[:-4]) if len(clips) > 1 or os.path.isdir(src) else args.output
        if not os.path.isfile(clip_path):
            print(f"error: no such file: {clip_path}", file=sys.stderr)
            return 1
        print(f"converting {base} -> {outdir}")
        try:
            with metrics.trace("convert"):
                paths = convert_clip(clip_path, outdir, config)
        except OSError as e:
            print(f"error: failed converting {base}: {e}", file=sys.stderr)
            return 1
        total_frames += sum(1 for p in paths if p.endswith(".dng"))
    dt = time.time() - t0
    print(f"done: {total_frames} frames in {dt:.2f}s ({total_frames / max(dt, 1e-9):.1f} fps)")
    if args.verbose:
        print("spans and counters:")
        print(metrics.report())
    return 0


def cmd_info(args) -> int:
    from .format.reader import MLVClip

    for clip_path in _iter_clips(args.input):
        with MLVClip(clip_path) as clip:
            fh = clip.frame_headers(0)
            ri = fh.raw_info
            cam = bytes(fh.idnt["cameraName"]).rstrip(b"\0").decode("ascii", "replace")
            lens = bytes(fh.lens["lensName"]).rstrip(b"\0").decode("ascii", "replace")
            print(f"{os.path.basename(clip_path)}:")
            print(f"  resolution : {fh.xres}x{fh.yres} @ {fh.fps:.3f} fps")
            print(f"  frames     : {clip.frame_count} video, {clip.audio_frame_count} audio")
            print(f"  bit depth  : {ri.bits_per_pixel}bpp  black={ri.black_level} white={ri.white_level}")
            print(f"  compression: {fh.compression}")
            print(f"  camera     : {cam} (0x{int(fh.idnt['cameraModel']):x})")
            print(f"  lens       : {lens}")
            print(f"  iso        : {int(fh.expo['isoValue'])}  shutter: {int(fh.expo['shutterValue'])}us")
            print(f"  audio      : {'yes' if clip.has_audio else 'no'}")
            print(f"  chunks     : {len(clip.chunk_paths)}")
    return 0


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(prog="mlvfs-tpu-torch", description=__doc__)
    parser.add_argument("--version", action="version", version=f"mlvfs-tpu-torch {__version__}")
    sub = parser.add_subparsers(dest="command")

    p_conv = sub.add_parser("convert", help="convert MLV clips to CinemaDNG sequences")
    p_conv.add_argument("input", nargs="?", help="MLV file or directory")
    p_conv.add_argument("--mlv_dir", "--mlv-dir", dest="mlv_dir", help="Directory containing MLV files")
    p_conv.add_argument("-o", "--output", required=True, help="Output directory")
    p_conv.add_argument(
        "--all", action="store_true",
        help="Also write the clip's .wav (when audio), .log and _PREVIEW.gif "
             "next to the DNGs (the reference's virtual directory contents)")
    _add_processing_flags(p_conv)
    p_conv.set_defaults(func=cmd_convert)

    p_info = sub.add_parser("info", help="show clip metadata")
    p_info.add_argument("input")
    p_info.set_defaults(func=cmd_info)

    args = parser.parse_args(argv)
    if not getattr(args, "func", None):
        parser.print_help()
        return 1
    return args.func(args)


if __name__ == "__main__":
    sys.exit(main())
