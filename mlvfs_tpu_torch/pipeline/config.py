"""Processing configuration — the public option surface.

Counterpart of ``mlvfs_tpu/pipeline/config.py``: the same frozen dataclass
and field names (struct mlvfs, mlvfs.h:32-48, and the reference CLI option
table, main.c:1853-1882), plus ``device``, the torch device the batches run
on. Two JAX engine knobs have no meaning here and are not carried:
``exact_luts`` (comes with the dual-ISO slice) and ``shard_devices``
(comes with multi-GPU).
"""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class ProcessingConfig:
    # -- reference options (same semantics / value encodings) --
    chroma_smooth: int = 0  # 0 off, 2=2x2, 3=3x3, 5=5x5 (--cs2x2/--cs3x3/--cs5x5)
    fix_bad_pixels: int = 0  # 0 off, 1=--bad-pix, 2=--really-bad-pix
    fix_focus_pixels: bool = True  # always-on in the reference (main.c:968)
    fix_stripes: bool = False  # --stripes
    fix_pattern_noise: bool = False  # --fix-pattern-noise
    dual_iso: int = 0  # 0 off, 1=--dual-iso-preview (fast), 2=--dual-iso (full)
    hdr_interpolation_method: int = 0  # 0=--amaze-edge, 1=--mean23
    hdr_no_fullres: bool = False  # webgui-only toggle in the reference
    hdr_no_alias_map: bool = False  # --no-alias-map / --alias-map
    deflicker: int = 0  # --deflicker=<target median>; 0 = off
    fps: float = 0.0  # --fps override for DNG FrameRate tag
    name_scheme: int = 0  # 0 default, 1 = --resolve-naming

    # -- engine options --
    batch_size: int = 16  # frames per device step
    prefetch: int = 2  # host->device pipeline depth (README.md:42 --prefetch)
    use_sidecar_idx: bool = True
    focus_pixel_dir: str = None  # directory with .fpm maps (default: package data)
    compress: str = "none"  # DNG output compression: none | lj92
    resume: bool = False  # skip frames whose DNG already exists (restartable)
    export_all: bool = False  # convert --all: also write the .wav/.log/
    #   _PREVIEW.gif sidecars next to the DNGs (main.c:1308-1320)
    stripes_batch_cal: bool = False  # stripe gains from the whole first batch
    device: str = "cuda"  # torch device of the batch pipeline: cuda[:N] | cpu
