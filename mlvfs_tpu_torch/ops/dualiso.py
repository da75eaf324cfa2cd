"""Dual-ISO preview (--dual-iso-preview): the host fit, kernel #5 and its
plain PyTorch twin.

Counterpart of ``mlvfs_tpu/ops/dualiso.py``. The sensor alternates ISO every
two rows; the preview reconstruction (hdr_convert_data, hdr.c:40-227):

  1. green-channel histograms per row phase (y mod 4), sampled every 5th row
     and every 4th column;
  2. phase detection: which pair of row phases is the dark exposure;
  3. focus-pixel fix (horizontal interpolation), on detected frames only;
  4. histogram matching: walk both CDFs to sample the dark = f(bright)
     curve, weighted least squares → gain a, offset b;
  5. per-row transform: darken bright rows into the dark exposure's scale
     (over-white pixels replaced from the neighbouring rows), lift dark
     shadows by blending with scaled bright neighbours;
  6. shift to 16 bit (<<2); the caller sets black/white ×4.

The fit (2, 4) runs where ``MLVFS_TPU_PREVIEW_DEV`` says
(:func:`_use_preview_dev`): on the batch's device
(``dualiso_preview_dev.py``: sorted samples, then ``csrc/dualiso_preview_fit.cu``
on a CUDA batch), the default on the card, or on the host in float64 from
one readback of the strided samples (:func:`green_phase_histograms`,
:func:`fit_preview`), the default on the CPU, as the reference chooses on
its accelerator and on the CPU. Step 5 is :func:`apply_preview`:
``csrc/dualiso_preview.cu`` on a CUDA tensor, :func:`apply_preview_plain` on
a CPU tensor.
"""

from __future__ import annotations

import dataclasses
import os

import numpy as np
import torch

from .. import _build
from ..utils import metrics
from .unpack import to_int16_bits

# Launches of the CUDA kernel by apply_preview, for showing that a run went
# through the kernel. Only the wrapper adds to it, once per launch.
KERNEL_LAUNCHES = 0


@dataclasses.dataclass
class PreviewFit:
    ok: bool = False
    dark_row_start: int = 0
    a: float = 1.0
    b: float = 0.0
    shadow: int = 0


# ---------------------------------------------------------------- histograms


def green_phase_histograms(imgs: torch.Tensor, white: int):
    """(B, 4, white+1) histograms + (4,) stored counts (hdr.c:47-59) of a
    batch (B, H, W) int16 (u16 bits) on any device.

    The sampling grid is static (every 5th row; within a phase all rows
    share one column offset), so the device side is four strided slices,
    read back in one copy; the histograms are np.bincount on the host, where
    the fit consumes them."""
    b, h, w = imgs.shape
    ys = np.arange(4, h - 4, 5)
    offs = (ys + 1) % 2
    phase = ys % 4  # which histogram each row feeds
    sample_sets = []
    counts = np.zeros(4, np.int64)
    for q in range(4):
        ys_q = ys[phase == q]
        off_q = int(offs[phase == q][0]) if len(ys_q) else 0
        rows = imgs[:, torch.as_tensor(ys_q, device=imgs.device), :][:, :, off_q::4]
        sample_sets.append(rows.reshape(b, -1))
        # reference count semantics: (w - off) // 4 per row (hist->count)
        counts[q] = len(ys_q) * ((w - off_q) // 4)
    sizes = [s.shape[1] for s in sample_sets]
    with metrics.sync("preview_samples"):
        host = torch.cat(sample_sets, 1).cpu().numpy().view(np.uint16)
    hists = np.zeros((b, 4, white + 1), np.int32)
    start = 0
    for q, n in enumerate(sizes):
        v = np.minimum(host[:, start : start + n].astype(np.int64), white)
        start += n
        if n == 0:
            continue
        for bi in range(b):
            hists[bi, q] = np.bincount(v[bi], minlength=white + 1)
    return hists, counts


def _hist_median(hist: np.ndarray, count: int) -> int:
    """hist_median (histogram.c:64-75): first bin where cumsum > count/2."""
    cum = np.cumsum(hist)
    idx = np.nonzero(cum > count // 2)[0]
    return int(idx[0]) if len(idx) else 0


# ------------------------------------------------------------- host-side fit


def detect_phase(medians, black: int):
    """Dark-row phase from the 4 medians (hdr.c:66-107). Returns
    (dark_row_start, lo phase, hi phase), dark_row_start -1 if none."""
    m = [int(v) - black for v in medians]
    if m[2] > 2 * m[0] and m[2] > 2 * m[1] and m[3] > 2 * m[0] and m[3] > 2 * m[1]:
        return 0, 0, 2
    if m[0] > 2 * m[1] and m[0] > 2 * m[2] and m[3] > 2 * m[1] and m[3] > 2 * m[2]:
        return 1, 1, 0
    if m[0] > 2 * m[2] and m[0] > 2 * m[3] and m[1] > 2 * m[2] and m[1] > 2 * m[3]:
        return 2, 2, 0
    if m[1] > 2 * m[0] and m[1] > 2 * m[3] and m[2] > 2 * m[0] and m[2] > 2 * m[3]:
        return 3, 0, 2
    return -1, 0, 0


def match_histograms(hist_hi, hist_lo, count_total, black: int, white: int) -> PreviewFit:
    """CDF walk + weighted least squares (hdr.c:111-183)."""
    min_pix = 100
    acc_lo = 0
    acc_hi = 0
    raw_lo = 0
    prev_acc_hi = 0
    xs, ys, ws = [], [], []
    hi = np.asarray(hist_hi, np.int64)
    lo = np.asarray(hist_lo, np.int64)
    total = int(count_total)
    lo_hi_bound = len(lo)
    for raw_hi in range(total):
        if raw_hi >= len(hi):
            break
        acc_hi += int(hi[raw_hi])
        while acc_lo < acc_hi and raw_lo < lo_hi_bound:
            acc_lo += int(lo[raw_lo])
            raw_lo += 1
        if raw_lo >= white:
            break
        if acc_hi - prev_acc_hi > min_pix:
            if acc_hi > total * 1 // 100 and acc_hi < total * 99.99 / 100:
                xs.append(raw_hi - black)
                ys.append(raw_lo - black)
                ws.append(max(0, raw_hi - black + 100))
                prev_acc_hi = acc_hi
    if len(xs) < 2:
        # the reference computes a NaN fit and converts anyway (hdr.c never
        # checks data_num); a neutral gain is used instead of NaN
        return PreviewFit(ok=True, a=1.0, b=0.0, shadow=0)
    x = np.asarray(xs, np.float64)
    y = np.asarray(ys, np.float64)
    wt = np.asarray(ws, np.float64)
    weight = wt.sum()
    mx = (x * wt).sum() / weight
    my = (y * wt).sum() / weight
    mxy = (x * y * wt).sum() / weight
    mx2 = (x * x * wt).sum() / weight
    a = (mxy - mx * my) / (mx2 - mx * mx)
    b = my - a * mx
    shadow = int(black + 1 / (a * a) + b) & 0xFFFF
    return PreviewFit(ok=True, a=float(a), b=float(b), shadow=shadow)


def fit_preview(hists, counts, black: int, white: int) -> list:
    """Per-frame fits from the histograms (B, 4, white+1)."""
    out = []
    for fr in range(hists.shape[0]):
        med = [_hist_median(hists[fr, q], counts[q]) for q in range(4)]
        drs, qlo, qhi = detect_phase(med, black)
        if drs < 0:
            out.append(PreviewFit(ok=False))
            continue
        # hist_total is hist[0]->count regardless of phase (hdr.c:125)
        fit = match_histograms(hists[fr, qhi], hists[fr, qlo], counts[0], black, white)
        fit.dark_row_start = drs
        out.append(fit)
    return out


# -------------------------------------------------------- device-side apply


def fma_f32(x: torch.Tensor, y: torch.Tensor, z: torch.Tensor) -> torch.Tensor:
    """x * y + z of float32 tensors, rounded once to float32 (a fused
    multiply-add), computed exactly in float64 on any device.

    The product of two floats is exact in float64; the sum is taken with
    its exact error (TwoSum). Rounding that sum to float32 is the correctly
    rounded result unless the sum was itself rounded onto the midpoint of
    two floats, in which case the error's sign picks the neighbour."""
    p = x.double() * y.double()
    zd = z.double()
    s = p + zd
    bv = s - p
    err = (p - (s - bv)) + (zd - bv)
    r = s.float()
    rd = r.double()
    toward = torch.nextafter(r, torch.where(s > rd, torch.inf, -torch.inf).float())
    tie = (s != rd) & ((s - rd).abs() * 2 == (toward.double() - rd).abs())
    beyond = (err != 0) & ((err > 0) == (s > rd))
    return torch.where(tie & beyond, toward, r)


def apply_preview_plain(imgs, a, b, shadow, dark_row_start, black: int, white: int):
    """Plain twin of the kernel: the row transform + 16-bit shift
    (hdr.c:185-224) of a batch (B, H, W) int16 (u16 bits) → (B, H, W) int16.

    ``a``, ``b``, ``shadow`` (float32) and ``dark_row_start`` (int32) are per
    frame, on the batch's device. Rows run top to bottom, each a (B, W)
    float32 step in the reference's operation order, carrying the
    transformed rows y-2 and y-1. XLA on the CPU contracts
    ``(p - black) * a + black`` into a fused multiply-add, so that step
    rounds once (:func:`fma_f32`); every other operation rounds on its own."""
    bsz, h, w = imgs.shape
    src = (imgs.to(torch.int32) & 0xFFFF).to(torch.float32)
    a = a.to(torch.float32)[:, None]
    b_ = b.to(torch.float32)[:, None]
    shadow_f = shadow.to(torch.float32)[:, None]
    drs = dark_row_start.to(torch.int32)
    blackf = torch.tensor(float(black), dtype=torch.float32, device=imgs.device)
    whitef = torch.tensor(float(white), dtype=torch.float32, device=imgs.device)

    def scale(p):
        d = p - blackf
        return torch.minimum(whitef, fma_f32(d, a.expand_as(d), blackf.expand_as(d)) + b_)

    out = torch.empty((bsz, h, w), dtype=torch.int32, device=imgs.device)
    prev2 = prev1 = src[:, 0]
    for y in range(h):
        row = src[:, y]
        below = src[:, min(y + 2, h - 1)]
        up_ok = y > 2
        down_ok = y < h - 2
        is_bright = ((y - drs + 4) % 4) >= 2  # (B,)

        # bright row (hdr.c:190-201)
        if up_ok:
            repl = torch.trunc((prev2 + below) / 2) if down_ok else prev2
        else:
            repl = below
        bright_out = torch.where(row >= whitef, torch.trunc(repl), torch.trunc(scale(row)))

        # dark row (hdr.c:203-214)
        scaled_below = scale(below)
        if up_ok:
            dark_repl = torch.trunc((prev2 + scaled_below) / 2) if down_ok else prev2
        else:
            dark_repl = torch.trunc(scaled_below)
        dark_out = torch.where(row < shadow_f, torch.trunc(dark_repl), row)

        res = torch.where(is_bright[:, None], bright_out, dark_out).clamp(0, 65535)
        out[:, y] = res.to(torch.int32)
        prev2, prev1 = prev1, res
    return to_int16_bits((out << 2) & 0xFFFF)


def _check(imgs, params):
    if imgs.dim() != 3:
        raise ValueError(f"preview takes (B, H, W) frames, got shape {tuple(imgs.shape)}")
    if imgs.dtype != torch.int16:
        raise TypeError(f"preview takes int16 frames, got {imgs.dtype}")
    for t in params:
        if t.shape != (imgs.shape[0],) or t.device != imgs.device:
            raise ValueError("preview takes one a, b, shadow and dark row start per frame, "
                             "on the frames' device")


def _apply_preview_cuda(imgs, a, b, shadow, dark_row_start, black: int, white: int):
    global KERNEL_LAUNCHES
    params = [a.to(torch.float32).contiguous(), b.to(torch.float32).contiguous(),
              shadow.to(torch.float32).contiguous(), dark_row_start.to(torch.int32).contiguous()]
    _check(imgs, params)
    if not imgs.is_contiguous():
        raise ValueError("preview kernel takes contiguous (B, H, W) frames")
    bsz, h, w = imgs.shape
    if bsz > 65535:
        raise ValueError(f"preview kernel takes at most 65535 frames per batch, got {bsz}")
    out = torch.empty_like(imgs)
    if out.numel() == 0:
        return out
    lib = _build.library("dualiso_preview")
    with torch.cuda.device(imgs.device):
        stream = torch.cuda.current_stream(imgs.device).cuda_stream
        rc = lib.mlvfs_dualiso_preview(
            imgs.data_ptr(), out.data_ptr(), *(t.data_ptr() for t in params),
            bsz, h, w, int(black), int(white), stream,
        )
    if rc != 0:
        raise RuntimeError(f"preview kernel launch failed (cudaError {rc})")
    KERNEL_LAUNCHES += 1
    return out


def apply_preview(imgs, a, b, shadow, dark_row_start, black: int, white: int):
    """Row transform + 16-bit shift (hdr.c:185-224) of a batch (B, H, W)
    int16 (u16 bits) → a new (B, H, W) int16.

    CPU tensor: the plain version. CUDA tensor: the CUDA kernel. Anything
    else raises."""
    if imgs.device.type == "cpu":
        _check(imgs, (a, b, shadow, dark_row_start))
        return apply_preview_plain(imgs, a, b, shadow, dark_row_start, black, white)
    if imgs.device.type == "cuda":
        return _apply_preview_cuda(imgs, a, b, shadow, dark_row_start, black, white)
    raise ValueError(f"apply_preview: unsupported device {imgs.device}")


# ------------------------------------------------------------- orchestrator


def _use_preview_dev(device: torch.device) -> bool:
    """Whether the preview fits on the batch's device: ``MLVFS_TPU_PREVIEW_DEV``
    ``1`` yes, ``0`` no (the host fit), anything else or unset (``auto``) on
    a CUDA batch, the port's accelerator, as the reference fits on its TPU
    and on the host on the CPU (``mlvfs_tpu/ops/dualiso.py:256-267``)."""
    mode = os.environ.get("MLVFS_TPU_PREVIEW_DEV", "auto")
    if mode == "0":
        return False
    if mode == "1":
        return True
    return device.type == "cuda"


def hdr_preview_batch(imgs: torch.Tensor, fh, cal):
    """Full preview path for a batch (B, H, W) int16 on its device. Returns
    (imgs, ok) with ok a (B,) numpy bool array: which frames were detected
    as dual-ISO and converted; frames that fail detection pass through.

    With the device fit (:func:`_use_preview_dev`) the fit, the focus-pixel
    selection and the row transform stay on the device, and ``ok`` is read
    back once at the end. The host fit reads the histogram samples back
    first, and no transform is launched when no frame is detected."""
    ri = fh.raw_info
    black, white = ri.black_level, ri.white_level
    dev = imgs.device
    if _use_preview_dev(dev):
        from . import dualiso_preview_dev as pdev

        ok, a, bb, shadow, drs = pdev.preview_fit_device(imgs, black, white)
    else:
        hists, counts = green_phase_histograms(imgs, white)
        fits = fit_preview(hists, counts, black, white)
        ok = np.array([f.ok for f in fits], bool)
        if not ok.any():
            return imgs, ok

        def per_frame(values, dtype):
            return torch.tensor(values, dtype=dtype).to(dev)

        a = per_frame([f.a if f.ok else 1.0 for f in fits], torch.float32)
        bb = per_frame([f.b if f.ok else 0.0 for f in fits], torch.float32)
        shadow = per_frame([f.shadow for f in fits], torch.float32)
        drs = per_frame([f.dark_row_start for f in fits], torch.int32)
    keep = torch.as_tensor(ok, device=dev)[:, None, None]

    # focus pixels fixed inside the preview path, horizontal mode, on the
    # detected frames only: the reference returns before fix_focus_pixels
    # when detection fails (hdr.c:104-109), leaving the frame to the
    # caller's normal-mode fixes (main.c:966-973)
    if cal is not None and cal.focus_pixel_list is not None and len(cal.focus_pixel_list):
        from . import pixels as pixel_ops

        crop_x = (int(fh.vidf["panPosX"]) + 7) & ~7
        crop_y = int(fh.vidf["panPosY"]) & ~1
        fixed = pixel_ops.fix_pixel_list_batch(
            imgs, cal.focus_pixel_list, black, crop_x, crop_y, dual_iso=True
        )
        imgs = torch.where(keep, fixed, imgs)

    converted = apply_preview(imgs, a, bb, shadow, drs, black, white)
    out = torch.where(keep, converted, imgs)
    if isinstance(ok, torch.Tensor):
        with metrics.sync("preview_ok"):
            ok = ok.cpu().numpy()
    return out, ok
