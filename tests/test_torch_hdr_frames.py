"""Frames that put hdr_check's mean just below and just above its 0.5
threshold, for the tests of the port's hdr_check on the CPU
(test_torch_dualiso_full.py) and on the card (test_torch_kernels.py).
This file imports torch and the port only."""

import math

import numpy as np
import torch

from mlvfs_tpu_torch.ops import dualiso_full


def hdr_threshold_frames(black, white, h=96, w=96, level=6000):
    """Two flat single-ISO frames at ``level`` whose hdr_check means sit just
    below and just above 0.5. A pixel raised by 1 on row y = 4 mod 8 adds
    one difference d to rows y - 2 and y; a pixel at white on row y = 0 mod
    8 takes two pixels out of the count n. Returns the (2, h, w) uint16
    frames and their exact means, the raised and whited-out pixel counts
    (k, m) chosen so that k * 2d / (n - 2m) comes nearest to 0.5 from each
    side."""
    flat = np.full((h, w), level, np.uint16)
    probe = np.stack([flat, flat])
    probe[1, 12, 8] += 1
    diff, num = dualiso_full.hdr_check_terms(torch.from_numpy(probe.view(np.int16)), black, white)
    n, d2 = int(num[0]), float(diff[1].to(torch.float64).sum())
    raised = [(y, x) for y in range(4, h - 4, 8) for x in range(2, w - 2)]
    whited = [(y, x) for y in range(8, h - 4, 8) for x in range(2, w - 2)]
    below = above = None
    for k in range(1, len(raised) + 1):
        for m in range(len(whited) + 1):
            mean = k * d2 / (n - 2 * m)
            if mean < 0.5 and (below is None or mean > below[0]):
                below = (mean, k, m)
            if mean > 0.5 and (above is None or mean < above[0]):
                above = (mean, k, m)
    frames = np.stack([flat, flat])
    for i, (_, k, m) in enumerate((below, above)):
        for y, x in raised[:k]:
            frames[i, y, x] += 1
        for y, x in whited[:m]:
            frames[i, y, x] = white
    return frames, (below[0], above[0])


def test_hdr_threshold_frames_straddle_half():
    """The two frames' exact means (math.fsum of their float32 differences
    over the count of valid pixels) are the ones returned, within 2e-4 of
    0.5 on each side, and the frames differ from flat only at the raised
    and whited-out pixels, away from the 2-px border."""
    black, white, level = 2048, 15000, 6000
    frames, means = hdr_threshold_frames(black, white, level=level)
    assert frames.shape == (2, 96, 96) and frames.dtype == np.uint16
    assert means[0] < 0.5 < means[1] and max(abs(m - 0.5) for m in means) < 2e-4
    changed = frames != level
    assert not changed[:, :2].any() and not changed[:, -2:].any()
    assert not changed[:, :, :2].any() and not changed[:, :, -2:].any()
    diff, num = dualiso_full.hdr_check_terms(torch.from_numpy(frames.view(np.int16)), black, white)
    for i in range(2):
        assert math.fsum(diff[i].double().flatten().tolist()) / int(num[i]) == means[i]
