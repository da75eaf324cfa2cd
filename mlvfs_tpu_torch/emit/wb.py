"""White balance: kelvin/green → AsShotNeutral channel multipliers.

Faithful float64 port of the UFRAW-derived math in the reference
(dng.c:264-472): CIE daylight fit for temperature→RGB, camera matrix
pseudo-inverse, and normalization so green multiplier is 1. The numbers feed
the AsShotNeutral rational (×1e6) and must match the reference's doubles to
integer truncation.
"""

from __future__ import annotations

import numpy as np

from ..format.mlv import (
    WB_AUTO,
    WB_SUNNY,
    WB_CLOUDY,
    WB_TUNGSTEN,
    WB_FLUORESCENT,
    WB_FLASH,
    WB_CUSTOM,
    WB_SHADE,
    WB_KELVIN,
)

XYZ_TO_RGB = np.array(
    [
        [3.24071, -0.969258, 0.0556352],
        [-1.53726, 1.87599, -0.203996],
        [-0.498571, 0.0415557, 1.05707],
    ]
)

XYZ_RGB = np.array(
    [
        [0.412453, 0.357580, 0.180423],
        [0.212671, 0.715160, 0.072169],
        [0.019334, 0.119193, 0.950227],
    ]
)

_KELVIN_FOR_MODE = {
    WB_SUNNY: 5500.0,
    WB_SHADE: 7000.0,
    WB_CLOUDY: 6000.0,
    WB_TUNGSTEN: 3200.0,
    WB_FLUORESCENT: 4000.0,
    WB_FLASH: 5500.0,
}


def temperature_to_rgb(t: float) -> np.ndarray:
    """CIE D-illuminant fit (dng.c:288-324)."""
    # explicit t*t / t*t*t like the C (dng.c:295-307): pow(t, 3) can differ
    # from the multiply chain in the last ulp
    if t <= 4000:
        xd = 0.27475e9 / (t * t * t) - 0.98598e6 / (t * t) + 1.17444e3 / t + 0.145986
    elif t <= 7000:
        xd = -4.6070e9 / (t * t * t) + 2.9678e6 / (t * t) + 0.09911e3 / t + 0.244063
    else:
        xd = -2.0064e9 / (t * t * t) + 1.9018e6 / (t * t) + 0.24748e3 / t + 0.237040
    yd = -3 * xd * xd + 2.87 * xd - 0.275
    xyz = np.array([xd / yd, 1.0, (1 - xd - yd) / yd])
    # explicit per-channel sums in the reference's order (dng.c:320-322);
    # a matmul may reassociate/FMA and drift the last ulp, which shows up
    # as an off-by-one AsShotNeutral denominator after the x1e6 truncation
    rgb = np.array([
        xyz[0] * XYZ_TO_RGB[0, c] + xyz[1] * XYZ_TO_RGB[1, c] + xyz[2] * XYZ_TO_RGB[2, c]
        for c in range(3)
    ])
    return rgb / rgb.max()


def _pseudoinverse(mat: np.ndarray, size: int) -> np.ndarray:
    """Gauss-Jordan pseudo-inverse over the first `size` rows (dng.c:326-353).

    Reimplemented with the same elimination order so results match the
    reference's doubles bit-for-bit.
    """
    work = np.zeros((3, 6))
    for i in range(3):
        for j in range(6):
            work[i, j] = 1.0 if j == i + 3 else 0.0
        for j in range(3):
            for k in range(size):
                work[i, j] += mat[k, i] * mat[k, j]
    for i in range(3):
        num = work[i, i]
        work[i, :] /= num
        for k in range(3):
            if k == i:
                continue
            num = work[k, i]
            work[k, :] -= work[i, :] * num
    out = np.zeros((size, 3))
    for i in range(size):
        for j in range(3):
            out[i, j] = sum(work[j, k + 3] * mat[i, k] for k in range(3))
    return out


def _cam_xyz_coeff(cam_xyz: np.ndarray):
    """Normalize camera→XYZ into camera→RGB + per-channel scale (dng.c:355-376)."""
    cam_rgb = np.zeros((4, 3))
    for i in range(3):
        for j in range(3):
            cam_rgb[i, j] = sum(cam_xyz[i, k] * XYZ_RGB[k, j] for k in range(3))
    pre_mul = np.zeros(4)
    for i in range(3):
        s = cam_rgb[i, :3].sum()
        cam_rgb[i, :3] /= s
        pre_mul[i] = 1 / s
    inverse = _pseudoinverse(cam_rgb, 3)
    rgb_cam = np.zeros((3, 4))
    for i in range(3):
        for j in range(3):
            rgb_cam[i, j] = inverse[j, i]
    # the reference declares float rgb_cam[3][4] (dng.c:357): the inverse is
    # rounded to float32 before the second pseudo-inverse consumes it, and
    # that rounding is observable in the final multipliers
    return np.float32(pre_mul), np.float64(np.float32(rgb_cam))


def kelvin_green_to_multipliers(temperature: float, green: float, color_matrix2) -> np.ndarray:
    """Channel multipliers for a kelvin/green WB (dng.c:379-422)."""
    cm = np.asarray(color_matrix2, np.float64).reshape(9, 2)
    cam_xyz = np.zeros((4, 3))
    cam_xyz[:3, :] = (cm[:, 0] / cm[:, 1]).reshape(3, 3)
    pre_mul, rgb_cam = _cam_xyz_coeff(cam_xyz)
    rgb_cam_t = np.zeros((4, 3))
    for i in range(4):
        for j in range(3):
            rgb_cam_t[i, j] = rgb_cam[j, i] if j < 3 else 0.0
    cam_rgb = _pseudoinverse(rgb_cam_t, 3)
    rgb_wb = temperature_to_rgb(temperature)
    rgb_wb = rgb_wb.copy()
    rgb_wb[1] /= green
    chan = np.zeros(3)
    for c in range(3):
        # C computes `1 / pre_mul[c]` with a float operand (dng.c:414), so
        # the reciprocal itself rounds to float32 before the double products
        recip = np.float64(np.float32(1.0) / pre_mul[c])
        inv = sum(recip * cam_rgb[c, cc] * rgb_wb[cc] for cc in range(3))
        chan[c] = 1 / inv
    chan[0] /= chan[1]
    chan[2] /= chan[1]
    chan[1] = 1.0
    return chan


def get_white_balance(wbal, color_matrix2) -> list:
    """AsShotNeutral rational array of 6 int32s (get_white_balance, dng.c:424-472)."""
    mode = int(wbal["wb_mode"])
    if mode == WB_CUSTOM:
        g = int(wbal["wbgain_g"])
        return [int(wbal["wbgain_r"]), g, g, g, int(wbal["wbgain_b"]), g]
    if mode in (WB_AUTO, WB_KELVIN):
        kelvin = float(int(wbal["kelvin"]))
    else:
        kelvin = _KELVIN_FOR_MODE.get(mode, 5500.0)
    chan = kelvin_green_to_multipliers(kelvin, 1.0, color_matrix2)
    return [
        1000000,
        int(chan[0] * 1000000),
        1000000,
        int(chan[1] * 1000000),
        1000000,
        int(chan[2] * 1000000),
    ]
