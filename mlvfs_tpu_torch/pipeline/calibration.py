"""Per-clip calibration sidecar (`.CAL`).

Counterpart of ``mlvfs_tpu/pipeline/calibration.py`` with the same file
format and keys, so a sidecar written by either package is read by the
other. Host-only JSON; no torch.

The reference recomputes its per-mount caches on every mount: stripe
gains from the first frame (main.c:980-996, stripes.c:29-69) and bad-pixel
maps per file GUID (cs.c:215-312). SURVEY.md section 5 (checkpoint/resume)
extends the `.IDX` sidecar idea to these: persist the calibration next to
the clip so a restarted conversion (or a new process) skips the detection
pass entirely.

Format: one JSON object. Entries are keyed by the file GUID plus the
config fields that affect the stored values, so changing e.g.
``--really-bad-pix`` invalidates only the bad-pixel entry.
"""

from __future__ import annotations

import json
import os

import numpy as np

CAL_VERSION = 1


def cal_path(mlv_path: str) -> str:
    """CLIP.MLV → CLIP.CAL (next to the .IDX sidecar)."""
    base, _ = os.path.splitext(mlv_path)
    return base + ".CAL"


def _stripes_key(guid: int) -> str:
    return f"{guid:016x}/stripes"


def _badpix_key(guid: int, aggressive: bool) -> str:
    return f"{guid:016x}/badpix/{'aggressive' if aggressive else 'normal'}"


def _read(path: str) -> dict:
    try:
        with open(path, "r") as f:
            data = json.load(f)
        if data.get("version") != CAL_VERSION:
            return {"version": CAL_VERSION}
        return data
    except (OSError, ValueError):
        return {"version": CAL_VERSION}


def load_into(cal, mlv_path: str, guid: int, cfg) -> None:
    """Populate ``cal`` (kernels.ClipCalibration) from the sidecar, if present."""
    data = _read(cal_path(mlv_path))
    s = data.get(_stripes_key(guid))
    if s is not None and cfg.fix_stripes:
        cal.stripes_gains = np.asarray(s["gains"], np.int32)
        cal.stripes_needed = bool(s["needed"])
        cal.stripes_done = True
    bp = data.get(_badpix_key(guid, cfg.fix_bad_pixels == 2))
    if bp is not None and cfg.fix_bad_pixels:
        cal.bad_pixel_list = np.asarray(bp["pixels"], np.int64).reshape(-1, 2)
        cal.bad_pixels_done = True


def save_from(cal, mlv_path: str, guid: int, cfg) -> None:
    """Persist whatever ``cal`` has computed. Atomic (tmp + rename)."""
    path = cal_path(mlv_path)
    data = _read(path)
    changed = False
    if cal.stripes_done and cfg.fix_stripes:
        entry = {
            "gains": [int(g) for g in np.asarray(cal.stripes_gains).tolist()]
            if cal.stripes_gains is not None
            else [],
            "needed": bool(cal.stripes_needed),
        }
        if data.get(_stripes_key(guid)) != entry:
            data[_stripes_key(guid)] = entry
            changed = True
    if cal.bad_pixels_done and cfg.fix_bad_pixels:
        pixels = (
            np.asarray(cal.bad_pixel_list, np.int64).reshape(-1).tolist()
            if cal.bad_pixel_list is not None
            else []
        )
        entry = {"pixels": pixels}
        key = _badpix_key(guid, cfg.fix_bad_pixels == 2)
        if data.get(key) != entry:
            data[key] = entry
            changed = True
    if not changed:
        return
    tmp = path + ".tmp"
    try:
        with open(tmp, "w") as f:
            json.dump(data, f)
        os.replace(tmp, path)
    except OSError:
        # the sidecar is an optimization; never fail the conversion over it
        try:
            os.unlink(tmp)
        except OSError:
            pass
