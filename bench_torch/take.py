"""A take of a configuration, made on the card from the seed.

The scene is ``mlvfs_tpu_torch/format/synth.py`` ``make_frame_data``'s
formula (gradients, a sine/cosine texture, Bayer channel gains, shot noise
of sigma 8, dual-ISO rows brightened by the configuration's EV), computed
in torch on the device; the sensor defects are the configuration's
(``chip_smoke.py`` ``flagged_frames``: a period-8 column gain and hot and
cold pixels). Each batch of frames draws its noise from a generator of its
own, seeded from (seed, batch), so that any batch can be made again after
the window for the reference. Frames are packed to the configuration's bit
depth on the card and written as one uncompressed MLV.
"""

from __future__ import annotations

import dataclasses
import math

import torch

import mlvfile


@dataclasses.dataclass
class Take:
    path: str
    frames: int
    width: int
    height: int
    batch: int
    seed: int
    config: dict

    @property
    def batches(self) -> list:
        """First frame of each batch, in order."""
        return list(range(0, self.frames, self.batch))


def _batch_seed(seed: int, first: int) -> int:
    return (int(seed) * 1_000_003 + int(first) * 7919 + 17) % (1 << 63)


def _scene(cfg: dict, h: int, w: int, device) -> torch.Tensor:
    """The noiseless scene (H, W) float64 in raw units, before the noise."""
    y = torch.arange(h, device=device, dtype=torch.float64)[:, None]
    x = torch.arange(w, device=device, dtype=torch.float64)[None, :]
    signal = 0.45 * (x / w) + 0.35 * (y / h) + 0.20 * (0.5 + 0.5 * torch.sin(x / 7.3) * torch.cos(y / 5.1))
    gains = torch.tensor([[0.8, 1.0], [1.0, 0.6]], device=device, dtype=torch.float64)
    signal = signal * gains[(torch.arange(h, device=device) % 2)[:, None], (torch.arange(w, device=device) % 2)[None, :]]
    cam = cfg["camera"]
    ev = cfg["scene"]["dual_iso_ev"]
    scale = 0.9 / (2.0 ** ev) if ev else 0.9
    return cam["black_level"] + signal * (cam["white_level"] - cam["black_level"]) * scale


def make_frames(take: Take, first: int, device) -> torch.Tensor:
    """Frames [first, first + batch) of the take: (B, H, W) int32 pixel values."""
    cfg = take.config
    cam, scene, sensor = cfg["camera"], cfg["scene"], cfg["sensor"]
    h, w = take.height, take.width
    n = min(take.batch, take.frames - first)
    gen = torch.Generator(device=device)
    gen.manual_seed(_batch_seed(take.seed, first))
    black, top = cam["black_level"], (1 << cam["bits_per_pixel"]) - 1
    data = _scene(cfg, h, w, device).expand(n, h, w) + 8.0 * torch.randn(
        (n, h, w), generator=gen, device=device, dtype=torch.float64)
    ev = scene["dual_iso_ev"]
    if ev:
        rows = torch.arange(h, device=device)
        bright = ((rows - scene["dual_iso_phase"]) % 4 >= 2)[None, :, None]
        data = torch.where(bright, black + (data - black) * (2.0 ** ev), data)
    data = torch.clamp(data, 0, top).trunc()  # synth's uint16 frame
    gain = torch.tensor(sensor["column_gain"], device=device, dtype=torch.float64)
    data = black + (data - black) * gain[torch.arange(w, device=device) % len(gain)]
    for key, value in (("cold_pixels", 0), ("hot_pixels", top)):
        for y, x in sensor[key]:
            if y < h and x < w:
                data[:, y, x] = value
    return torch.clamp(data, 0, top).trunc().to(torch.int32)


def pack(values: torch.Tensor, bpp: int) -> torch.Tensor:
    """(B, H, W) int32 values → (B, bytes) uint8: the MSB-first stream of
    16-bit little-endian words (raw.h:41-52), as ``format/bits.py``
    ``pack_bits_np`` packs it, on the values' device."""
    b = values.shape[0]
    lcm = math.lcm(16, bpp)
    ppb, wpb = lcm // bpp, lcm // 16
    flat = values.reshape(b, -1)
    if flat.shape[1] % ppb:
        raise ValueError(f"a frame of {flat.shape[1]} pixels is not whole blocks of {ppb}")
    p = flat.reshape(b, -1, ppb)
    words = torch.zeros((b, p.shape[1], wpb), dtype=torch.int32, device=values.device)
    for j in range(ppb):
        off = j * bpp
        a, sh = off >> 4, off & 15
        if sh + bpp <= 16:
            words[:, :, a] |= p[:, :, j] << (16 - bpp - sh)
        else:
            spill = sh + bpp - 16
            words[:, :, a] |= p[:, :, j] >> spill
            words[:, :, a + 1] |= (p[:, :, j] << (16 - spill)) & 0xFFFF
    words = words.reshape(b, -1)
    return torch.stack([words & 0xFF, words >> 8], dim=-1).to(torch.uint8).reshape(b, -1)


def write(path: str, cfg: dict, frames: int, seed: int, batch: int, device,
          size: tuple = None) -> Take:
    """Make the take on ``device`` and write it to ``path``."""
    cam = cfg["camera"]
    width, height = size or (cfg["sensor"]["width"], cfg["sensor"]["height"])
    take = Take(path, frames, width, height, batch, seed, cfg)
    bpp = cam["bits_per_pixel"]
    payload = width * height * bpp // 8
    header = mlvfile.header_bytes(cam, frames, width, height, cfg["scene"]["dual_iso_ev"])
    vidf = mlvfile.vidf_headers(frames, payload, cam["fps_nom"], cam["fps_denom"])
    pin = device.type == "cuda"

    def payloads():
        host = None
        for first in take.batches:
            packed = pack(make_frames(take, first, device), bpp)
            if host is None or host.shape != packed.shape:
                host = torch.empty(packed.shape, dtype=torch.uint8, pin_memory=pin)
            host.copy_(packed)
            arr = host.numpy()
            for k in range(packed.shape[0]):
                yield first + k, arr[k]

    mlvfile.write_take(path, header, vidf, payloads())
    return take
