"""The deflicker median, batched over frames, in plain PyTorch.

Counterpart of ``mlvfs_tpu/ops/histogram.py`` ``deflicker_median``
(main.c:895-906, hist_add/hist_median in histogram.c:52-75). The reference
feeds every second 16-bit value starting at element 1 (the odd flat indices)
into a histogram with bins [0..white] (values above white clamp into the last
bin) and walks the CDF for the first bin whose running total exceeds
count / 2. That bin is the order statistic of rank ``middle`` of the clamped
values, so it is taken directly with ``kthvalue``; the JAX package's
bisection and its even-width parity-mask branch compute the same value (for
every frame size, the odd flat indices are exactly the values added).

A reduction with no Pallas original: plain torch on either device.
"""

from __future__ import annotations

import torch


def deflicker_median(imgs: torch.Tensor, white: int) -> torch.Tensor:
    """(B, H, W) int16 (u16 bits) → (B,) int32 medians, on the batch's device."""
    b = imgs.shape[0]
    hw = imgs[0].numel()
    s = (2 * hw - 1) // 2  # hist_add 'size' argument
    n_added = (s + 1) // 2
    middle = (s // 2) // 2  # hist->count // 2
    if n_added <= middle:  # nothing exceeds count/2 (a 1-pixel frame)
        return torch.zeros(b, dtype=torch.int32, device=imgs.device)
    odd = imgs.reshape(b, hw)[:, 1::2][:, :n_added]
    v = torch.clamp(odd.to(torch.int32) & 0xFFFF, max=white)
    return torch.kthvalue(v, middle + 1, dim=1).values
