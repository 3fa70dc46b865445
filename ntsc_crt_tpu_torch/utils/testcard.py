"""Synthetic SMPTE-style test card — the default input for the live front ends
and examples (stands in for the sample PPMs of the reference's README).

The port's own copy of ``ntsc_crt_tpu/utils/testcard.py`` (numpy only; a
test holds the two equal)."""

import numpy as np


def test_card(w: int = 320, h: int = 240) -> np.ndarray:
    """SMPTE-ish color bars over a frequency sweep (artifact-color bait)."""
    img = np.zeros((h, w, 3), np.uint8)
    bars = [(192, 192, 192), (192, 192, 0), (0, 192, 192), (0, 192, 0),
            (192, 0, 192), (192, 0, 0), (0, 0, 192)]
    bw = w // len(bars)
    for i, c in enumerate(bars):
        img[: h // 2, i * bw:(i + 1) * bw] = c
    # bottom half: B/W stripes at increasing frequency (artifact colors)
    x = np.arange(w)
    for row in range(h // 2, h):
        period = max(2, 16 - (row - h // 2) * 14 // (h // 2))
        img[row] = np.where(((x // max(1, period // 2)) % 2 == 0)[:, None],
                            255, 0)
    return img
