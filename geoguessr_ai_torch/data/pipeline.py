"""Host-side JPEG decode for the guess path (PIL; the native libjpeg
decoder of the JAX package is not ported yet)."""

from __future__ import annotations

import io

import numpy as np


def decode_jpeg(blob: bytes, size: int) -> np.ndarray:
    """Decode one JPEG to (size, size, 3) uint8 RGB, resized bilinearly
    when it is not already size x size."""
    from PIL import Image

    with Image.open(io.BytesIO(blob)) as im:
        im = im.convert("RGB")
        if im.size != (size, size):
            im = im.resize((size, size), Image.BILINEAR)
        return np.asarray(im, dtype=np.uint8)
