"""PAVE image-fetch helpers (reference util/infer_utils.py:6-40): the port's
own copy of the JAX package's pave/infer_utils.py.

CDN download is gated on `requests` being importable; local-file paths work
everywhere (the batch harness reads local files).
"""
from __future__ import annotations

import io
import os
from typing import Optional, Tuple

from PIL import Image


def download_from_cdn(url: str, timeout: float = 10.0) -> Image.Image:
    try:
        import requests
    except ImportError as e:
        raise RuntimeError("requests not available in this environment") from e
    r = requests.get(url, timeout=timeout)
    r.raise_for_status()
    return Image.open(io.BytesIO(r.content)).convert("RGB")


def get_img(
    path_or_url: str, expected_size: Optional[Tuple[int, int]] = (1920, 1080)
) -> Image.Image:
    """Load a frame from disk or CDN; resize to the expected (w, h) if it
    deviates (reference get_img resize check)."""
    if os.path.exists(path_or_url):
        img = Image.open(path_or_url).convert("RGB")
    else:
        img = download_from_cdn(path_or_url)
    if expected_size is not None and img.size != expected_size:
        img = img.resize(expected_size, Image.BILINEAR)
    return img
