"""Google Street View API client: signed URLs, metadata and four-heading
panorama blocks (counterpart of geoguessr_ai_tpu/acquisition/street_view.py).

URLs are signed by HMAC-SHA1 with the URL-safe base64 secret; a block is
four 640 x 640 images at fov 90, at headings seed, +90, +180 and +270.
The network goes through ``requests``, imported inside the functions that
use it, so signing and the URLs need no network and no ``requests``.
"""

from __future__ import annotations

import base64
import hashlib
import hmac
import random
import time
import urllib.parse
from typing import Dict, List, Optional, Tuple

METADATA_URL = "https://maps.googleapis.com/maps/api/streetview/metadata"
IMAGE_URL = "https://maps.googleapis.com/maps/api/streetview"
IMAGE_SIZE = "640x640"
FOV = 90


def sign_url(url: str, secret: str) -> str:
    """Appends the HMAC-SHA1 signature of the URL's path and query."""
    parsed = urllib.parse.urlparse(url)
    to_sign = f"{parsed.path}?{parsed.query}".encode()
    key = base64.urlsafe_b64decode(secret)
    sig = base64.urlsafe_b64encode(
        hmac.new(key, to_sign, hashlib.sha1).digest()).decode()
    return f"{url}&signature={sig}"


def build_image_url(lat: float, lon: float, heading: float, api_key: str,
                    secret: Optional[str] = None, size: str = IMAGE_SIZE,
                    fov: int = FOV) -> str:
    params = urllib.parse.urlencode({
        "size": size, "location": f"{lat},{lon}", "heading": f"{heading:.1f}",
        "fov": fov, "key": api_key, "source": "outdoor",
        "return_error_code": "true"})
    url = f"{IMAGE_URL}?{params}"
    return sign_url(url, secret) if secret else url


def build_metadata_url(lat: float, lon: float, api_key: str,
                       secret: Optional[str] = None) -> str:
    params = urllib.parse.urlencode(
        {"location": f"{lat},{lon}", "key": api_key, "source": "outdoor"})
    url = f"{METADATA_URL}?{params}"
    return sign_url(url, secret) if secret else url


class RateLimitError(RuntimeError):
    """HTTP 403: the API's rate limit; collection stops on it."""


def fetch_metadata(lat: float, lon: float, api_key: str,
                   secret: Optional[str] = None, session=None,
                   retries: int = 3, backoff: float = 1.0) -> Optional[Dict]:
    """The metadata dict (status, pano_id, date), or None where there is
    no imagery or every try failed; RateLimitError on a 403."""
    import requests

    sess = session or requests
    url = build_metadata_url(lat, lon, api_key, secret)
    for attempt in range(retries):
        resp = sess.get(url, timeout=20)
        if resp.status_code == 403:
            raise RateLimitError("Street View metadata: 403 rate limited")
        if resp.ok:
            meta = resp.json()
            return meta if meta.get("status") == "OK" else None
        time.sleep(backoff * (2 ** attempt))
    return None


def heading_block(yaw_seed: float) -> List[float]:
    """The four headings of a block: seed, +90, +180, +270 (mod 360)."""
    return [(yaw_seed + k * 90.0) % 360.0 for k in range(4)]


def fetch_block(lat: float, lon: float, api_key: str,
                secret: Optional[str] = None,
                yaw_seed: Optional[float] = None,
                session=None) -> Tuple[Dict, List[Tuple[float, bytes]]]:
    """The metadata and the block's (heading, JPEG bytes) that came back
    (none where there is no imagery); RateLimitError on a 403."""
    import requests

    sess = session or requests
    meta = fetch_metadata(lat, lon, api_key, secret, session=sess)
    if meta is None:
        return {}, []
    if yaw_seed is None:
        yaw_seed = random.uniform(0, 360)
    images = []
    for heading in heading_block(yaw_seed):
        resp = sess.get(build_image_url(lat, lon, heading, api_key, secret),
                        timeout=30)
        if resp.status_code == 403:
            raise RateLimitError("Street View image: 403 rate limited")
        if resp.ok:
            images.append((heading, resp.content))
    return meta, images
