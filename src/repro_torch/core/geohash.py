"""GeoHash (paper §3.2, [14]): locality encoding for proximity search.

``geoProximitySearch`` uses *reduced precision* on purpose — the paper
widens the geographic cell so farther-but-faster nodes stay in the
candidate list in heterogeneous environments.

Two representations coexist:

* base32 strings (``encode``/``decode``) — the paper's wire format, kept
  for readability and the original scalar path;
* int64 Morton cell codes (``encode_batch``) — ``5 * precision`` bits of
  interleaved lon/lat, MSB-first, so "the first ``p`` base32 characters
  match" becomes ``(a ^ b) >> (5 * (precision - p)) == 0``.  All batch
  selection (SelectionEngine, autoscale region grouping, the geo_topk
  kernel) runs on these codes; no strings on the hot path.
"""
from __future__ import annotations

import math
from typing import List, Tuple

import numpy as np

_BASE32 = "0123456789bcdefghjkmnpqrstuvwxyz"
_DECODE = {c: i for i, c in enumerate(_BASE32)}


def encode(lat: float, lon: float, precision: int = 9) -> str:
    lat_lo, lat_hi = -90.0, 90.0
    lon_lo, lon_hi = -180.0, 180.0
    bits = []
    even = True
    while len(bits) < precision * 5:
        if even:
            mid = (lon_lo + lon_hi) / 2
            if lon >= mid:
                bits.append(1)
                lon_lo = mid
            else:
                bits.append(0)
                lon_hi = mid
        else:
            mid = (lat_lo + lat_hi) / 2
            if lat >= mid:
                bits.append(1)
                lat_lo = mid
            else:
                bits.append(0)
                lat_hi = mid
        even = not even
    chars = []
    for i in range(0, len(bits), 5):
        n = 0
        for b in bits[i:i + 5]:
            n = (n << 1) | b
        chars.append(_BASE32[n])
    return "".join(chars)


def decode(gh: str) -> Tuple[float, float, float, float]:
    """-> (lat, lon, lat_err, lon_err): cell center and half-sizes."""
    lat_lo, lat_hi = -90.0, 90.0
    lon_lo, lon_hi = -180.0, 180.0
    even = True
    for c in gh:
        n = _DECODE[c]
        for shift in range(4, -1, -1):
            bit = (n >> shift) & 1
            if even:
                mid = (lon_lo + lon_hi) / 2
                if bit:
                    lon_lo = mid
                else:
                    lon_hi = mid
            else:
                mid = (lat_lo + lat_hi) / 2
                if bit:
                    lat_lo = mid
                else:
                    lat_hi = mid
            even = not even
    return ((lat_lo + lat_hi) / 2, (lon_lo + lon_hi) / 2,
            (lat_hi - lat_lo) / 2, (lon_hi - lon_lo) / 2)


def common_prefix(a: str, b: str) -> int:
    n = 0
    for x, y in zip(a, b):
        if x != y:
            break
        n += 1
    return n


def distance_km(lat1, lon1, lat2, lon2) -> float:
    """Haversine."""
    r = 6371.0
    p1, p2 = math.radians(lat1), math.radians(lat2)
    dp = math.radians(lat2 - lat1)
    dl = math.radians(lon2 - lon1)
    a = (math.sin(dp / 2) ** 2
         + math.cos(p1) * math.cos(p2) * math.sin(dl / 2) ** 2)
    return 2 * r * math.asin(math.sqrt(a))


# ---------------------------------------------------------------------------
# Vectorized primitives (int64 Morton cell codes)
# ---------------------------------------------------------------------------

_M1 = np.int64(0x5555555555555555)
_M2 = np.int64(0x3333333333333333)
_M4 = np.int64(0x0F0F0F0F0F0F0F0F)
_M8 = np.int64(0x00FF00FF00FF00FF)
_M16 = np.int64(0x0000FFFF0000FFFF)


def _part1by1(v: np.ndarray) -> np.ndarray:
    """Spread the low 32 bits of ``v`` so bit ``j`` lands at bit ``2j``."""
    v = (v | (v << 16)) & _M16
    v = (v | (v << 8)) & _M8
    v = (v | (v << 4)) & _M4
    v = (v | (v << 2)) & _M2
    v = (v | (v << 1)) & _M1
    return v


def _quantize(x: np.ndarray, lo: float, hi: float, bits: int) -> np.ndarray:
    q = np.floor((np.asarray(x, np.float64) - lo) / (hi - lo)
                 * float(1 << bits)).astype(np.int64)
    return np.clip(q, 0, (1 << bits) - 1)


def encode_batch(lats, lons, precision: int = 9) -> np.ndarray:
    """Morton cell codes for arrays of coordinates.

    Returns int64 codes of ``5 * precision`` bits (lon bit first, exactly
    the bit stream ``encode`` packs into base32).  Codes of equal precision
    are prefix-comparable: points share their first ``p`` geohash chars
    iff ``(a ^ b) >> (5 * (precision - p)) == 0``.
    """
    nbits = 5 * precision
    lon_bits = (nbits + 1) // 2
    lat_bits = nbits // 2
    lon_q = _quantize(lons, -180.0, 180.0, lon_bits)
    lat_q = _quantize(lats, -90.0, 90.0, lat_bits)
    # The bit stream starts with a lon bit; whether lon lands on even or
    # odd LSB offsets depends on the parity of the total bit count.
    if nbits % 2:
        return _part1by1(lon_q) | (_part1by1(lat_q) << np.int64(1))
    return (_part1by1(lon_q) << np.int64(1)) | _part1by1(lat_q)


def code_to_str(code: int, precision: int = 9) -> str:
    """Morton cell code -> base32 geohash string (``encode`` equivalent)."""
    chars = []
    for i in range(precision):
        shift = 5 * (precision - 1 - i)
        chars.append(_BASE32[(int(code) >> shift) & 0x1F])
    return "".join(chars)


def str_to_code(gh: str) -> int:
    """Base32 geohash string -> Morton cell code (int, 5*len(gh) bits)."""
    code = 0
    for c in gh:
        code = (code << 5) | _DECODE[c]
    return code


def _bit_length(x: np.ndarray) -> np.ndarray:
    """Vectorized ``int.bit_length`` for non-negative int64 arrays."""
    x = np.asarray(x, np.int64)
    bl = np.zeros(x.shape, np.int64)
    nz = x > 0
    bl[nz] = np.floor(np.log2(x[nz].astype(np.float64))).astype(np.int64) + 1
    # guard libm rounding at exact powers of two
    bl = np.where((x >> np.clip(bl, 0, 63)) != 0, bl + 1, bl)
    too_big = (bl > 0) & ((x >> np.clip(bl - 1, 0, 63)) == 0)
    return np.where(too_big, bl - 1, bl)


def shared_prefix_chars(a, b, precision: int = 9) -> np.ndarray:
    """Broadcasted count of common leading base32 chars between code arrays.

    Parity target: ``common_prefix(encode(p1), encode(p2))`` for codes made
    by ``encode_batch(..., precision)``.
    """
    diff = np.bitwise_xor(np.asarray(a, np.int64), np.asarray(b, np.int64))
    return np.minimum(precision,
                      (5 * precision - _bit_length(diff)) // 5)


def distance_km_batch(lat1, lon1, lat2, lon2) -> np.ndarray:
    """Broadcasted haversine (same formula as ``distance_km``)."""
    r = 6371.0
    p1 = np.radians(np.asarray(lat1, np.float64))
    p2 = np.radians(np.asarray(lat2, np.float64))
    dp = np.radians(np.asarray(lat2, np.float64)
                    - np.asarray(lat1, np.float64))
    dl = np.radians(np.asarray(lon2, np.float64)
                    - np.asarray(lon1, np.float64))
    a = (np.sin(dp / 2) ** 2
         + np.cos(p1) * np.cos(p2) * np.sin(dl / 2) ** 2)
    return 2 * r * np.arcsin(np.sqrt(np.clip(a, 0.0, 1.0)))


def proximity_search(origin: Tuple[float, float],
                     items: List[Tuple[str, Tuple[float, float]]],
                     precision: int = 4, min_hits: int = 4) -> List[str]:
    """IDs whose reduced-precision geohash cell matches the origin's.

    The precision is *reduced* until at least ``min_hits`` candidates are in
    the cell (paper: 'apply GeoHash with less precision ... so relatively
    far-away edge nodes will be evaluated in the same way as closer edge
    nodes to avoid excluding better-performing options')."""
    og = encode(*origin, precision=9)
    for p in range(precision, 0, -1):
        hits = [i for i, loc in items
                if common_prefix(encode(*loc, precision=9), og) >= p]
        if len(hits) >= min(min_hits, len(items)):
            return hits
    return [i for i, _ in items]
