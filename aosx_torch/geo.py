"""Geo / frame alignment (a copy of ``aosx/geo.py``; reference:
src/gps_to_utm_node.cpp).

GPS (lat, lon) -> UTM via the 6th-order Krueger series (equivalent to
GeographicLib UTMUPS::Forward to sub-mm over a UTM zone), the 2-point
UTM -> base_link similarity alignment, the GPS antenna lever-arm offset,
and the gps_polygon.json -> exploration-polygon conversion.

This is bring-up code (the reference runs it once per mission), so it is
vectorized NumPy float64 on the host: f32 device math would lose about
0.5 m at UTM magnitudes (~4e6 m northing). The batch conversion doubles as
the GpsToRelative service (srv/GpsToRelative.srv, an interface without a
server in the reference).
"""

from __future__ import annotations

import dataclasses
import json
import math
from typing import Optional, Tuple

import numpy as np

# WGS84
_A = 6378137.0
_F = 1.0 / 298.257223563
_K0 = 0.9996
_FALSE_EASTING = 500000.0
_FALSE_NORTHING_SOUTH = 10000000.0

_N = _F / (2.0 - _F)
_E = math.sqrt(_F * (2.0 - _F))
_A_BAR = _A / (1.0 + _N) * (1.0 + _N**2 / 4.0 + _N**4 / 64.0 + _N**6 / 256.0)

# Krueger alpha coefficients (series in n, 6th order; Karney 2011 eq. 35)
_ALPHA = np.array(
    [
        _N / 2 - 2 * _N**2 / 3 + 5 * _N**3 / 16 + 41 * _N**4 / 180 - 127 * _N**5 / 288
        + 7891 * _N**6 / 37800,
        13 * _N**2 / 48 - 3 * _N**3 / 5 + 557 * _N**4 / 1440 + 281 * _N**5 / 630
        - 1983433 * _N**6 / 1935360,
        61 * _N**3 / 240 - 103 * _N**4 / 140 + 15061 * _N**5 / 26880
        + 167603 * _N**6 / 181440,
        49561 * _N**4 / 161280 - 179 * _N**5 / 168 + 6601661 * _N**6 / 7257600,
        34729 * _N**5 / 80640 - 3418889 * _N**6 / 1995840,
        212378941 * _N**6 / 319334400,
    ]
)


def utm_zone_of(lon: float) -> int:
    return int((lon + 180.0) // 6.0) + 1


def utm_forward(lat, lon, zone: Optional[int] = None):
    """Forward transverse Mercator (UTM). lat/lon in degrees, vectorized.
    Returns (easting, northing, zone). Matches GeographicLib's
    UTMUPS::Forward (src/gps_to_utm_node.cpp:144-149 usage, fixed zone 52 by
    default in the reference params)."""
    lat = np.asarray(lat, np.float64)
    lon = np.asarray(lon, np.float64)
    if zone is None or zone == 0:
        zone = utm_zone_of(float(np.mean(lon)))
    lon0 = math.radians(-183.0 + 6.0 * zone)
    phi = np.radians(lat)
    lam = np.radians(lon) - lon0

    sphi = np.sin(phi)
    t = np.sinh(np.arctanh(sphi) - _E * np.arctanh(_E * sphi))
    xi_p = np.arctan2(t, np.cos(lam))
    eta_p = np.arcsinh(np.sin(lam) / np.sqrt(t * t + np.cos(lam) ** 2))

    xi = xi_p.copy()
    eta = eta_p.copy()
    for j in range(6):
        k = 2.0 * (j + 1)
        xi = xi + _ALPHA[j] * np.sin(k * xi_p) * np.cosh(k * eta_p)
        eta = eta + _ALPHA[j] * np.cos(k * xi_p) * np.sinh(k * eta_p)

    x = _K0 * _A_BAR * eta + _FALSE_EASTING
    y = _K0 * _A_BAR * xi
    y = np.where(lat < 0.0, y + _FALSE_NORTHING_SOUTH, y)
    return x, y, zone


@dataclasses.dataclass(frozen=True)
class Transform2D:
    """UTM -> base_link rigid transform (src/gps_to_utm_node.cpp:33-50)."""

    tx: float
    ty: float
    theta: float

    def apply(self, x, y):
        c, s = math.cos(self.theta), math.sin(self.theta)
        return c * x - s * y + self.tx, s * x + c * y + self.ty


def apply_gps_offset(offset_x, offset_y, yaw):
    """Antenna lever arm rotated by base_link yaw (cpp:176-191)."""
    c, s = math.cos(yaw), math.sin(yaw)
    return c * offset_x - s * offset_y, s * offset_x + c * offset_y


def quat_yaw(qx, qy, qz, qw):
    return math.atan2(2.0 * (qw * qz + qx * qy), 1.0 - 2.0 * (qy * qy + qz * qz))


def compute_initial_transform(
    base0: Tuple[float, float],
    utm0: Tuple[float, float],
    base1: Tuple[float, float],
    utm1: Tuple[float, float],
) -> Transform2D:
    """2-point similarity alignment (cpp:444-476): rotation from segment
    angles, translation averaged over both correspondences."""
    base_angle = math.atan2(base1[1] - base0[1], base1[0] - base0[0])
    utm_angle = math.atan2(utm1[1] - utm0[1], utm1[0] - utm0[0])
    theta = base_angle - utm_angle
    c, s = math.cos(theta), math.sin(theta)
    tx0 = base0[0] - (c * utm0[0] - s * utm0[1])
    ty0 = base0[1] - (s * utm0[0] + c * utm0[1])
    tx1 = base1[0] - (c * utm1[0] - s * utm1[1])
    ty1 = base1[1] - (s * utm1[0] + c * utm1[1])
    return Transform2D((tx0 + tx1) / 2.0, (ty0 + ty1) / 2.0, theta)


class GpsAligner:
    """The gps_to_utm node's stateful bring-up protocol (cpp:109-415):
    queue UTM fixes, store first GPS-receiver position, and after >= 5 m of
    travel compute the UTM -> base_link transform from the (first, current)
    correspondence pair (timestamp-matched)."""

    def __init__(self, zone: int = 52, gps_offset=(-0.65, 0.55), queue_size: int = 100,
                 min_travel: float = 5.0):
        self.zone = zone
        self.gps_offset = gps_offset
        self.queue: list = []
        self.queue_size = queue_size
        self.min_travel = min_travel
        self.first_utm = None
        self.first_receiver = None
        self.transform: Optional[Transform2D] = None

    def on_gps(self, lat: float, lon: float, t: float):
        """NavSatFix handler (cpp:109-173): validate, convert, enqueue."""
        if not (math.isfinite(lat) and math.isfinite(lon)):
            return
        if not (-90.0 <= lat <= 90.0 and -180.0 <= lon <= 180.0):
            return
        if abs(lat) < 1e-6 and abs(lon) < 1e-6:
            return
        x, y, _ = utm_forward(lat, lon, self.zone)
        if self.first_utm is None:
            self.first_utm = (float(x), float(y))
        self.queue.append((float(x), float(y), t))
        if len(self.queue) > self.queue_size:
            self.queue.pop(0)

    def _matching_utm(self, t: float):
        """Nearest-timestamp UTM fix (cpp:418-441)."""
        if not self.queue:
            return None
        return min(self.queue, key=lambda u: abs(u[2] - t))

    def on_odom(self, x: float, y: float, quat, t: float):
        """Odometry handler (cpp:345-415). Returns True once aligned."""
        yaw = quat_yaw(*quat)
        ox, oy = apply_gps_offset(*self.gps_offset, yaw)
        rx, ry = x + ox, y + oy
        if self.first_receiver is None:
            self.first_receiver = (rx, ry)
        if self.transform is None and self.first_utm is not None:
            d = math.hypot(rx - self.first_receiver[0], ry - self.first_receiver[1])
            if d >= self.min_travel:
                cur = self._matching_utm(t)
                if cur is not None:
                    self.transform = compute_initial_transform(
                        self.first_receiver, self.first_utm, (rx, ry), cur[:2]
                    )
        return self.transform is not None

    def gps_to_base(self, lons, lats):
        """Batch GPS -> base_link (the GpsToRelative service, srv/GpsToRelative.srv;
        also cpp:194-230). Returns (x, y, success mask)."""
        lats = np.asarray(lats, np.float64)
        lons = np.asarray(lons, np.float64)
        ok = (
            np.isfinite(lats) & np.isfinite(lons)
            & (lats >= -90) & (lats <= 90) & (lons >= -180) & (lons <= 180)
        )
        x, y, _ = utm_forward(np.where(ok, lats, 0.0), np.where(ok, lons, 0.0), self.zone)
        if self.transform is None:
            return np.zeros_like(x), np.zeros_like(y), np.zeros_like(ok)
        bx, by = self.transform.apply(x, y)
        return bx, by, ok


def convert_gps_polygon(json_path: str, aligner: GpsAligner):
    """gps_polygon.json -> exploration polygon in base frame (cpp:233-342).
    Points that fail conversion or land exactly at (0,0) are dropped, like
    the reference's publisher. Returns [P,2] float64 (may be < 3 points)."""
    with open(json_path) as f:
        doc = json.load(f)
    pts = doc.get("points", [])
    lats = [p["latitude"] for p in pts if "latitude" in p and "longitude" in p]
    lons = [p["longitude"] for p in pts if "latitude" in p and "longitude" in p]
    if not lats:
        return np.zeros((0, 2))
    bx, by, ok = aligner.gps_to_base(lons, lats)
    keep = ok & ((bx != 0.0) | (by != 0.0))
    return np.stack([bx[keep], by[keep]], axis=1)
