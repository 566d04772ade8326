"""The port's copy of the geo module (``aosx_torch/geo.py``) against
``aosx/geo.py`` on tests/test_geo.py's inputs: UTM forward, zone selection,
the two-point alignment, the aligner protocol and the GPS polygon
conversion, every output bitwise (host f64 numpy in both packages)."""

import json

import numpy as np
import pytest

from aosx import geo as jgeo
from aosx_torch import geo


def _same(a, b):
    a, b = np.asarray(a), np.asarray(b)
    assert a.dtype == b.dtype and a.shape == b.shape and np.array_equal(a, b, equal_nan=True)


@pytest.mark.parametrize("lat,lon,zone", [(36.0, 129.0, 52), (10.0, 129.0, 52),
                                          (36.111, 129.0, 52), (52.0, 129.0, 52),
                                          (36.0, 129.01, 52), (-33.9, 151.2, None),
                                          (40.7, -73.5, 0)])
def test_utm_forward_matches_jax(lat, lon, zone):
    for a, b in zip(geo.utm_forward(lat, lon, zone), jgeo.utm_forward(lat, lon, zone)):
        _same(a, b)
    lats = np.linspace(lat - 0.5, lat + 0.5, 101)
    lons = np.linspace(lon - 0.5, lon + 0.5, 101)
    for a, b in zip(geo.utm_forward(lats, lons, zone), jgeo.utm_forward(lats, lons, zone)):
        _same(a, b)


def test_zone_transform_and_helpers_match_jax():
    for lon in (128.64, -73.5, 0.0, 179.9, -180.0):
        assert geo.utm_zone_of(lon) == jgeo.utm_zone_of(lon)
    utm0, utm1 = (450000.0, 3990000.0), (450007.0, 3990003.0)
    ref = geo.Transform2D(123.4, -56.7, 0.7)
    b0, b1 = ref.apply(*utm0), ref.apply(*utm1)
    assert b0 == jgeo.Transform2D(123.4, -56.7, 0.7).apply(*utm0)
    t = geo.compute_initial_transform(b0, utm0, b1, utm1)
    jt = jgeo.compute_initial_transform(b0, utm0, b1, utm1)
    assert (t.tx, t.ty, t.theta) == (jt.tx, jt.ty, jt.theta)
    assert geo.apply_gps_offset(-0.65, 0.55, 0.3) == jgeo.apply_gps_offset(-0.65, 0.55, 0.3)
    assert geo.quat_yaw(0.0, 0.0, 0.3, 0.95) == jgeo.quat_yaw(0.0, 0.0, 0.3, 0.95)


def test_aligner_and_polygon_match_jax(tmp_path):
    lat0, lon0 = 36.1115, 128.6421
    truth = jgeo.Transform2D(-445000.0, -3990000.0, 0.0)
    aligners = [m.GpsAligner(zone=52, gps_offset=(0.0, 0.0)) for m in (geo, jgeo)]
    for i, t in enumerate(np.linspace(0, 10, 11)):
        lat, lon = lat0, lon0 + i * 6.5e-5
        x, y, _ = jgeo.utm_forward(lat, lon, 52)
        bx, by = truth.apply(float(x), float(y))
        done = [al.on_gps(lat, lon, t) or al.on_odom(bx, by, (0, 0, 0, 1), t) for al in aligners]
        assert done[0] == done[1]
    al, jal = aligners
    assert al.transform is not None
    assert (al.transform.tx, al.transform.ty, al.transform.theta) == \
        (jal.transform.tx, jal.transform.ty, jal.transform.theta)
    lats, lons = [lat0, np.nan, 91.0, lat0 + 4e-5], [lon0, lon0, lon0, lon0 + 6e-5]
    for a, b in zip(al.gps_to_base(lons, lats), jal.gps_to_base(lons, lats)):
        _same(a, b)
    doc = {"points": [{"latitude": lat0, "longitude": lon0},
                      {"latitude": lat0 + 4e-5, "longitude": lon0},
                      {"latitude": lat0 + 4e-5, "longitude": lon0 + 6e-5},
                      {"longitude": lon0}]}
    p = tmp_path / "gps_polygon.json"
    p.write_text(json.dumps(doc))
    poly = geo.convert_gps_polygon(str(p), al)
    _same(poly, jgeo.convert_gps_polygon(str(p), jal))
    assert poly.shape == (3, 2) and 4.0 < np.linalg.norm(poly[1] - poly[0]) < 5.0
