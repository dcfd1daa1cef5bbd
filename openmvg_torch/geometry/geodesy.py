"""WGS84 geodetic conversions (counterpart: openmvg_tpu/geometry/geodesy.py;
geodesy/geodesy.hpp:22-46): lla_to_ecef for the init stage's GPS priors,
ecef_to_lla and lla_to_utm for geo-registration.  Host numpy."""

import numpy as np

WGS84_A = 6378137.0
WGS84_B = 6356752.314245
WGS84_E2 = 1.0 - (WGS84_B / WGS84_A) ** 2


def lla_to_ecef(lat_deg, lon_deg, alt=0.0):
    lat = np.radians(np.asarray(lat_deg, float))
    lon = np.radians(np.asarray(lon_deg, float))
    alt = np.asarray(alt, float)
    N = WGS84_A / np.sqrt(1.0 - WGS84_E2 * np.sin(lat) ** 2)
    x = (N + alt) * np.cos(lat) * np.cos(lon)
    y = (N + alt) * np.cos(lat) * np.sin(lon)
    z = (N * (1.0 - WGS84_E2) + alt) * np.sin(lat)
    return np.stack(np.broadcast_arrays(x, y, z), axis=-1)


def ecef_to_lla(xyz, n_iter=8):
    xyz = np.asarray(xyz, float)
    x, y, z = xyz[..., 0], xyz[..., 1], xyz[..., 2]
    lon = np.arctan2(y, x)
    p = np.hypot(x, y)
    lat = np.arctan2(z, p * (1.0 - WGS84_E2))
    for _ in range(n_iter):
        N = WGS84_A / np.sqrt(1.0 - WGS84_E2 * np.sin(lat) ** 2)
        alt = p / np.cos(lat) - N
        lat = np.arctan2(z, p * (1.0 - WGS84_E2 * N / (N + alt)))
    N = WGS84_A / np.sqrt(1.0 - WGS84_E2 * np.sin(lat) ** 2)
    alt = p / np.cos(lat) - N
    return np.stack([np.degrees(lat), np.degrees(lon), alt], axis=-1)


def lla_to_utm(lat_deg, lon_deg, alt=0.0):
    """Standard UTM (TM projection, k0 = 0.9996). Returns (easting,
    northing, alt, zone)."""
    lat = np.radians(float(lat_deg))
    lon = np.radians(float(lon_deg))
    zone = int((float(lon_deg) + 180) // 6) + 1
    lon0 = np.radians((zone - 1) * 6 - 180 + 3)
    k0 = 0.9996
    e2 = WGS84_E2
    ep2 = e2 / (1 - e2)
    N = WGS84_A / np.sqrt(1 - e2 * np.sin(lat) ** 2)
    T = np.tan(lat) ** 2
    C = ep2 * np.cos(lat) ** 2
    A = np.cos(lat) * (lon - lon0)
    M = WGS84_A * (
        (1 - e2 / 4 - 3 * e2**2 / 64 - 5 * e2**3 / 256) * lat
        - (3 * e2 / 8 + 3 * e2**2 / 32 + 45 * e2**3 / 1024) * np.sin(2 * lat)
        + (15 * e2**2 / 256 + 45 * e2**3 / 1024) * np.sin(4 * lat)
        - (35 * e2**3 / 3072) * np.sin(6 * lat))
    easting = k0 * N * (A + (1 - T + C) * A**3 / 6
                        + (5 - 18 * T + T**2 + 72 * C - 58 * ep2) * A**5 / 120) + 500000.0
    northing = k0 * (M + N * np.tan(lat) * (
        A**2 / 2 + (5 - T + 9 * C + 4 * C**2) * A**4 / 24
        + (61 - 58 * T + T**2 + 600 * C - 330 * ep2) * A**6 / 720))
    if lat < 0:
        northing += 10000000.0
    return easting, northing, float(alt), zone
