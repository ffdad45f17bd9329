"""Lon/lat <-> internal metre coordinates (counterpart of
``ltjax.convert``): an equirectangular projection about (lonmin, latmin)
on a sphere of radius ``radius``, or a planar identity-scale mapping
when ``spherical`` is off.  Elementwise on host numpy arrays.
"""

from __future__ import annotations

import numpy as np


def lon2x(lon, lat, lonmin, latmin, radius=6378e3, spherical=True):
    if not spherical:
        return lon - lonmin
    d2r = np.pi / 180.0
    # cosine at the particle latitude (local scale), as in the reference
    return radius * d2r * (lon - lonmin) * np.cos(d2r * lat)


def lat2y(lat, latmin, radius=6378e3, spherical=True):
    if not spherical:
        return lat - latmin
    return radius * (np.pi / 180.0) * (lat - latmin)


def x2lon(x, y, lonmin, latmin, radius=6378e3, spherical=True):
    if not spherical:
        return x + lonmin
    d2r = np.pi / 180.0
    lat = y2lat(y, latmin, radius, spherical)
    return lonmin + x / (radius * d2r * np.cos(d2r * lat))


def y2lat(y, latmin, radius=6378e3, spherical=True):
    if not spherical:
        return y + latmin
    return latmin + y / (radius * (np.pi / 180.0))
