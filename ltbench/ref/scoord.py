"""ROMS s-coordinate depths (counterpart of ``ltjax.scoord``).

``s``/``Cs`` have shape (K,), ``zeta``/``h`` any shape B; the result is
(B..., K).  Works on tensors and numpy arrays alike.
"""

from __future__ import annotations


def s_depths(zeta, h, s, Cs, hc, vtransform: int):
    """z of s-levels (negative below surface).

    Vtransform=1:  z0 = hc*s + (h-hc)*Cs ;  z = z0 + zeta*(1 + z0/h)
    Vtransform=2:  z0 = (hc*s + h*Cs)/(hc+h) ;  z = zeta + (zeta+h)*z0
    """
    zeta = zeta[..., None]
    h = h[..., None]
    if vtransform == 1:
        z0 = hc * s + (h - hc) * Cs
        return z0 + zeta * (1.0 + z0 / h)
    if vtransform == 2:
        z0 = (hc * s + h * Cs) / (hc + h)
        return zeta + (zeta + h) * z0
    raise ValueError(f"Vtransform must be 1 or 2, got {vtransform}")
