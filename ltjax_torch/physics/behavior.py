"""Larval behavior and mortality (counterpart of
``ltjax.physics.behavior``), types 0-7.

  0 passive
  1 near-surface orientation: biased walk toward SURFACE_ZONE below zeta
  2 near-bottom orientation: biased walk toward BOTTOM_ZONE above -h
  3 diel vertical migration driven by modeled surface irradiance
  4 Crassostrea virginica oyster larva: a veliger swims up on the
    halocline cue |dS/dz| >= Sgradient and walks randomly without it; a
    pediveliger (age >= pediage) swims down
  5 C. ariakensis: as 4, but a young larva without the cue still swims
    half up, half at random
  6 constant sinking
  7 tidal-stream transport (rides the current at Swimdepth when it runs
    faster than TST_MIN_SPEED, else holds near the bottom)

Swimming types use the ontogenetic swim-speed ramp swimslow -> swimfast
over [swimstart, pediage] and the biased-random-walk idiom: toward the
preferred zone with probability P_BIAS (BEHAVE substream), a mixing walk
r_mix * w_swim * idt otherwise (MORTALITY substream).  Mortality is
deterministic death at age >= deadage, or (``stochastic``) random death
at the constant hazard 1/deadage: a released particle dies in a step with
probability 1 - exp(-idt/deadage) on its own DEATH draw, bit-equal to
ltjax's.

The cue of types 4/5 is the derivative of the tension spline fitted to
the salt profile at the particle (``_salt_gradient``).
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

from .. import rng, tension
from .advect import scalar_profile

P_BIAS = 0.8          # probability of swimming toward the preferred zone
SURFACE_ZONE = 2.0    # [m] preferred band below surface for type 1
BOTTOM_ZONE = 2.0     # [m] preferred band above bottom for type 2
TST_MIN_SPEED = 0.05  # [m/s] current speed that triggers tide-riding

PORTED_TYPES = (0, 1, 2, 3, 4, 5, 6, 7)


class BehaveParams(NamedTuple):
    behavior: int = 0
    mortality: bool = False
    deadage: float = 1e30
    pediage: float = 0.0
    swimstart: float = 0.0
    swimslow: float = 0.0
    swimfast: float = 0.0
    Sgradient: float = 1.0
    sink: float = 0.0
    Hswimspeed: float = 0.0
    Swimdepth: float = 2.0
    # dvmparam group
    twistart: float = 4.801821
    twiend: float = 19.19956
    Em: float = 1935.077
    Kp: float = 0.4
    thresh: float = 0.0166
    idt: float = 120.0
    sigma: float = 0.0
    stochastic: bool = False


def check_ported(p: BehaveParams) -> None:
    """Raise ValueError for a behavior type outside 0..7."""
    if p.behavior not in PORTED_TYPES:
        raise ValueError(f"Behavior={p.behavior}: types are 0..7")


def swim_speed(age, p: BehaveParams, dtype):
    """Ontogenetic ramp swimslow -> swimfast over [swimstart, pediage]."""
    denom = max(p.pediage - p.swimstart, 1e-30)
    frac = torch.clamp((age - p.swimstart) / denom, 0.0, 1.0).to(dtype)
    w = p.swimslow + (p.swimfast - p.swimslow) * frac
    return torch.where(age >= p.swimstart, w, torch.zeros_like(w)).to(dtype)


def surface_irradiance(t, p: BehaveParams, dtype):
    """Modeled surface light: sine arc between twistart and twiend hours
    of the day, peak Em."""
    hours = (torch.as_tensor(t, dtype=dtype) / 3600.0) % 24.0
    span = p.twiend - p.twistart
    tau = (hours - p.twistart) / span
    day = (tau > 0.0) & (tau < 1.0)
    return torch.where(day, p.Em * torch.sin(math.pi * tau),
                       torch.zeros_like(tau))


def _salt_gradient(grid, fields, x, y, z, t, sigma):
    """(dS/dz, S) at particles: the derivative and value of the tension
    spline fitted to the salt profile of the particle's column at t."""
    z_r, prof_t = scalar_profile(grid, fields, fields.salt, x, y, t)
    z2 = tension.fit(z_r, prof_t, sigma)
    return (tension.evaluate_deriv(z_r, prof_t, z2, sigma, z),
            tension.evaluate(z_r, prof_t, z2, sigma, z))


def behave(grid, fields, seed, step, pids, x, y, z, t, age, zeta_p, h_p,
           currents, p: BehaveParams):
    """Behavioral displacement (dx, dy, dz) and death mask for this step.

    zeta_p/h_p: free surface and depth at each particle; currents: (u, v)
    at the particle (used by type 7); ``fields`` carries the salt that
    types 4/5 cue on."""
    check_ported(p)
    dtype = x.dtype
    dev = x.device
    n = x.shape[0]
    idt = torch.full((), p.idt, dtype=dtype, device=dev)
    zero = torch.zeros(n, dtype=dtype, device=dev)
    dx = dy = dz = zero

    w_swim = swim_speed(age, p, dtype)
    r_dir = rng.uniform(seed, step, rng.BEHAVE, pids, (), 0.0, 1.0, dtype)
    r_mix = rng.uniform(seed, step, rng.MORTALITY, pids, (), -1.0, 1.0,
                        dtype)

    def biased_dz(target_above: bool):
        """Swim toward the preferred zone with probability P_BIAS."""
        toward = 1.0 if target_above else -1.0
        sgn = torch.where(r_dir < P_BIAS, toward, -toward).to(dtype)
        return sgn * w_swim * idt

    b = p.behavior
    if b == 1:
        below_zone = z < (zeta_p - SURFACE_ZONE)
        dz = torch.where(below_zone, biased_dz(True), r_mix * w_swim * idt)
    elif b == 2:
        above_zone = z > (-h_p + BOTTOM_ZONE)
        dz = torch.where(above_zone, biased_dz(False), r_mix * w_swim * idt)
    elif b == 3:
        e0 = surface_irradiance(t, p, dtype)
        light = e0 * torch.exp(-p.Kp * torch.clamp(zeta_p - z, min=0.0))
        # swim down out of light above threshold; otherwise swim up
        dz = torch.where(light > p.thresh, -w_swim * idt,
                         torch.where(e0 > 0.0, w_swim * idt,
                                     r_mix * w_swim * idt))
    elif b in (4, 5):
        dsdz, _ = _salt_gradient(grid, fields, x, y, z, t, p.sigma)
        cue = dsdz.abs() >= p.Sgradient
        up = biased_dz(True)
        rnd = r_mix * w_swim * idt
        veliger = torch.where(cue, up, rnd)
        dz = torch.where(age >= p.pediage, biased_dz(False), veliger)
        if b == 5:
            dz = torch.where(age < p.pediage,
                             torch.where(cue, up, up * 0.5 + rnd * 0.5), dz)
    elif b == 6:
        dz = -torch.full((), p.sink, dtype=dtype, device=dev) * idt \
            * torch.ones(n, dtype=dtype, device=dev)
    elif b == 7:
        u_c, v_c = currents
        speed = torch.sqrt(u_c * u_c + v_c * v_c)
        riding = speed > TST_MIN_SPEED
        # ride: hold at Swimdepth below the surface with Hswimspeed along
        # the current; else sit near the bottom
        target_z = torch.where(riding, zeta_p - p.Swimdepth, -h_p + 0.5)
        bound = w_swim * idt + 1.0
        dz = torch.minimum(torch.maximum(target_z - z, -w_swim * idt - 1.0),
                           bound)
        spd_safe = torch.clamp(speed, min=1e-12)
        dx = torch.where(riding, p.Hswimspeed * u_c / spd_safe * idt, zero)
        dy = torch.where(riding, p.Hswimspeed * v_c / spd_safe * idt, zero)

    dies = torch.zeros(n, dtype=torch.bool, device=dev)
    if p.mortality and p.stochastic:
        # constant hazard 1/deadage on the DEATH substream
        u = rng.uniform(seed, step, rng.DEATH, pids, (), 0.0, 1.0, dtype)
        p_die = -torch.expm1(-idt / torch.full((), p.deadage, dtype=dtype,
                                               device=dev))
        dies = (age >= 0.0) & (u < p_die)
    elif p.mortality:
        dies = age >= p.deadage
    return dx, dy, dz, dies
