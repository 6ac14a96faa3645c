"""Problem library: remap mesh velocities and initial conditions.

The port's copy of `remhos_tpu.problems` for the remap problems (10-17):
vectorized torch versions of the reference's velocity_function
(remhos.cpp:2001-2120) and u0_function (remhos.cpp:2201-2355). Functions map
points x[..., dim] -> values and broadcast over leading axes; they compute in
the dtype and on the device of `x`.
"""

from __future__ import annotations

import math

import torch


def exec_mode_of(problem: int) -> int:
    """problem < 10 -> transport (0), 10 <= problem < 20 -> remap (1)."""
    if problem < 10:
        return 0
    if problem < 20:
        return 1
    raise ValueError("Unspecified execution mode.")


def _ref_coords(x, bb_min, bb_max):
    """Physical coordinates -> the reference [-1, 1] box."""
    lo = torch.as_tensor(bb_min, dtype=x.dtype, device=x.device)
    hi = torch.as_tensor(bb_max, dtype=x.dtype, device=x.device)
    center = 0.5 * (lo + hi)
    return 2.0 * (x - center) / (hi - lo)


def velocity_function(problem: int, x, bb_min, bb_max):
    """Remap mesh velocity v[..., dim] at points x[..., dim]."""
    dim = x.shape[-1]
    pe = problem % 20
    if pe == 11:
        # Gresho deformation
        r = torch.sqrt(x[..., 0] ** 2 + x[..., 1] ** 2)
        zero = torch.zeros_like(r)
        v0 = torch.where(r < 0.2, 5.0 * x[..., 1],
                         torch.where(r < 0.4,
                                     2.0 * x[..., 1] / r - 5.0 * x[..., 1],
                                     zero))
        v1 = torch.where(r < 0.2, -5.0 * x[..., 0],
                         torch.where(r < 0.4,
                                     -2.0 * x[..., 0] / r + 5.0 * x[..., 0],
                                     zero))
        comps = [v0, v1] + ([zero] if dim == 3 else [])
        return torch.stack(comps, dim=-1)
    if pe in (10, 12, 13, 14, 15, 16, 17):
        # Taylor-Green deformation
        Y = _ref_coords(x, bb_min, bb_max) * 0.5 + 0.5
        v0 = torch.sin(math.pi * Y[..., 0]) * torch.cos(math.pi * Y[..., 1])
        v1 = -torch.cos(math.pi * Y[..., 0]) * torch.sin(math.pi * Y[..., 1])
        if dim == 3:
            cz = torch.cos(math.pi * Y[..., 2])
            return torch.stack([v0 * cz, v1 * cz, torch.zeros_like(v0)],
                               dim=-1)
        return torch.stack([v0, v1], dim=-1)
    raise NotImplementedError(
        f"remhos_torch has remap velocities for problems 10-17 only, got "
        f"{problem} (ROADMAP.md Queue 1, item 9)")


def _ind(cond, like):
    return cond.to(like.dtype)


def _box2d(p1, p2, theta, origin, x, y):
    s, c = math.sin(theta * math.pi / 180), math.cos(theta * math.pi / 180)
    ox, oy = origin
    xn = c * (x - ox) - s * (y - oy) + ox
    yn = s * (x - ox) + c * (y - oy) + oy
    return _ind((xn > p1[0]) & (xn < p2[0]) & (yn > p1[1]) & (yn < p2[1]), x)


def _box3d(xmin, xmax, ymin, ymax, zmin, zmax, theta, ox, oy, x, y, z):
    s, c = math.sin(theta * math.pi / 180), math.cos(theta * math.pi / 180)
    xn = c * (x - ox) - s * (y - oy) + ox
    yn = s * (x - ox) + c * (y - oy) + oy
    return _ind((xn > xmin) & (xn < xmax) & (yn > ymin) & (yn < ymax)
                & (z > zmin) & (z < zmax), x)


def _cross(r1, r2):
    return r1 + r2 - r1 * r2


def _ring(rin, rout, c, y):
    ct = torch.as_tensor(c, dtype=y.dtype, device=y.device)
    r = torch.sqrt(((y - ct) ** 2).sum(-1))
    return _ind((r > rin) & (r < rout), y)


def u0_function(problem: int, x, bb_min, bb_max):
    """Initial condition at points x[..., dim] (remhos.cpp:2201-2355)."""
    dim = x.shape[-1]
    X = _ref_coords(x, bb_min, bb_max)
    pe = problem % 10
    if pe in (0, 1):
        rx, ry, cx, cy, w = 0.45, 0.25, 0.0, -0.2, 10.0
        if dim == 3:
            s = 1.0 + 0.25 * torch.cos(2 * math.pi * X[..., 2])
            rx, ry = rx * s, ry * s
        erfc = torch.special.erfc
        return (erfc(w * (X[..., 0] - cx - rx))
                * erfc(-w * (X[..., 0] - cx + rx))
                * erfc(w * (X[..., 1] - cy - ry))
                * erfc(-w * (X[..., 1] - cy + ry))) / 16.0
    if pe == 2:
        rho = torch.hypot(X[..., 0], X[..., 1])
        phi = torch.atan2(X[..., 1], X[..., 0])
        return torch.sin(math.pi * rho) ** 2 * torch.sin(3 * phi)
    if pe == 3:
        return 0.5 * (torch.sin(math.pi * X[..., 0])
                      * torch.sin(math.pi * X[..., 1]) + 1.)
    if pe == 4:
        # Zalesak: slotted cylinder, cone, hump
        scale = 0.0225
        coef = 0.5 / math.sqrt(scale)
        slit = ((X[..., 0] <= -0.05) | (X[..., 0] >= 0.05)
                | (X[..., 1] >= 0.7))
        cone = coef * torch.sqrt(X[..., 0] ** 2 + (X[..., 1] + 0.5) ** 2)
        hump = coef * torch.sqrt((X[..., 0] + 0.5) ** 2 + X[..., 1] ** 2)
        cyl = _ind(slit & (X[..., 0] ** 2 + (X[..., 1] - 0.5) ** 2
                           <= 4 * scale), X)
        con = (1.0 - cone) * _ind(X[..., 0] ** 2 + (X[..., 1] + 0.5) ** 2
                                  <= 4 * scale, X)
        hmp = 0.25 * (1.0 + torch.cos(math.pi * hump)) * _ind(
            (X[..., 0] + 0.5) ** 2 + X[..., 1] ** 2 <= 4 * scale, X)
        return cyl + con + hmp
    if pe == 5:
        # balls and jacks
        y = 50.0 * (x + 1.0)
        if dim == 2:
            r1 = _box2d((14., 3.), (17., 26.), -45., (15.5, 11.5),
                        y[..., 0], y[..., 1])
            r2 = _box2d((7., 10.), (32., 13.), -45., (15.5, 11.5),
                        y[..., 0], y[..., 1])
            return (_cross(r1, r2) + _ring(7., 10., [40., 40.], y)
                    + _ring(3., 7., [40., 20.], y))
        yx, yy, yz = y[..., 0], y[..., 1], y[..., 2]
        r1 = _box3d(7., 32., 10., 13., 10., 13., -45., 15.5, 11.5, yx, yy, yz)
        r2 = _box3d(14., 17., 3., 26., 10., 13., -45., 15.5, 11.5, yx, yy, yz)
        r3 = _box3d(14., 17., 10., 13., 3., 26., -45., 15.5, 11.5, yx, yy, yz)
        cross = _cross(_cross(r1, r2), r3)
        c1, c2 = [40., 40., 40.], [40., 20., 20.]
        dom2 = cross + _ring(7., 10., c1, y) + _ring(3., 7., c2, y)
        r1 = _box3d(2., 27., 30., 33., 30., 33., 0., 0., 0., yx, yy, yz)
        r2 = _box3d(9., 12., 23., 46., 30., 33., 0., 0., 0., yx, yy, yz)
        r3 = _box3d(9., 12., 30., 33., 23., 46., 0., 0., 0., yx, yy, yz)
        cross = _cross(_cross(r1, r2), r3)
        dom3 = (cross + _ring(0., 7., c1, y) + _ring(0., 3., c2, y)
                + _ring(7., 10., c2, y))
        dom1 = 1.0 - _cross(dom2, dom3)
        return dom1 + 2.0 * dom2 + 3.0 * dom3
    if pe == 6:
        r = torch.linalg.norm(x, dim=-1)
        return torch.where(
            (r >= 0.15) & (r < 0.45), torch.ones_like(r),
            torch.where((r >= 0.55) & (r < 0.85),
                        torch.cos(10. * math.pi * (r - 0.7) / 3.) ** 2,
                        torch.zeros_like(r)))
    if pe == 7:
        r = torch.linalg.norm(x, dim=-1)
        a, b, c = 0.5, 3.e-2, 0.1
        return 0.25 * (1. + torch.tanh((r + c - a) / b)) * \
            (1. - torch.tanh((r - c - a) / b))
    return torch.zeros(x.shape[:-1], dtype=x.dtype, device=x.device)


def s0_function(x):
    """Product-field ratio initial condition (remhos.cpp:2357-2361)."""
    return 2.0 + torch.sin(2 * math.pi * x[..., 0]) * torch.sin(
        2 * math.pi * x[..., 1])
