"""Rotated anisotropic diffusion stencils (counterpart of
``pyamg_tpu/gallery/diffusion.py``): the standard discretizations of
``-div Q A Q^T grad u`` with ``Q`` a rotation and ``A = diag(1, eps)``
(2-D) or ``diag(1, eps_y, eps_z)`` (3-D).  Host numpy."""

from __future__ import annotations

import numpy as np


def diffusion_stencil_2d(epsilon=1.0, theta=0.0, type="FE"):
    """3x3 stencil for 2-D rotated anisotropic diffusion (y varies first),
    ``type`` 'FE' (Q1 finite elements) or 'FD' (finite differences).

    Examples
    --------
    >>> from pyamg_tpu_torch.gallery import diffusion_stencil_2d
    >>> diffusion_stencil_2d(type="FD").tolist()
    [[0.0, -1.0, -0.0], [-1.0, 4.0, -1.0], [-0.0, -1.0, 0.0]]
    """
    eps = float(epsilon)
    theta = float(theta)
    C, S = np.cos(theta), np.sin(theta)
    CS, CC, SS = C * S, C * C, S * S

    if type == "FE":
        a = (-1 * eps - 1) * CC + (-1 * eps - 1) * SS + (3 * eps - 3) * CS
        b = (2 * eps - 4) * CC + (-4 * eps + 2) * SS
        c = (-1 * eps - 1) * CC + (-1 * eps - 1) * SS + (-3 * eps + 3) * CS
        d = (-4 * eps + 2) * CC + (2 * eps - 4) * SS
        e = (8 * eps + 8) * CC + (8 * eps + 8) * SS
        return np.array([[a, b, c], [d, e, d], [c, b, a]]) / 6.0
    if type == "FD":
        a = 0.5 * (eps - 1) * CS
        b = -(eps * SS + CC)
        c = -a
        d = -(eps * CC + SS)
        e = 2.0 * (eps + 1)
        return np.array([[a, b, c], [d, e, d], [c, b, a]])
    raise ValueError("only 'FE' and 'FD' supported")


def _rotation_3d(theta, phi, psi):
    """ZXZ Euler rotation matrix."""
    cth, sth = np.cos(theta), np.sin(theta)
    cphi, sphi = np.cos(phi), np.sin(phi)
    cpsi, spsi = np.cos(psi), np.sin(psi)
    Rz1 = np.array([[cpsi, -spsi, 0], [spsi, cpsi, 0], [0, 0, 1]])
    Rx = np.array([[1, 0, 0], [0, cphi, -sphi], [0, sphi, cphi]])
    Rz2 = np.array([[cth, -sth, 0], [sth, cth, 0], [0, 0, 1]])
    return Rz2 @ Rx @ Rz1


def diffusion_stencil_3d(epsilony=1.0, epsilonz=1.0, theta=0.0, phi=0.0,
                         psi=0.0, type="FD"):
    """3x3x3 finite-difference stencil for 3-D rotated anisotropic
    diffusion, ``Q`` the ZXZ Euler rotation: central differences for the
    second derivatives and the 4-point cross terms."""
    if type != "FD":
        raise ValueError("3D diffusion stencil: only 'FD' supported")
    Q = _rotation_3d(theta, phi, psi)
    K = Q @ np.diag([1.0, float(epsilony), float(epsilonz)]) @ Q.T

    st = np.zeros((3, 3, 3))
    c = 1
    # second derivatives: K[a, a] (-u_- + 2 u_0 - u_+) along axis a
    for a in range(3):
        idx_m = [c, c, c]
        idx_p = [c, c, c]
        idx_m[a] = 0
        idx_p[a] = 2
        st[tuple(idx_m)] += -K[a, a]
        st[tuple(idx_p)] += -K[a, a]
        st[c, c, c] += 2 * K[a, a]
    # mixed derivatives: -2 K[a, b] u_ab on the 4-point stencil / 4
    for a in range(3):
        for b in range(a + 1, 3):
            coef = 2.0 * K[a, b] / 4.0
            for sa, sb, sign in [(0, 0, -1), (2, 2, -1), (0, 2, 1),
                                 (2, 0, 1)]:
                idx = [c, c, c]
                idx[a], idx[b] = sa, sb
                st[tuple(idx)] += sign * coef
    return st
