"""E(3)-equivariant building blocks of the port: real spherical harmonics,
Wigner-D rotations, real Clebsch-Gordan tensors and the radial bases
(PyTorch port of ``src/repro/models/equivariant.py``).

The constants are derived numerically with numpy, as in the reference,
from one polynomial real-SH construction: ``j_matrix`` (the Wigner-D of a
rotation by -pi/2 about x, solved by least squares from SH values) and
``real_cg`` (the null space of the equivariance constraints under a few
random rotations).  This module keeps its own copy of those derivations;
its numbers equal the reference's.  The runtime functions (``sh``,
``wigner_d_align``, the bases) take and return torch tensors; the models
turn each constant into a tensor on their device once, at construction.

Not carried over: the complex-basis Clebsch-Gordan route
(``_complex_to_real``, ``_complex_sh``, ``_cg_complex``), which no model
uses.
"""
from __future__ import annotations

import math
from functools import lru_cache

import numpy as np
import torch


# --------------------------------------------------------------- SH values


def _dfact(n: int) -> int:
    return 1 if n <= 0 else n * _dfact(n - 2)


def _sh_values(xp, vecs, l_max: int):
    """Real orthonormal SH of unit vectors (..., 3) -> (..., (l_max+1)^2),
    per l the layout [m = -l..-1, 0, 1..l].  ``xp`` is numpy or torch: the
    same code serves the constants and the runtime."""
    x, y, z = vecs[..., 0], vecs[..., 1], vecs[..., 2]
    # azimuthal polynomials A_m = Re((x+iy)^m), B_m = Im((x+iy)^m)
    a = [xp.ones_like(x)]
    b = [xp.zeros_like(x)]
    for m in range(1, l_max + 1):
        a.append(x * a[m - 1] - y * b[m - 1])
        b.append(x * b[m - 1] + y * a[m - 1])
    # sectoral-free associated Legendre Q_l^m (no (1-z^2)^{m/2}, no CS phase)
    q = {}
    for m in range(0, l_max + 1):
        q[(m, m)] = xp.full_like(z, float(_dfact(2 * m - 1)))
        if m + 1 <= l_max:
            q[(m + 1, m)] = z * (2 * m + 1) * q[(m, m)]
        for l in range(m + 2, l_max + 1):
            q[(l, m)] = ((2 * l - 1) * z * q[(l - 1, m)]
                         - (l + m - 1) * q[(l - 2, m)]) / (l - m)
    out = []
    for l in range(l_max + 1):
        comps = [None] * (2 * l + 1)
        for m in range(0, l + 1):
            k = math.sqrt((2 * l + 1) / (4 * math.pi)
                          * math.factorial(l - m) / math.factorial(l + m))
            if m == 0:
                comps[l] = k * q[(l, 0)]
            else:
                k2 = k * math.sqrt(2.0)
                comps[l + m] = k2 * q[(l, m)] * a[m]
                comps[l - m] = k2 * q[(l, m)] * b[m]
        out.extend(comps)
    return xp.stack(out, -1)


def sh(vecs, l_max: int, normalize: bool = True):
    """Real spherical harmonics of (..., 3) vectors -> (..., (l_max+1)^2)."""
    if normalize:
        norm = torch.linalg.vector_norm(vecs, dim=-1, keepdim=True)
        vecs = vecs / torch.clamp(norm, min=1e-12)
    return _sh_values(torch, vecs, l_max)


def sh_np(vecs, l_max: int, normalize: bool = True):
    vecs = np.asarray(vecs, np.float64)
    if normalize:
        vecs = vecs / np.maximum(
            np.linalg.norm(vecs, axis=-1, keepdims=True), 1e-12)
    return _sh_values(np, vecs, l_max)


def num_sh(l_max: int) -> int:
    return (l_max + 1) ** 2


def l_slices(l_max: int):
    return [(l * l, (l + 1) * (l + 1)) for l in range(l_max + 1)]


# ----------------------------------------------------- Wigner-D machinery


def _rot_x(t):
    c, s = math.cos(t), math.sin(t)
    return np.array([[1, 0, 0], [0, c, -s], [0, s, c]])


def _sh_block(vals, l):
    return vals[..., l * l: (l + 1) * (l + 1)]


@lru_cache(maxsize=None)
def j_matrix(l: int) -> np.ndarray:
    """K^l = D^l(R_x(-pi/2)), solved from SH values (orthogonal).  R_x(-pi/2)
    maps z to y, so D_y(b) = K Z(b) K^T."""
    rng = np.random.default_rng(12345)
    v = rng.normal(size=(max(4 * (2 * l + 1), 32), 3))
    v /= np.linalg.norm(v, axis=-1, keepdims=True)
    s = _sh_block(sh_np(v, l), l)                     # (K, 2l+1)
    sr = _sh_block(sh_np(v @ _rot_x(-math.pi / 2).T, l), l)
    # solve SR = S @ J.T  ->  SH(Rv) = J @ SH(v)
    j, *_ = np.linalg.lstsq(s, sr, rcond=None)
    j = j.T
    assert np.allclose(j @ j.T, np.eye(2 * l + 1), atol=1e-8)
    return j


@lru_cache(maxsize=None)
def z_masks(l: int):
    """Constant cos/sin placement masks: Z(t) = sum_m cos(mt) Mc[m] +
    sin(mt) Ms[m], each (l+1, 2l+1, 2l+1)."""
    d = 2 * l + 1
    mc = np.zeros((l + 1, d, d))
    ms = np.zeros((l + 1, d, d))
    mc[0, l, l] = 1.0
    for m in range(1, l + 1):
        mc[m, l - m, l - m] = 1.0
        mc[m, l + m, l + m] = 1.0
        ms[m, l - m, l + m] = 1.0
        ms[m, l + m, l - m] = -1.0
    return mc, ms


def _z_rot_np(angle: float, l: int) -> np.ndarray:
    mc, ms = z_masks(l)
    ang = angle * np.arange(l + 1)
    return (np.einsum("m,muv->uv", np.cos(ang), mc)
            + np.einsum("m,muv->uv", np.sin(ang), ms))


def _wigner_np(a: float, b: float, g: float, l: int) -> np.ndarray:
    j = j_matrix(l)
    return _z_rot_np(a, l) @ j @ _z_rot_np(b, l) @ j.T @ _z_rot_np(g, l)


class WignerConstants:
    """The per-l constants of :func:`wigner_d_align` (J and the z-rotation
    masks) as float32 tensors on one device, made once per model."""

    def __init__(self, l_max: int, device):
        self.j, self.mc, self.ms, self.m = [], [], [], []
        for l in range(l_max + 1):
            mc, ms = z_masks(l)
            f32 = dict(dtype=torch.float32, device=device)
            self.j.append(torch.as_tensor(j_matrix(l), **f32))
            self.mc.append(torch.as_tensor(mc, **f32))
            self.ms.append(torch.as_tensor(ms, **f32))
            self.m.append(torch.arange(l + 1, **f32))


def z_rot_block(consts: WignerConstants, angle, l: int):
    """Z^l(t): analytic z-rotation in the real basis, (...,) -> (..., 2l+1,
    2l+1).  The pair (-m, +m) mixes as [[cos, sin], [-sin, cos]]."""
    ang = angle[..., None] * consts.m[l]
    return (torch.einsum("...m,muv->...uv", torch.cos(ang), consts.mc[l])
            + torch.einsum("...m,muv->...uv", torch.sin(ang), consts.ms[l]))


def wigner_d(consts: WignerConstants, angles, l: int):
    """D^l(a, b, g) = Z(a) J Z(b) J^T Z(g) for R = R_z(a) R_y(b) R_z(g);
    satisfies SH(R v) = D(R) @ SH(v)."""
    a, b, g = angles
    j = consts.j[l]
    za = z_rot_block(consts, a, l)
    zb = z_rot_block(consts, b, l)
    zg = z_rot_block(consts, g, l)
    return za @ (j @ (zb @ (j.T @ zg)))


def edge_align_angles(vecs):
    """(a, b) of the edge direction: R_z(a) R_y(b) z = v / |v|."""
    n = torch.linalg.vector_norm(vecs, dim=-1, keepdim=True)
    u = vecs / torch.clamp(n, min=1e-12)
    beta = torch.arccos(torch.clamp(u[..., 2], -1.0, 1.0))
    alpha = torch.arctan2(u[..., 1], u[..., 0])
    return alpha, beta


def wigner_d_align(consts: WignerConstants, vecs, l: int,
                   inverse: bool = False):
    """D mapping SH(v / |v|) into the z-aligned frame (inverse=False), or
    back."""
    alpha, beta = edge_align_angles(vecs)
    zero = torch.zeros_like(alpha)
    if inverse:
        return wigner_d(consts, (alpha, beta, zero), l)
    return wigner_d(consts, (zero, -beta, -alpha), l)


# ----------------------------------------------------------- Clebsch-Gordan


@lru_cache(maxsize=None)
def real_cg(l1: int, l2: int, l3: int) -> np.ndarray:
    """Real-basis CG tensor W: (2l1+1, 2l2+1, 2l3+1), the intertwiner
    l1 x l2 -> l3 for this real SH basis, solved as the null space of
    sum_uv W_uvw D1_ua D2_vb = sum_c D3_wc W_abc over three random
    rotations; normalised to |W|_F = 1, largest entry positive; zeros if
    the triple violates the triangle inequality."""
    d1, d2, d3 = 2 * l1 + 1, 2 * l2 + 1, 2 * l3 + 1
    if l3 < abs(l1 - l2) or l3 > l1 + l2:
        return np.zeros((d1, d2, d3))
    rng = np.random.default_rng(999)
    rows = []
    eye1, eye2, eye3 = np.eye(d1), np.eye(d2), np.eye(d3)
    for _ in range(3):
        a, b, g = rng.uniform(-math.pi, math.pi, 3)
        dm = {l: _wigner_np(a, b, g, l) for l in {l1, l2, l3}}
        m1 = np.einsum("ua,vb,wx->abwuvx", dm[l1], dm[l2], eye3)
        m2 = np.einsum("ua,vb,wx->abwuvx", eye1, eye2, dm[l3])
        rows.append((m1 - m2).reshape(d1 * d2 * d3, d1 * d2 * d3))
    mat = np.concatenate(rows, axis=0)
    _, s, vt = np.linalg.svd(mat)
    null = vt[-1]
    assert s[-1] < 1e-8 and (len(s) < 2 or s[-2] > 1e-4), \
        (l1, l2, l3, s[-3:])
    w = null.reshape(d1, d2, d3)
    idx = np.unravel_index(np.argmax(np.abs(w)), w.shape)
    if w[idx] < 0:
        w = -w
    return w


# ------------------------------------------------------------ radial bases


def poly_cutoff(r, cutoff: float, p: int = 6):
    x = torch.clamp(r / cutoff, 0.0, 1.0)
    return (1.0 - ((p + 1) * (p + 2) / 2) * x ** p
            + p * (p + 2) * x ** (p + 1)
            - (p * (p + 1) / 2) * x ** (p + 2))


def bessel_basis(r, n_rbf: int, cutoff: float):
    """Sinc-like Bessel radial basis with the smooth polynomial cutoff
    (MACE, EquiformerV2)."""
    r = torch.clamp(r, min=1e-9)
    n = torch.arange(1, n_rbf + 1, dtype=torch.float32, device=r.device)
    rb = math.sqrt(2.0 / cutoff) * torch.sin(
        n * math.pi * r[..., None] / cutoff) / r[..., None]
    return rb * poly_cutoff(r, cutoff)[..., None]


def gaussian_basis(r, n_rbf: int, cutoff: float):
    """SchNet's Gaussian RBF grid on [0, cutoff]."""
    centers = torch.linspace(0.0, cutoff, n_rbf, dtype=torch.float32,
                             device=r.device)
    gamma = 1.0 / (centers[1] - centers[0]) ** 2
    return torch.exp(-gamma * (r[..., None] - centers) ** 2)
