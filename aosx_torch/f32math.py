"""XLA:CPU's f32 transcendentals, bit for bit, where the port must draw
the JAX package's numbers (``prng.erfinv_uniform`` and ``orchards.make_orchard``).

Read from what XLA:CPU emits for the reference (its LLVM IR, and the libm
symbols its object code calls):

- ``log_f32``: XLA's vectorised f32 log, a Cephes-style polynomial on the
  mantissa in [sqrt(1/2), sqrt(2)), with the multiply-adds LLVM contracts;
- ``log1p_f32``: XLA's log1p, a Cephes rational function below sqrt(2) - 1
  and log(1 + x) above;
- ``erfinv_f32``: the chlo.erf_inv decomposition (Giles' single-precision
  polynomial on -log1p(-x^2)), its Horner steps fused;
- ``sin_f32``, ``cos_f32``: glibc's sinf and cosf (XLA:CPU calls them), which
  evaluate in f64 after a reduction by pi/2 and round once; |x| < 120 only.

Each is held against ``jax`` on millions of inputs by
tests/test_torch_orchards.py. The f64 steps that glibc's FMA build fuses are
left unfused here except in the reduction (kept exact as a double-double):
elsewhere a fused step moves the f64 result by an ulp, which reaches the f32
result about once in 2^29.
"""

from __future__ import annotations

import numpy as np
import torch

from .ops import fma, sqrt

# XLA:CPU's f32 log: a Cephes-style polynomial on the mantissa in
# [sqrt(1/2), sqrt(2)), evaluated with the multiply-adds LLVM contracts
_LOG_P = tuple(np.float32(v) for v in (
    7.0376836292e-2, -1.1514610310e-1, 1.1676998740e-1, -1.2420140846e-1, 1.4249322787e-1,
    -1.6668057665e-1, 2.0000714765e-1, -2.4999993993e-1, 3.3333331174e-1))
_LOG_Q1, _LOG_Q2 = np.float32(-2.12194440e-4), np.float32(0.693359375)
# XLA's log1p below sqrt(2) - 1: a Cephes rational function of x
_LOG1P_NUM = tuple(np.float32(v) for v in (
    4.5270000862445199635215e-5, 4.9854102823193375972212e-1, 6.5787325942061044846969e0,
    2.9911919328553073277375e1, 6.0949667980987787057556e1, 5.7112963590585538103336e1,
    2.0039553499201281259648e1))
_LOG1P_DEN = tuple(np.float32(v) for v in (
    1.0, 1.5062909083469192043167e1, 8.3047565967967209469434e1, 2.2176239823732856465394e2,
    3.0909872225312059774938e2, 2.1642788614495947685003e2, 6.0118660497603843919306e1))
# Giles' single-precision erfinv (the chlo.erf_inv decomposition), w < 5 and else
_ERFINV_SMALL = tuple(np.float32(v) for v in (
    2.81022636e-08, 3.43273939e-07, -3.5233877e-06, -4.39150654e-06, 0.00021858087,
    -0.00125372503, -0.00417768164, 0.246640727, 1.50140941))
_ERFINV_LARGE = tuple(np.float32(v) for v in (
    -0.000200214257, 0.000100950558, 0.00134934322, -0.00367342844, 0.00573950773,
    -0.0076224613, 0.00943887047, 1.00167406, 2.83297682))


def _c(v, like):
    return torch.full_like(like, float(v))


def _horner(x, coeffs):
    """coeffs[0] * x^(n-1) + ... + coeffs[-1], one FMA a step."""
    r = _c(coeffs[0], x)
    for c in coeffs[1:]:
        r = fma(r, x, _c(c, x))
    return r


def log_f32(x):
    """XLA:CPU's f32 natural log, bit for bit, for finite x > 0."""
    x = torch.clamp(x, min=np.float32(1.17549435e-38))
    bits = x.view(torch.int32)
    e = ((bits >> 23) - 0x7F).to(torch.float32) + 1.0
    m = ((bits & ~0x7F800000) | 0x3F000000).view(torch.float32)
    low = m < np.float32(0.707106781186547524)
    e = e - low.to(torch.float32)
    m = (m - 1.0) + torch.where(low, m, torch.zeros_like(m))
    m2 = m * m
    m3 = m2 * m
    y = _horner(m, _LOG_P[0:3])
    y = fma(y, m3, _horner(m, _LOG_P[3:6]))
    y = fma(y, m3, _horner(m, _LOG_P[6:9]))
    y = fma(y, m3, _LOG_Q1 * e)
    m = fma(m2, _c(-0.5, m), m) + y
    return fma(_c(_LOG_Q2, e), e, m)


def log1p_f32(x):
    """XLA:CPU's f32 log1p, bit for bit, for finite x > -1: a rational
    function below sqrt(2) - 1 in magnitude, log(1 + x) above."""
    x2 = x * x
    r = _horner(x, _LOG1P_NUM) / _horner(x, _LOG1P_DEN)
    near = x + ((np.float32(-0.5) * x2) + (x * x2) * r)
    return torch.where(x.abs() < np.float32(0.41421356237309504880), near, log_f32(x + 1.0))


def erfinv_f32(u):
    """XLA:CPU's f32 erfinv (``lax.erf_inv``), bit for bit, for |u| < 1."""
    w = -log1p_f32(u * -u)
    lt = w < 5.0
    w = torch.where(lt, w - 2.5, sqrt(w) - 3.0)
    p = torch.where(lt, _c(_ERFINV_SMALL[0], w), _c(_ERFINV_LARGE[0], w))
    for a, b in zip(_ERFINV_SMALL[1:], _ERFINV_LARGE[1:]):
        p = fma(p, w, torch.where(lt, _c(a, w), _c(b, w)))
    return p * u


# glibc's __sincosf_table: 2/pi scaled by 2^24, pi/2, the cosine
# polynomial (negated in the second table) and the sine polynomial
_HPI_INV = float.fromhex("0x1.45F306DC9C883p+23")
_HPI = float.fromhex("0x1.921FB54442D18p0")
_COS = tuple(float.fromhex(v) for v in ("0x1p0", "-0x1.ffffffd0c621cp-2", "0x1.55553e1068f19p-5",
                                        "-0x1.6c087e89a359dp-10", "0x1.99343027bf8c3p-16"))
_SIN = tuple(float.fromhex(v) for v in ("-0x1.555545995a603p-3", "0x1.1107605230bc4p-7",
                                        "-0x1.994eb3774cf24p-13"))
# the top 12 bits of |x|'s f32 encoding at which glibc switches branches
_TOP12_PIO4, _TOP12_TINY, _TOP12_120 = 0x3F4, 0x398, 0x42F


def _sinf_poly(x, x2, neg_cos, want_cos):
    """glibc's sinf_poly in f64: the sine or (where ``want_cos``) the cosine
    polynomial, the cosine's coefficients negated where ``neg_cos``."""
    x3 = x * x2
    sin = (x + x3 * _SIN[0]) + (x3 * x2) * (_SIN[1] + x2 * _SIN[2])
    sgn = torch.where(neg_cos, -1.0, 1.0).to(torch.float64)
    x4 = x2 * x2
    c1 = sgn * _COS[0] + x2 * (sgn * _COS[1])
    c2 = sgn * _COS[3] + x2 * (sgn * _COS[4])
    cos = (c1 + x4 * (sgn * _COS[2])) + (x4 * x2) * c2
    return torch.where(want_cos, cos, sin)


def _two_split(a):
    t = 134217729.0 * a
    hi = t - (t - a)
    return hi, a - hi


def _sincos_f32(y, cosine: bool):
    top = (y.view(torch.int32) >> 20) & 0x7FF
    if bool((top >= _TOP12_120).any()):
        raise ValueError("sin_f32/cos_f32 cover |x| < 120 only")
    x = y.double()
    # the reduction x - n * pi/2, the product's error kept, as glibc's FMA
    n = ((x * _HPI_INV).to(torch.int32) + 0x800000) >> 24
    nd = n.to(torch.float64)
    p = nd * _HPI
    nh, nl = _two_split(nd)
    hh, hl = _two_split(torch.full_like(nd, _HPI))
    err = ((nh * hh - p) + nh * hl + nl * hh) + nl * hl
    s = x - p
    b = s - x
    r = s + (((x - (s - b)) + (-p - b)) - err)
    sign = torch.tensor([1.0, -1.0, -1.0, 1.0], dtype=torch.float64, device=y.device)[(n & 3).long()]
    odd = (n & 1) == 1
    big = _sinf_poly(r * sign, r * r, (n & 2) != 0, ~odd if cosine else odd)
    false = torch.zeros_like(odd)
    small = _sinf_poly(x, x * x, false, ~false if cosine else false)
    tiny = torch.ones_like(x) if cosine else x
    out = torch.where(top < _TOP12_PIO4, torch.where(top < _TOP12_TINY, tiny, small), big)
    return out.float()


def sin_f32(x):
    """glibc's sinf (what XLA:CPU calls for an f32 sine), for |x| < 120."""
    return _sincos_f32(x, False)


def cos_f32(x):
    """glibc's cosf (what XLA:CPU calls for an f32 cosine), for |x| < 120."""
    return _sincos_f32(x, True)
