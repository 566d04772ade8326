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
  evaluate in f64 after a reduction by pi/2 and round once; |x| < 120 only;
- ``atan2_f32``: glibc's atan2f (XLA:CPU lowers an f32 atan2 to a call to
  it), the fdlibm single-precision algorithm in f32 arithmetic, which is
  not correctly rounded (1 ulp off on about 16 % of normal pairs).

Each is held against ``jax`` on millions of inputs by
tests/test_torch_orchards.py and tests/test_torch_xla_f32.py. The f64 steps that glibc's FMA build fuses are
left unfused here except in the reduction (kept exact as a double-double):
elsewhere a fused step moves the f64 result by an ulp, which reaches the f32
result about once in 2^29.
"""

from __future__ import annotations

import numpy as np
import torch

from .ops import fma, read_any, sqrt

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


# glibc's __sincosf_table: 2/pi scaled by 2^24, pi/2 (and its Veltkamp
# split), the cosine polynomial and the sine polynomial
_HPI_INV = float.fromhex("0x1.45F306DC9C883p+23")
_HPI = float.fromhex("0x1.921FB54442D18p0")
_HPI_HI = (134217729.0 * _HPI) - ((134217729.0 * _HPI) - _HPI)
_HPI_LO = _HPI - _HPI_HI
_COS = tuple(float.fromhex(v) for v in ("0x1p0", "-0x1.ffffffd0c621cp-2", "0x1.55553e1068f19p-5",
                                        "-0x1.6c087e89a359dp-10", "0x1.99343027bf8c3p-16"))
_SIN = tuple(float.fromhex(v) for v in ("-0x1.555545995a603p-3", "0x1.1107605230bc4p-7",
                                        "-0x1.994eb3774cf24p-13"))
# |x| below which glibc returns x (sinf) and 1 (cosf); above 120 it takes
# another reduction, which the port does not carry
_SINCOS_TINY, _SINCOS_MAX = 2.0 ** -12, 120.0
_TABLES = {}


def _table(values, like, dtype=None):
    """A small constant table on ``like``'s device, made once a device."""
    key = (values, like.device, dtype)
    t = _TABLES.get(key)
    if t is None:
        t = _TABLES[key] = torch.tensor(values, dtype=dtype or like.dtype, device=like.device)
    return t


def _lookup(values, idx, like):
    """values[idx] for an index tensor of any shape, 0-d included, with no
    host read (``torch.take``)."""
    return torch.take(_table(values, like), idx)


def sincos_f32(y, check: bool = True):
    """(glibc's sinf(y), cosf(y)) for f32 y, |y| < 120: what XLA:CPU calls
    for an f32 sine and cosine, bit for bit. In f64 as glibc evaluates:
    the reduction y - n pi/2 with the product's rounding error kept (glibc's
    FMA build), then the sine and the cosine polynomial of the reduced
    argument, one of them each output's by the parity of n, the cosine's
    coefficients negated where n & 2 (exactly a negation of its value).
    Below pi/4 glibc's own branch is this one with n = 0; below 2^-12 sinf
    returns y and cosf 1. ``check`` raises (a host read) on |y| >= 120: a
    caller whose domain is bounded by construction passes False and says
    why."""
    if check and read_any(y.abs() >= _SINCOS_MAX, "sincos_check"):
        raise ValueError("sin_f32/cos_f32 cover |x| < 120 only")
    x = y.double()
    n = ((x * _HPI_INV).to(torch.int64) + 0x800000) >> 24      # |x * 2^24 / (pi / 2)| < 2^31
    nd = n.double()         # |n| <= 77: its Veltkamp split is (nd, 0)
    p = nd * _HPI
    err = (nd * _HPI_HI - p) + nd * _HPI_LO
    s = x - p
    b = s - x
    r = s + (((x - (s - b)) + (-p - b)) - err)
    xs = r * _lookup((1.0, -1.0, -1.0, 1.0), n & 3, r)
    x2 = r * r
    x3 = xs * x2
    sin = (xs + x3 * _SIN[0]) + (x3 * x2) * (_SIN[1] + x2 * _SIN[2])
    x4 = x2 * x2
    cos = ((_COS[0] + x2 * _COS[1]) + x4 * _COS[2]) + (x4 * x2) * (_COS[3] + x2 * _COS[4])
    cos = cos * (1 - (n & 2))
    odd = (n & 1) == 1
    tiny = y.abs() < _SINCOS_TINY
    return (torch.where(tiny, y, torch.where(odd, cos, sin).float()),
            torch.where(tiny, 1.0, torch.where(odd, sin, cos).float()))


def sin_f32(x, check: bool = True):
    """glibc's sinf (what XLA:CPU calls for an f32 sine), for |x| < 120
    (``sincos_f32``)."""
    return sincos_f32(x, check)[0]


def cos_f32(x, check: bool = True):
    """glibc's cosf (what XLA:CPU calls for an f32 cosine), for |x| < 120
    (``sincos_f32``)."""
    return sincos_f32(x, check)[1]


# glibc's (fdlibm's) atanf: the argument's reduction about 0.5, 1, 1.5 and
# infinity, t = (a x - b) / (a + b x) with (a, b) by interval (1, 0 gives x
# itself; 0, 1 gives -1/x), atan of the reduction points split in high and
# low parts (0 and 0 below 7/16, where hi - ((rs - lo) - r) is r - rs), and
# the polynomial's coefficients, the odd- and the even-indexed chain side by
# side (pairs, the even chain one step longer)
# (7/16, 11/16, 19/16, 39/16, 2^25, then NaN: intervals 5 and 6 are replaced)
_ATAN_BOUNDS = (0x3EE00000, 0x3F300000, 0x3F980000, 0x401C0000, 0x4C000000, 0x7F800001)
_ATAN_A = (1.0, 2.0, 1.0, 1.0, 0.0, 0.0, 0.0)
_ATAN_B = (0.0, 1.0, 1.0, 1.5, 1.0, 1.0, 1.0)
_ATANHI = (0.0, 4.6364760399e-01, 7.8539812565e-01, 9.8279368877e-01, 1.5707962513e+00,
           1.5707962513e+00, 1.5707962513e+00)
_ATANLO = (0.0, 5.0121582440e-09, 3.7748947079e-08, 3.4473217170e-08, 7.5497894159e-08,
           7.5497894159e-08, 7.5497894159e-08)
_AT = tuple(float(np.float32(v)) for v in (
    3.3333334327e-01, -2.0000000298e-01, 1.4285714924e-01, -1.1111110449e-01, 9.0908870101e-02,
    -7.6918758452e-02, 6.6610731184e-02, -5.8335702866e-02, 4.9768779427e-02, -3.6531571299e-02,
    1.6285819933e-02))
_AT_CHAINS = tuple((_AT[i], _AT[i - 1]) for i in (10, 8, 6, 4, 2))


def _f32(v):
    """v rounded to f32, as a Python float (the constants of f32 code)."""
    return float(np.float32(v))


_ATAN_INF = _f32(np.float32(_ATANHI[4]) + np.float32(_ATANLO[4]))
_PI_O_4, _PI_O_2 = _f32(7.8539818525e-01), _f32(1.5707963705e+00)
_PI, _PI_LO = _f32(3.1415927410e+00), _f32(-8.7422776573e-08)
_3PI_O_4 = _f32(np.float32(3.0) * np.float32(_PI_O_4))
_FLT_MIN = 2.0 ** -126
# [x class * 4 + y class][x sign bit] -> |atan2|, the classes 0 zero,
# 1 finite (subnormals included), 2 infinite, 3 NaN: y zero gives 0 or pi,
# x zero (y not) and y infinite (x finite) pi/2, x infinite 0 or pi, both
# infinite pi/4 or 3 pi/4, a NaN NaN; (finite, finite) is not special
_NAN = float("nan")
_ATAN2_SPECIAL = (
    0.0, _PI, _PI_O_2, _PI_O_2, _PI_O_2, _PI_O_2, _NAN, _NAN,            # x zero
    0.0, _PI, 0.0, 0.0, _PI_O_2, _PI_O_2, _NAN, _NAN,                     # x finite
    0.0, _PI, 0.0, _PI, _PI_O_4, _3PI_O_4, _NAN, _NAN,                    # x infinite
    _NAN, _NAN, _NAN, _NAN, _NAN, _NAN, _NAN, _NAN)                       # x NaN


def _atanf_abs(t):
    """glibc's atanf of t >= 0 (inf and NaN included), in f32 operations:
    t reduced by interval, atan(c) + atan(reduced) from the odd and even
    halves of the polynomial; from 2^25 (infinity included) pi/2; NaN
    stays NaN. (Below 2^-29 glibc returns t, which r - rs is there: rs is
    under a millionth of t's ulp.)"""
    it = t.view(torch.int32)
    k = torch.bucketize(it, _table(_ATAN_BOUNDS, it), right=True)    # interval 0..6
    a, b = _lookup(_ATAN_A, k, t), _lookup(_ATAN_B, k, t)
    r = (a * t - b) / (a + b * t)
    z = r * r
    w = z * z
    def pair(i):
        return _table(_AT_CHAINS[i], t).reshape((2,) + (1,) * t.dim())

    s = pair(0) * w + pair(1)             # [2, ...]: the odd and the even chain
    for i in (2, 3, 4):
        s = s * w + pair(i)
    rs = r * (z * (s[0] * w + _AT[0]) + w * s[1])
    hi, lo = _lookup(_ATANHI, k, t), _lookup(_ATANLO, k, t)
    return torch.where(k == 5, _ATAN_INF, hi - ((rs - lo) - r))


def atan2_f32(y, x):
    """glibc's atan2f (what XLA:CPU calls for an f32 atan2), bit for bit,
    for every pair of f32 values, signed zeros, infinities and NaN
    included: fdlibm's e_atan2f.c over ``_atanf_abs`` of |y / x| (of y
    where x is 1) and its special cases, each written as the magnitude it
    gives before y's sign. (Its overrides for |y / x| beyond 2^+-60 give the
    bits the general path gives there; they only spare glibc an underflow.)
    As under XLA:CPU (FTZ and DAZ set), the quotient reads subnormal
    operands as zeros and flushes a subnormal result, so a pair of
    subnormals gives NaN, as ``jnp.arctan2`` does."""
    hx, hy = x.view(torch.int32), y.view(torch.int32)
    ix, iy = hx & 0x7FFFFFFF, hy & 0x7FFFFFFF
    q = (y * (iy >= 0x800000)) / (x * (ix >= 0x800000))
    q = q * (q.abs() >= _FLT_MIN)
    z = _atanf_abs(torch.where(hx == 0x3F800000, y, q).abs())
    xneg = hx < 0
    mag = torch.where(xneg, _PI - (z - _PI_LO), z)
    # glibc's special cases, NaN's included, by the class of each operand and
    # x's sign: the magnitudes (a NaN is NaN, glibc's x + y)
    classes = _table((1, 0x7F800000, 0x7F800001), ix)
    code = (torch.bucketize(ix, classes, right=True) * 4
            + torch.bucketize(iy, classes, right=True))
    mag = torch.where(code != 5, _lookup(_ATAN2_SPECIAL, code * 2 + xneg, z), mag)
    return torch.copysign(mag, y)
