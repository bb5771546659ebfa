"""Accurate f32 transcendentals for the f32 compute path.

A device's native f32 sin/cos/exp may be approximations whose error sits
*above* the integrator's rtol=1e-7, which causes step-rejection churn.  With
correctly rounded f32 mul/add/div/sqrt, our own Cody–Waite argument reduction
+ minimax polynomials in pure f32 give ~1-2 ulp absolute accuracy on any
device, independent of its math library.

f64 inputs pass through to jnp (the platform's f64 libm).
"""

from __future__ import annotations

import numpy as np

import jax.numpy as jnp

def _split3(v, bits=11):
    """Triple Cody–Waite split: v = hi + mid + lo with hi, mid carrying only
    `bits` significant bits each, so products with small integers are exact."""
    def trunc(x):
        if x == 0.0:
            return 0.0
        e = np.floor(np.log2(abs(x)))
        q = 2.0 ** (e - bits + 1)
        return float(np.floor(x / q) * q)

    hi = trunc(v)
    mid = trunc(v - hi)
    lo = np.float32(v - hi - mid)
    return np.float32(hi), np.float32(mid), lo


_PI_HI, _PI_MID, _PI_LO = _split3(np.pi)
_INV_PI = np.float32(1.0 / np.pi)
_LN2_HI, _LN2_MID, _LN2_LO = _split3(np.log(2.0))
_INV_LN2 = np.float32(1.4426950408889634)


def _fit_coeffs():
    """Least-squares polynomial fits on Chebyshev nodes (accuracy ~1e-9,
    far below the f32 evaluation rounding)."""
    # sin on [-pi/2, pi/2]: odd polynomial in x -> sin(x) = x * P(x^2)
    n = 2000
    x = np.pi / 2 * np.cos(np.linspace(0, np.pi, n))
    y = np.sin(x)
    # fit y/x = P(x^2) with degree-5 in x^2 (=> degree 11 odd)
    z = x**2
    A = np.vander(z, 6, increasing=True)
    sin_c = np.linalg.lstsq(A * (np.abs(x)[:, None] + 1e-3), (y / x) * (np.abs(x) + 1e-3),
                            rcond=None)[0]
    # cos on [-pi/2, pi/2]: even polynomial, cos(x) = Q(x^2)
    yc = np.cos(x)
    cos_c = np.linalg.lstsq(A, yc, rcond=None)[0]
    # exp on [-ln2/2, ln2/2]
    xe = np.log(2) / 2 * np.cos(np.linspace(0, np.pi, n))
    Ae = np.vander(xe, 8, increasing=True)
    exp_c = np.linalg.lstsq(Ae, np.exp(xe), rcond=None)[0]
    return (sin_c.astype(np.float32), cos_c.astype(np.float32),
            exp_c.astype(np.float32))


_SIN_C, _COS_C, _EXP_C = _fit_coeffs()


def _poly(c, z):
    acc = jnp.full_like(z, c[-1])
    for coef in c[-2::-1]:
        acc = acc * z + coef
    return acc


def _reduce_pi(x):
    """x = n*pi + r with r in [-pi/2, pi/2]; returns (r, n mod 2).
    Exact for |n| < 2^11 (|x| < ~6400)."""
    n = jnp.round(x * _INV_PI)
    r = ((x - n * _PI_HI) - n * _PI_MID) - n * _PI_LO
    odd = jnp.mod(n, 2.0)
    return r, odd


def _sin32(x):
    r, odd = _reduce_pi(x)
    s = r * _poly(_SIN_C, r * r)
    return jnp.where(odd > 0.5, -s, s)


def _cos32(x):
    r, odd = _reduce_pi(x)
    c = _poly(_COS_C, r * r)
    return jnp.where(odd > 0.5, -c, c)


def _exp32(x):
    n = jnp.round(x * _INV_LN2)
    r = ((x - n * _LN2_HI) - n * _LN2_MID) - n * _LN2_LO
    p = _poly(_EXP_C, r)
    # 2^n via exponent-field bit construction (n in [-126, 127])
    ni = jnp.clip(n, -126.0, 127.0).astype(jnp.int32)
    two_n = jax.lax.bitcast_convert_type(
        ((ni + 127) << 23).astype(jnp.int32), jnp.float32)
    out = p * two_n
    return jnp.where(x < -87.0, 0.0, out)


import jax  # noqa: E402  (lax used above)


def sin_p(x):
    x = jnp.asarray(x)
    if x.dtype == jnp.float32:
        return _sin32(x)
    return jnp.sin(x)


def cos_p(x):
    x = jnp.asarray(x)
    if x.dtype == jnp.float32:
        return _cos32(x)
    return jnp.cos(x)


def exp_p(x):
    x = jnp.asarray(x)
    if x.dtype == jnp.float32:
        return _exp32(x)
    return jnp.exp(x)
