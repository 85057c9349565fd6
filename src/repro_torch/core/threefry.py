"""The part of ``jax.random`` the port draws with, in torch.

LSH-DDP draws its projections with ``normal`` and its offsets with
``uniform``; CFSFDP-A its k-means pivots with ``choice(replace=False)``;
DPC-KV its projection with ``normal``; the serving engine samples with
``categorical`` (the gumbel-max trick over ``gumbel``).
The same integer seed gives the same draws here as in the JAX package,
bit for bit, so the two packages' baselines partition the same points the
same way.

This follows jax 0.9.0's defaults: the ``threefry2x32`` generator with
``jax_threefry_partitionable = True``, the scheme in which ``split`` and
the random bits hash a 64-bit counter over the output's shape
(``jax/_src/prng.py``: ``_threefry_split_foldlike``,
``_threefry_random_bits_partitionable``), and ``PRNGKey`` of a 64-bit
seed (x64 on, as the JAX package sets it).  A key is a (2,) int64 tensor
holding two unsigned 32-bit words; every word is computed in int64 and
masked to 32 bits, on the device of the key.

``normal`` is ``sqrt(2) * erf_inv(u)``.  ``torch.erfinv`` is another
function than XLA's, so ``erf_inv`` here is XLA's f32 one written out:
Giles' two-branch polynomial in ``w = -log1p(-u*u)``, with XLA's own
``log1p`` and ``log`` (the CPU code XLA emits for them), with a fused
multiply-add wherever XLA's CPU code has one, and every operation rounded
to f32 as XLA's does.
"""
from __future__ import annotations

import math

import numpy as np
import torch

__all__ = ["prng_key", "split", "random_bits", "uniform", "normal",
           "gumbel", "categorical", "permutation", "choice", "erf_inv",
           "log1p", "div_f32"]

_MASK = 0xFFFFFFFF
_ROT = ((13, 15, 26, 6), (17, 29, 16, 24))
_PARITY = 0x1BD11BDA


def prng_key(seed: int, device=None) -> torch.Tensor:
    """``jax.random.PRNGKey(seed)``: the 64-bit seed's high and low words."""
    s = int(seed) & (2**64 - 1)
    return torch.tensor([s >> 32, s & _MASK], dtype=torch.int64,
                        device=device)


def _rotl(x: torch.Tensor, r: int) -> torch.Tensor:
    return ((x << r) | (x >> (32 - r))) & _MASK


def threefry2x32(key: torch.Tensor, x0: torch.Tensor, x1: torch.Tensor):
    """The Threefry-2x32 hash (20 rounds) of the counter words ``x0``,
    ``x1`` under ``key``: two tensors of words."""
    k0, k1 = key[0], key[1]
    ks = (k0, k1, k0 ^ k1 ^ _PARITY)
    x0 = (x0 + ks[0]) & _MASK
    x1 = (x1 + ks[1]) & _MASK
    for i in range(5):
        for r in _ROT[i % 2]:
            x0 = (x0 + x1) & _MASK
            x1 = _rotl(x1, r) ^ x0
        x0 = (x0 + ks[(i + 1) % 3]) & _MASK
        x1 = (x1 + ks[(i + 2) % 3] + (i + 1)) & _MASK
    return x0, x1


def _hash_counts(key: torch.Tensor, shape: tuple[int, ...]):
    """Both hash words of the 64-bit counters 0 .. prod(shape)-1, split
    into their high and low words, in ``shape``."""
    idx = torch.arange(math.prod(shape), dtype=torch.int64,
                       device=key.device)
    b0, b1 = threefry2x32(key, idx >> 32, idx & _MASK)
    return b0.reshape(shape), b1.reshape(shape)


def split(key: torch.Tensor, num: int = 2) -> torch.Tensor:
    """``jax.random.split(key, num)``: (num, 2) keys."""
    b0, b1 = _hash_counts(key, (num,))
    return torch.stack([b0, b1], dim=1)


def random_bits(key: torch.Tensor, shape) -> torch.Tensor:
    """``jax.random.bits(key, shape)`` (32-bit): int64 in [0, 2^32)."""
    b0, b1 = _hash_counts(key, tuple(shape))
    return b0 ^ b1


def uniform(key: torch.Tensor, shape, minval: float = 0.0,
            maxval: float = 1.0) -> torch.Tensor:
    """``jax.random.uniform(key, shape, float32, minval, maxval)``: 23
    random mantissa bits under the exponent of 1, less 1, scaled and
    shifted in f32 and clamped below at ``minval``."""
    bits = random_bits(key, shape)
    one = ((bits >> 9) | 0x3F800000).to(torch.int32).view(torch.float32)
    lo = torch.tensor(minval, dtype=torch.float32, device=key.device)
    hi = torch.tensor(maxval, dtype=torch.float32, device=key.device)
    floats = one - 1.0
    return torch.maximum(lo, _fma(floats, hi - lo, lo))


def normal(key: torch.Tensor, shape) -> torch.Tensor:
    """``jax.random.normal(key, shape, float32)``: sqrt(2) erf_inv(u) of
    u uniform in (-1, 1)."""
    lo = float(np.nextafter(np.float32(-1.0), np.float32(0.0)))
    u = uniform(key, shape, lo, 1.0)
    return erf_inv(u) * float(np.float32(math.sqrt(2.0)))


def gumbel(key: torch.Tensor, shape) -> torch.Tensor:
    """``jax.random.gumbel(key, shape, float32)`` in its default ``"low"``
    mode: -log(-log(u)) of u uniform in [tiny, 1), through XLA's f32
    ``log``."""
    u = uniform(key, shape, _FLT_MIN, 1.0)
    return -_log(-_log(u))


def categorical(key: torch.Tensor, logits: torch.Tensor,
                axis: int = -1) -> torch.Tensor:
    """``jax.random.categorical(key, logits, axis)`` (with replacement,
    default shape): the argmax of f32 gumbel noise plus the logits, the
    first index among equal values; int64."""
    g = gumbel(key, tuple(logits.shape))
    return torch.argmax(g + logits, dim=axis)


def permutation(key: torch.Tensor, n: int) -> torch.Tensor:
    """``jax.random.permutation(key, n)``: ``jax.random``'s sort-based
    shuffle of arange(n), one stable sort by 32 fresh random bits a round,
    ceil(3 ln n / ln(2^32 - 1)) rounds (one up to n = 1625, two above)."""
    rounds = int(np.ceil(3 * np.log(max(1, n)) / np.log(_MASK)))
    x = torch.arange(n, dtype=torch.int64, device=key.device)
    for _ in range(rounds):
        key, sub = split(key)
        x = x[torch.argsort(random_bits(sub, (n,)), stable=True)]
    return x


def choice(key: torch.Tensor, n: int, shape) -> torch.Tensor:
    """``jax.random.choice(key, n, shape, replace=False)``: the head of
    ``permutation(key, n)``."""
    k = math.prod(shape)
    if k > n:
        raise ValueError(f"choice: {k} draws without replacement from {n}")
    return permutation(key, n)[:k].reshape(tuple(shape))


# ------------------------------------------------------- XLA's f32 math
# XLA's CPU code generator lets LLVM contract a multiply into the add that
# takes it (``AllowFPOpFusion = Fast``), so its f32 polynomials run on
# fused multiply-adds: ``_fma`` below wherever its code has one.
def _f32(v: float) -> float:
    return float(np.float32(v))


def div_f32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """f32 a / b correctly rounded on any device: the f64 quotient rounds
    to the same f32 (53 >= 2 * 24 + 2 bits)."""
    return (a.double() / b.double()).to(torch.float32)


def _sqrt(a: torch.Tensor) -> torch.Tensor:
    """f32 sqrt correctly rounded on any device (a CPU build's vectorized
    f32 sqrt may miss by an ulp), through f64 as ``div_f32``."""
    return torch.sqrt(a.double()).to(torch.float32)


def _fma(a, b, c) -> torch.Tensor:
    """f32 a*b + c with one rounding.  The product of two f32 values is
    exact in f64; the sum is made exact by TwoSum and rounded to odd in
    f64, whose rounding to f32 is then the single correct one."""
    a, b, c = (t.double() if isinstance(t, torch.Tensor) else t
               for t in (a, b, c))
    ab = a * b
    s = ab + c
    v = s - ab
    err = (ab - (s - v)) + (c - v)
    even = (s.view(torch.int64) & 1) == 0
    toward = torch.where(err > 0, float("inf"), float("-inf"))
    s = torch.where((err != 0) & even, torch.nextafter(s, toward), s)
    return s.to(torch.float32)


# Eigen's plog (XLA's f32 log): x = m 2^e with m in [sqrt(1/2), sqrt(2)),
# log(m) by a degree-9 polynomial in m - 1, e log 2 in two parts
_LOG_P = tuple(_f32(c) for c in (
    7.0376836292e-2, -1.1514610310e-1, 1.1676998740e-1,
    -1.2420140846e-1, 1.4249322787e-1, -1.6668057665e-1,
    2.0000714765e-1, -2.4999993993e-1, 3.3333331174e-1))
_LOG_Q1 = _f32(-2.12194440e-4)
_LOG_Q2 = _f32(0.693359375)
_SQRT_HALF = _f32(0.707106781186547524)
_FLT_MIN = float(np.finfo(np.float32).tiny)


def _log(v: torch.Tensor) -> torch.Tensor:
    """XLA's f32 ``log`` for v > 0 (the domain ``log1p`` hands it)."""
    bits = torch.clamp_min(v, _FLT_MIN).view(torch.int32)
    m = ((bits & 0x7FFFFF) | 0x3F000000).view(torch.float32)
    e = ((bits >> 23) - 127).to(torch.float32) + 1.0
    low = m < _SQRT_HALF
    e = e - low.to(torch.float32)
    x = (m - 1.0) + torch.where(low, m, 0.0)
    x2 = x * x
    x3 = x2 * x
    p = _LOG_P
    y1 = _fma(_fma(x, p[0], p[1]), x, p[2])
    y2 = _fma(_fma(x, p[3], p[4]), x, p[5])
    y3 = _fma(_fma(x, p[6], p[7]), x, p[8])
    y = _fma(_fma(_fma(y1, x3, y2), x3, y3), x3, e * _LOG_Q1)
    # x2 * 0.5 and e * _LOG_Q2 are exact: XLA's fused forms round as these
    r = (x - x2 * 0.5) + y
    r = r + e * _LOG_Q2
    r = torch.where(v == 0, float("-inf"), r)
    return torch.where(v == float("inf"), float("inf"), r)


# XLA's f32 exp: Cephes' range reduction x = n log 2 + r (r by two fused
# steps of log 2's two parts), a degree-5 polynomial, times 2^n; results
# below the smallest normal flush to 0
_EXP_P = tuple(_f32(c) for c in (
    1.9875691500e-4, 1.3981999507e-3, 8.3334519073e-3, 4.1665795894e-2,
    1.6666665459e-1, 5.0000001201e-1))
_LOG2E = _f32(1.44269504088896341)
_EXP_C1, _EXP_C2 = _f32(0.693359375), _f32(-2.12194440e-4)


def _exp_xla(v: torch.Tensor) -> torch.Tensor:
    """XLA's f32 ``exp`` (the CPU code it emits), bit for bit."""
    x = torch.clamp(v, -88.8, 88.8)
    n = torch.floor(_fma(x, _LOG2E, 0.5))
    r = _fma(n, -_EXP_C2, _fma(n, -_EXP_C1, x))
    y = _fma(r, _EXP_P[0], _EXP_P[1])
    for c in _EXP_P[2:]:
        y = _fma(y, r, c)
    y = (1.0 + _fma(y, r * r, r)).double() * torch.pow(2.0, n.double())
    return torch.where(y < _FLT_MIN, 0.0, y).to(torch.float32)


class _Exp(torch.autograd.Function):
    """exp's derivative is exp: the backward is the gradient times the
    forward's output, as JAX differentiates ``jnp.exp`` (the emulation's
    floor, ``nextafter`` and bit views have no useful derivative)."""

    @staticmethod
    def forward(ctx, v):
        out = _exp_xla(v)
        ctx.save_for_backward(out)
        return out

    @staticmethod
    def backward(ctx, grad):
        out, = ctx.saved_tensors
        return grad * out


def _exp(v: torch.Tensor) -> torch.Tensor:
    """XLA's f32 ``exp``, bit for bit, with exp's gradient."""
    return _Exp.apply(v)


# XLA's log1p: Cephes' rational approximation for |x| < sqrt(2) - 1,
# log(1 + x) elsewhere
_LOG1P_NUM = tuple(_f32(c) for c in (
    4.5270000862445199635e-5, 4.9854102823193375972e-1,
    6.5787325942061044846e0, 2.9911919328553073277e1,
    6.0949667980987787057e1, 5.7112963590585538103e1,
    2.0039553499201281259e1))
_LOG1P_DEN = tuple(_f32(c) for c in (
    1.0, 1.5062909083469192198e1, 8.3047565967967209469e1,
    2.2176239823732856465e2, 3.0909872225312059774e2,
    2.1642788614495947685e2, 6.0118660497603843919e1))
_LOG1P_SMALL = _f32(0.41421356237309504880)


def _horner(x: torch.Tensor, coeffs) -> torch.Tensor:
    """XLA's ``EvaluatePolynomial``, highest degree first: 0 * x + c0,
    then p * x + c fused."""
    p = x * 0.0 + coeffs[0]
    for c in coeffs[1:]:
        p = _fma(p, x, c)
    return p


def log1p(x: torch.Tensor) -> torch.Tensor:
    """XLA's f32 ``log1p`` for x > -1."""
    x2 = x * x
    small = (x * x2) * div_f32(_horner(x, _LOG1P_NUM),
                            _horner(x, _LOG1P_DEN))
    small = x + (small - x2 * 0.5)      # x2 * 0.5 exact, as in _log
    return torch.where(x.abs() < _LOG1P_SMALL, small, _log(x + 1.0))


# XLA's ErfInv32 (Giles): w < 5 on w - 2.5, else on sqrt(w) - 3
_ERFINV_LT5 = tuple(_f32(c) for c in (
    2.81022636e-08, 3.43273939e-07, -3.5233877e-06, -4.39150654e-06,
    0.00021858087, -0.00125372503, -0.00417768164, 0.246640727,
    1.50140941))
_ERFINV_GE5 = tuple(_f32(c) for c in (
    -0.000200214257, 0.000100950558, 0.00134934322, -0.00367342844,
    0.00573950773, -0.0076224613, 0.00943887047, 1.00167406, 2.83297682))


def erf_inv(x: torch.Tensor) -> torch.Tensor:
    """XLA's f32 ``erf_inv`` on [-1, 1] (``jax.lax.erf_inv``)."""
    w = -log1p(-x * x)
    lt = w < 5.0
    t = torch.where(lt, w - 2.5, _sqrt(w) - 3.0)

    def coef(i):
        return torch.where(lt, _ERFINV_LT5[i], _ERFINV_GE5[i])

    p = coef(0)
    for i in range(1, 9):
        p = _fma(p, t, coef(i))
    return torch.where(x.abs() == 1.0, x * float("inf"), p * x)
