"""Statistical epilogue for the association engine, in PyTorch.

Elementwise float32 functions over the ``(M, P)`` statistic tile, run on
whatever device the tensor lies on.

Numerical notes
---------------
* Two-sided p-value of a t statistic with ``nu`` degrees of freedom is the
  regularized incomplete beta ``I_x(nu/2, 1/2)`` at ``x = nu / (nu + t^2)``.
* ``-log10 p`` is reported through a dedicated log-space branch, so hits far
  past ``p ~ 1e-35`` (where a float32 p underflows) stay finite:

  - tail (``t^2 > t2*``): modified-Lentz continued fraction for
    ``I_x(a, b)`` evaluated as ``log I = a log x + b log1p(-x) - betaln(a,b)
    - log a + log(cf)``.
  - bulk, ``nu <= 4096``: ``p = 1 - I_z(1/2, nu/2)`` at ``z = t^2/(nu+t^2)``.
    ``torch.special`` has neither ``betainc`` nor ``betaln``, so the port
    evaluates ``I`` with the same Lentz fraction on whichever side of the
    symmetry ``I_z(a, b) = 1 - I_{1-z}(b, a)`` converges (``z < (a+1)/(a+b+2)``,
    i.e. ``t^2 <= 3 nu / (nu + 2)``), as Numerical Recipes' ``betai`` does,
    and ``betaln(1/2, b)`` from ``lgamma`` in float64.
  - bulk, ``nu > 4096``: Edgeworth-corrected normal tail.
"""
from __future__ import annotations

import functools
import math
import threading

import numpy as np
import torch

__all__ = [
    "t_from_r",
    "neglog10_p_from_t",
    "t2_screen_threshold",
    "refine_neglog10p",
    "REFINE_WIDTH",
    "genomic_control_lambda",
    "LOG10E",
]

LOG10E = 0.4342944819032518  # log10(e)

_CF_ITERS = 128     # fixed Lentz trips; ample inside the convergence region
_T2_SWITCH = 6.0    # t^2 above this -> log-space tail; below -> bulk lanes
_FPMIN = 1e-30


def t_from_r(r: torch.Tensor, dof: float, *, eps: float = 1e-12) -> torch.Tensor:
    """Paper Eq. (3): ``T = R * sqrt(dof / (1 - R^2))``.

    ``1 - r^2`` is clamped at ``eps`` so monomorphic / perfectly-collinear
    columns produce large-but-finite statistics instead of inf.
    """
    denom = torch.clamp(1.0 - r * r, min=eps)
    return r * torch.sqrt(torch.tensor(float(dof), dtype=r.dtype, device=r.device) / denom)


def _tiny_floor(v: torch.Tensor) -> torch.Tensor:
    return torch.where(torch.abs(v) < _FPMIN, torch.full_like(v, _FPMIN), v)


def _betacf(a: torch.Tensor, b: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """Modified-Lentz continued fraction for the incomplete beta
    (Numerical Recipes betacf), elementwise, fixed ``_CF_ITERS`` trips.
    Converges for ``x < (a+1)/(a+b+2)``."""
    qab, qap, qam = a + b, a + 1.0, a - 1.0
    c = torch.ones_like(x)
    d = 1.0 / _tiny_floor(1.0 - qab * x / qap)
    h = d
    for m in range(_CF_ITERS):
        mf = float(m) + 1.0
        m2 = 2.0 * mf
        aa = mf * (b - mf) * x / ((qam + m2) * (a + m2))
        d = 1.0 / _tiny_floor(1.0 + aa * d)
        c = _tiny_floor(1.0 + aa / c)
        h = h * d * c
        aa = -(a + mf) * (qab + mf) * x / ((a + m2) * (qap + m2))
        d = 1.0 / _tiny_floor(1.0 + aa * d)
        c = _tiny_floor(1.0 + aa / c)
        h = h * d * c
    return h


_LGAMMA_HALF = 0.5723649429247001  # lgamma(1/2) = log(sqrt(pi))


def _betaln_half(a: float) -> float:
    """``betaln(a, 1/2)`` stable for huge ``a`` (``a = nu/2`` is one scalar
    per scan).  Direct lgamma differencing, in float64, up to ``a = 200``;
    above it ``Gamma(a+1/2)/Gamma(a) ~ sqrt(a)(1 - 1/(8a) + 1/(128a^2))``
    (error O(a^-3))."""
    if a > 200.0:
        inv = 1.0 / a
        return _LGAMMA_HALF - 0.5 * math.log(a) - math.log1p(-0.125 * inv + (1.0 / 128.0) * inv * inv)
    return math.lgamma(a) + _LGAMMA_HALF - math.lgamma(a + 0.5)


def _log_p_tail(nu: float, t2: torch.Tensor) -> torch.Tensor:
    """``log I_x(nu/2, 1/2)`` at ``x = nu/(nu+t^2)`` — the two-sided t tail —
    with every term computed from the well-conditioned ratio ``t^2/nu``.
    Lanes below ``_T2_SWITCH`` are clamped into the convergence region and
    discarded by the caller."""
    a = nu * 0.5
    x_cf = torch.minimum(nu / (nu + t2), torch.full_like(t2, nu / (nu + _T2_SWITCH)))
    cf = _betacf(torch.full_like(t2, a), torch.full_like(t2, 0.5), x_cf)
    t2s = torch.clamp(t2, min=_T2_SWITCH)
    log_x_term = -a * torch.log1p(t2s / nu)
    log_1mx_term = 0.5 * (torch.log(t2s) - torch.log(nu + t2s))
    return (
        log_x_term
        + log_1mx_term
        - _betaln_half(a)
        - math.log(a)
        + torch.log(torch.clamp(cf, min=_FPMIN))
    )


def _p_bulk_beta(nu: float, t2: torch.Tensor) -> torch.Tensor:
    """Two-sided p on the bulk lane for ``nu <= 4096``.

    With ``b = nu/2``, ``z = t^2/(nu+t^2)`` and ``x = 1 - z``, both
    ``I_z(1/2, b)`` and ``I_x(b, 1/2)`` share the prefactor
    ``exp(-b log1p(t^2/nu) + (log t^2 - log(nu+t^2))/2 - betaln(1/2, b))``;
    only the leading ``1/a`` and the continued fraction differ.  Lanes with
    ``t^2 <= 3 nu/(nu+2)`` take ``p = 1 - I_z(1/2, b)``, the rest
    ``p = I_x(b, 1/2)`` — each where its fraction converges."""
    b = nu * 0.5
    use_z = t2 <= 3.0 * nu / (nu + 2.0)
    half = torch.full_like(t2, 0.5)
    bb = torch.full_like(t2, b)
    z = t2 / (nu + t2)
    cf = _betacf(torch.where(use_z, half, bb), torch.where(use_z, bb, half),
                 torch.where(use_z, z, 1.0 - z))
    log_pref = -b * torch.log1p(t2 / nu) + 0.5 * (torch.log(t2) - torch.log(nu + t2)) - _betaln_half(b)
    log_inv_a = torch.where(use_z, torch.full_like(t2, -math.log(0.5)), torch.full_like(t2, -math.log(b)))
    part = torch.exp(log_pref + log_inv_a + torch.log(torch.clamp(cf, min=_FPMIN)))
    return torch.where(use_z, 1.0 - part, part)


_SQRT_HALF = 0.7071067811865476
_INV_SQRT_2PI = 0.3989422804014327
_NU_BETAINC = 4096.0   # at or below this dof the bulk lane is the beta function
_T2_ERFC_MAX = 144.0   # erfc underflows in f32 past |t| ~ 12


def neglog10_p_from_t(t, dof: float) -> torch.Tensor:
    """Two-sided ``-log10 p`` for a t statistic, stable to ``p ~ 1e-10000``.

    Three lanes, selected elementwise by ``t2* = clip(nu/2000, 6, 144)``:

      * tail (``t^2 > t2*``): log-space continued fraction;
      * bulk, ``nu <= 4096``: ``p = 1 - I_z(1/2, nu/2)`` (``_p_bulk_beta``);
      * bulk, ``nu > 4096``: Edgeworth-corrected normal
        ``P(T>t) = Q(t) + (t^3+t) phi(t)/(4 nu) + O(nu^-2)``.

    ``dof`` is one scalar per call (one scan), so the lane choice that
    depends only on it is made once in Python.
    """
    t = torch.as_tensor(t, dtype=torch.float32)
    nu = float(np.float32(dof))
    t2 = t * t
    t2_switch = float(np.float32(min(max(nu / 2000.0, _T2_SWITCH), _T2_ERFC_MAX)))

    log_p_tail = _log_p_tail(nu, torch.clamp(t2, min=t2_switch))
    if nu > _NU_BETAINC:
        abs_t = torch.abs(t)
        q_norm = 0.5 * torch.special.erfc(abs_t * _SQRT_HALF)
        phi = _INV_SQRT_2PI * torch.exp(-0.5 * torch.clamp(t2, max=160.0))
        p_bulk = 2.0 * (q_norm + (abs_t * t2 + abs_t) * phi / (4.0 * nu))
    else:
        p_bulk = _p_bulk_beta(nu, torch.clamp(t2, max=t2_switch))
    log_p_bulk = torch.log(torch.clamp(p_bulk, 1e-38, 1.0))

    log_p = torch.where(t2 > t2_switch, log_p_tail, log_p_bulk)
    return torch.clamp(-LOG10E * log_p, min=0.0)


# ------------------------------------------------- sparse-epilogue screening
#
# For fixed dof, -log10 p is strictly increasing in t^2.  ``neglog10_p_from_t``
# evaluates it in f32 with bounded error and bounded local jitter, so
# inverting the hit threshold through the function itself, against a target
# reduced by a margin that dwarfs both, yields a t^2 bound that soundly
# *underestimates* the true boundary: every lane the scan would report as a
# hit passes the screen, and only near-threshold misses are screened in
# spuriously (the exact refine then rejects them).

_T2_SCREEN_MAX = 1e37  # f32-finite cap for the bracket search
_PROBES = 64           # probes per narrowing round of the bracket search


@functools.lru_cache(maxsize=1024)
def t2_screen_threshold(threshold_nlp: float, dof: float) -> float | None:
    """Invert the hit threshold to a conservative per-dof t^2 screen bound.

    Returns ``t2*`` such that ``neglog10_p_from_t(t, dof) >= threshold_nlp``
    implies ``t^2 >= t2*``.  Searches on the port's own f32 function against
    the reduced target ``threshold - (0.05 + 0.02*threshold)``.  The bracket
    is narrowed by evaluating ``_PROBES`` evenly spaced probes per round in
    one vectorized call (a many-way bisection; each round keeps the probe
    pair around the first crossing) until the probes stop being distinct in
    float64.  The result is the largest probe still below the target, one f32
    ulp down.  ``None`` means no useful bound exists (threshold at or below
    the margin floor): callers must fall back to the dense epilogue.
    """
    threshold_nlp = float(threshold_nlp)
    dof = float(dof)
    target = threshold_nlp - (0.05 + 0.02 * threshold_nlp)
    if not (target > 0.0) or not (dof > 0.0):
        return None

    def nlp32(t2: np.ndarray) -> np.ndarray:
        t2_32 = torch.from_numpy(np.asarray(t2, np.float32))
        return neglog10_p_from_t(torch.sqrt(t2_32), dof).numpy()

    hi = 1.0
    while nlp32(np.array([hi]))[0] < target:
        hi *= 4.0
        if hi > _T2_SCREEN_MAX:
            # Even the largest representable statistic stays below the
            # target: a screen at the cap soundly rejects everything.
            return float(_T2_SCREEN_MAX)
    lo = 0.0
    while True:
        probes = np.linspace(lo, hi, _PROBES + 2)[1:-1]
        probes = probes[(probes > lo) & (probes < hi)]
        if probes.size == 0:
            break
        below = nlp32(probes) < target
        first_above = int(np.argmin(below)) if not below.all() else probes.size
        new_lo = probes[first_above - 1] if first_above > 0 else lo
        new_hi = probes[first_above] if first_above < probes.size else hi
        if new_lo == lo and new_hi == hi:
            break
        lo, hi = float(new_lo), float(new_hi)
    # ``lo`` is the largest probe still below the reduced target; one ulp
    # down (in f32, the comparison precision of the screen) for strictness.
    return float(np.nextafter(np.float32(lo), np.float32(0.0)))


# Canonical chunk width for refining hit buffers.  Every emitted -log10 p —
# compact buffer, overflow fallback, dense audit, per-trait winners, tile
# reconstruction — is evaluated in fixed (REFINE_WIDTH,) chunks, so the
# emitted bits cannot depend on a buffer's length or position: a full SIMD
# multiple, so no scalar remainder lanes exist whose position could change a
# bit.
REFINE_WIDTH = 64


def refine_neglog10p(
    t_values: np.ndarray, dof: float, *, width: int | None = REFINE_WIDTH
) -> np.ndarray:
    """Canonical exact-tail refine on the host CPU.

    Evaluates ``neglog10_p_from_t`` on a 1-D t buffer.  With ``width`` (the
    default, ``REFINE_WIDTH``), the buffer is zero-padded and evaluated in
    fixed ``(width,)`` chunks, so the sparse compact path, the overflow
    fallback, the dense audit mode, the per-trait winners and the full-tile
    reconstruction all feed slot-identical chunks to one function and produce
    bit-identical values for the same t.  Padding lanes (t=0) map to nlp=0
    and are sliced off.  ``width=None`` evaluates the buffer as one call.
    """
    with _REFINE_LOCK:
        return _refine(t_values, dof, width)


# One refine at a time per process.  A refine is a chain of a few hundred
# small eager ops, each of which releases and retakes the GIL; when the
# executor's slot tails refine concurrently they convoy on the GIL, and
# every call runs several times slower than alone.  Taking turns costs
# nothing in bits: the same chunks run through the same ops.
_REFINE_LOCK = threading.Lock()


def _refine(t_values: np.ndarray, dof: float, width: int | None) -> np.ndarray:
    flat = np.ascontiguousarray(np.asarray(t_values, np.float32).ravel())
    if width is None:
        return neglog10_p_from_t(torch.from_numpy(flat.copy()), dof).numpy()
    width = int(width)
    k = int(flat.shape[0])
    n_chunks = max(1, -(-k // width))
    buf = np.zeros(n_chunks * width, np.float32)
    buf[:k] = flat
    # Whole chunks are evaluated together, at most _REFINE_GROUP elements per
    # call: below PyTorch's intra-op grain size a call runs on one thread, and
    # a length that is a multiple of the SIMD width has no scalar remainder,
    # so each lane sees exactly the arithmetic of a lone (width,) call.
    group = max(width, (_REFINE_GROUP // width) * width)
    out = np.concatenate(
        [neglog10_p_from_t(torch.from_numpy(buf[i:i + group]), dof).numpy()
         for i in range(0, buf.shape[0], group)]
    )
    return out[:k]


_REFINE_GROUP = 16384


def genomic_control_lambda(t_stats) -> torch.Tensor:
    """Genomic-control lambda: median(t^2) / qchisq(0.5, 1).

    ``qchisq(0.5, 1) = 0.45493642``.  The median of an even-length sample is
    the mean of the two middle values (``torch.median`` would return the
    lower one).
    """
    chi2 = torch.square(torch.as_tensor(t_stats, dtype=torch.float32).reshape(-1))
    s = torch.sort(chi2).values
    n = s.shape[0]
    med = s[n // 2] if n % 2 else (s[n // 2 - 1] + s[n // 2]) / 2.0
    return med / 0.45493642311957184
