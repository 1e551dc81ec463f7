"""Double-word fp32 ("df64") arithmetic (PyTorch).

Counterpart of :mod:`cgx.ops.df64`, with the same operations in the same
order.  A df64 value is the unevaluated sum ``hi + lo`` of two fp32 words
with ``|lo| ≤ ½ulp(hi)``: 48 mantissa bits (eps ≈ 3.6e-15), enough that
``κ·eps ≪ 1`` at κ = 10¹⁰.  The primitives are the error-free transforms
(Dekker 1971, Knuth TAOCP §4.2.2):

* :func:`two_sum` — exact fp32 addition ``a + b = s + err`` (6 flops);
* :func:`two_prod` — exact fp32 product by Dekker's 12-bit split (no FMA);
* double-word add, multiply and divide built on them (QD style);
* :func:`df_sum` / :func:`df_dot` — pairwise halving with the double-word
  add (:func:`_fold_axis`), log₂(n) steps of elementwise ops.

Every expression is a chain of single tensor ops, each rounded on its own.
Nothing here may be written in a form that can fuse a product into a sum
(``torch.addcmul``, ``add(..., alpha=c)``, ``torch.compile``): a fused
multiply-add re-rounds the product and destroys the transforms.  Eager
PyTorch launches one kernel per op, so the CPU and the card keep them
exact; ``chip_smoke.py`` (phase HP) counts the mismatches of
:func:`two_prod` and :func:`two_sum` against fp64 on the card.

The words live on one device; :func:`df_from_f64` splits a host fp64
array onto ``device`` (the card unless the caller asks for the CPU) and
:func:`df_to_f64` brings the fp64 view back to the host.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Tuple

import numpy as np
import torch

from cgx_torch.sparse.types import resolve_device

__all__ = ["DF64", "two_sum", "quick_two_sum", "two_prod",
           "df", "df_from_f64", "df_to_f64", "df_zeros_like",
           "df_neg", "df_add", "df_sub", "df_mul", "df_mul_f32",
           "df_div", "df_sum", "df_dot", "df_axpy"]

# Dekker's splitting constant for fp32: 2¹² + 1 (splits a 24-bit mantissa
# into two 12-bit halves whose product is exact in fp32).
_SPLIT = 4097.0


@dataclass(frozen=True, eq=False)
class DF64:
    """A double-word fp32 array: the unevaluated sum ``hi + lo``."""

    hi: torch.Tensor
    lo: torch.Tensor

    @property
    def shape(self):
        return self.hi.shape

    @property
    def dtype(self):
        return self.hi.dtype

    @property
    def device(self) -> torch.device:
        return self.hi.device


def two_sum(a, b) -> Tuple[torch.Tensor, torch.Tensor]:
    """Error-free fp32 sum: ``a + b = s + err`` exactly (Knuth, 6 flops)."""
    s = a + b
    bb = s - a
    err = (a - (s - bb)) + (b - bb)
    return s, err


def quick_two_sum(a, b) -> Tuple[torch.Tensor, torch.Tensor]:
    """Error-free sum assuming ``|a| ≥ |b|`` (3 flops)."""
    s = a + b
    return s, b - (s - a)


def _split(a):
    t = _SPLIT * a
    hi = t - (t - a)
    return hi, a - hi


def two_prod(a, b) -> Tuple[torch.Tensor, torch.Tensor]:
    """Error-free fp32 product: ``a·b = p + err`` exactly (Dekker)."""
    p = a * b
    ah, al = _split(a)
    bh, bl = _split(b)
    err = ((ah * bh - p) + ah * bl + al * bh) + al * bl
    return p, err


# ---------------------------------------------------------------------------
# Construction and conversion
# ---------------------------------------------------------------------------

def _f32(v, device) -> torch.Tensor:
    if isinstance(v, torch.Tensor):
        return v.to(torch.float32)
    arr = np.asarray(v, np.float32)
    return torch.from_numpy(arr.copy()).to(resolve_device(device))


def df(hi, lo=None, device="cuda") -> DF64:
    """Wrap fp32 word(s) as a :class:`DF64` (``lo`` defaults to zero).  A
    tensor keeps its device; an array goes to ``device``."""
    h = _f32(hi, device)
    return DF64(h, torch.zeros_like(h) if lo is None
                else _f32(lo, device).to(h.device))


def df_from_f64(x, device="cuda") -> DF64:
    """Split a host fp64 array into an exact df64 pair on ``device``: hi is
    the fp32 rounding of x, lo the fp32 of the remainder (exact, because
    the remainder has at most 24 significant bits left)."""
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu().numpy()
    x = np.asarray(x, np.float64)
    hi = np.array(x.astype(np.float32))
    lo = np.array((x - hi.astype(np.float64)).astype(np.float32))
    dev = resolve_device(device)
    return DF64(torch.from_numpy(hi).to(dev), torch.from_numpy(lo).to(dev))


def df_to_f64(x: DF64) -> np.ndarray:
    """The host fp64 view ``hi + lo`` of a df64 array."""
    return (x.hi.detach().cpu().numpy().astype(np.float64)
            + x.lo.detach().cpu().numpy().astype(np.float64))


def df_zeros_like(x: DF64) -> DF64:
    return DF64(torch.zeros_like(x.hi), torch.zeros_like(x.lo))


# ---------------------------------------------------------------------------
# Double-word arithmetic (QD style)
# ---------------------------------------------------------------------------

def df_neg(x: DF64) -> DF64:
    return DF64(-x.hi, -x.lo)


def df_add(x: DF64, y: DF64) -> DF64:
    """Double-word addition (the 11-flop "sloppy" form: error
    O(eps²·|x+y|), the right trade for long accumulations)."""
    s, e = two_sum(x.hi, y.hi)
    e = e + (x.lo + y.lo)
    s, e = quick_two_sum(s, e)
    return DF64(s, e)


def df_sub(x: DF64, y: DF64) -> DF64:
    return df_add(x, df_neg(y))


def df_mul(x: DF64, y: DF64) -> DF64:
    """Double-word product (drops the lo·lo term, O(eps²))."""
    p, e = two_prod(x.hi, y.hi)
    e = e + (x.hi * y.lo + x.lo * y.hi)
    p, e = quick_two_sum(p, e)
    return DF64(p, e)


def df_mul_f32(x: DF64, c) -> DF64:
    """df64 × fp32."""
    p, e = two_prod(x.hi, c)
    e = e + x.lo * c
    p, e = quick_two_sum(p, e)
    return DF64(p, e)


def df_div(x: DF64, y: DF64) -> DF64:
    """Double-word division: the fp32 quotient and one Newton correction
    (full df64 accuracy for CG's scalar coefficients)."""
    q1 = x.hi / y.hi
    r = df_sub(x, df_mul_f32(y, q1))
    q2 = (r.hi + r.lo) / (y.hi + y.lo)
    s, e = quick_two_sum(q1, q2)
    return DF64(s, e)


# ---------------------------------------------------------------------------
# Reductions: pairwise halving
# ---------------------------------------------------------------------------

def _fold_axis(x: DF64, axis: int) -> DF64:
    """Sum a df64 array along ``axis`` by pairwise halving: zero padding to
    the next power of two (exact under :func:`two_sum`), then log₂ steps of
    the double-word add of the first half and the second."""
    hi, lo = x.hi, x.lo
    axis = axis % hi.dim()
    n = hi.shape[axis]
    p = 1 << max(0, (n - 1).bit_length())
    if p != n:
        pad_shape = list(hi.shape)
        pad_shape[axis] = p - n
        hi = torch.cat([hi, hi.new_zeros(pad_shape)], dim=axis)
        lo = torch.cat([lo, lo.new_zeros(pad_shape)], dim=axis)
    while hi.shape[axis] > 1:
        m = hi.shape[axis] // 2
        s = df_add(DF64(hi.narrow(axis, 0, m), lo.narrow(axis, 0, m)),
                   DF64(hi.narrow(axis, m, m), lo.narrow(axis, m, m)))
        hi, lo = s.hi, s.lo
    return DF64(hi.squeeze(axis), lo.squeeze(axis))


def df_sum(x: DF64) -> DF64:
    """Pairwise df64 sum of a whole df64 array → a df64 scalar."""
    return _fold_axis(DF64(x.hi.reshape(-1), x.lo.reshape(-1)), 0)


def df_dot(x: DF64, y: DF64) -> DF64:
    """df64 inner product ``xᵀy``: error-free products, pairwise
    double-word accumulation (about one ulp of 2⁻⁴⁸ whatever n)."""
    return df_sum(df_mul(x, y))


def df_axpy(alpha: DF64, x: DF64, y: DF64) -> DF64:
    """``alpha·x + y`` in df64 (``alpha`` a df64 scalar)."""
    ax = df_mul(DF64(alpha.hi.expand(x.hi.shape),
                     alpha.lo.expand(x.lo.shape)), x)
    return df_add(ax, y)
