"""Plain PyTorch versions of the row-wise norms and of their gradient.

:func:`norm_plain` is the models' eager formula (``repro.models.layers``'
``layernorm`` and ``rmsnorm``, which XLA fuses): statistics in f32, the mean
and then the mean of squared deviations (LayerNorm) or the mean of squares
(RMSNorm), ``y = (x - mean) * rsqrt(var + eps)``, times the weight, plus
the bias, rounded once to x's dtype.  :func:`norm_formula` is the same
arithmetic in the dtype it is given, for autograd in f64.

:func:`norm_stats_plain` and :func:`norm_bwd_plain` are what
``csrc/norm.cu`` computes: the per-row mean and rstd that the forward keeps,
and the closed-form backward from them,

    xhat = (x - mean) * rstd,   g = dy * w
    dx = rstd * (g - mean(g) - xhat * mean(g * xhat))   (RMSNorm: no mean(g))
    dw = sum over rows of dy * xhat,   db = sum over rows of dy

in f32 (f64 for f64 inputs).  The JAX package has no such function: it
differentiates its formula.
"""
from __future__ import annotations

import torch


def norm_formula(x, weight=None, bias=None, eps: float = 1e-5, rms: bool = False):
    """The norm of x over its last dim in x's own dtype (no casts)."""
    if rms:
        var = (x * x).mean(dim=-1, keepdim=True)
        y = x * torch.rsqrt(var + eps)
    else:
        mu = x.mean(dim=-1, keepdim=True)
        var = ((x - mu) ** 2).mean(dim=-1, keepdim=True)
        y = (x - mu) * torch.rsqrt(var + eps)
    if weight is not None:
        y = y * weight
    if bias is not None:
        y = y + bias
    return y


def norm_plain(x, weight=None, bias=None, eps: float = 1e-5, rms: bool = False):
    """LayerNorm (``rms`` False) or RMSNorm of x over its last dim with an
    optional weight and bias (d,), computed in f32 and returned in x's
    dtype: the models' eager formula."""
    y = norm_formula(x.float(), None if weight is None else weight.float(),
                     None if bias is None else bias.float(), eps, rms)
    return y.to(x.dtype)


def _acc(x) -> torch.dtype:
    return torch.float64 if x.dtype == torch.float64 else torch.float32


def norm_stats_plain(x, eps: float = 1e-5, rms: bool = False):
    """(2, rows): each row's mean (0 for RMSNorm) and rstd, as the forward
    kernel keeps them for the backward."""
    xf = x.to(_acc(x)).reshape(-1, x.shape[-1])
    mu = torch.zeros_like(xf[:, 0]) if rms else xf.mean(dim=-1)
    var = ((xf - mu[:, None]) ** 2).mean(dim=-1)
    return torch.stack([mu, torch.rsqrt(var + eps)])


def norm_bwd_plain(x, dy, stats, weight=None, has_bias: bool = False, rms: bool = False):
    """(dx, dweight, dbias) of ``y = norm(x, weight, bias)`` for the upstream
    gradient ``dy``, from the forward's ``stats`` (:func:`norm_stats_plain`);
    dx in x's dtype, dweight (None without a weight) and dbias (None without
    a bias) in f32 (f64 for f64 inputs)."""
    acc = _acc(x)
    d = x.shape[-1]
    xf, dyf = x.to(acc).reshape(-1, d), dy.to(acc).reshape(-1, d)
    mu, rstd = stats.to(acc)[0, :, None], stats.to(acc)[1, :, None]
    xhat = (xf - mu) * rstd
    g = dyf if weight is None else dyf * weight.to(acc)
    c2 = (g * xhat).mean(dim=-1, keepdim=True)
    inner = g - xhat * c2 if rms else g - g.mean(dim=-1, keepdim=True) - xhat * c2
    dx = (rstd * inner).to(x.dtype).reshape(x.shape)
    dweight = None if weight is None else (dyf * xhat).sum(0)
    dbias = dyf.sum(0) if has_bias else None
    return dx, dweight, dbias
