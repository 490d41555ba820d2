"""Linear algebra (``paddle_tpu/ops/linalg.py``) over ``torch.linalg``.

Decompositions keep Paddle's defaults: ``svd(full_matrices=False)``
returns ``(U, S, Vh)``, ``qr(mode="reduced")``, ``cholesky(upper=False)``;
``lstsq`` returns its four outputs (solution, residuals, rank, singular
values) computed on the device from an SVD, with numpy's rules (the
residuals only when the rank is full and there are more rows than
columns). Matmul-class ops are on the AMP white list, so under
``auto_cast`` they compute in bf16 / f16.
"""
from __future__ import annotations

import numpy as np
import torch

from ..core.dtype import float_of
from ._common import amp

__all__ = [
    "matmul", "mm", "bmm", "mv", "multi_dot", "norm", "vector_norm",
    "matrix_norm", "dist", "cholesky", "inverse", "inv", "det", "slogdet",
    "pinv", "solve", "triangular_solve", "cholesky_solve", "lstsq",
    "matrix_power", "matrix_rank", "qr", "svd", "eig", "eigh", "eigvals",
    "eigvalsh", "cov", "corrcoef", "histogram", "bincount", "pca_lowrank",
]


def matmul(x, y, transpose_x=False, transpose_y=False, name=None):
    x, y = amp("matmul", x, y)
    if transpose_x and x.ndim > 1:
        x = x.transpose(-1, -2)
    if transpose_y and y.ndim > 1:
        y = y.transpose(-1, -2)
    return torch.matmul(x, y)


def mm(x, y, name=None):
    return matmul(x, y)


def bmm(x, y, name=None):
    x, y = amp("bmm", x, y)
    return torch.matmul(x, y)


def mv(x, vec, name=None):
    x, vec = amp("mv", x, vec)
    return torch.matmul(x, vec)


def multi_dot(tensors, name=None):
    return torch.linalg.multi_dot(list(amp("multi_dot", *tensors)))


def norm(x, p=None, axis=None, keepdim=False, name=None):
    """``axis=None``: a vector norm of the flattened ``x`` (``"fro"`` and
    2 alike, ``inf``, ``-inf``, 0, 1, any ``p``; ``keepdim`` is ignored,
    as in JAX); an int axis: a vector norm (``p`` 2 by default); two
    axes: a matrix norm (``"fro"`` by default)."""
    ax = tuple(axis) if isinstance(axis, (list, tuple)) else axis
    pp = p if p is not None else ("fro" if (ax is None or
                                            isinstance(ax, tuple)) else 2)
    (x,) = amp("norm", x)
    if ax is None:
        flat = x.reshape(-1)
        if pp in ("fro", 2):
            return torch.sqrt(torch.sum(flat * flat))
        if pp == np.inf:
            return torch.max(torch.abs(flat))
        if pp == -np.inf:
            return torch.min(torch.abs(flat))
        if pp == 1:
            return torch.sum(torch.abs(flat))
        if pp == 0:
            return torch.sum((flat != 0).to(x.dtype))
        return torch.sum(torch.abs(flat) ** pp) ** (1.0 / pp)
    return torch.linalg.norm(x, ord=pp, dim=ax, keepdim=keepdim)


def vector_norm(x, p=2.0, axis=None, keepdim=False, name=None):
    ax = tuple(axis) if isinstance(axis, (list, tuple)) else axis
    (x,) = amp("vector_norm", x)
    return torch.linalg.vector_norm(x, ord=p, dim=ax, keepdim=keepdim)


def matrix_norm(x, p="fro", axis=(-2, -1), keepdim=False, name=None):
    (x,) = amp("matrix_norm", x)
    return torch.linalg.matrix_norm(x, ord=p, dim=tuple(int(a) for a in axis),
                                    keepdim=keepdim)


def dist(x, y, p=2, name=None):
    x, y = amp("dist", x, y)
    return torch.linalg.vector_norm((x - y).reshape(-1), ord=p)


def cholesky(x, upper=False, name=None):
    (x,) = amp("cholesky", x)
    low = torch.linalg.cholesky(x)
    return low.transpose(-1, -2) if upper else low


def inverse(x, name=None):
    (x,) = amp("inverse", x)
    return torch.linalg.inv(x)


inv = inverse


def det(x, name=None):
    (x,) = amp("det", x)
    return torch.linalg.det(x)


def slogdet(x, name=None):
    (x,) = amp("slogdet", x)
    return tuple(torch.linalg.slogdet(x))


def pinv(x, rcond=1e-15, hermitian=False, name=None):
    (x,) = amp("pinv", x)
    return torch.linalg.pinv(x, rtol=rcond, hermitian=hermitian)


def solve(x, y, name=None):
    x, y = amp("solve", x, y)
    return torch.linalg.solve(x, y)


def triangular_solve(x, y, upper=True, transpose=False, unitriangular=False,
                     name=None):
    """Solve ``x @ out = y`` (``x.T @ out = y`` with ``transpose``) for a
    triangular ``x``."""
    x, y = amp("triangular_solve", x, y)
    if transpose:
        x, upper = x.transpose(-1, -2), not upper
    return torch.linalg.solve_triangular(x, y, upper=upper,
                                         unitriangular=unitriangular)


def cholesky_solve(x, y, upper=False, name=None):
    """Solve ``A @ out = x`` where ``y`` is ``A``'s Cholesky factor (only
    its triangle is read, so the other triangle gets no gradient)."""
    x, y = amp("cholesky_solve", x, y)
    y = torch.triu(y) if upper else torch.tril(y)
    return torch.cholesky_solve(x, y, upper=upper)


def lstsq(x, y, rcond=None, driver=None, name=None):
    """The least-squares solution of ``x @ out = y`` with numpy's outputs:
    (solution, residuals, rank, singular values). The rank is read on the
    host (the residuals' shape depends on it)."""
    m, n = x.shape[-2], x.shape[-1]
    u, s, vh = torch.linalg.svd(x, full_matrices=False)
    if rcond is None:
        rcond = torch.finfo(s.dtype).eps * max(m, n)
    cut = rcond * s.amax(-1, keepdim=True)
    keep = s > cut
    s_inv = torch.where(keep, 1.0 / torch.where(keep, s, torch.ones_like(s)),
                        torch.zeros_like(s))
    yy = y if y.ndim == x.ndim else y.unsqueeze(-1)
    sol = vh.transpose(-1, -2) @ (s_inv.unsqueeze(-1) *
                                  (u.transpose(-1, -2) @ yy))
    if y.ndim != x.ndim:
        sol = sol.squeeze(-1)
    rank = keep.sum(-1).to(torch.int32)
    if int(rank.min()) == n and m > n:
        r = y - (x @ sol if y.ndim == x.ndim else
                 (x @ sol.unsqueeze(-1)).squeeze(-1))
        res = (r * r).sum(-2 if y.ndim == x.ndim else -1)
    else:
        res = torch.zeros(0, dtype=x.dtype, device=x.device)
    return sol, res, rank, s


def matrix_power(x, n, name=None):
    (x,) = amp("matrix_power", x)
    return torch.linalg.matrix_power(x, n)


def matrix_rank(x, tol=None, hermitian=False, name=None):
    """The rank with ``tol`` a relative tolerance (``rtol``, as the JAX
    package passes it; ``hermitian`` is ignored there too)."""
    return torch.linalg.matrix_rank(x, rtol=tol).to(torch.int64)


def qr(x, mode="reduced", name=None):
    (x,) = amp("qr", x)
    return tuple(torch.linalg.qr(x, mode=mode))


def svd(x, full_matrices=False, name=None):
    (x,) = amp("svd", x)
    return tuple(torch.linalg.svd(x, full_matrices=full_matrices))


def eig(x, name=None):
    """Complex eigenvalues and vectors, always (the JAX package returns
    numpy's real f32 arrays when every imaginary part is 0: ROADMAP
    Queue 3)."""
    return tuple(torch.linalg.eig(x))


def eigh(x, UPLO="L", name=None):
    (x,) = amp("eigh", x)
    return tuple(torch.linalg.eigh(x, UPLO=UPLO))


def eigvals(x, name=None):
    return torch.linalg.eigvals(x)


def eigvalsh(x, UPLO="L", name=None):
    (x,) = amp("eigvalsh", x)
    return torch.linalg.eigvalsh(x, UPLO=UPLO)


def cov(x, rowvar=True, ddof=True, fweights=None, aweights=None, name=None):
    """Covariance of the rows (the columns when not ``rowvar``); the
    weights are ignored, as in JAX."""
    (x,) = amp("cov", x)
    x = float_of(x)
    if not rowvar and x.ndim > 1:
        x = x.transpose(0, 1)
    return torch.cov(x, correction=1 if ddof else 0)


def corrcoef(x, rowvar=True, name=None):
    (x,) = amp("corrcoef", x)
    x = float_of(x)
    if not rowvar and x.ndim > 1:
        x = x.transpose(0, 1)
    return torch.corrcoef(x)


def histogram(x, bins=100, min=0, max=0, name=None):  # noqa: A002
    """int64 counts over ``bins`` equal bins of [min, max] (the data's
    range when both are 0; the last bin holds its right edge)."""
    xf = x.to(torch.float64)
    return torch.histc(xf, bins=bins, min=min, max=max).to(torch.int64)


def bincount(x, weights=None, minlength=0, name=None):
    out = torch.bincount(x, weights=weights, minlength=minlength)
    if weights is not None and out.dtype != weights.dtype and \
            weights.is_floating_point():
        out = out.to(weights.dtype)
    return out


def pca_lowrank(x, q=None, center=True, niter=2, name=None):
    """(U, S, V) of the (centred) matrix's exact thin SVD, cut to ``q``
    components (``min(6, m, n)`` by default), in f32."""
    m, n = x.shape[-2], x.shape[-1]
    if q is None:
        q = min(6, m, n)
    (x,) = amp("pca_lowrank", x)
    af = x.to(torch.float32)
    if center:
        af = af - af.mean(dim=-2, keepdim=True)
    u, s, vh = torch.linalg.svd(af, full_matrices=False)
    return u[..., :q], s[..., :q], vh.transpose(-1, -2)[..., :q]

