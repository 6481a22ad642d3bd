"""Small numerical helpers shared by the port's solver and frontend."""

from __future__ import annotations

import torch


def eigh64(a: torch.Tensor):
    """Symmetric eigendecomposition computed in float64 and returned in the
    input's type: float32 LAPACK divide-and-conquer can fail to converge on
    the rank-deficient matrices this code factors (marginalization priors
    with many zero rows, 9x9 Gram matrices of degenerate RANSAC samples)."""
    evals, evecs = torch.linalg.eigh(a.to(torch.float64))
    return evals.to(a.dtype), evecs.to(a.dtype)


def cholesky_or_nan(a: torch.Tensor) -> torch.Tensor:
    """Lower Cholesky factor; a matrix that is not positive definite yields
    NaNs (the reference's behaviour) instead of an exception."""
    L, info = torch.linalg.cholesky_ex(a)
    bad = (info != 0).reshape(info.shape + (1, 1))
    return torch.where(bad, torch.full_like(L, float("nan")), L)


def median(x: torch.Tensor) -> torch.Tensor:
    """numpy/JAX median of a 1-D tensor: the mean of the two middle values
    for even n."""
    s, _ = torch.sort(x)
    n = s.shape[0]
    return 0.5 * (s[(n - 1) // 2] + s[n // 2])


def tree_where(cond, a, b):
    """Field-wise torch.where over two NamedTuples of tensors (nested
    NamedTuples field by field)."""
    return type(a)(*[tree_where(cond, u, v) if isinstance(u, tuple)
                     else torch.where(cond, u, v) for u, v in zip(a, b)])
