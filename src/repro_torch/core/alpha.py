"""Step 3 of MATCHA: the mixing weight alpha and the spectral norm rho.

The paper (Lemma 1) poses  min_alpha || E[W'W] - J ||_2  as an SDP with
auxiliary beta >= alpha^2, and proves the optimum has beta = alpha^2.
That makes the SDP *exactly equivalent* to the one-dimensional problem

    min_alpha  rho(alpha) = lmax( (I - alpha*L_bar)^2 + 2 alpha^2 L_tilde - J )

(eq. 87 in the paper; the matrix is symmetric PSD minus J). Each
eigen-direction contributes a convex quadratic in alpha, so rho(alpha)
— a pointwise max of convex functions — is convex. We therefore solve
it EXACTLY with golden-section search bracketed by the closed-form
candidates from Theorem 2's proof (alpha* = lam/(lam^2 + 2 zeta)),
instead of relaxing to an SDP. No SDP solver is needed and the result
is at least as tight as the paper's.
"""
from __future__ import annotations

import dataclasses

import numpy as np


def spectral_norm_rho(
    alpha: float, L_bar: np.ndarray, L_tilde: np.ndarray
) -> float:
    """rho(alpha) = || E[W'W] - J ||_2 with W = I - alpha * L(k).

    Uses the exact second-moment expansion (paper eq. 86-87):
        E[W'W] = (I - alpha L_bar)^2 + 2 alpha^2 L_tilde.
    """
    m = L_bar.shape[0]
    J = np.full((m, m), 1.0 / m)
    I = np.eye(m)
    A = I - alpha * L_bar
    Ew = A @ A + 2.0 * (alpha**2) * L_tilde
    lam = np.linalg.eigvalsh(Ew - J)
    return float(np.max(np.abs(lam)))


@dataclasses.dataclass(frozen=True)
class AlphaSolution:
    alpha: float
    rho: float


def optimize_alpha(
    L_bar: np.ndarray,
    L_tilde: np.ndarray,
    *,
    tol: float = 1e-12,
    max_iter: int = 200,
) -> AlphaSolution:
    """Exact 1-D convex minimization of rho(alpha)."""
    lam = np.linalg.eigvalsh(L_bar)
    lam2, lam_m = float(lam[1]), float(lam[-1])
    zeta = float(np.max(np.abs(np.linalg.eigvalsh(L_tilde))))
    # Theorem-2 closed-form candidates bound the relevant alpha range:
    # any minimizer lies in (0, 2*max-candidate].
    cands = []
    for lv in (lam2, lam_m):
        if lv > 0:
            cands.append(lv / (lv * lv + 2.0 * zeta))
    hi = 2.0 * max(cands) if cands else 1.0
    lo = 0.0

    f = lambda a: spectral_norm_rho(a, L_bar, L_tilde)
    # Golden-section search on the convex rho(alpha).
    invphi = (np.sqrt(5.0) - 1.0) / 2.0
    a, b = lo, hi
    c = b - invphi * (b - a)
    d = a + invphi * (b - a)
    fc, fd = f(c), f(d)
    for _ in range(max_iter):
        if abs(b - a) < tol:
            break
        if fc < fd:
            b, d, fd = d, c, fc
            c = b - invphi * (b - a)
            fc = f(c)
        else:
            a, c, fc = c, d, fd
            d = a + invphi * (b - a)
            fd = f(d)
    alpha = 0.5 * (a + b)
    return AlphaSolution(alpha=float(alpha), rho=f(alpha))
