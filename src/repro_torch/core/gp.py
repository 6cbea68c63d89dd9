"""Gaussian-process regression (pure numpy) for the BO surrogate (paper §III-A).

Matern-5/2 kernel with a single lengthscale, signal variance, and observation
noise; hyperparameters fit by log-marginal-likelihood grid search (cheap,
dependency-free, and robust for the <100-point datasets an online tuner
sees). T' = T + e with Gaussian e is handled by the noise term, matching the
paper's noise-resilience argument.
"""
from __future__ import annotations

import numpy as np


def _matern52(X1, X2, ls: float):
    d = np.sqrt(np.maximum(
        np.sum((X1[:, None, :] - X2[None, :, :]) ** 2, axis=-1), 0.0)) / ls
    s5 = np.sqrt(5.0) * d
    return (1.0 + s5 + 5.0 / 3.0 * d * d) * np.exp(-s5)


class GaussianProcess:
    def __init__(self, lengthscale: float = 0.5, signal_var: float = 1.0,
                 noise_var: float = 1e-2):
        self.ls = lengthscale
        self.sv = signal_var
        self.nv = noise_var
        self._X = None
        self._y = None
        self._mean = 0.0
        self._std = 1.0
        self._L = None
        self._alpha = None

    # ------------------------------------------------------------------ fit
    def fit(self, X, y, optimize: bool = True):
        X = np.asarray(X, float)
        y = np.asarray(y, float).ravel()
        assert X.ndim == 2 and len(X) == len(y) and len(y) >= 1
        self._mean = float(np.mean(y))
        self._std = float(np.std(y)) or 1.0
        yn = (y - self._mean) / self._std
        self._X, self._y = X, yn
        if optimize and len(y) >= 4:
            self._optimize()
        self._factorize()
        return self

    def _nll(self, ls, nv):
        K = self.sv * _matern52(self._X, self._X, ls)
        K[np.diag_indices_from(K)] += nv
        try:
            L = np.linalg.cholesky(K)
        except np.linalg.LinAlgError:
            return np.inf
        alpha = np.linalg.solve(L.T, np.linalg.solve(L, self._y))
        return (0.5 * self._y @ alpha + np.sum(np.log(np.diag(L)))
                + 0.5 * len(self._y) * np.log(2 * np.pi))

    def _optimize(self):
        best = (np.inf, self.ls, self.nv)
        for ls in (0.1, 0.2, 0.35, 0.5, 0.8, 1.2, 2.0):
            for nv in (1e-4, 1e-3, 1e-2, 5e-2, 0.1):
                nll = self._nll(ls, nv)
                if nll < best[0]:
                    best = (nll, ls, nv)
        _, self.ls, self.nv = best

    def _factorize(self):
        K = self.sv * _matern52(self._X, self._X, self.ls)
        K[np.diag_indices_from(K)] += self.nv + 1e-10
        self._L = np.linalg.cholesky(K)
        self._alpha = np.linalg.solve(self._L.T,
                                      np.linalg.solve(self._L, self._y))

    # -------------------------------------------------------------- predict
    def predict(self, Xs):
        """Returns (mean, std) in the original y units."""
        Xs = np.asarray(Xs, float)
        if Xs.ndim == 1:
            Xs = Xs[None, :]
        Ks = self.sv * _matern52(Xs, self._X, self.ls)       # (m, n)
        mu = Ks @ self._alpha
        v = np.linalg.solve(self._L, Ks.T)                   # (n, m)
        var = self.sv - np.sum(v * v, axis=0)
        var = np.maximum(var, 1e-12)
        return (mu * self._std + self._mean,
                np.sqrt(var) * self._std)
