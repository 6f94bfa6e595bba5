"""Self-contained GLM / mixed-model fitting for the hierarchical compare pipeline.

statsmodels is not available in this environment, so the model families the
reference's ``HierarchicalTwoSamplesCompare`` selects between
(``statistical_analysis.py:653-885``: Poisson / NegativeBinomial / ZIP / ZINB
GLMs for counts; random-intercept LMM, log-LMM, Gamma and InverseGaussian GLMs
for continuous data) are implemented here directly:

- ``fit_glm``: IRLS with the same default links statsmodels uses
  (Poisson/NB: log; Gamma: inverse power; InverseGaussian: 1/mu^2), Wald
  z-tests from the observed information (X' W X)^-1.
- ``fit_zip`` / ``fit_zinb``: maximum likelihood with a logit zero-inflation
  part (``exog_infl="stage"``-equivalent: intercept + stage), standard errors
  from a numerical Hessian of the negative log-likelihood.
- ``fit_lmm``: random-intercept linear mixed model, REML with the variance
  ratio profiled out (1-D bounded optimization), GLS Wald test — the same
  inference ``smf.mixedlm(...).fit()`` reports for the fixed effect.

All fits take a design matrix ``X`` whose second column is the group indicator
("stage"), and report ``p_stage``, the two-sided Wald p-value of that
coefficient — what the reference reads as ``model.pvalues["stage[T.1]"]``.

Copied from ``tissue_image_processing_tpu/stats/glm.py``: host code, the
same functions and file formats; its imports name the port's modules.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, Optional

import numpy as np
from scipy import optimize, stats


@dataclass
class GLMResult:
    family: str
    coef: np.ndarray
    bse: np.ndarray
    p_values: np.ndarray
    mu: np.ndarray
    pearson_chi2: float
    df_resid: int
    converged: bool
    extra: Dict = field(default_factory=dict)

    @property
    def p_stage(self) -> float:
        return float(self.p_values[1])

    @property
    def overdispersion(self) -> float:
        return self.pearson_chi2 / max(self.df_resid, 1)


# ---------------------------------------------------------------------------
# links / variance functions (statsmodels defaults per family)
# ---------------------------------------------------------------------------

def _family_funcs(family: str, alpha: float = 1.0):
    """Returns (linkinv, dmu_deta, variance) for eta -> mu."""
    if family in ("poisson", "negbin"):
        linkinv = np.exp
        dmu_deta = np.exp
        if family == "poisson":
            var = lambda mu: mu
        else:  # NB2 with fixed alpha (statsmodels NegativeBinomial default 1.0)
            var = lambda mu: mu + alpha * mu ** 2
    elif family == "gamma":  # inverse power link: mu = 1/eta
        linkinv = lambda eta: 1.0 / eta
        dmu_deta = lambda eta: -1.0 / eta ** 2
        var = lambda mu: mu ** 2
    elif family == "invgauss":  # 1/mu^2 link: mu = eta^(-1/2)
        linkinv = lambda eta: eta ** (-0.5)
        dmu_deta = lambda eta: -0.5 * eta ** (-1.5)
        var = lambda mu: mu ** 3
    else:
        raise ValueError(f"unknown family {family!r}")
    return linkinv, dmu_deta, var


def _init_eta(y: np.ndarray, family: str) -> np.ndarray:
    mu = np.maximum((y + y.mean()) / 2.0, 1e-3)
    if family in ("poisson", "negbin"):
        return np.log(mu)
    if family == "gamma":
        return 1.0 / mu
    return 1.0 / mu ** 2  # invgauss


def fit_glm(y: np.ndarray, X: np.ndarray, family: str = "poisson",
            alpha: float = 1.0, max_iter: int = 100, tol: float = 1e-8
            ) -> GLMResult:
    """IRLS GLM fit; Wald z-tests like statsmodels GLM.fit() (scale=1 for
    count families; Pearson-estimated scale for gamma/invgauss)."""
    y = np.asarray(y, float)
    X = np.asarray(X, float)
    n, k = X.shape
    linkinv, dmu_deta, var = _family_funcs(family, alpha)
    eta = _init_eta(y, family)
    beta = np.zeros(k)
    converged = False
    for _ in range(max_iter):
        mu = linkinv(eta)
        mu = np.clip(mu, 1e-10, 1e10)
        g = dmu_deta(eta)
        v = var(mu)
        w = g ** 2 / np.maximum(v, 1e-12)
        z = eta + (y - mu) / np.where(np.abs(g) < 1e-12,
                                      np.sign(g) * 1e-12 + (g == 0), g)
        WX = X * w[:, None]
        try:
            beta_new = np.linalg.solve(X.T @ WX, WX.T @ z)
        except np.linalg.LinAlgError:
            break
        eta_new = X @ beta_new
        if family == "gamma":
            eta_new = np.maximum(eta_new, 1e-8)
        elif family == "invgauss":
            eta_new = np.maximum(eta_new, 1e-10)
        if np.max(np.abs(beta_new - beta)) < tol * (1 + np.max(np.abs(beta))):
            beta, eta = beta_new, eta_new
            converged = True
            break
        beta, eta = beta_new, eta_new
    mu = np.clip(linkinv(eta), 1e-10, 1e10)
    g = dmu_deta(eta)
    v = var(mu)
    w = g ** 2 / np.maximum(v, 1e-12)
    pearson = float(np.sum((y - mu) ** 2 / np.maximum(v, 1e-12)))
    df_resid = n - k
    scale = 1.0 if family in ("poisson", "negbin") else pearson / max(df_resid, 1)
    cov = np.linalg.pinv(X.T @ (X * w[:, None])) * scale
    bse = np.sqrt(np.maximum(np.diag(cov), 0))
    zstat = np.divide(beta, bse, out=np.zeros_like(beta), where=bse > 0)
    p = 2 * stats.norm.sf(np.abs(zstat))
    return GLMResult(family, beta, bse, p, mu, pearson, df_resid, converged)


# ---------------------------------------------------------------------------
# zero-inflated count models (logit inflation with intercept + stage)
# ---------------------------------------------------------------------------

def _zip_nll(params, y, X, Xi):
    kb = X.shape[1]
    beta, gamma = params[:kb], params[kb:]
    lam = np.exp(np.clip(X @ beta, -30, 30))
    pi = 1.0 / (1.0 + np.exp(-np.clip(Xi @ gamma, -30, 30)))
    zero = y == 0
    ll = np.empty_like(lam)
    ll[zero] = np.log(pi[zero] + (1 - pi[zero]) * np.exp(-lam[zero]) + 1e-300)
    yz = y[~zero]
    ll[~zero] = (np.log1p(-pi[~zero]) - lam[~zero] + yz * np.log(lam[~zero])
                 - _gammaln(yz + 1))
    return -np.sum(ll)


def _gammaln(x):
    from scipy.special import gammaln
    return gammaln(x)


def _zinb_nll(params, y, X, Xi):
    kb = X.shape[1]
    beta, gamma = params[:kb], params[kb:-1]
    alpha = np.exp(np.clip(params[-1], -20, 10))  # dispersion > 0
    mu = np.exp(np.clip(X @ beta, -30, 30))
    pi = 1.0 / (1.0 + np.exp(-np.clip(Xi @ gamma, -30, 30)))
    size = 1.0 / alpha
    prob = size / (size + mu)
    lognb = (_gammaln(y + size) - _gammaln(size) - _gammaln(y + 1)
             + size * np.log(prob + 1e-300) + y * np.log1p(-prob + 1e-300))
    zero = y == 0
    ll = np.empty_like(mu)
    ll[zero] = np.log(pi[zero] + (1 - pi[zero]) * np.exp(lognb[zero]) + 1e-300)
    ll[~zero] = np.log1p(-pi[~zero]) + lognb[~zero]
    return -np.sum(ll)


def _numerical_hessian(f, x0, args, eps=1e-4):
    k = len(x0)
    H = np.zeros((k, k))
    f0 = f(x0, *args)
    for i in range(k):
        for j in range(i, k):
            ei = np.zeros(k); ei[i] = eps
            ej = np.zeros(k); ej[j] = eps
            fpp = f(x0 + ei + ej, *args)
            fpm = f(x0 + ei - ej, *args)
            fmp = f(x0 - ei + ej, *args)
            fmm = f(x0 - ei - ej, *args)
            H[i, j] = H[j, i] = (fpp - fpm - fmp + fmm) / (4 * eps * eps)
    del f0
    return H


def _fit_zero_inflated(y, X, Xi, nb: bool) -> GLMResult:
    y = np.asarray(y, float)
    kb, ki = X.shape[1], Xi.shape[1]
    # warm start from the non-inflated GLM + logit of the excess-zero fraction
    base = fit_glm(y, X, "negbin" if nb else "poisson")
    pz = np.clip((y == 0).mean(), 1e-3, 1 - 1e-3)
    x0 = np.concatenate([base.coef, [np.log(pz / (1 - pz))] + [0.0] * (ki - 1)])
    nll = _zinb_nll if nb else _zip_nll
    if nb:
        x0 = np.concatenate([x0, [0.0]])  # log alpha
    res = optimize.minimize(nll, x0, args=(y, X, Xi), method="BFGS",
                            options={"maxiter": 500})
    H = _numerical_hessian(nll, res.x, (y, X, Xi))
    try:
        cov = np.linalg.pinv(H)
        bse_all = np.sqrt(np.maximum(np.diag(cov), 0))
    except np.linalg.LinAlgError:
        bse_all = np.full_like(res.x, np.nan)
    beta = res.x[:kb]
    bse = bse_all[:kb]
    zstat = np.divide(beta, bse, out=np.zeros_like(beta), where=bse > 0)
    p = 2 * stats.norm.sf(np.abs(zstat))
    mu = np.exp(np.clip(X @ beta, -30, 30))
    v = mu if not nb else mu + np.exp(res.x[-1]) * mu ** 2
    pearson = float(np.sum((y - mu) ** 2 / np.maximum(v, 1e-12)))
    fam = "zinb" if nb else "zip"
    return GLMResult(fam, beta, bse, p, mu, pearson, len(y) - len(res.x),
                     bool(res.success),
                     extra={"infl_coef": res.x[kb:kb + ki],
                            "alpha": float(np.exp(res.x[-1])) if nb else None,
                            "nll": float(res.fun)})


def fit_zip(y, X, Xi) -> GLMResult:
    """Zero-inflated Poisson (logit inflation on Xi)."""
    return _fit_zero_inflated(y, X, Xi, nb=False)


def fit_zinb(y, X, Xi) -> GLMResult:
    """Zero-inflated NB2 with estimated dispersion (statsmodels ZINBP p=2)."""
    return _fit_zero_inflated(y, X, Xi, nb=True)


# ---------------------------------------------------------------------------
# random-intercept linear mixed model (REML, profiled variance ratio)
# ---------------------------------------------------------------------------

def fit_lmm(y: np.ndarray, X: np.ndarray, groups: np.ndarray) -> GLMResult:
    """y = X b + u_group + e, u ~ N(0, s2_u), e ~ N(0, s2_e); REML fit with the
    ratio r = s2_u/s2_e profiled (1-D optimization), GLS Wald test on b."""
    y = np.asarray(y, float)
    X = np.asarray(X, float)
    groups = np.asarray(groups)
    n, k = X.shape
    _, ginv = np.unique(groups, return_inverse=True)
    ng = ginv.max() + 1
    counts = np.bincount(ginv, minlength=ng).astype(float)

    def gls(r):
        """GLS with V = I + r * Z Z' via Woodbury: V^-1 = I - Z D Z',
        D = diag(r / (1 + r*n_g))."""
        d = r / (1.0 + r * counts)

        def vinv(M):
            Msum = np.zeros((ng,) + M.shape[1:])
            np.add.at(Msum, ginv, M)
            return M - (d[:, None] * Msum if M.ndim == 2 else d * Msum)[ginv]

        ViX = vinv(X)
        Viy = vinv(y)
        XtViX = X.T @ ViX
        beta = np.linalg.solve(XtViX, X.T @ Viy)
        resid = y - X @ beta
        Vir = vinv(resid)
        rss = float(resid @ Vir)
        # REML: log|V| = sum log(1 + r*n_g); + log|X'V^-1X|
        logdetV = float(np.sum(np.log1p(r * counts)))
        sign, logdetX = np.linalg.slogdet(XtViX)
        s2 = rss / (n - k)
        reml = ((n - k) * np.log(s2) + logdetV + logdetX
                + (n - k))
        return reml, beta, XtViX, s2

    res = optimize.minimize_scalar(lambda t: gls(np.exp(t))[0],
                                   bounds=(-10, 10), method="bounded")
    r = float(np.exp(res.x))
    _, beta, XtViX, s2 = gls(r)
    cov = np.linalg.pinv(XtViX) * s2
    bse = np.sqrt(np.maximum(np.diag(cov), 0))
    zstat = np.divide(beta, bse, out=np.zeros_like(beta), where=bse > 0)
    p = 2 * stats.norm.sf(np.abs(zstat))
    mu = X @ beta
    return GLMResult("lmm", beta, bse, p, mu,
                     float(np.sum((y - mu) ** 2)), n - k, True,
                     extra={"var_ratio": r, "sigma2_e": s2,
                            "sigma2_u": r * s2, "n_groups": int(ng)})
