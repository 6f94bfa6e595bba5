"""Statistical comparison machinery.

Rebuild of the reference's test selectors (``statistical_analysis.py:220-885``):

- ``TwoSampleCompare``: normality (Shapiro for n<20 else D'Agostino) + Levene ->
  Student / Welch t-test or Mann-Whitney U (``:220-335``).
- ``TwoByTwoCompare``: 2x2 factorial — two-way ANOVA when both factors' residuals
  look normal, otherwise Scheirer-Ray-Hare on ranks; Tukey HSD or Dunn post-hoc
  (``:337-651``). statsmodels/scikit-posthocs are not available in this environment,
  so the two-way ANOVA, SRH and Dunn tests are computed directly (standard formulas
  on sums of squares / rank sums); Tukey uses scipy.stats.tukey_hsd.
- ``HierarchicalTwoSamplesCompare``: the reference's GLMM model-selection pipeline
  (``:653-885``), with the model fits implemented directly in ``stats/glm.py``
  (statsmodels is not available in this environment): counts route to
  Poisson / negative-binomial / ZIP / ZINB by overdispersion and zero-inflation
  checks, continuous data to LMM / log-LMM / Gamma / InvGauss GLM by Shapiro +
  skew — real IRLS / ML / REML fits, with Wald z on the stage coefficient.

Copied from ``tissue_image_processing_tpu/stats/compare.py``: host code, the
same functions and file formats; its imports name the port's modules.
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional, Sequence

import numpy as np
import pandas as pd
from scipy import stats

__all__ = ["TwoSampleCompare", "TwoByTwoCompare", "HierarchicalTwoSamplesCompare",
           "two_way_anova", "scheirer_ray_hare", "dunn_test"]


def _is_normal(x: np.ndarray, alpha: float = 0.05) -> bool:
    x = np.asarray(x, float)
    if x.size < 3:
        return True
    if x.size < 20:
        return stats.shapiro(x).pvalue > alpha
    return stats.normaltest(x).pvalue > alpha


class TwoSampleCompare:
    """Pick and run the right two-sample test (reference
    ``statistical_analysis.py:220-335``)."""

    def __init__(self, sample1, sample2, labels=("sample1", "sample2"),
                 alpha: float = 0.05):
        self.s1 = np.asarray(sample1, float)
        self.s2 = np.asarray(sample2, float)
        self.labels = labels
        self.alpha = alpha
        self.result = self.compare()

    def compare(self) -> Dict:
        normal = _is_normal(self.s1, self.alpha) and _is_normal(self.s2, self.alpha)
        equal_var = stats.levene(self.s1, self.s2).pvalue > self.alpha \
            if min(self.s1.size, self.s2.size) > 1 else True
        if normal:
            test = "Student t-test" if equal_var else "Welch t-test"
            stat, p = stats.ttest_ind(self.s1, self.s2, equal_var=equal_var)
        else:
            test = "Mann-Whitney U"
            stat, p = stats.mannwhitneyu(self.s1, self.s2, alternative="two-sided")
        return {
            "test": test, "statistic": float(stat), "p_value": float(p),
            "normal": normal, "equal_variance": bool(equal_var),
            "n1": int(self.s1.size), "n2": int(self.s2.size),
            "mean1": float(np.mean(self.s1)) if self.s1.size else np.nan,
            "mean2": float(np.mean(self.s2)) if self.s2.size else np.nan,
            "significant": bool(p < self.alpha),
        }

    def to_row(self) -> pd.DataFrame:
        row = dict(self.result)
        row["label1"], row["label2"] = self.labels
        return pd.DataFrame([row])

    def append_to_table(self, path: str) -> str:
        """Append the result row to an xlsx/csv log (reference
        ``_append_row_to_excel``, ``statistical_analysis.py:167-218``)."""
        import os

        from tissue_image_processing_tpu_torch.core.export import write_table

        row = self.to_row()
        target = path if not path.endswith(".xlsx") else path
        existing = None
        for candidate in (target, target.replace(".xlsx", ".csv")):
            if os.path.isfile(candidate):
                existing = (pd.read_excel(candidate) if candidate.endswith(".xlsx")
                            else pd.read_csv(candidate))
                break
        df = pd.concat([existing, row], ignore_index=True) if existing is not None else row
        return write_table(df, target)


def two_way_anova(values: np.ndarray, a: np.ndarray, b: np.ndarray) -> pd.DataFrame:
    """Balanced/unbalanced two-way ANOVA with interaction (type-I SS via nested
    group means, adequate for the reference's 2x2 designs)."""
    values = np.asarray(values, float)
    a = np.asarray(a)
    b = np.asarray(b)
    grand = values.mean()
    ss_total = ((values - grand) ** 2).sum()
    a_levels = np.unique(a)
    b_levels = np.unique(b)
    ss_a = sum(((values[a == la].mean() - grand) ** 2) * (a == la).sum()
               for la in a_levels)
    ss_b = sum(((values[b == lb].mean() - grand) ** 2) * (b == lb).sum()
               for lb in b_levels)
    ss_cells = 0.0
    ss_err = 0.0
    n_cells = 0
    for la in a_levels:
        for lb in b_levels:
            sel = (a == la) & (b == lb)
            if sel.sum() == 0:
                continue
            n_cells += 1
            cm = values[sel].mean()
            ss_cells += sel.sum() * (cm - grand) ** 2
            ss_err += ((values[sel] - cm) ** 2).sum()
    ss_ab = ss_cells - ss_a - ss_b
    df_a = len(a_levels) - 1
    df_b = len(b_levels) - 1
    df_ab = df_a * df_b
    df_err = values.size - n_cells
    rows = []
    for name, ss, df in [("A", ss_a, df_a), ("B", ss_b, df_b),
                         ("A:B", ss_ab, df_ab)]:
        ms = ss / df if df else np.nan
        mse = ss_err / df_err if df_err else np.nan
        f = ms / mse if mse else np.nan
        p = 1 - stats.f.cdf(f, df, df_err) if np.isfinite(f) else np.nan
        rows.append({"factor": name, "ss": ss, "df": df, "F": f, "p_value": p})
    rows.append({"factor": "Residual", "ss": ss_err, "df": df_err,
                 "F": np.nan, "p_value": np.nan})
    return pd.DataFrame(rows)


def scheirer_ray_hare(values: np.ndarray, a: np.ndarray, b: np.ndarray) -> pd.DataFrame:
    """Nonparametric two-way test on ranks (reference uses this when normality
    fails, ``statistical_analysis.py:337-651``)."""
    ranks = stats.rankdata(values)
    df = two_way_anova(ranks, a, b)
    n = len(ranks)
    ms_total = ((ranks - ranks.mean()) ** 2).sum() / (n - 1)
    rows = []
    for _, row in df.iterrows():
        if row["factor"] == "Residual":
            continue
        h = row["ss"] / ms_total
        p = 1 - stats.chi2.cdf(h, row["df"])
        rows.append({"factor": row["factor"], "H": h, "df": row["df"], "p_value": p})
    return pd.DataFrame(rows)


def dunn_test(groups: Sequence[np.ndarray], labels: Optional[Sequence[str]] = None
              ) -> pd.DataFrame:
    """Dunn's post-hoc z-tests on pooled ranks with Bonferroni correction."""
    labels = list(labels or range(len(groups)))
    all_vals = np.concatenate([np.asarray(g, float) for g in groups])
    ranks = stats.rankdata(all_vals)
    n = all_vals.size
    idx = 0
    mean_ranks, sizes = [], []
    for g in groups:
        k = len(g)
        mean_ranks.append(ranks[idx:idx + k].mean())
        sizes.append(k)
        idx += k
    # tie correction
    _, counts = np.unique(all_vals, return_counts=True)
    tie_sum = np.sum(counts ** 3 - counts)
    rows = []
    m = len(groups) * (len(groups) - 1) // 2
    for i in range(len(groups)):
        for j in range(i + 1, len(groups)):
            se = math.sqrt((n * (n + 1) / 12.0 - tie_sum / (12.0 * (n - 1)))
                           * (1.0 / sizes[i] + 1.0 / sizes[j]))
            z = (mean_ranks[i] - mean_ranks[j]) / se if se else np.nan
            p = 2 * (1 - stats.norm.cdf(abs(z)))
            rows.append({"group1": labels[i], "group2": labels[j], "z": z,
                         "p_value": min(p * m, 1.0)})
    return pd.DataFrame(rows)


class TwoByTwoCompare:
    """2x2 factorial comparison (reference ``TwoByTwoCompare``,
    ``statistical_analysis.py:337-651``)."""

    def __init__(self, samples: Dict[tuple, np.ndarray], alpha: float = 0.05):
        """samples: {(factorA_level, factorB_level): values}."""
        self.samples = {k: np.asarray(v, float) for k, v in samples.items()}
        self.alpha = alpha
        self.result = self.compare()

    def compare(self) -> Dict:
        values = np.concatenate(list(self.samples.values()))
        a = np.concatenate([[k[0]] * len(v) for k, v in self.samples.items()])
        b = np.concatenate([[k[1]] * len(v) for k, v in self.samples.items()])
        normal = all(_is_normal(v, self.alpha) for v in self.samples.values()
                     if v.size >= 3)
        if normal:
            table = two_way_anova(values, a, b)
            method = "two-way ANOVA"
            post = stats.tukey_hsd(*self.samples.values())
            post_p = np.asarray(post.pvalue)
        else:
            table = scheirer_ray_hare(values, a, b)
            method = "Scheirer-Ray-Hare"
            post_df = dunn_test(list(self.samples.values()),
                                [str(k) for k in self.samples])
            post_p = post_df
        return {"method": method, "table": table, "posthoc": post_p,
                "normal": normal}


class HierarchicalTwoSamplesCompare:
    """Hierarchical (per biological repeat) two-sample comparison with the
    reference's exact model-selection routing (``statistical_analysis.py:653-885``):

    counts: fit Poisson GLM ``measurement ~ stage``; overdispersion = Pearson
    chi^2 / df_resid of that fit (threshold 1.5); zero-inflation = observed zero
    fraction > 1.5 * exp(-mean). Routes to Poisson / NB / ZIP / ZINB and reports
    the Wald p-value of the stage coefficient.

    continuous: Shapiro normality + skew on the pooled measurements; normal ->
    random-intercept LMM (replicate = biological repeat, shared across stages
    like the reference's ``R{group}`` labels); all-positive -> log-LMM; else
    Gamma GLM (skew <= 2) or InverseGaussian GLM (skew > 2).

    The fits are our own IRLS / ML / REML implementations (stats/glm.py);
    statsmodels is not available here.
    """

    def __init__(self, groups1: Sequence[np.ndarray], groups2: Sequence[np.ndarray],
                 kind: str = "continuous", alpha: float = 0.05):
        """groups1/groups2: one array per biological repeat."""
        self.g1 = [np.asarray(g, float) for g in groups1]
        self.g2 = [np.asarray(g, float) for g in groups2]
        self.kind = kind
        self.alpha = alpha
        self.result = self.compare()

    def _design(self):
        y = np.concatenate(self.g1 + self.g2)
        stage = np.concatenate([np.zeros(sum(g.size for g in self.g1)),
                                np.ones(sum(g.size for g in self.g2))])
        # replicate labels repeat across stages (reference: f"R{group}")
        rep = np.concatenate([np.full(g.size, i) for i, g in enumerate(self.g1)]
                             + [np.full(g.size, i) for i, g in enumerate(self.g2)])
        X = np.column_stack([np.ones_like(y), stage])
        return y, X, rep

    def compare(self) -> Dict:
        from tissue_image_processing_tpu_torch.stats.glm import (
            fit_glm, fit_lmm, fit_zinb, fit_zip)

        y, X, rep = self._design()
        if self.kind == "counts":
            pois = fit_glm(y, X, "poisson")
            overdisp = pois.overdispersion
            zero_inf = bool((y == 0).mean() > np.exp(-y.mean()) * 1.5)
            if zero_inf:
                if overdisp > 1.5:
                    model, family = fit_zinb(y, X, X), "zero-inflated negative binomial"
                else:
                    model, family = fit_zip(y, X, X), "zero-inflated poisson"
            else:
                if overdisp > 1.5:
                    model, family = fit_glm(y, X, "negbin"), "negative binomial"
                else:
                    model, family = pois, "poisson"
            p = model.p_stage
            return {"family": family, "test": "Wald z on stage coefficient",
                    "statistic": float(model.coef[1] / model.bse[1])
                    if model.bse[1] > 0 else 0.0,
                    "p_value": p, "overdispersion": float(overdisp),
                    "zero_inflation": zero_inf, "model": model,
                    "significant": bool(p < self.alpha)}
        # continuous: Shapiro + skew routing, identical branch order to the
        # reference (p_norm > 0.05 & |skew| < 1 -> LMM; all positive -> log-LMM;
        # else skew > 2 -> InvGauss GLM, otherwise Gamma GLM)
        # subsample at random for huge n — taking the FIRST 5000 of
        # concat(g1, g2) would test one group only
        y_norm = (y if y.size <= 5000 else
                  y[np.random.default_rng(0).choice(y.size, 5000, replace=False)])
        p_norm = float(stats.shapiro(y_norm)[1])
        sk = float(stats.skew(y))
        if p_norm > 0.05 and abs(sk) < 1:
            model, family = fit_lmm(y, X, rep), "LMM (normal)"
        elif (y > 0).all():
            model, family = fit_lmm(np.log(y), X, rep), "log-LMM"
        else:
            # reference feeds y straight to the GLM here; clip to positive so
            # the variance function is defined (its statsmodels call would fail)
            yp = np.maximum(y, 1e-8)
            if sk > 2:
                model, family = fit_glm(yp, X, "invgauss"), "InvGauss GLMM"
            else:
                model, family = fit_glm(yp, X, "gamma"), "Gamma GLMM"
        p = model.p_stage
        return {"family": family, "test": "Wald z on stage coefficient",
                "statistic": float(model.coef[1] / model.bse[1])
                if model.bse[1] > 0 else 0.0,
                "p_value": p, "normality_p": p_norm, "skewness": sk,
                "model": model, "significant": bool(p < self.alpha)}
