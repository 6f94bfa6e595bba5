"""PyTorch port vs the JAX package: ``stats/``, ``core/shape_fit.py``,
``core/export.write_table`` and ``models/sanity_check.py``.

The cases of ``tests/test_stats_and_shapes.py`` run through both packages
on the same seeded data. ``stats/`` and ``shape_fit`` are host numpy /
scipy / pandas code that the port copies, so every number is compared
exactly (the same code on the same inputs), and the JAX test's own
assertions are held on the port's results. ``sanity_check.main`` runs the
port's predictor on the CPU at ``--crop 64`` on a small TIFF and writes its
PNG (matplotlib is optional, as in the JAX package).
"""

import os

import numpy as np
import pandas as pd
import pytest
import torch

from tissue_image_processing_tpu.core import shape_fit as j_shape
from tissue_image_processing_tpu.stats import compare as j_compare
from tissue_image_processing_tpu.stats import glm as j_glm
from tissue_image_processing_tpu_torch.core import shape_fit as t_shape
from tissue_image_processing_tpu_torch.stats import compare as t_compare
from tissue_image_processing_tpu_torch.stats import glm as t_glm

# one intra-op thread: the test workers share the cores with each other
# and with XLA's device threads
torch.set_num_threads(1)


def _rng():
    return np.random.default_rng(0)


def _same(a, b):
    """Exact equality of nested results (dicts, tuples, arrays, frames,
    GLM results); NaN equals NaN."""
    if isinstance(a, pd.DataFrame):
        pd.testing.assert_frame_equal(a, b, check_exact=True)
    elif isinstance(a, dict):
        assert list(a) == list(b)
        for k in a:
            _same(a[k], b[k])
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            _same(x, y)
    elif hasattr(a, "coef"):  # GLMResult
        assert type(a).__name__ == type(b).__name__ == "GLMResult"
        _same(vars(a), vars(b))
    elif isinstance(a, (np.ndarray, float, int, np.floating, np.integer)):
        np.testing.assert_array_equal(a, b)
    elif hasattr(a, "pvalue"):  # scipy's TukeyHSDResult
        np.testing.assert_array_equal(a.pvalue, b.pvalue)
    else:
        assert a == b


def _both(name, *args, **kwargs):
    """Run ``name`` of ``stats/compare`` in each package on the same
    inputs; results equal; returns the port's."""
    got = getattr(t_compare, name)(*args, **kwargs)
    want = getattr(j_compare, name)(*args, **kwargs)
    _same(getattr(got, "result", got), getattr(want, "result", want))
    return getattr(got, "result", got)


def test_two_sample_normal_picks_t():
    rng = _rng()
    r = _both("TwoSampleCompare", rng.normal(0, 1, 100), rng.normal(1.0, 1, 100))
    assert "t-test" in r["test"]
    assert r["p_value"] < 0.001 and r["significant"]


def test_two_sample_nonnormal_picks_mannwhitney(tmp_path):
    rng = _rng()
    a, b = rng.exponential(1.0, 200), rng.exponential(1.0, 200)
    r = _both("TwoSampleCompare", a, b)
    assert r["test"] == "Mann-Whitney U"
    assert r["p_value"] > 0.01
    # the appended result row, written through the port's write_table
    cmp = t_compare.TwoSampleCompare(a, b, labels=("a", "b"))
    path = cmp.append_to_table(str(tmp_path / "log.xlsx"))
    path = cmp.append_to_table(path)
    table = pd.read_csv(path)
    assert len(table) == 2 and list(table["label1"]) == ["a", "a"]


def _anova_data():
    rng = _rng()
    vals, fa, fb = [], [], []
    for a in (0, 1):
        for b in (0, 1):
            vals.append(rng.normal(2.0 * a, 1, 50))
            fa += [a] * 50
            fb += [b] * 50
    return np.concatenate(vals), np.array(fa), np.array(fb)


def test_two_way_anova_detects_main_effect():
    table = _both("two_way_anova", *_anova_data())
    pa = table.query('factor == "A"').p_value.iloc[0]
    pb = table.query('factor == "B"').p_value.iloc[0]
    assert pa < 1e-6 and pb > 0.01


def test_scheirer_ray_hare_runs():
    vals = _rng().exponential(1, 80)
    a = np.repeat([0, 1], 40)
    b = np.tile(np.repeat([0, 1], 20), 2)
    out = _both("scheirer_ray_hare", vals, a, b)
    assert set(out.factor) == {"A", "B", "A:B"}
    assert ((out.p_value >= 0) & (out.p_value <= 1)).all()


def test_dunn_test():
    rng = _rng()
    groups = [rng.normal(0, 1, 60), rng.normal(0, 1, 60), rng.normal(3, 1, 60)]
    out = _both("dunn_test", groups, ["a", "b", "c"])
    p_ab = out.query('group1 == "a" and group2 == "b"').p_value.iloc[0]
    p_ac = out.query('group1 == "a" and group2 == "c"').p_value.iloc[0]
    assert p_ab > 0.05 and p_ac < 0.001


@pytest.mark.parametrize("dist", ["normal", "exponential"])
def test_two_by_two_compare(dist):
    rng = _rng()
    draw = (lambda a: rng.normal(a * 2.0, 1, 40)) if dist == "normal" else (
        lambda a: rng.exponential(1.0 + 3 * a, 40))
    samples = {(a, b): draw(a) for a in (0, 1) for b in (0, 1)}
    r = _both("TwoByTwoCompare", samples)
    assert r["method"] == ("two-way ANOVA" if dist == "normal"
                           else "Scheirer-Ray-Hare")
    assert r["table"].query('factor == "A"').iloc[0, -1] < 0.001


def _counts(kind):
    rng = _rng()
    if kind == "rates":
        return ([rng.poisson(2.0, 50) for _ in range(4)],
                [rng.poisson(5.0, 50) for _ in range(4)])
    if kind == "poisson":
        return ([rng.poisson(3.0, 60) for _ in range(4)],
                [rng.poisson(3.2, 60) for _ in range(4)])
    if kind == "negbin":
        def nb(n):
            return rng.poisson(rng.gamma(2.0, 3.0, n)) + 1
        return [nb(80) for _ in range(4)], [nb(80) + 2 for _ in range(4)]
    assert kind == "zip"

    def zip_draw(n):
        y = rng.poisson(4.0, n)
        y[rng.random(n) < 0.5] = 0
        return y
    return [zip_draw(100) for _ in range(3)], [zip_draw(100) for _ in range(3)]


@pytest.mark.parametrize("kind,family", [
    ("rates", None), ("poisson", "poisson"), ("negbin", "negative binomial"),
    ("zip", "zero-inflated")])
def test_hierarchical_counts_routing(kind, family):
    g1, g2 = _counts(kind)
    r = _both("HierarchicalTwoSamplesCompare", g1, g2, kind="counts")
    if kind == "rates":
        assert r["p_value"] < 0.01
        assert "binomial" in r["family"] or "poisson" in r["family"]
    elif kind == "zip":
        assert r["zero_inflation"] and family in r["family"]
        assert r["p_value"] > 0.01
    else:
        assert r["family"] == family
        assert (r["overdispersion"] > 1.5) == (kind == "negbin")


@pytest.mark.parametrize("kind,family", [
    ("normal", "LMM (normal)"), ("lognormal", "log-LMM"),
    ("skewed", None)])
def test_hierarchical_continuous_routing(kind, family):
    rng = _rng()
    if kind == "normal":
        g1 = [rng.normal(10, 1, 60) for _ in range(4)]
        g2 = [rng.normal(12, 1, 60) for _ in range(4)]
    elif kind == "lognormal":
        g1 = [np.exp(rng.normal(0, 1.1, 60)) for _ in range(4)]
        g2 = [np.exp(rng.normal(0.8, 1.1, 60)) for _ in range(4)]
    else:  # values at or below zero and skewed: the Gamma / InvGauss GLMs
        g1 = [rng.exponential(1.0, 60) - 0.05 for _ in range(4)]
        g2 = [rng.exponential(2.0, 60) - 0.05 for _ in range(4)]
    r = _both("HierarchicalTwoSamplesCompare", g1, g2, kind="continuous")
    if family:
        assert r["family"] == family
    else:
        assert r["family"] in ("Gamma GLMM", "InvGauss GLMM")
    assert r["p_value"] < 1e-3


def test_glm_poisson_recovers_rate_ratio():
    rng = _rng()
    y = np.concatenate([rng.poisson(2.0, 400), rng.poisson(6.0, 400)])
    X = np.column_stack([np.ones(800), np.r_[np.zeros(400), np.ones(400)]])
    res = t_glm.fit_glm(y, X, "poisson")
    _same(res, j_glm.fit_glm(y, X, "poisson"))
    assert res.converged
    assert abs(np.exp(res.coef[1]) - 3.0) < 0.4
    assert res.p_stage < 1e-6
    assert 0.7 < res.overdispersion < 1.3
    for family in ("negbin", "gamma", "invgauss"):
        _same(t_glm.fit_glm(y + 1.0, X, family), j_glm.fit_glm(y + 1.0, X, family))


def test_lmm_random_intercept_widens_se():
    rng = _rng()
    offs = rng.normal(0, 3.0, 6)
    y, stage, rep = [], [], []
    for i, o in enumerate(offs):
        y.append(rng.normal(o, 1.0, 40))
        stage.append(np.full(40, i % 2))
        rep.append(np.full(40, i))
    y, stage, rep = map(np.concatenate, (y, stage, rep))
    X = np.column_stack([np.ones_like(y), stage])
    res = t_glm.fit_lmm(y, X, rep)
    _same(res, j_glm.fit_lmm(y, X, rep))
    assert res.extra["var_ratio"] > 1.0
    assert res.bse[1] > 3 * np.sqrt(8 / len(y))


def _points(shape):
    if shape == "line":
        x = np.linspace(0, 10, 30)
        return x, 2.0 * x + 1.0 + np.random.default_rng(0).normal(0, 0.01, 30)
    if shape == "steep line":
        y = np.linspace(0, 10, 30)
        return 0.2 * y + 3.0 + np.random.default_rng(1).normal(0, 0.01, 30), y
    if shape == "circle":
        t = np.linspace(0, 2 * np.pi, 40, endpoint=False)
        return 5 + 3 * np.cos(t), -2 + 3 * np.sin(t)
    if shape == "circle arc":
        t = np.linspace(0.3, 1.5, 25)
        return 10 + 8 * np.cos(t), 4 + 8 * np.sin(t)
    if shape == "ellipse":
        t = np.linspace(0, 2 * np.pi, 60, endpoint=False)
        a, b, phi = 6.0, 3.0, 0.5
        return (a * np.cos(t) * np.cos(phi) - b * np.sin(t) * np.sin(phi) + 20,
                a * np.cos(t) * np.sin(phi) + b * np.sin(t) * np.cos(phi) + 10)
    assert shape == "spline"
    x = np.linspace(0, 20, 40)
    return x, np.sin(x / 3.0) * 5


@pytest.mark.parametrize("shape", ["line", "steep line", "circle",
                                   "circle arc", "ellipse", "spline"])
def test_shape_fits_match_jax(shape):
    x, y = _points(shape)
    fit = shape.replace("steep ", "")
    got = t_shape.fit_shape(fit, list(zip(x, y)), normalization=[2.0, 4.0])
    _same(got, j_shape.fit_shape(fit, list(zip(x, y)), normalization=[2.0, 4.0]))
    res, curve = t_shape._FITS[fit](x, y)
    assert curve.shape[1] == 2
    if shape == "line":
        assert abs(res["slope"][0] - 2.0) < 0.01 and res["slope"][1] < 0.01
        assert abs(res["y cross"][0] - 1.0) < 0.05
    elif shape == "steep line":
        assert abs(res["slope"][0] - 5.0) < 0.05
    elif shape == "circle":
        assert abs(res["radius"][0] - 3.0) < 1e-3
        assert abs(res["x_center"][0] - 5.0) < 1e-3
        assert abs(res["y_center"][0] + 2.0) < 1e-3
    elif shape == "circle arc":
        assert abs(res["curvature"][0] - 1 / 8.0) < 1e-3
    elif shape == "ellipse":
        assert abs(res["semi-major"][0] - 6.0) < 0.05
        assert abs(res["semi-minor"][0] - 3.0) < 0.05
        assert abs(res["center x"][0] - 20) < 0.1
        assert abs(res["center y"][0] - 10) < 0.1
    else:
        assert res["N"][0] == 40
    assert t_shape.calc_standard_error([1.0, 2.0], np.eye(2)) == \
        j_shape.calc_standard_error([1.0, 2.0], np.eye(2))


def test_data_collector_matches_jax(tmp_path):
    from tissue_image_processing_tpu.stats.collect import DataCollector as JDC
    from tissue_image_processing_tpu_torch.stats.collect import DataCollector

    rng = _rng()
    for grp, mean in [("expA", 0.0), ("expB", 3.0)]:
        d = tmp_path / grp
        os.makedirs(d)
        for i in range(2):
            pd.DataFrame({"area": rng.normal(mean, 1, 30)}).to_pickle(
                d / f"area_division_data_{i}")
        (d / "area_broken").write_bytes(b"not a pickle")
    folders = [str(tmp_path / "expA"), str(tmp_path / "expB")]
    dc = DataCollector(folders, "area_*", "area")
    jdc = JDC(folders, "area_*", "area")
    _same(dc.samples, jdc.samples)
    _same(dc.normalized("median"), jdc.normalized("median"))
    stats_df = dc.group_stats()
    _same(stats_df, jdc.group_stats())
    assert stats_df.n.tolist() == [60, 60]
    assert abs(stats_df.iloc[1]["mean"] - 3.0) < 0.5
    assert dc.ratio_of_samples("expB", "expA") == jdc.ratio_of_samples(
        "expB", "expA")
    out = dc.export(str(tmp_path / "samples.xlsx"))
    assert out == jdc.export(str(tmp_path / "samples_j.xlsx")).replace(
        "samples_j", "samples")
    pd.testing.assert_frame_equal(pd.read_csv(out),
                                  pd.read_csv(out.replace("samples", "samples_j")))


def test_compare_and_plot():
    pytest.importorskip("matplotlib")
    import matplotlib
    matplotlib.use("Agg")
    from tissue_image_processing_tpu.stats.plots import (
        compare_and_plot_samples as j_plot)
    from tissue_image_processing_tpu_torch.stats.plots import (
        compare_and_plot_samples)

    rng = _rng()
    samples = {"a": rng.normal(0, 1, 50), "b": rng.normal(2, 1, 50),
               "c": rng.normal(0.2, 1, 50)}
    for kind in ("violin", "bar", "box", "histogram"):
        ax, results = compare_and_plot_samples(samples, kind=kind)
        _same(results, j_plot(samples, kind=kind)[1])
    ax, results = compare_and_plot_samples(samples, kind="violin")
    assert results[("a", "b")]["p_value"] < 0.001
    assert ax.get_xticklabels()[0].get_text() == "a"


def test_sanity_check_writes_png(tmp_path):
    pytest.importorskip("matplotlib")
    from tissue_image_processing_tpu_torch.io.tiff import save_tiff
    from tissue_image_processing_tpu_torch.models import sanity_check
    from tissue_image_processing_tpu_torch.utils.synthetic import make_movie

    frame = make_movie(T=1, Z=1, H=96, W=80, seed=3)[0, :, 0]  # (2, 96, 80)
    save_tiff(str(tmp_path / "image.tif"), frame.astype(np.uint16), axes="CYX")
    labels = (frame[0] > frame[0].mean()).astype(np.uint8) + 1
    save_tiff(str(tmp_path / "labels.tif"), np.stack([labels, labels]),
              axes="CYX")
    out = str(tmp_path / "sanity.png")
    assert sanity_check.main([str(tmp_path / "image.tif"),
                              str(tmp_path / "labels.tif"), "--crop", "64",
                              "--out", out], device="cpu") == 0
    with open(out, "rb") as f:
        assert f.read(8) == b"\x89PNG\r\n\x1a\n"
