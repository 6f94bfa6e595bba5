"""Least-squares shape fitting with full covariance error propagation.

Host-side rebuild of the reference's click-driven shape fits
(``tissue_info.py:3029-3460``): line, smoothing spline with knot-count search,
circle arc, ellipse (conic -> canonical with analytic derivatives) and circle.
Each fit returns the reference's results dict {param: (value, stderr)} plus the
fitted curve coordinates for rendering (the reference drew onto a matplotlib axis).

Copied from ``tissue_image_processing_tpu/core/shape_fit.py``: host code,
the same functions and file formats; its imports name the port's modules.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np

__all__ = ["fit_a_line", "fit_a_spline", "fit_a_circle", "fit_a_circle_arc",
           "fit_an_ellipse", "fit_shape", "calc_standard_error"]


def calc_standard_error(der: np.ndarray, cov: np.ndarray) -> float:
    """sqrt(der^T C der) (reference ``calc_standard_error``,
    ``tissue_info.py:3050-3054``)."""
    der = np.asarray(der, float).reshape(-1)
    return float(np.sqrt(der @ cov @ der))


def fit_a_line(X, Y, norm_factor: float = 1.0):
    """(reference ``fit_a_line``, ``tissue_info.py:3076-3128``)."""
    X = np.asarray(X, float)
    Y = np.asarray(Y, float)
    horizontal = np.ptp(X) > np.ptp(Y)
    if horizontal:
        params, cov = np.polyfit(X, Y, 1, cov=True)
        slope, y_cross = params[0], params[1]
        x_cross = -params[1] / params[0]
        perr = np.sqrt(np.diagonal(cov))
        slope_err, y_cross_err = perr[0], perr[1]
        x_cross_der = np.array([params[1] / params[0] ** 2, -1 / params[0]])
        x_cross_err = float(np.sqrt(np.sum((perr * x_cross_der) ** 2)))
        chi_sqr = np.sum((Y - params[0] * X - params[1]) ** 2) / (params[0] ** 2 + 1)
        xs = np.linspace(X.min(), X.max(), 300)
        curve = np.stack([xs, slope * xs + y_cross], 1)
    else:
        params, cov = np.polyfit(Y, X, 1, cov=True)
        slope = 1 / params[0]
        y_cross = -params[1] / params[0]
        x_cross = params[1]
        perr = np.sqrt(np.diagonal(cov))
        slope_err = perr[0] * slope ** 2
        x_cross_err = perr[1]
        y_cross_der = np.array([params[1] / params[0] ** 2, -1 / params[0]])
        y_cross_err = float(np.sqrt(np.sum((perr * y_cross_der) ** 2)))
        chi_sqr = np.sum((X - params[0] * Y - params[1]) ** 2) / (params[0] ** 2 + 1)
        ys = np.linspace(Y.min(), Y.max(), 300)
        curve = np.stack([ys / slope + x_cross, ys], 1)
    chi_sqr /= norm_factor * X.size
    res = {"slope": (float(slope), float(slope_err)),
           "x cross": (float(x_cross), float(x_cross_err)),
           "y cross": (float(y_cross), float(y_cross_err)),
           "Chi square": (float(chi_sqr), 0.0), "N": (int(X.size), 0)}
    return res, curve


def fit_a_spline(X, Y, norm_factor: float = 1.0, cells_per_knot: int = 10,
                 max_iter: int = 100):
    """Smoothing spline with binary search for the target knot count (reference
    ``fit_a_spline``, ``tissue_info.py:3130-3207``)."""
    from scipy.interpolate import UnivariateSpline

    X = np.asarray(X, float)
    Y = np.asarray(Y, float)
    horizontal = np.ptp(X) > np.ptp(Y)
    params = np.polyfit(X, Y, 1) if horizontal else np.polyfit(Y, X, 1)
    slope = params[0] if horizontal else 1 / params[0]
    ox, oy = X.mean(), Y.mean()
    angle = -np.arctan(slope)
    rot_x = ox + np.cos(angle) * (X - ox) - np.sin(angle) * (Y - oy)
    rot_y = oy + np.sin(angle) * (X - ox) + np.cos(angle) * (Y - oy)
    order = np.argsort(rot_x)
    rx, ry = rot_x[order], rot_y[order]
    knots = X.size // cells_per_knot + 2
    s = float(X.size)
    got = -1
    factor = 2.0
    was_big = was_small = False
    it = 0
    spline = None
    while got != knots and it < max_iter:
        spline = UnivariateSpline(rx, ry, s=s)
        got = spline.get_knots().size
        if got < knots:
            was_small = True
            if was_big:
                factor -= (factor - 1) / 2
                was_small = False
            s /= factor
        elif got > knots:
            was_big = True
            if was_small:
                factor -= (factor - 1) / 2
                was_big = False
            s *= factor
        it += 1
    chi_sqr = spline.get_residual() / (X.size * norm_factor)
    xs = np.linspace(rx.min(), rx.max(), 300)
    ys = spline(xs)
    curve_x = ox + np.cos(angle) * (xs - ox) + np.sin(angle) * (ys - oy)
    curve_y = oy - np.sin(angle) * (xs - ox) + np.cos(angle) * (ys - oy)
    res = {"Chi square": (float(chi_sqr), 0.0), "N": (int(X.size), 0),
           "knots": (int(got), 0)}
    return res, np.stack([curve_x, curve_y], 1)


def fit_a_circle(X, Y, norm_factor: float = 1.0):
    """(reference ``fit_a_circle``, ``tissue_info.py:3382-3438``)."""
    X = np.asarray(X, float)
    Y = np.asarray(Y, float)
    sx, sy = X - X.mean(), Y - Y.mean()
    rescale = abs(max(sx.max(), sy.max()))
    rx, ry = sx / rescale, sy / rescale
    A = np.column_stack([rx ** 2 + ry ** 2, rx, ry])
    b = np.ones_like(rx)
    params, residuals, _, _ = np.linalg.lstsq(A, b, rcond=None)
    chi_sqr = float(residuals[0]) if residuals.size else 0.0
    cov = np.linalg.inv(A.T @ A) * chi_sqr / max(X.size - 3, 1)
    xc = -params[1] / (2 * params[0])
    yc = -params[2] / (2 * params[0])
    radius = np.sqrt(1 / params[0] + xc ** 2 + yc ** 2)
    xc_der = np.array([2 * params[1] / params[0] ** 2, -2 / params[0], 0])
    yc_der = np.array([2 * params[2] / params[0] ** 2, 0, -2 / params[0]])
    r_der = (1 / (2 * radius)) * (2 * xc * xc_der + 2 * yc * yc_der
                                  + np.array([-1 / params[0] ** 2, 0, 0]))
    xc_err = calc_standard_error(xc_der, cov)
    yc_err = calc_standard_error(yc_der, cov)
    r_err = calc_standard_error(r_der, cov)
    radius *= rescale
    xc = xc * rescale + X.mean()
    yc = yc * rescale + Y.mean()
    angle = np.linspace(0, 2 * np.pi, 100)
    curve = np.stack([xc + radius * np.cos(angle), yc + radius * np.sin(angle)], 1)
    res = {"radius": (float(radius), float(r_err * rescale)),
           "x_center": (float(xc), float(xc_err * rescale)),
           "y_center": (float(yc), float(yc_err * rescale)),
           "Chi square": (float(chi_sqr), 0.0), "N": (int(X.size), 0)}
    return res, curve


def fit_a_circle_arc(X, Y, norm_factor: float = 1.0):
    """(reference ``fit_a_circle_arc``, ``tissue_info.py:3209-3287``)."""
    X = np.asarray(X, float)
    Y = np.asarray(Y, float)
    rescale = abs(max(X.max(), Y.max()))
    rx = (X - X.mean()) / rescale
    ry = (Y - Y.mean()) / rescale
    A = np.column_stack([rx ** 2 + ry ** 2, rx, ry])
    b = np.ones_like(rx)
    params = np.linalg.lstsq(A, b, rcond=None)[0].squeeze()
    cov = np.linalg.inv(A.T @ A)
    span2 = np.ptp(rx) ** 2 + np.ptp(ry) ** 2
    linear = params[0] * span2 < 0.01
    curvature = 1 / np.sqrt(1 / params[0]
                            + 0.25 * (params[1] ** 2 + params[2] ** 2) / params[0] ** 2)
    slope = -params[1] / params[2]
    if linear:
        chi_sqr = np.sum((params[1] * X + params[2] * Y - 1) ** 2) / \
            (params[1] ** 2 + params[2] ** 2)
    else:
        chi_sqr = np.sum((np.sqrt(np.maximum((A @ params - 1) / params[0]
                                             + 1 / curvature ** 2, 0))
                          - 1 / curvature) ** 2)
    curvature_der = -0.5 * curvature ** 3 * np.array(
        [-1 / params[0] ** 2 - 0.5 * (params[1] ** 2 + params[2] ** 2) / params[0] ** 3,
         0.5 * params[1] / params[0] ** 2, 0.5 * params[2] / params[0] ** 2])
    slope_der = np.array([0, -1 / params[2], params[1] / params[2] ** 2])
    curvature_err = calc_standard_error(curvature_der, cov)
    slope_err = calc_standard_error(slope_der, cov)
    curvature /= rescale
    chi_sqr *= rescale ** 2 / (norm_factor * X.size)
    xs = np.linspace(rx.min(), rx.max(), 300)
    if linear:
        ys = (1 - params[1] * xs) / params[2]
    else:
        disc = params[2] ** 2 - 4 * params[0] * (params[0] * xs ** 2 + params[1] * xs - 1)
        disc = np.maximum(disc, 0)
        yplus = (-params[2] + np.sqrt(disc)) / (2 * params[0])
        yminus = (-params[2] - np.sqrt(disc)) / (2 * params[0])
        ys = yplus if abs(ry.min() - yplus.min()) < abs(ry.min() - yminus.min()) else yminus
    curve = np.stack([xs * rescale + X.mean(), ys * rescale + Y.mean()], 1)
    res = {"curvature": (float(curvature), float(curvature_err)),
           "slope": (float(slope), float(slope_err)),
           "Chi square": (float(chi_sqr), 0.0), "N": (int(X.size), 0)}
    return res, curve


def fit_an_ellipse(X, Y, norm_factor: float = 1.0):
    """Conic least squares -> canonical parameters + analytic error propagation
    (reference ``fit_an_ellipse``, ``tissue_info.py:3290-3380``)."""
    X = np.asarray(X, float)
    Y = np.asarray(Y, float)
    rescale = abs(max(X.max(), Y.max()))
    rx = (X - X.mean()) / rescale
    ry = (Y - Y.mean()) / rescale
    A = np.column_stack([rx ** 2, rx * ry, ry ** 2, rx, ry])
    b = np.ones_like(rx)
    params, chi, _, _ = np.linalg.lstsq(A, b, rcond=None)
    params = params.squeeze()
    chi_sqr = float(chi[0]) if chi.size else 0.0
    cov = np.linalg.inv(A.T @ A)
    # Conic qa*x^2 + qb*x*y + qc*y^2 + qd*x + qe*y = 1 -> canonical form via the
    # standard conic-to-ellipse algebra. Writing lam+- = qa + qc +- root (the
    # scaled eigenvalues of the quadratic part), det4 = qb^2 - 4*qa*qc and
    # num = qa*qe^2 + qc*qd^2 - qb*qd*qe - qb^2 + 4*qa*qc:
    #   semi axes = -sqrt(2*num*lam+-)/det4, center = (gradient zero point).
    qa, qb, qc, qd, qe = params
    num = qa * qe ** 2 + qc * qd ** 2 - qb * qd * qe - qb ** 2 + 4 * qa * qc
    root = np.hypot(qa - qc, qb)
    lam_plus = qa + qc + root
    lam_minus = qa + qc - root
    det4 = qb ** 2 - 4 * qa * qc
    rad_plus = np.sqrt(2 * num * lam_plus)
    rad_minus = np.sqrt(2 * num * lam_minus)
    semi_major = -rad_plus / det4
    semi_minor = -rad_minus / det4
    center_x = (2 * qc * qd - qb * qe) / det4
    center_y = (2 * qa * qe - qb * qd) / det4
    tanphi = (qc - qa - root) / qb if qb != 0 else 0.0
    rotating_angle = np.arctan(tanphi) if qb != 0 else \
        (0.0 if qa < qc else np.pi / 2)
    eccentricity = 2 * (semi_major / semi_minor - 1) / 3
    # error propagation: gradients of each intermediate w.r.t. (qa,qb,qc,qd,qe),
    # chained into the canonical parameters, then sigma = sqrt(g^T cov g)
    g_num = np.array([qe ** 2 + 4 * qc,
                      -qd * qe - 2 * qb,
                      qd ** 2 + 4 * qa,
                      2 * qc * qd - qb * qe,
                      2 * qa * qe - qb * qd])
    g_lam_plus = np.array([1 + (qa - qc) / root, qb / root,
                           1 - (qa - qc) / root, 0, 0])
    g_lam_minus = np.array([1 - (qa - qc) / root, -qb / root,
                            1 + (qa - qc) / root, 0, 0])
    g_det4 = np.array([-4 * qc, 2 * qb, -4 * qa, 0, 0])
    g_tanphi = np.array([(-1 - (qa - qc) / root) / qb,
                         -tanphi / qb - 1 / root,
                         (1 + (qa - qc) / root) / qb, 0, 0]) \
        if qb != 0 else np.zeros(5)
    semi_minor_der = (rad_minus / det4 ** 2) * g_det4 \
        - 2 * (lam_minus * g_num + num * g_lam_minus) / (rad_minus * det4)
    semi_major_der = (rad_plus / det4 ** 2) * g_det4 \
        - 2 * (lam_plus * g_num + num * g_lam_plus) / (rad_plus * det4)
    center_x_der = np.array([0, -qe, 2 * qd, 2 * qc, -qb]) / det4 \
        - (center_x / det4) * g_det4
    center_y_der = np.array([2 * qe, -qd, 0, -qb, 2 * qa]) / det4 \
        - (center_y / det4) * g_det4
    rotating_angle_der = (1 / (1 + tanphi ** 2)) * g_tanphi
    eccentricity_der = 2 * (semi_major_der / semi_minor
                            - semi_minor_der * semi_major / semi_minor ** 2) / 3
    errs = {name: calc_standard_error(d, cov) for name, d in [
        ("semi_major", semi_major_der), ("semi_minor", semi_minor_der),
        ("center_x", center_x_der), ("center_y", center_y_der),
        ("angle", rotating_angle_der), ("ecc", eccentricity_der)]}
    center_x = center_x * rescale + X.mean()
    center_y = center_y * rescale + Y.mean()
    semi_major *= rescale
    semi_minor *= rescale
    chi_sqr *= rescale ** 2 / (norm_factor * X.size)
    t = np.linspace(0, 2 * np.pi, 300)
    cx = semi_major * np.cos(t) * np.cos(rotating_angle) \
        - semi_minor * np.sin(t) * np.sin(rotating_angle) + center_x
    cy = semi_major * np.cos(t) * np.sin(rotating_angle) \
        + semi_minor * np.sin(t) * np.cos(rotating_angle) + center_y
    res = {"semi-major": (float(semi_major), float(errs["semi_major"] * rescale)),
           "semi-minor": (float(semi_minor), float(errs["semi_minor"] * rescale)),
           "rotation angle": (float(-rotating_angle), float(errs["angle"])),
           "center x": (float(center_x), float(errs["center_x"] * rescale)),
           "center y": (float(center_y), float(errs["center_y"] * rescale)),
           "eccentricity": (float(eccentricity), float(errs["ecc"])),
           "Chi square": (float(chi_sqr), 0.0), "N": (int(X.size), 0)}
    return res, np.stack([cx, cy], 1)


_FITS = {"line": fit_a_line, "spline": fit_a_spline, "circle": fit_a_circle,
         "circle arc": fit_a_circle_arc, "ellipse": fit_an_ellipse}


def fit_shape(shape: str, points: List[Tuple[float, float]],
              normalization: List[float] = ()) -> Tuple[Dict, np.ndarray]:
    """Dispatch like the reference's ``end_shape_fitting``
    (``tissue_info.py:3056-3074``)."""
    X = np.array([p[0] for p in points], float)
    Y = np.array([p[1] for p in points], float)
    norm = float(np.mean(normalization)) if len(normalization) else 1.0
    return _FITS[shape](X, Y, norm)
