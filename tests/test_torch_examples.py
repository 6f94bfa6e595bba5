"""The port's example analyses (``examples/*_torch.py``) against the JAX
package's scripts, each run in-process on the CPU on the same inputs:

- ``survival_by_neighbors``: a ``.seg`` from the port's
  ``utils/synthetic.py:make_tracked_tissue`` with HC cells from frame 1
  and planted differentiations, a division and a delamination (found by
  ``find_events``; the archive loads into either package);
- ``event_rates``: configs of literal counts (the form in its docstring)
  and of sessions, as a 2 x 2 design and as a pairwise one;
- ``compare_experiments``: pickled feature tables in two condition folders
  of two repeats each, with and without ``--hierarchical``.

Written CSVs are equal (integers exactly, floats to rtol 1e-6) and so are
the stats JSON files; both write the same file names. No port script
imports JAX or the JAX package, and without ``device="cpu"`` on a host
with no card each raises before reading a file.
"""

import importlib.util
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pandas as pd
import pytest
import torch

# one intra-op thread: the test workers share the cores with each other
# and with XLA's device threads
torch.set_num_threads(1)

EXAMPLES = Path(__file__).resolve().parent.parent / "examples"
NAMES = ("compare_experiments", "event_rates", "survival_by_neighbors")


def _script(name: str):
    spec = importlib.util.spec_from_file_location(f"example_{name}",
                                                  EXAMPLES / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def seg(tmp_path_factory):
    from tissue_image_processing_tpu_torch.utils.synthetic import (
        make_tracked_tissue)

    hc = [(i, 1) for i in (22, 24, 34, 46, 57, 66, 75)]
    later = [(33, 3), (45, 4), (56, 4), (63, 5), (27, 3)]
    tissue, _ = make_tracked_tissue(
        n_frames=6, size=256, n_cells=100, seed=1, differentiate=hc + later,
        delaminate=[(77, 4)], divide=[(72, 3)], device="cpu")
    tissue.type_names = ["HC"]
    tissue.find_events()
    kinds = set(tissue.get_events().type)
    assert {"differentiation", "division"} <= kinds, kinds
    path = str(tmp_path_factory.mktemp("seg") / "tracked.seg")
    for _ in tissue.save(path):
        pass
    return path


def _run_both(name, argv_for, tmp_path):
    """Each package's script on ``argv_for(out_dir)``; returns the two
    output folders."""
    outs = {}
    for tag, script in (("jax", name), ("torch", f"{name}_torch")):
        out = tmp_path / tag
        out.mkdir()
        kw = {"device": "cpu"} if tag == "torch" else {}
        assert _script(script).main(argv_for(out), **kw) == 0
        outs[tag] = out
    return outs["jax"], outs["torch"]


def _assert_same_values(a, b, where):
    if isinstance(a, dict):
        assert a.keys() == b.keys(), where
        for k in a:
            _assert_same_values(a[k], b[k], f"{where}.{k}")
    elif isinstance(a, list):
        assert len(a) == len(b), where
        for i, (x, y) in enumerate(zip(a, b)):
            _assert_same_values(x, y, f"{where}[{i}]")
    elif isinstance(a, float) or isinstance(b, float):
        np.testing.assert_allclose(b, a, rtol=1e-6, err_msg=where)
    else:
        assert a == b, where


def _assert_outputs_equal(want: Path, got: Path, min_rows: int = 1):
    assert sorted(p.name for p in want.iterdir()) == \
        sorted(p.name for p in got.iterdir())
    checked = 0
    for path in sorted(want.iterdir()):
        if path.suffix == ".csv":
            w, g = pd.read_csv(path), pd.read_csv(got / path.name)
            assert list(w.columns) == list(g.columns), path.name
            assert len(w) == len(g) >= min_rows, (path.name, len(w), len(g))
            for col in w.columns:
                a, b = w[col].to_numpy(), g[col].to_numpy()
                if a.dtype.kind == "f" or b.dtype.kind == "f":
                    np.testing.assert_allclose(b.astype(float), a.astype(float),
                                               rtol=1e-6, err_msg=col)
                else:   # NaN stands where either table has nothing
                    both = pd.isna(a) & pd.isna(b)
                    np.testing.assert_array_equal(b[~both], a[~both],
                                                  err_msg=col)
            checked += 1
        elif path.suffix == ".json":
            with open(path) as f, open(got / path.name) as h:
                _assert_same_values(json.load(f), json.load(h), path.name)
            checked += 1
    assert checked > 0


def test_survival_by_neighbors(seg, tmp_path):
    want, got = _run_both("survival_by_neighbors",
                          lambda out: [str(out), seg, seg], tmp_path)
    _assert_outputs_equal(want, got)
    data = pd.read_csv(got / "survival_by_neighbors_data.csv")
    assert data.shape[1] > 2   # curves for several neighbour counts


LITERAL = {
    "E17.5/normal": {"counts": [32, 27, 59], "hours": [48, 46, 30],
                     "area_um2": [327040, 300160, 328320]},
    "E17.5/ablation": {"counts": [12, 19, 25], "hours": [36, 50, 41],
                       "area_um2": [252520, 320580, 301000]},
    "P0/normal": {"counts": [8, 14, 11], "hours": [40, 44, 47],
                  "area_um2": [298000, 310400, 287300]},
    "P0/ablation": {"counts": [21, 30, 17], "hours": [39, 45, 43],
                    "area_um2": [265200, 301000, 279900]},
}


@pytest.mark.parametrize("design", ["2x2_literal", "2x2_sessions",
                                    "pairwise"])
def test_event_rates(seg, tmp_path, design):
    groups = dict(LITERAL)
    if design == "2x2_sessions":
        groups["E17.5/ablation"] = {"sessions": [seg, seg],
                                    "hours": [36, 50],
                                    "area_um2": [252520, 320580]}
    elif design == "pairwise":
        groups = {"normal": LITERAL["E17.5/normal"],
                  "ablation": LITERAL["E17.5/ablation"],
                  "sessions": {"sessions": [seg, seg, seg],
                               "hours": [30, 36, 42],
                               "area_um2": [6000, 6500, 7000]}}

    def argv(out):
        cfg = out.parent / f"{out.name}.json"
        cfg.write_text(json.dumps({"groups": groups, "output": str(out),
                                   "event_type": "differentiation",
                                   "factors": ["age", "treatment"]}))
        return [str(cfg)]

    want, got = _run_both("event_rates", argv, tmp_path)
    _assert_outputs_equal(want, got)
    with open(got / "differentiation_rates_stats.json") as f:
        assert json.load(f)["design"] == design.split("_")[0]


def _feature_folders(root: Path) -> dict:
    """Two conditions of two repeats, each repeat two pickled tables of
    ``area`` and ``roundness`` (the pattern's matches) and one that does
    not match."""
    rng = np.random.default_rng(4)
    conditions = {}
    for c, (cond, mu) in enumerate((("E17.5", 60.0), ("P0", 75.0))):
        folders = []
        for r in range(2):
            folder = root / f"{cond}_{r}"
            folder.mkdir()
            for k in range(2):
                n = 20 + 5 * k + 3 * r + c
                pd.DataFrame({
                    "area": rng.gamma(8.0, mu / 8.0, n),
                    "roundness": rng.random(n)}).to_pickle(
                    folder / f"area_and_roundness_division{k}_data")
            pd.DataFrame({"area": [1e6]}).to_pickle(folder / "other_data")
            folders.append(str(folder))
        conditions[cond] = folders
    return conditions


@pytest.mark.parametrize("hierarchical", [False, True])
def test_compare_experiments(tmp_path, hierarchical):
    conditions = _feature_folders(tmp_path)

    def argv(out):
        cfg = out.parent / f"{out.name}.json"
        cfg.write_text(json.dumps({
            "conditions": conditions, "output": str(out), "feature": "area",
            "pattern": "area_and_roundness_division*_data"}))
        return [str(cfg)] + (["--hierarchical"] if hierarchical else [])

    want, got = _run_both("compare_experiments", argv, tmp_path)
    _assert_outputs_equal(want, got)
    rows = pd.read_csv(got / "area_stats.csv")
    assert len(rows) == (2 if hierarchical else 1)


@pytest.mark.parametrize("name", NAMES)
def test_port_scripts_need_a_card(name, tmp_path):
    """``device=None`` is the card: without one, each script raises before
    it reads its (missing) input."""
    if torch.cuda.is_available():
        pytest.skip("a card is visible")
    missing = str(tmp_path / "missing.json")
    argv = [str(tmp_path), missing] if name == "survival_by_neighbors" \
        else [missing]
    with pytest.raises(RuntimeError, match="CUDA"):
        _script(f"{name}_torch").main(argv)


def test_port_scripts_import_no_jax(seg, tmp_path):
    """All three port scripts run in a fresh interpreter; afterwards no
    module of JAX or of the JAX package is loaded."""
    cfg = tmp_path / "rates.json"
    cfg.write_text(json.dumps({"groups": {
        "a": LITERAL["P0/normal"],
        "b": {"sessions": [seg, seg], "hours": [30, 36],
              "area_um2": [6000, 6500]}}, "output": str(tmp_path / "r")}))
    conditions = _feature_folders(tmp_path)
    cmp_cfg = tmp_path / "compare.json"
    cmp_cfg.write_text(json.dumps({
        "conditions": conditions, "output": str(tmp_path / "c"),
        "feature": "area", "pattern": "area_and_roundness_division*_data"}))
    code = (
        "import importlib.util, sys\n"
        "def run(name, argv):\n"
        f"    spec = importlib.util.spec_from_file_location(name, "
        f"{str(EXAMPLES)!r} + '/' + name + '.py')\n"
        "    mod = importlib.util.module_from_spec(spec)\n"
        "    spec.loader.exec_module(mod)\n"
        "    assert mod.main(argv, device='cpu') == 0\n"
        f"run('survival_by_neighbors_torch', [{str(tmp_path / 's')!r}, "
        f"{seg!r}])\n"
        f"run('event_rates_torch', [{str(cfg)!r}])\n"
        f"run('compare_experiments_torch', [{str(cmp_cfg)!r}, "
        "'--hierarchical'])\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in\n"
        "       ('jax', 'jaxlib', 'flax', 'tissue_image_processing_tpu')]\n"
        "assert not bad, bad\n")
    env = dict(os.environ, OMP_NUM_THREADS="1")
    res = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300, env=env)
    assert res.returncode == 0, res.stderr[-3000:]
