"""Tiny-config execution smoke of examples/tutorial.ipynb.

Enforces the "every cell executes" claim mechanically: the notebook is
loaded, its heavy literals shrunk (restarts, ranks, bootstrap counts,
iteration budgets), a prelude cell forces the CPU backend and caps the
model classes' default iteration budgets, and the whole thing runs under
nbclient. Any raising cell fails the test. The shipped notebook's outputs
are produced by a full-scale run; this smoke only guarantees the code in
every cell stays executable.
"""

import copy
import json
import re
import shutil
from pathlib import Path

import pytest

nbformat = pytest.importorskip("nbformat")
nbclient = pytest.importorskip("nbclient")

REPO = Path(__file__).resolve().parents[1]
NOTEBOOK = REPO / "examples" / "tutorial.ipynb"

PRELUDE = """
import sys
sys.path.insert(0, {repo!r})
import jax
jax.config.update("jax_platforms", "cpu")

# cap the model families' default convergence budgets for the smoke run
# (explicit per-cell budgets are shrunk by the test's source rewrites)
import salamander_tpu.models as _m

def _cap(cls):
    orig = cls.__init__

    def tiny(self, *args, **kwargs):
        kwargs.setdefault("min_iterations", 10)
        kwargs.setdefault("max_iterations", 40)
        return orig(self, *args, **kwargs)

    cls.__init__ = tiny

for _cls in (_m.KLNMF, _m.MvNMF, _m.CorrNMFDet, _m.ARDNMF,
             _m.MultimodalCorrNMF):
    _cap(_cls)
"""

# (pattern, replacement) applied to every code cell's source
SHRINK = [
    (r"n_restarts=100", "n_restarts=4"),
    (r"n_restarts=50", "n_restarts=4"),
    (r"n_restarts=8\b", "n_restarts=2"),
    (r"n_restarts=4\b", "n_restarts=2"),
    (r"n_bootstraps=\d+", "n_bootstraps=2"),
    (r"n_replicates=\d+", "n_replicates=4"),
    (r"ranks=range\(2, \d+\)", "ranks=range(2, 4)"),
    (r"ranks=range\(1, \d+\)", "ranks=range(1, 3)"),
    (r"range\(2, 9\)", "range(2, 4)"),
    (r"range\(2, 7\)", "range(2, 4)"),
    (r"min_iterations=\d+", "min_iterations=5"),
    (r"max_iterations=\d+", "max_iterations=30"),
    (r"FitConfig\(300, 2000, 10, 1e-6\)", "FitConfig(5, 20, 5, 1e-6)"),
    (r"n_samples=2000", "n_samples=200"),
    (r"n_steps=400\b", "n_steps=40"),
    (r"n_steps=6000\b", "n_steps=60"),
    # the tiny budgets make stability/suggestion thresholds meaningless;
    # inject extract kwargs after the 'seed=0,' every extract call carries
    # (kwargs cannot be prepended: a positional counts frame comes first)
    (r"n_bootstraps=2, seed=0,",
     "n_bootstraps=2, seed=0, min_iterations=5, max_iterations=30, "
     "min_stability=0.0,"),
    (r"tl\.suggest_rank\(scan\)", "tl.suggest_rank(scan, min_stability=0.0)"),
    (r"sal\.assign_signatures\(sbs, catalog, rel_tol=0\.02\)",
     "sal.assign_signatures(sbs, catalog, rel_tol=0.05, "
     "candidate_iters=10, max_iterations=300)"),
    (r"min_fraction=0\.05,", "min_fraction=0.05, max_iterations=200,"),
    (r"\"tutorial_checkpoint\"", "\"{SMOKE_CKPT}\""),
]


@pytest.mark.slow
def test_tutorial_executes_tiny(tmp_path):
    raw = json.loads(NOTEBOOK.read_text())
    nb = nbformat.from_dict(copy.deepcopy(raw))

    ckpt = str(tmp_path / "tutorial_ckpt")
    shutil.rmtree(ckpt, ignore_errors=True)
    for cell in nb.cells:
        if cell.cell_type != "code":
            continue
        source = cell.source
        if isinstance(source, list):
            source = "".join(source)
        for pattern, repl in SHRINK:
            source = re.sub(pattern, repl, source)
        cell.source = source.replace("{SMOKE_CKPT}", ckpt)
    nb.cells.insert(
        0, nbformat.v4.new_code_cell(PRELUDE.format(repo=str(REPO)))
    )
    # matplotlib must not try to open a display
    nb.cells.insert(0, nbformat.v4.new_code_cell(
        "import matplotlib\nmatplotlib.use('Agg')"
    ))

    client = nbclient.NotebookClient(
        nb, timeout=600, kernel_name="python3",
        resources={"metadata": {"path": str(REPO / "examples")}},
    )
    client.execute()  # raises CellExecutionError on any failing cell

    executed = [c for c in nb.cells if c.cell_type == "code"]
    assert all(c.execution_count is not None for c in executed)


def test_shipped_notebook_fully_executed():
    """The checked-in notebook must carry a complete execution: every code
    cell has an execution count (the README's 'every cell executes'
    claim is checked, not asserted)."""
    raw = json.loads(NOTEBOOK.read_text())
    dead = [
        index
        for index, cell in enumerate(raw["cells"])
        if cell["cell_type"] == "code"
        and cell.get("execution_count") is None
    ]
    assert dead == [], f"code cells without execution counts: {dead}"
