"""chip_smoke.py's CPU-checkable parts (device refusal, the CPU reference
child, data reader, numpy float64 MU twin, the fixed-iteration comparison)
and, on a card, the update-path precision check it runs there."""

import json
import subprocess
import sys
from types import SimpleNamespace

import numpy as np
import pytest

import chip_smoke


def test_refuses_cpu(capsys):
    """On a CPU the script exits non-zero before any phase and prints no
    result."""
    with pytest.raises(SystemExit, match="chip_smoke: needs an NVIDIA GPU"):
        chip_smoke.main([])
    assert capsys.readouterr().out == ""


def _fake_child(monkeypatch, platform):
    calls = []

    def run(argv, **kwargs):
        calls.append((argv, kwargs))
        line = json.dumps({"platform": platform, "klnmf_best": 1.0})
        return SimpleNamespace(returncode=0, stdout="noise\n" + line + "\n",
                               stderr="")

    monkeypatch.setattr(subprocess, "run", run)
    return calls


def test_cpu_reference_runs_in_a_cpu_only_child(monkeypatch):
    calls = _fake_child(monkeypatch, "cpu")
    reference = chip_smoke.cpu_reference()
    assert reference == {"platform": "cpu", "klnmf_best": 1.0}
    (argv, kwargs), = calls
    assert argv[0] == sys.executable and argv[-1] == "--cpu-reference"
    assert argv[1].endswith("chip_smoke.py")
    assert kwargs["env"]["JAX_PLATFORMS"] == "cpu"


def test_cpu_reference_refuses_a_child_off_the_cpu(monkeypatch):
    _fake_child(monkeypatch, "gpu")
    with pytest.raises(RuntimeError, match="ran on gpu"):
        chip_smoke.cpu_reference()


def test_gap_ratio_is_the_median_lane_ratio():
    cpu = [1e-7, 2e-7, 4e-7, 1e-6, 3e-7]
    device = [3e-7, 2e-7, 2e-6, 1e-6, 3e-7]  # ratios 3, 1, 5, 1, 1
    assert chip_smoke.gap_ratio(device, cpu) == pytest.approx(1.0)
    assert chip_smoke.gap_ratio([10 * gap for gap in cpu], cpu) == \
        pytest.approx(10.0)


def test_numpy_csv_reader_matches_pandas_loader():
    from salamander_tpu.datasets import load_pcawg_sbs, read_counts_csv

    values, index, columns = read_counts_csv("pcawg_sbs")
    frame = load_pcawg_sbs()  # samples x channels
    assert values.shape == (96, 192) and values.dtype == np.float64
    np.testing.assert_array_equal(values.T, frame.to_numpy())
    assert index == list(frame.columns)
    assert columns == list(frame.index)
    np.testing.assert_array_equal(chip_smoke.pcawg_counts(), values)


def test_numpy_twin_matches_engine_update():
    """The float64 reference loop is the engine's update rule."""
    import jax.numpy as jnp

    from salamander_tpu.ops import klnmf

    rng = np.random.default_rng(0)
    X = rng.poisson(30.0, (12, 20)).astype(np.float64)
    W = rng.dirichlet(np.ones(12), 3).T
    H = rng.uniform(1.0, 5.0, (3, 20))
    W_np, H_np = chip_smoke.np_update_wh(X, W, H)
    W_jx, H_jx = klnmf.update_WH(jnp.asarray(X), jnp.asarray(W),
                                 jnp.asarray(H))
    np.testing.assert_allclose(W_np, np.asarray(W_jx), rtol=1e-12)
    np.testing.assert_allclose(H_np, np.asarray(H_jx), rtol=1e-12)


def test_fixed_iteration_gaps_on_one_device():
    """On one device two runs are the same program, so their lanes' gaps
    to float64 agree (ratio 1); they are float32-sized, and the starts
    follow the seed."""
    X = chip_smoke.pcawg_counts()[:, :48]
    kwargs = dict(n_lanes=2, n_signatures=3, n_iterations=30)
    first = chip_smoke.lane_gaps(X, **kwargs)
    again = chip_smoke.lane_gaps(X, **kwargs)
    assert first == again and len(first) == 2
    assert chip_smoke.gap_ratio(again, first) == 1.0
    assert all(0 < gap < 1e-4 for gap in first)
    assert chip_smoke.lane_gaps(X, seed=2, **kwargs) != first


@pytest.mark.gpu
def test_update_precision_matches_cpu_on_gpu(gpu_device):
    """On the card, the KLNMF multi-start agrees with the CPU device and
    float32 MU steps stay as close to float64 as the CPU's do (chip_smoke
    phase 2; fails under a reduced-precision update tier)."""
    record = chip_smoke.phase_klnmf_pcawg(chip_smoke.pcawg_counts(),
                                          chip_smoke.cpu_reference())
    assert record["best_rel"] <= chip_smoke.BEST_RTOL
    assert record["gap_ratio"] <= chip_smoke.GAP_RATIO_LIMIT
