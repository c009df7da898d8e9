"""Utilities: timing artifacts, profiling/roofline, visualisation."""
import json
import os

import numpy as np

from tpcg.utils.profiling import (PhaseTimer, cg_iteration_flops,
                                  roofline_fraction)
from tpcg.utils.timing import save_sweep_output
from tpcg.utils.viz import plot_field, plot_surface3d


def test_save_sweep_output(tmp_path):
    p = save_sweep_output(2, 8, 256, [1.23, 4.56], directory=str(tmp_path))
    text = open(p).read()
    assert "2 subdomain width" in text and "End of Array" in text
    assert "1.23" in text and "4.56" in text
    assert os.path.basename(p) == "output_2_8_256.txt"


def test_phase_timer():
    t = PhaseTimer()
    with t.phase("assembly"):
        pass
    with t.phase("solve"):
        pass
    rep = json.loads(t.report())
    assert set(rep) == {"assembly", "solve"}


def test_flops_accounting():
    # report Table II, complex helm_fem numbers
    fl = cg_iteration_flops(16384, 113666, is_complex=True)
    assert fl == 4 * (2 * 113666 + 10 * 16384)
    kind = "NVIDIA H100 80GB HBM3"
    frac = roofline_fraction(200.0, 16384, 113666, is_complex=True,
                             device_kind=kind)
    # 3.35 TB/s data-sheet peak: fl/by GFLOPS-per-GB/s times the peak
    by = 4 * (3 * 113666 + 6 * 16384 * 2)
    np.testing.assert_allclose(frac, 200.0 / (3350.0 * fl / by))
    assert roofline_fraction(1e-3, 16384, 113666, True, kind) < 0.01
    # a device kind without a recorded peak is an error, not a default
    import pytest
    with pytest.raises(KeyError, match="no HBM peak"):
        roofline_fraction(1.0, 16384, 113666, True, "unknown card")


def test_plots(tmp_path):
    f = np.random.default_rng(0).standard_normal(64) \
        + 1j * np.random.default_rng(1).standard_normal(64)
    p1 = str(tmp_path / "field.png")
    p2 = str(tmp_path / "surf.png")
    plot_field(f, "t", path=p1)
    plot_surface3d(f, "t", path=p2)
    assert os.path.getsize(p1) > 0 and os.path.getsize(p2) > 0


def test_gnuplot_splot_script(tmp_path):
    """The Gnuplot pipe writer's script round-trips the field data and
    carries the reference plot3d's settings (parametric / data lines /
    contour base)."""
    from tpcg.utils.viz import gnuplot_splot

    rng = np.random.default_rng(2)
    f = rng.standard_normal(49) + 1j * rng.standard_normal(49)
    p = str(tmp_path / "surf.gp")
    script = gnuplot_splot(f, "t", script_path=p)
    assert open(p).read() == script
    for directive in ("set parametric", "set style data lines",
                      "set contour base", "splot $grid matrix"):
        assert directive in script
    body = script.split("<< EOD\n")[1].split("\nEOD")[0]
    grid = np.array([[float(v) for v in line.split()]
                     for line in body.splitlines()])
    want = (f.real + f.imag).reshape(7, 7) / 2.0
    np.testing.assert_allclose(grid, want, rtol=1e-6, atol=1e-8)
