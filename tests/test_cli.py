"""CLI drivers (``tpcg.cli``): argv parity with ``main.c`` and the big
scripts' ``__main__`` tails, including the UseCG=6 mesh fan-out."""
import os

import scipy.io
import scipy.sparse as sp

from tpcg.cli import main


def test_cg_cli(tmp_path, capsys, monkeypatch):
    n = 60
    Q = sp.random(n, n, density=0.1, random_state=0, format="csr")
    A = sp.csr_matrix(Q @ Q.T + n * sp.eye(n))
    mtx = tmp_path / "spd.mtx"
    scipy.io.mmwrite(str(mtx), A)
    assert main(["cg", str(mtx), "2", "0", "40"]) == 0
    out = capsys.readouterr().out
    assert "rhs 0: final residual" in out and "rhs 1:" in out


def test_helmholtz_cli_usecg6_builds_mesh(tmp_path, capsys, monkeypatch):
    """UseCG=6 must actually shard over a device mesh
    (``p_h-PY_C-CL-multi-GPU.py:2123-2181``); on the 8-virtual-device CPU
    backend with M_s=2 it uses a 2-device mesh.  Its iteration count must
    match UseCG=2 (same numerics, different placement)."""
    monkeypatch.chdir(tmp_path)
    assert main(["helmholtz", "2", "6", "2,6", "40"]) == 0
    out = capsys.readouterr().out
    its = [int(ln.split("####it:")[1]) for ln in out.splitlines()
           if "####it:" in ln]
    assert len(its) == 2 and its[0] == its[1]
    assert os.path.exists(tmp_path / "output_2_6_40.txt")


def test_helmholtz_cli_multihost_flag(tmp_path, capsys, monkeypatch):
    """--multihost on a single-process job: env bootstrap is a no-op,
    the solve runs on the global mesh (8 virtual devices -> 2-device
    mesh for M_s=2) and converges like the plain run."""
    monkeypatch.chdir(tmp_path)
    monkeypatch.delenv("COORDINATOR_ADDRESS", raising=False)
    monkeypatch.delenv("NUM_PROCESSES", raising=False)
    assert main(["helmholtz", "2", "6", "2", "40", "--multihost"]) == 0
    out = capsys.readouterr().out
    its = [int(ln.split("####it:")[1]) for ln in out.splitlines()
           if "####it:" in ln]
    assert len(its) == 1 and its[0] > 0
    assert os.path.exists(tmp_path / "output_2_6_40.txt")


def test_helmholtz_cli_exit_code_when_a_mode_raises(tmp_path, capsys,
                                                    monkeypatch):
    """A variant that raises is recorded as 0 in the output file, like the
    reference (:3715-3718), but the command exits non-zero."""
    import sys
    hs = sys.modules["tpcg.parallel.hsolver"]

    def boom(*a, **k):
        raise RuntimeError("subdomain solve failed")
    monkeypatch.setattr(hs, "hsolver", boom)
    monkeypatch.chdir(tmp_path)
    assert main(["helmholtz", "2", "6", "0,2", "40"]) == 1
    assert "subdomain solve failed" in capsys.readouterr().out
    text = open(tmp_path / "output_2_6_40.txt").read()
    assert "0.00" in text and "End of Array" in text

