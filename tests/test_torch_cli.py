"""The port's command line (``python -m lammps_user_conp2_tpu_torch``)
against the JAX package's, on the 352-atom ionic-liquid fixture placed as
``il_onelayer/data`` under ``$CONP_REF_TESTS``:

* ``run il_onelayer 0 --cpu --steps 4 --thermo 2`` in a subprocess of each
  package: the thermo rows equal as printed (8 significant digits); the
  port's log has the ``Loop time`` line and the per-phase timing lines,
  and its checkpoint loads;
* ``compare`` of a log with itself prints ``max|diff|=0.000e+00``;
* ``run --dump`` then ``rerun``: the re-solved charges of each frame equal
  the logged ones to the dump's 8 significant digits (2e-7 e);
* ``profile --cpu`` prints every phase of the engine's path;
* without ``--cpu`` and with no card the command raises; ``dilute`` is
  refused, naming its missing data file.
"""

import argparse
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from lammps_user_conp2_tpu_torch import cli
from lammps_user_conp2_tpu_torch.utils.lammps_log import parse_thermo_blocks
from torch_cells import IL_SMALL

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ARGS = ["run", "il_onelayer", "0", "--cpu", "--steps", "4", "--thermo", "2"]


@pytest.fixture(scope="module")
def ref_dir(tmp_path_factory):
    from lammps_user_conp2_tpu_torch.workloads import write_il_data
    d = tmp_path_factory.mktemp("ref")
    os.makedirs(d / "il_onelayer")
    write_il_data(str(d / "il_onelayer" / "data"), **IL_SMALL)
    return d


def _cli(package, args, ref_dir, cwd):
    env = dict(os.environ, CONP_REF_TESTS=str(ref_dir),
               PYTHONPATH=REPO + os.pathsep + os.environ.get("PYTHONPATH",
                                                             ""))
    proc = subprocess.run([sys.executable, "-m", package, *args], cwd=cwd,
                          env=env, capture_output=True, text=True,
                          timeout=300)
    assert proc.returncode == 0, proc.stderr
    return proc.stdout


@pytest.fixture(scope="module")
def logs(ref_dir, tmp_path_factory):
    d = tmp_path_factory.mktemp("logs")
    _cli("lammps_user_conp2_tpu", ARGS + ["--log", "jax.log", "--no-timing"],
         ref_dir, d)
    out = _cli("lammps_user_conp2_tpu_torch",
               ARGS + ["--log", "port.log", "--checkpoint", "ck.npz"],
               ref_dir, d)
    assert "wrote port.log" in out
    return d


def test_run_thermo_rows_match_jax_cli(logs):
    port = (logs / "port.log").read_text().splitlines()
    jax = (logs / "jax.log").read_text().splitlines()
    rows = lambda lines: [ln for ln in lines if ln and ln[0].isdigit()]
    assert port[0] == jax[0] == cli.THERMO_HEADER
    assert len(rows(port)) == 3
    assert rows(port) == rows(jax)
    text = "\n".join(port)
    assert "# Loop time" in text
    for phase in ("b_vector", "charge_solve", "pair_forces", "kspace_forces",
                  "full_step"):
        assert f"# {phase}: " in text


def test_run_checkpoint_loads(logs, ref_dir, monkeypatch):
    from lammps_user_conp2_tpu_torch.utils.checkpoint import load_checkpoint
    monkeypatch.setenv("CONP_REF_TESTS", str(ref_dir))
    args = argparse.Namespace(
        workload="il_onelayer", trial=0, cpu=True, f32=False, solver=None,
        pair_path=None, kmax=None)
    _, eng = cli.build(args)
    st = load_checkpoint(str(logs / "ck.npz"), eng)
    last = parse_thermo_blocks(logs / "port.log")[0]
    assert st.step == 4 and int(st.step_t) == 4
    assert float(eng.thermo(st)["pe"]) == pytest.approx(last["PotEng"][-1],
                                                        rel=1e-7)


def test_compare_log_with_itself(logs, capsys):
    assert cli.main(["compare", str(logs / "port.log"), str(logs / "port.log"),
                     str(logs / "jax.log")]) == 0
    out = capsys.readouterr().out.splitlines()
    assert out[1].endswith("max|diff|=0.000e+00 rms=0.000e+00")
    assert "max|diff|=0.000e+00" in out[2]


def test_dump_then_rerun(ref_dir, tmp_path, monkeypatch, capsys):
    monkeypatch.setenv("CONP_REF_TESTS", str(ref_dir))
    monkeypatch.chdir(tmp_path)
    assert cli.main(["run", "il_onelayer", "0", "--cpu", "--steps", "6",
                     "--thermo", "3", "--dump", "traj", "--log", "log",
                     "--no-timing"]) == 0
    logged = parse_thermo_blocks("log")[0]
    capsys.readouterr()
    assert cli.main(["rerun", "il_onelayer", "0", "traj", "--cpu"]) == 0
    lines = capsys.readouterr().out.splitlines()
    assert lines[0] == "Step c_qleft c_qright f_e"
    got = np.array([[float(v) for v in ln.split()] for ln in lines[1:]])
    np.testing.assert_array_equal(got[:, 0], [3, 6])
    for col, k in ((1, "c_qleft"), (2, "c_qright")):
        np.testing.assert_allclose(got[:, col], logged[k][1:], rtol=0,
                                   atol=2e-7)


def test_profile_prints_every_phase(ref_dir, monkeypatch, capsys):
    monkeypatch.setenv("CONP_REF_TESTS", str(ref_dir))
    assert cli.main(["profile", "il_onelayer", "0", "--cpu", "--iters",
                     "1"]) == 0
    out = capsys.readouterr().out
    times = json.loads(out[:out.index("launches")])
    assert list(times) == ["b_vector", "charge_solve", "pair_forces",
                           "kspace_forces", "full_step"]
    assert all(v.endswith(" ms") for v in times.values())
    launches = json.loads(out[out.index("launches") + 8:])
    # no CUDA kernel launches on the CPU
    assert all(v == {} for v in launches.values())


def test_refusals(ref_dir, monkeypatch):
    monkeypatch.setenv("CONP_REF_TESTS", str(ref_dir))
    with pytest.raises(NotImplementedError, match="dilute/data"):
        cli.main(["run", "dilute", "0", "--cpu"])
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            cli.main(["run", "il_onelayer", "0", "--steps", "1"])
