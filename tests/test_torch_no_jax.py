"""The port runs without jax: in a fresh interpreter (this one has jax
loaded by conftest), import the port, run S1 for 2 steps on the CPU, and
check that neither jax nor the JAX package was imported and that no CUDA
kernel was launched."""

import json
import os
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

SCRIPT = r"""
import json, sys
import torch
torch.set_num_threads(2)
from lammps_user_conp2_tpu_torch import workloads
from lammps_user_conp2_tpu_torch.models.conp import setup_conp
from lammps_user_conp2_tpu_torch.models.md import build_engine
from lammps_user_conp2_tpu_torch.ops.kernels import ele_rows_kernel, pair_kernel
system, md, cfg = workloads.synthetic(64, 4)
eng = build_engine(system, md, setup_conp(system, md, cfg))
st, th = eng.run(eng.init_state(x0=workloads.near_wall_positions(system)), 2)
print(json.dumps(dict(
    jax=[m for m in sys.modules if m == "jax" or m.startswith("jax.")],
    ref=[m for m in sys.modules if m.split(".")[0] == "lammps_user_conp2_tpu"],
    launches=[pair_kernel.launches.count, ele_rows_kernel.launches.count],
    step=st.step, energy=float(st.energy), temp=float(th["temp"][-1]))))
"""


def test_port_runs_without_jax():
    env = dict(os.environ, PYTHONPATH=REPO)
    proc = subprocess.run([sys.executable, "-c", SCRIPT], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    out = json.loads(proc.stdout.strip().splitlines()[-1])
    assert out["jax"] == [] and out["ref"] == []
    assert out["launches"] == [0, 0]
    assert out["step"] == 2
    assert out["temp"] > 0.0 and abs(out["energy"]) < 1e12
