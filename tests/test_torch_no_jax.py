"""The port runs without jax: in a fresh interpreter (this one has jax
loaded by conftest), import the port, run S1 for 2 steps on the CPU, run
the Verlet-list + PPPM path on S3 for 2 steps, write the test-size
ionic-liquid data file and run il_onelayer (SHAKE/RATTLE) on it for 2
steps, import the gather probes (``timing``, ``exp_vmem_gather``,
``exp_gather_chunk``, K9's ``ops.kernels.vmem_gather``) and run K9's
plain path, import the command line, the diagnostics, the pressure and
the I/O modules, run ``cli.main(["run", "synthetic", "--cpu", ...])`` and
a step of S1 with its electrodes scattered over the rows (and its
pressure tensor), run the sharded step (``parallel/``) on S3 over a
one-rank gloo group and import ``bench_sharded``, and check that neither jax nor the JAX package (nor
``tools/``) was imported and that no CUDA kernel was launched."""

import json
import os
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

SCRIPT = r"""
import json, sys, tempfile
import numpy as np
import torch
torch.set_num_threads(2)
from lammps_user_conp2_tpu_torch import workloads
from lammps_user_conp2_tpu_torch.models.conp import setup_conp
from lammps_user_conp2_tpu_torch.models.md import build_engine
from lammps_user_conp2_tpu_torch.ops.kernels import (
    block_pair, ele_rows_kernel, pair_kernel, pppm_gather, pppm_spread,
    shake_kernel, vmem_gather)
from lammps_user_conp2_tpu_torch.utils.config import KSpaceStyle
import lammps_user_conp2_tpu_torch.interop
import lammps_user_conp2_tpu_torch.shake_residual
import lammps_user_conp2_tpu_torch.step_breakdown
import lammps_user_conp2_tpu_torch.step_breakdown_large
from lammps_user_conp2_tpu_torch import exp_gather_chunk, exp_vmem_gather, timing
S64 = dict(solve_dtype=torch.float64, device="cpu")
C64 = dict(dtype=torch.float64, device="cpu")
system, md, cfg = workloads.synthetic(64, 4)
eng = build_engine(system, md, setup_conp(system, md, cfg, **S64), **C64)
st, th = eng.run(eng.init_state(x0=workloads.near_wall_positions(system)), 2)
import dataclasses
system, md, cfg = workloads.synthetic(512, 5, lz=36.0, lxy=20.0)
md = dataclasses.replace(md, pair_path="nlist", kspace_style=KSpaceStyle.PPPM)
cfg = dataclasses.replace(cfg, kspace=KSpaceStyle.PPPM)
big = build_engine(system, md, setup_conp(system, md, cfg, **S64), **C64)
st2, th2 = big.run(big.init_state(x0=workloads.near_wall_positions(system)), 2)
path = workloads.write_il_data(tempfile.mkdtemp() + "/il.data", n_pairs=40,
                               sheets=1, nx=6, ny=4)
system, md, cfg = workloads.il_onelayer(0, data_path=path)
md = dataclasses.replace(md, cutoff=7.0, kspace_accuracy=1e-5)
il = build_engine(system, md, setup_conp(system, md, cfg, **S64), **C64)
st3, th3 = il.run(il.init_state(), 2)
probe = exp_vmem_gather.run_probe(2, 32, R=3, device="cpu", iters=2)
from lammps_user_conp2_tpu_torch import cli
from lammps_user_conp2_tpu_torch.models import diagnostics, pressure
from lammps_user_conp2_tpu_torch.models.system import reorder_atoms
from lammps_user_conp2_tpu_torch.utils import (checkpoint, dump, lammps_log,
                                               matio, timers)
rc = cli.main(["run", "synthetic", "--cpu", "--steps", "2", "--thermo", "1"])
system, md, cfg = workloads.synthetic(64, 4)
scr = reorder_atoms(system, np.random.default_rng(0).permutation(
    system.natoms))
sc = build_engine(scr, md, setup_conp(scr, md, cfg, **S64), **C64)
st4 = sc.step(sc.init_state())
p6 = pressure.pressure_tensor(sc, st4)
from lammps_user_conp2_tpu_torch import bench_sharded
from lammps_user_conp2_tpu_torch.parallel import comm as pcomm
from lammps_user_conp2_tpu_torch.parallel.sharded import build_sharded_engine
group = pcomm.init_group("cpu", 0, 1, tempfile.mkdtemp() + "/store")
sh = build_sharded_engine(big, group)
st5, _ = sh.run(big.init_state(x0=workloads.near_wall_positions(big.system)),
                2, thermo_every=0)
pcomm.close_group()
mods = (pair_kernel, ele_rows_kernel, block_pair, pppm_spread, pppm_gather,
        vmem_gather)
print(json.dumps(dict(
    jax=[m for m in sys.modules if m == "jax" or m.startswith("jax.")],
    ref=[m for m in sys.modules if m.split(".")[0] == "lammps_user_conp2_tpu"],
    tools=[m for m in ("timing", "exp_vmem_gather", "exp_gather_chunk")
           if m in sys.modules],
    probe_ms=probe["ms"],
    launches=[m.launches.count for m in mods] + [
        shake_kernel.shake_launches.count, shake_kernel.rattle_launches.count],
    step=st.step, energy=float(st.energy), temp=float(th["temp"][-1]),
    step2=st2.step, energy2=float(st2.energy), list2=big.ncfg is not None,
    step3=st3.step, temp3=float(th3["tempsl"][-1]), shake3=il.cons is not None,
    cli_rc=rc, scrambled=not sc.conp.ele_contig, step4=st4.step,
    energy4=float(st4.energy), p6=[float(v) for v in p6], step5=st5.step,
    energy5=float(st5.energy))))
"""


def test_port_runs_without_jax():
    env = dict(os.environ, PYTHONPATH=REPO)
    proc = subprocess.run([sys.executable, "-c", SCRIPT], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    out = json.loads(proc.stdout.strip().splitlines()[-1])
    assert out["jax"] == [] and out["ref"] == [] and out["tools"] == []
    assert out["launches"] == [0, 0, 0, 0, 0, 0, 0, 0]
    assert out["probe_ms"] > 0.0
    assert out["step"] == 2 and out["step2"] == 2 and out["list2"]
    assert out["step3"] == 2 and out["shake3"] and out["temp3"] > 0.0
    assert out["temp"] > 0.0 and abs(out["energy"]) < 1e12
    assert abs(out["energy2"]) < 1e12
    assert out["cli_rc"] == 0 and out["scrambled"] and out["step4"] == 1
    assert abs(out["energy4"]) < 1e12 and len(out["p6"]) == 6
    assert out["step5"] == 2 and abs(out["energy5"]) < 1e12
