"""The benchmark's own arithmetic: ns/day, the union of kernel intervals,
the idle gaps, the no-JAX check."""

import pytest

from perfbench import devtrace
from perfbench.harness import ns_per_day
from perfbench.nojax import jax_modules


def test_ns_per_day():
    # 500 steps of 2 fs in 1 s: 1e-3 ns/s, 86.4 ns/day
    assert ns_per_day(500, 2.0, 1.0) == pytest.approx(86.4)
    # LAMMPS's dilute figure: 7.171 steps/s at 1 fs is 0.620 ns/day
    assert ns_per_day(7171, 1.0, 1000.0) == pytest.approx(0.6196, abs=1e-4)


def test_union_and_gaps():
    ivs = sorted([(0, 10), (5, 12), (12, 13), (20, 30), (25, 26), (40, 41)])
    merged = devtrace.union(ivs)
    assert merged == [[0, 13], [20, 30], [40, 41]]
    assert devtrace.busy_us(ivs) == 13 + 10 + 1
    assert devtrace.gaps(merged) == [(13, 20), (30, 40)]


def test_host_at_names_the_covering_event():
    cpu = [(0, 15, "cudaGraphLaunch"), (14, 40, "cudaStreamSynchronize")]
    assert devtrace.host_at(cpu, 13, 20) == "cudaStreamSynchronize"
    assert devtrace.host_at(cpu, 50, 60) == "host (no event)"


def test_kernel_of_longest_part():
    parts = {"K4": ("pair_sweep", "pair_reduce"), "K1": ("block_pair_reduce",)}
    assert devtrace.kernel_of("void block_pair_reduce_k<8>", parts) == "K1"
    assert devtrace.kernel_of("pair_reduce_kernel", parts) == "K4"
    assert devtrace.kernel_of("elementwise", parts) is None


def test_top():
    assert devtrace.top({"a": 1.0, "b": 3.0, "c": 2.0}, 2) == [["b", 3.0],
                                                              ["c", 2.0]]


def test_no_jax_by_whole_top_level_name():
    names = ["torch", "numpy.linalg", "lammps_user_conp2_tpu_torch",
             "lammps_user_conp2_tpu_torch.models.md", "jaxtyping", "flaxen"]
    assert jax_modules(names) == []
    bad = ["jax", "jax.numpy", "jaxlib.xla_client", "flax.linen",
           "lammps_user_conp2_tpu", "lammps_user_conp2_tpu.models.md"]
    assert jax_modules(names + bad) == sorted(bad)


def test_a_run_loads_no_jax():
    """A whole CPU run of a cell in a fresh interpreter leaves neither JAX
    nor the JAX package in sys.modules."""
    import subprocess
    import sys

    from conftest import ROOT
    script = (
        "import sys, time, torch\n"
        "torch.set_num_threads(2)\n"
        "from perfbench import harness\n"
        "from perfbench.nojax import jax_modules\n"
        "c = harness.load_cell('dilute0')\n"
        "c['traffic'] = dict(c['traffic'], chunk_steps=2, thermo_every=2)\n"
        "out = harness.run_cell(c, 3, 0.0, False, device='cpu',\n"
        "                       dtype=torch.float64, log=lambda m: None)\n"
        "assert out['correct'], out['checks']\n"
        "print(jax_modules(sys.modules))\n")
    r = subprocess.run([sys.executable, "-c", script], cwd=ROOT,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr[-2000:]
    assert r.stdout.strip().splitlines()[-1] == "[]"
