"""K10, one half step of the integrator (``ops/kernels/integrate_kernel``),
on the CPU.

* The plain version (``integrate_half_plain``, and ``integrate_half`` on
  the CPU) equals the integrator's own composition
  (``thermostat_half`` -> ``kick`` -> ``drift``; ``kick`` ->
  ``thermostat_half``; each alone) bit for bit, in float32 and float64,
  with 1 and 2 thermostats, overlapping groups, frozen rows, tchain 3
  and 5.
* The tables the kernel reads: ``Integrator.dtfm`` kicks as ``kick`` does
  bit for bit; ``tables`` (``row_bits``, ``nhc_par``) holds the groups, the
  mobile rows and the chain constants, built once per integrator.
* The wrapper refuses a stage sequence it does not have, arguments of the
  wrong shape, dtype, contiguity or device (the kernel route forced on
  CPU tensors), and an integrator whose instance replaces a stage, with
  no launch; on the CPU such an integrator runs its replacement.
"""

import pytest
import torch

from lammps_user_conp2_tpu_torch.ops.kernels import build
from lammps_user_conp2_tpu_torch.ops.kernels import integrate_kernel as ik
from lammps_user_conp2_tpu_torch.utils.units import REAL
from torch_cells import integrator_case

N = 61
STAGES = list(ik.STAGES)


def make(dtype, nthermo=1, tchain=3, overlap=False, seed=0):
    return integrator_case(N, dtype, "cpu", nthermo, tchain, overlap, seed)


def composed(itg, v, f, x, xi, vxi, stages):
    """The integrator's methods in the order ``stages`` names them."""
    if stages == ("nhc", "kick", "drift"):
        v, xi, vxi = itg.thermostat_half(v, xi, vxi)
        v = itg.kick(v, f)
        return v, itg.drift(x, v), xi, vxi
    if stages == ("kick", "nhc"):
        v, xi, vxi = itg.thermostat_half(itg.kick(v, f), xi, vxi)
        return v, x, xi, vxi
    if stages == ("kick",):
        return itg.kick(v, f), x, xi, vxi
    v, xi, vxi = itg.thermostat_half(v, xi, vxi)
    return v, x, xi, vxi


CASES = [(1, 3, False), (2, 3, False), (2, 5, True), (1, 5, False)]


@pytest.mark.parametrize("stages", STAGES, ids="-".join)
@pytest.mark.parametrize("nthermo,tchain,overlap", CASES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_plain_equals_composition(dtype, nthermo, tchain, overlap, stages):
    itg, *args = make(dtype, nthermo, tchain, overlap)
    want = composed(itg, *args, stages)
    n0 = ik.launches.count
    for got in (ik.integrate_half_plain(itg, *args, stages),
                ik.integrate_half(itg, *args, stages)):
        assert all(torch.equal(a, b) for a, b in zip(got, want))
    assert ik.launches.count == n0
    v, x = want[0], want[1]
    frozen = ~itg.mobile_mask
    # frozen rows keep their velocity through kicks and their position
    # through the drift
    if "kick" in stages and "nhc" not in stages:
        assert torch.equal(v[frozen], args[0][frozen])
    assert torch.equal(x[frozen], args[2][frozen])


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_tables(dtype):
    itg, v, f, x, xi, vxi = make(dtype, 2, 3, overlap=True)
    kicked = torch.where(itg.mobile_mask[:, None], v + itg.dtfm[:, None] * f,
                         v)
    assert torch.equal(kicked, itg.kick(v, f))
    bits, par = ik.tables(itg)
    assert ik.tables(itg)[0] is bits
    assert bits.dtype == torch.int32
    assert torch.equal((bits >> ik.MOBILE_BIT & 1).bool(), itg.mobile_mask)
    for t, p in enumerate(itg.thermostats):
        assert torch.equal((bits >> t & 1).bool(), p.group_mask)
        kt = REAL.boltz * p.t_start
        assert par[t].tolist() == [p.dof, kt, p.dof * kt * p.damp ** 2,
                                   kt * p.damp ** 2]
    assert par.dtype == torch.float64


def test_unknown_stages_raise():
    itg, *args = make(torch.float32)
    with pytest.raises(ValueError, match="stages"):
        ik.integrate_half(itg, *args, ("drift", "kick"))


def _bad(kind):
    itg, v, f, x, xi, vxi = make(torch.float32, 2)
    if kind == "shape":
        f = f[:-1]
    elif kind == "chain":
        xi, vxi = xi[:, :2].contiguous(), vxi[:, :2].contiguous()
    elif kind == "dtype":
        f = f.double()
    elif kind == "contiguity":
        v = v.t().contiguous().t()
    return itg, v, f, x, xi, vxi


@pytest.mark.parametrize("kind,err,match", [
    ("shape", ValueError, r"\(N, 3\)"), ("chain", ValueError, "tchain"),
    ("dtype", TypeError, "float32"), ("contiguity", ValueError, "contiguous"),
    ("device", ValueError, "CUDA")])
def test_kernel_route_refuses_bad_arguments(kind, err, match, monkeypatch):
    monkeypatch.setattr(build, "kernel_route", lambda name, t: True)
    itg, *args = _bad(kind)
    n0 = ik.launches.count
    # a call without a thermostat half reads no chain state
    for stages in [s for s in STAGES if kind != "chain" or "nhc" in s]:
        with pytest.raises(err, match=match):
            ik.integrate_half(itg, *args, stages)
    assert ik.launches.count == n0


def test_replaced_stage_raises_on_the_kernel_route(monkeypatch):
    itg, *args = make(torch.float32, 2)
    itg.kick = lambda v, f: v
    # on the CPU the plain version runs the replacement
    got = ik.integrate_half(itg, *args, ("kick", "nhc"))
    want = itg.thermostat_half(args[0], args[3], args[4])
    assert torch.equal(got[0], want[0]) and torch.equal(got[3], want[2])
    monkeypatch.setattr(build, "kernel_route", lambda name, t: True)
    n0 = ik.launches.count
    with pytest.raises(RuntimeError, match="replaces a stage"):
        ik.integrate_half(itg, *args, ("kick", "nhc"))
    assert ik.launches.count == n0
