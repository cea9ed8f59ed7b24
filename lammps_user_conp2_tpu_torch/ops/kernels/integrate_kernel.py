"""One half step of the integrator (K10): the CUDA kernel of
``csrc/integrate.cu`` and its plain PyTorch version.

A half step is a sequence of the integrator's stages
(``models.integrate.Integrator``), one of ``STAGES``:

    ("nhc", "kick", "drift")   the step's first half
    ("kick", "nhc")            its second half without SHAKE
    ("kick",), ("nhc",)        its second half around RATTLE

"nhc" is ``Integrator.thermostat_half`` (every thermostat in turn), "kick"
``Integrator.kick`` (v + dtfm f on mobile rows), "drift"
``Integrator.drift`` (x + dt v on mobile rows, at the velocities after the
stages before it).  The plain version is that composition, call for call.

``integrate_half`` launches the kernel for CUDA float32 tensors and takes
the plain version for CPU and CUDA float64 tensors (``build.kernel_route``).
On the card a call is one launch (two above ``ONE_CTA_MAX_ROWS`` rows when
the call has a thermostat half), which writes every output row once.  The
kick, drift and scaling are the plain version's float32 arithmetic op for
op; the chain's scalars (2 KE, the chain velocities, the scale) are formed
in float64, so xi and vxi lie within float32 rounding of the plain version
run in float64, and the velocities differ from the plain float32 version's
by that version's own float32 error in the scale.  The kernel reads
``Integrator.dtfm`` (kick's factor, formed as kick forms it) and the
tables ``tables`` builds once per integrator: ``row_bits`` (bit t:
thermostat t's group; ``MOBILE_BIT``: an integrated row) and ``nhc_par``
(per thermostat: dof, kT, Q_1, Q_k in float64, as ``nhc_half_step``
forms them).  An integrator whose instance replaces a stage is refused on
the card: the kernel runs the class's stages, not the replacement.
"""

from __future__ import annotations

import torch

from . import build

# the stage sequences and their kernel flags (kick_first, nhc, kick_last,
# drift)
STAGES = {("nhc", "kick", "drift"): (0, 1, 1, 1),
          ("kick", "nhc"): (1, 1, 0, 0),
          ("kick",): (1, 0, 0, 0),
          ("nhc",): (0, 1, 0, 0)}
MAX_THERMOSTATS = 4     # csrc/integrate.cu IH_MAX_T
MAX_CHAIN = 16          # IH_MAX_CHAIN
MOBILE_BIT = 30         # IH_MOBILE
# the split form's rows per CTA (a multiple of IH_GRID_TB = 256 threads)
SPLIT_ROWS = 1024
# rows up to which one CTA does a call with a thermostat half; above it the
# two-launch form (measured on the card: PERF.md, the K10 row)
ONE_CTA_MAX_ROWS = 4096

launches = build.LaunchCounter("integrate_half")


def integrate_half_plain(itg, v, f, x, xi, vxi, stages):
    """(v, x, xi, vxi) after ``stages`` run as the integrator's own
    methods, in order."""
    for s in stages:
        if s == "nhc":
            v, xi, vxi = itg.thermostat_half(v, xi, vxi)
        elif s == "kick":
            v = itg.kick(v, f)
        else:
            x = itg.drift(x, v)
    return v, x, xi, vxi


def tables(itg):
    """(row_bits, nhc_par) of the integrator, built on its device at the
    first call and kept on it: int32 (N,) bits, bit t for thermostat t's
    group and ``MOBILE_BIT`` for a mobile row; float64 (T, 4) dof, kT,
    Q_1 = dof kT damp^2 and Q_k = kT damp^2 of each thermostat.  The first
    call copies to the card, so it runs before any graph capture (the
    graphs' warm-up)."""
    dev = itg.mass.device
    kept = itg.__dict__.get("_k10_tables")
    if kept is not None and kept[0].device == dev:
        return kept
    bits = itg.mobile_mask.to(torch.int32) << MOBILE_BIT
    for t, p in enumerate(itg.thermostats[:MAX_THERMOSTATS]):
        bits |= p.group_mask.to(device=dev, dtype=torch.int32) << t
    par = []
    for p in itg.thermostats:
        kt = itg.units.boltz * p.t_start
        par.append([p.dof, kt, p.dof * kt * p.damp ** 2, kt * p.damp ** 2])
    kept = (bits.contiguous(), torch.tensor(
        par, dtype=torch.float64, device=dev).reshape(-1, 4))
    itg.__dict__["_k10_tables"] = kept
    return kept


def check_args(itg, v, f, x, xi, vxi, nt):
    """Raise unless the kernel takes these arguments: shapes (v, f, x
    (N, 3); xi, vxi (T, M) with every chain M links), then dtypes
    (float32), contiguity, and last the device."""
    n = itg.mass.shape[0]
    if any(t.shape != (n, 3) for t in (v, f, x)):
        raise ValueError(f"integrate_half: expected (N, 3) v, f, x with N = "
                         f"{n}, got {tuple(v.shape)}, {tuple(f.shape)}, "
                         f"{tuple(x.shape)}")
    if nt > MAX_THERMOSTATS:
        raise ValueError(f"integrate_half: the kernel takes at most "
                         f"{MAX_THERMOSTATS} thermostats, got {nt}")
    m = xi.shape[-1]
    if nt and (xi.shape != (nt, m) or vxi.shape != (nt, m)
               or not 1 <= m <= MAX_CHAIN
               or any(p.tchain != m for p in itg.thermostats)):
        raise ValueError(f"integrate_half: expected ({nt}, tchain) xi and "
                         f"vxi with tchain <= {MAX_CHAIN}, got "
                         f"{tuple(xi.shape)}, {tuple(vxi.shape)}")
    floats = (v, f, x, xi, vxi, itg.dtfm, itg.mass)
    if any(t.dtype != torch.float32 for t in floats):
        raise TypeError("integrate_half: the CUDA kernel takes float32 "
                        "v, f, x, xi, vxi and masses")
    if not all(t.is_contiguous() for t in floats):
        raise ValueError("integrate_half: expected contiguous tensors")
    build.check_cuda("integrate_half", torch.float32, *floats)


def _overridden(itg) -> bool:
    """Whether the integrator's instance replaces one of its stages."""
    return any(s in vars(itg) for s in ("thermostat_half", "kick", "drift"))


def integrate_half(itg, v, f, x, xi, vxi, stages):
    """(v, x, xi, vxi) after the half step ``stages`` (one of ``STAGES``)
    of the integrator ``itg``: v, f, x (N, 3), xi and vxi (T, tchain), the
    thermostat state; x passes through unless the stages drift, xi and vxi
    unless they run the thermostats (or there are none).  On the card: one
    launch (two in the split form), outputs written in full; an
    integrator whose instance replaces a stage raises there."""
    if stages not in STAGES:
        raise ValueError(f"integrate_half: stages {stages} are not one of "
                         f"{list(STAGES)}")
    if not build.kernel_route("integrate_half", v):
        return integrate_half_plain(itg, v, f, x, xi, vxi, stages)
    if _overridden(itg):
        raise RuntimeError("integrate_half: the integrator's instance "
                           "replaces a stage, which the CUDA kernel does "
                           "not run")
    kick_first, nhc, kick_last, drift = STAGES[stages]
    nt = len(itg.thermostats) if nhc else 0
    if not (kick_first or nt or kick_last or drift):
        return v, x, xi, vxi          # a thermostat half with no thermostat
    check_args(itg, v, f, x, xi, vxi, nt)
    row_bits, nhc_par = tables(itg)
    n = v.shape[0]
    split = int(nt > 0 and n > ONE_CTA_MAX_ROWS)
    g = -(-n // SPLIT_ROWS)
    part = (torch.empty(g * ((1 << nt) - 1), dtype=torch.float64,
                        device=v.device) if split else None)
    v_out = torch.empty_like(v)
    x_out = torch.empty_like(x) if drift else x
    xi_out = torch.empty_like(xi) if nt else xi
    vxi_out = torch.empty_like(vxi) if nt else vxi
    dt = itg.dt
    lib = build.load_library()
    status = lib.conp2_integrate_half_f32(
        v.data_ptr(), f.data_ptr(), x.data_ptr(), itg.dtfm.data_ptr(),
        itg.mass.data_ptr(), row_bits.data_ptr(), nhc_par.data_ptr(),
        xi.data_ptr(), vxi.data_ptr(), n, nt, xi.shape[-1], kick_first,
        kick_last, drift, dt, dt / 2.0, dt / 4.0, dt / 8.0, itg.units.mvv2e,
        split, SPLIT_ROWS, 0 if part is None else part.data_ptr(),
        v_out.data_ptr(), x_out.data_ptr(), xi_out.data_ptr(),
        vxi_out.data_ptr(), build.stream_ptr(v.device))
    build.check_status("integrate_half", status)
    launches.count += 1 + split
    return v_out, x_out, xi_out, vxi_out
