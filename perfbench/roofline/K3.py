"""K3, the ad force gather from the z-binned potential (``csrc/
pppm_gather.cu``): the xy-wrap-padded z-binned potential, the slot rows
and the B-spline coefficients read once, three field values of every
slot written once; 1000 operations per atom (values and derivatives over
its 5 x 5 x 5 stencil)."""

PARTS = ("gather3_kernel",)
COUNTER = "gather3"
ATOM_FLOPS = 1000
COEFFS = 5 * 5 * 4


def cost(s):
    if not s.get("tiles"):
        return None
    (ntx, nty, ntz), (tlx, tly, tlz) = s["tiles"], s["tile"]
    bw = s["tile_border"]
    ez = tlz + 2 * bw
    t, cap = ntx * nty * ntz, s["slot_cap"]
    up = (ntx * tlx + 2 * bw) * (nty * tly + 2 * bw) * ntz * ez * 4
    by = up + t * 8 * cap * 4 + COEFFS + t * cap * 3 * 4
    return by, ATOM_FLOPS * s["natoms"]
