"""K2a, the charges spread into the z-binned mesh (``csrc/pppm_spread.cu``
``spread_mesh_kernel``): every slot's charge and the other five rows of
the charged slots read once, the B-spline coefficients, the z-binned
mesh written once; 400 operations per charged slot (its 5 x 5 x 5
stencil)."""

PARTS = ("spread_mesh_kernel",)
COUNTER = "spread_mesh"
SLOT_FLOPS = 400
COEFFS = 5 * 5 * 4


def cost(s):
    if not s.get("tiles"):
        return None
    (ntx, nty, ntz), (tlx, tly, tlz) = s["tiles"], s["tile"]
    ez = tlz + 2 * s["tile_border"]
    t, cap, m = ntx * nty * ntz, s["slot_cap"], s["charged_elyte"]
    by = t * cap * 4 + m * 6 * 4 + COEFFS + ntx * tlx * nty * tly * ntz * ez * 4
    return by, SLOT_FLOPS * m
