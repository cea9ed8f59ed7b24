"""K8, RATTLE (``csrc/shake_kernel.cu``): v whole, the clustered rows of x
and the cluster tables read once, v written once; 25 operations per
constraint slot and sweep."""

PARTS = ("rattle_rows_kernel", "rattle_kernel")
COUNTER = "rattle_velocities"
SLOT_FLOPS = 25
SWEEPS = 12


def cost(s):
    n, m, k, c, r = (s["natoms"], s["clusters"], s["cluster_atoms"],
                     s["cluster_slots"], s["clustered_rows"])
    if not m:
        return None
    tables = m * k * 4 + 2 * m * c * 4 + m * k * 4 + m * c
    b = n * 12 + r * 12 + tables + n * 12
    return b, SLOT_FLOPS * SWEEPS * m * c
