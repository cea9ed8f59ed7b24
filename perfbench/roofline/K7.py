"""K7, SHAKE (``csrc/shake_kernel.cu``): x_new whole, the clustered rows
of x_old and the cluster tables read once, x and dv written once; 45
operations per constraint slot and sweep."""

PARTS = ("shake_rows_kernel", "shake_kernel")
COUNTER = "shake_positions"
SLOT_FLOPS = 45
SWEEPS = 12


def cost(s):
    n, m, k, c, r = (s["natoms"], s["clusters"], s["cluster_atoms"],
                     s["cluster_slots"], s["clustered_rows"])
    if not m:
        return None
    tables = m * k * 4 + 2 * m * c * 4 + m * k * 4 + m * c
    b = n * 12 + r * 12 + tables + m * c * 4 + 2 * n * 12
    return b, SLOT_FLOPS * SWEEPS * m * c
