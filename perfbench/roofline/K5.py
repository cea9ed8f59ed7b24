"""K5, the electrode rows of the b vector (``csrc/ele_rows_kernel.cu``):
its tensors read and written once, and 40 operations per
electrode-electrolyte pair within the Coulomb cutoff."""

PARTS = ("b_order_kernel", "b_rows_kernel")
COUNTER = "b_realspace"
ROW_FLOPS = 40


def cost(s):
    """(bytes, operations) of one call: x, the electrolyte charges, the
    int64 electrode rows, the electrolyte flags, the electrodes' width and
    overlap rows over the types, the int64 types, the z order; b out."""
    n, ne, t1 = s["natoms"], s["ne"], s["ntypes"] + 1
    b = (n * 12 + n * 4 + ne * 8 + n * 4 + 2 * ne * t1 * 4 + n * 8
         + n * 12 + ne * 4)
    return b, ROW_FLOPS * s["ele_pairs"]
