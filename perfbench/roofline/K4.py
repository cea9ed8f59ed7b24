"""K4, the dense tile-pair sweep with the fused CONP correction
(``csrc/pair_kernel.cu``): its tensors read and written once, and 60
operations per pair within the cutoff."""

PARTS = ("pair_schedule", "pair_sweep", "pair_reduce")
COUNTER = "pair_forces"
PAIR_FLOPS = 60


def cost(s):
    """(bytes, operations) of one call at the shapes ``s``: x, q, the
    int64 types, the four LJ tables, the exclusion lists (int64 ids,
    float32 factors), the z order (int64 permutation, float32 keys), the
    correction's two flag vectors and two type tables; f and three
    energies out."""
    n, t1, m = s["natoms"], s["ntypes"] + 1, s["excl_width"]
    b = (n * 12 + n * 4 + n * 8 + 4 * t1 * t1 * 4 + n * m * 12 + n * 12
         + 2 * n * 4 + 2 * t1 * t1 * 4 + n * 12 + 3 * 4)
    return b, PAIR_FLOPS * s["pairs"]
