"""K1, the block Verlet list's pair sweep with the fused CONP correction
(``csrc/block_pair.cu``): its tensors read and written once (x, q, the
int64 types, the int32 union members of each block, the int64 block
rows, the four LJ tables, the correction's two flag vectors and two type
tables; the forces of every block row and three energies out), and 60
operations per ordered pair within the cutoff."""

PARTS = ("block_pack_kernel", "block_sweep_kernel", "block_force_reduce",
         "block_pair_reduce")
COUNTER = "block_pair"
PAIR_FLOPS = 60


def cost(s):
    if not s.get("list_blocks"):
        return None
    n, t1 = s["natoms"], s["ntypes"] + 1
    nb, b, u = s["list_blocks"], s["block_atoms"], s["union_width"]
    rows = nb * b
    by = (n * 12 + n * 4 + n * 8 + nb * u * 4 + rows * 8 + 4 * t1 * t1 * 4
          + 2 * n * 4 + 2 * t1 * t1 * 4 + rows * 12 + 3 * 4)
    return by, PAIR_FLOPS * 2 * s["pairs"]
