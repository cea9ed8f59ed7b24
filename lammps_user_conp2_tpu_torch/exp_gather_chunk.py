"""Rate of a global-memory gather of 4-float atom rows: the floor that the
shared-memory window gather (``exp_vmem_gather``, K9) is measured against.

    python -m lammps_user_conp2_tpu_torch.exp_gather_chunk

Gathers rows of an (n + 1, 4) float32 standard-normal table by (n, k)
indices and sums them, n = 99,362 (the 100k cell's atoms) and k = 56 (its
neighbour-list width): 5.56M rows per step, in one index ("one-shot") or
in 4, 8 and 16 chunks summed in a loop.  Two index sets from
``np.random.default_rng(0)``: uniform over the table ("random") and row id
+ uniform [-400, 400) mod n ("local", as a z-sorted neighbour list issues
them).  Plain PyTorch on the card (reads through L1/L2): indexing, as
the JAX tool's ``t[idx]``, and once more one-shot with each 4-float row
gathered as one 16-byte element (``gather_sum_rows``), which keeps
PyTorch's row-gather kernel out of the measurement; the probe has no
kernel of its own.

Timed step, chained 50 times by ``timing.chain_ms`` (min of 3 trials):
``tab = tab + 1e-30 * g(tab)``, g the (1, 4) gather sum.  Reported: ms per
step and ns/row = ms 1e6 / (n k).  Runs on the card; ``device="cpu"``
runs on the CPU.
"""

from __future__ import annotations

import numpy as np
import torch

from .timing import chain_ms
from .utils.device import resolve_device

N_ATOMS = 99362
K_NEIGH = 56
WIDTH = 4
CHUNKS = (4, 8, 16)
EPS = 1e-30


def make_inputs(n=N_ATOMS, k=K_NEIGH):
    """(table (n+1, 4) float64, {"random": (n, k), "local": (n, k)} int32)
    as numpy arrays."""
    rng = np.random.default_rng(0)
    tab = rng.standard_normal((n + 1, WIDTH))
    idx_rand = rng.integers(0, n, size=(n, k)).astype(np.int32)
    idx_loc = ((np.arange(n)[:, None] + rng.integers(-400, 400, size=(n, k)))
               % n).astype(np.int32)
    return tab, {"random": idx_rand, "local": idx_loc}


def gather_sum(tab, idx):
    """(1, 4): the sum of the table rows ``idx`` names, in one gather."""
    return torch.sum(tab[idx.reshape(-1)], dim=0, keepdim=True)


def gather_sum_rows(tab, idx):
    """(1, 4): the same sum from an (m, 4) float32 table, each row gathered
    as one 16-byte element (the table viewed as complex128) by
    ``torch.gather``: one element per index, where indexing gathers rows
    through PyTorch's row-gather kernel."""
    if tab.dtype != torch.float32 or tab.shape[1] != WIDTH:
        raise ValueError("gather_sum_rows: takes an (m, 4) float32 table")
    rows16 = tab.view(torch.complex128)[:, 0]
    g = torch.gather(rows16, 0, idx.reshape(-1))
    return torch.sum(torch.view_as_real(g).view(torch.float32), dim=0,
                     keepdim=True)


def gather_sum_chunked(tab, idx_c):
    """(1, 4): the same sum, one gather per row of ``idx_c`` (nchunk, rows),
    accumulated in chunk order."""
    acc = torch.zeros(tab.shape[1], dtype=tab.dtype, device=tab.device)
    for c in range(idx_c.shape[0]):
        acc = acc + torch.sum(tab[idx_c[c]], dim=0)
    return acc[None]


def run(n=N_ATOMS, k=K_NEIGH, device=None, iters=50):
    """Time every (index set, chunking), and the one-shot sum of rows
    gathered as 16-byte elements; prints one line each and returns a list
    of dict(name, chunks, rows, ms, ns_row, op), op "index" or
    "elements"."""
    dev = resolve_device(device)
    tab_np, idx_sets = make_inputs(n, k)
    tab = torch.as_tensor(tab_np, dtype=torch.float32, device=dev)
    rows = n * k
    out = []
    for name, idx_np in idx_sets.items():
        idx = torch.as_tensor(idx_np, device=dev)
        for nchunk in (1,) + CHUNKS:
            if rows % nchunk:
                raise ValueError(f"{rows} rows do not split into {nchunk}")
            if nchunk == 1:
                g = lambda t: gather_sum(t, idx)
                label = f"one-shot  ({rows / 1e6:.2f}M)"
            else:
                idx_c = idx.reshape(nchunk, rows // nchunk)
                g = lambda t, idx_c=idx_c: gather_sum_chunked(t, idx_c)
                label = f"{nchunk:2d}-chunk ({rows / nchunk / 1e6:.2f}M each)"
            ms = chain_ms(lambda t, g=g: t + EPS * g(t), tab, iters=iters)
            ns_row = ms * 1e6 / rows
            print(f"{name:6s}  {label}: {ms:7.3f} ms  {ns_row:6.4f} ns/row",
                  flush=True)
            out.append(dict(name=name, chunks=nchunk, rows=rows, ms=ms,
                            ns_row=ns_row, op="index"))
        ms = chain_ms(lambda t: t + EPS * gather_sum_rows(t, idx), tab,
                      iters=iters)
        ns_row = ms * 1e6 / rows
        print(f"{name:6s}  one-shot 16-byte elements: {ms:7.3f} ms  "
              f"{ns_row:6.4f} ns/row", flush=True)
        out.append(dict(name=name, chunks=1, rows=rows, ms=ms, ns_row=ns_row,
                        op="elements"))
    return out


def main():
    dev = resolve_device(None)
    print(f"device: {torch.cuda.get_device_name(dev)}", flush=True)
    run(device=dev)


if __name__ == "__main__":
    main()
