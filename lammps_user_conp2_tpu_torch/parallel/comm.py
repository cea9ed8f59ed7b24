"""Process groups and collectives for the sharded step (``sharded.py``).

The JAX package writes its step with ``shard_map``, where the collectives
are built in; here each rank is a process and the collectives go through
``torch.distributed``: NCCL for CUDA tensors, gloo for CPU tensors, chosen
by the device and never mixed.  The group meets through a ``FileStore``,
so no network address is needed.

Every reduction that feeds replicated state is an ``all_gather`` followed
by a sum in rank order (``psum``): each rank adds the same parts in the
same order, so the replicated values are equal bit for bit on every rank
and from run to run, whatever algorithm the backend would use for
``all_reduce``.  ``pmin``/``pmax`` are exact and use ``all_reduce``.
``all_gather`` is the list form, which both the card's torch (2.11) and
newer ones have.
"""

from __future__ import annotations

import dataclasses
import datetime
import hashlib
import os
import pickle
import shutil
import tempfile
import time

import numpy as np
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

# how long a collective waits for a peer before the group fails
DEFAULT_TIMEOUT = datetime.timedelta(seconds=300)


@dataclasses.dataclass(frozen=True)
class Comm:
    """This rank's place in the default process group and its device."""
    rank: int
    size: int
    device: torch.device

    def all_gather_rows(self, t, n=None):
        """The ranks' ``t`` (equal shapes) concatenated along the first
        axis in rank order, cut to ``n`` rows (the tiled ``all_gather``)."""
        out = torch.cat(self._gather(t), dim=0)
        return out if n is None else out[:n]

    def psum(self, t):
        """The sum of every rank's ``t``, added in rank order."""
        parts = self._gather(t)
        acc = parts[0]
        for p in parts[1:]:
            acc = acc + p
        return acc

    def pmin(self, t):
        return self._reduce(t, dist.ReduceOp.MIN)

    def pmax(self, t):
        return self._reduce(t, dist.ReduceOp.MAX)

    def _gather(self, t):
        cplx = t.is_complex()
        src = (torch.view_as_real(t) if cplx else t).contiguous()
        shape = src.shape
        flat = src.reshape(-1)
        parts = [torch.empty_like(flat) for _ in range(self.size)]
        dist.all_gather(parts, flat)
        parts = [p.reshape(shape) for p in parts]
        return [torch.view_as_complex(p) for p in parts] if cplx else parts

    def _reduce(self, t, op):
        kind = t.dtype
        out = t.to(torch.int64) if kind == torch.bool else t.clone()
        out = out.reshape(-1).contiguous()
        dist.all_reduce(out, op=op)
        return out.reshape(t.shape).to(kind)


def init_group(device, rank: int, world: int, store_path: str, *,
               timeout: datetime.timedelta = DEFAULT_TIMEOUT) -> Comm:
    """Join the default process group as ``rank`` of ``world`` through a
    ``FileStore`` at ``store_path`` (a file every rank can reach, absent or
    empty before the first rank joins): NCCL on a CUDA device, gloo on the
    CPU.  Returns this rank's ``Comm``."""
    device = torch.device(device)
    if device.type == "cuda":
        if device.index is None:
            device = torch.device("cuda", rank % torch.cuda.device_count())
        torch.cuda.set_device(device)
        backend = "nccl"
    elif device.type == "cpu":
        backend = "gloo"
    else:
        raise ValueError(f"no process-group backend for {device}")
    store = dist.FileStore(store_path, world)
    dist.init_process_group(backend, store=store, rank=rank,
                            world_size=world, timeout=timeout)
    return Comm(rank=rank, size=world, device=device)


def default_comm(device) -> Comm:
    """The ``Comm`` of an initialised default process group."""
    if not dist.is_initialized():
        raise RuntimeError("no process group: call comm.init_group first")
    return Comm(rank=dist.get_rank(), size=dist.get_world_size(),
                device=torch.device(device))


def close_group() -> None:
    """Leave the default process group (no-op without one)."""
    if dist.is_initialized():
        dist.destroy_process_group()


def digest(obj) -> str:
    """sha256 of tensors and arrays, in order, of ``obj``: a tensor, an
    array, or a (nested) list, tuple or dict of them (dicts by key)."""
    h = hashlib.sha256()

    def walk(o):
        if isinstance(o, dict):
            for k in sorted(o):
                h.update(str(k).encode())
                walk(o[k])
        elif isinstance(o, (list, tuple)):
            for v in o:
                walk(v)
        elif isinstance(o, torch.Tensor):
            h.update(str(o.dtype).encode())
            h.update(o.detach().cpu().contiguous().numpy().tobytes())
        elif o is not None:
            a = np.ascontiguousarray(o)
            h.update(str(a.dtype).encode())
            h.update(a.tobytes())

    walk(obj)
    return h.hexdigest()


def _rank_main(rank, fn, world, device, tmp, args):
    torch.set_num_threads(1)
    comm = init_group(device, rank, world, os.path.join(tmp, "store"))
    try:
        results, replicated = fn(rank, comm, *args)
        out = dict(digest={k: digest(v) for k, v in replicated.items()})
        if rank == 0:
            out["results"] = results
        with open(os.path.join(tmp, f"rank{rank}.pkl"), "wb") as fh:
            pickle.dump(out, fh)
    finally:
        close_group()


def spawn_ranks(fn, d: int, device, *args, timeout: float = 600.0):
    """Run ``fn(rank, comm, *args)`` in ``d`` spawned processes joined in
    one group on ``device`` ("cpu": gloo).  ``fn`` lives in a module the
    children can import and returns (results, replicated): ``results``
    picklable (numpy), ``replicated`` a dict of name -> tensors that every
    rank holds alike.  Returns (rank 0's results, [each rank's {name:
    digest of its replicated[name]}]).  A rank that raises fails the call
    and its peers are stopped; a call that outlives ``timeout`` seconds
    stops every rank and raises TimeoutError."""
    tmp = tempfile.mkdtemp(prefix="conp2_ranks_")
    try:
        ctx = mp.start_processes(_rank_main,
                                 args=(fn, d, str(device), tmp, args),
                                 nprocs=d, join=False, start_method="spawn")
        deadline = time.monotonic() + timeout
        try:
            while not ctx.join(timeout=1.0):
                if time.monotonic() > deadline:
                    raise TimeoutError(f"spawn_ranks: {d} ranks did not "
                                       f"finish in {timeout} s")
        finally:
            for p in ctx.processes:
                if p.is_alive():
                    p.kill()
                p.join()
        outs = []
        for r in range(d):
            with open(os.path.join(tmp, f"rank{r}.pkl"), "rb") as fh:
                outs.append(pickle.load(fh))
        return outs[0]["results"], [o["digest"] for o in outs]
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
