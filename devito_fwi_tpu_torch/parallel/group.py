"""Meshes of ranks over ``torch.distributed`` process groups, the one
collective the parallel layer uses, the per-card budget share, and a
helper that runs a function on several ranks.

A mesh is a view of a process group, not a list of devices: each process
is one rank and drives one device, ``cuda:{local rank % device count}``
(or the CPU when asked). ``shot_mesh`` is one axis ``("shots",)``;
``domain_mesh`` splits the grid's leading axes; ``hier_mesh`` is ``("shots",
"dx")``, shot groups by domain columns. The ranks' coordinates are
row-major in the mesh's axis sizes, as the JAX package's
``devices.reshape(axis_sizes)``. Without an initialised
``torch.distributed`` a mesh is a world of one, and its collectives do
nothing.

Every exchange is an ``all_reduce`` sum (gloo takes CUDA tensors only for
``all_reduce`` and ``broadcast``, and only gloo runs several ranks on one
card): a gather is the sum of zero-filled full-size buffers in which each
rank wrote only its own entries, exact because each sum has one term that
is not zero.
"""
from __future__ import annotations

import contextlib
import os
import pickle
import shutil
import socket
import tempfile
import time
import traceback
import zlib

import numpy as np
import torch
import torch.distributed as dist

__all__ = ["Mesh", "shot_mesh", "domain_mesh", "hier_mesh", "spawn",
           "budget_share", "all_sum_", "block"]


def _initialised():
    return dist.is_available() and dist.is_initialized()


def _world():
    """(this process's rank, the world's size): (0, 1) without a group."""
    if not _initialised():
        return 0, 1
    return dist.get_rank(), dist.get_world_size()


def _group_ranks(group):
    """The global ranks of ``group`` (None: the default group), in order."""
    if not _initialised():
        return [0]
    if group is None:
        return list(range(dist.get_world_size()))
    return dist.get_process_group_ranks(group)


def _rank_device(device):
    """The device of this rank: "cuda" is ``cuda:{local rank % device
    count}`` (the local rank from ``LOCAL_RANK``, else the global rank);
    without a card it raises, never running on the CPU."""
    from ..fwi import _resolve_device
    dev = _resolve_device(device)
    if dev.type == "cuda" and dev.index is None:
        local = int(os.environ.get("LOCAL_RANK", _world()[0]))
        dev = torch.device("cuda", local % torch.cuda.device_count())
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    return dev


def all_sum_(t, group=None):
    """Sum ``t`` in place over the ranks of ``group``; nothing without an
    initialised ``torch.distributed``."""
    if _initialised():
        dist.all_reduce(t, op=dist.ReduceOp.SUM, group=group)
    return t


def block(n, parts, index):
    """Indices of part ``index`` of ``range(n)`` cut into ``parts``
    contiguous blocks as even as possible (empty when n < parts)."""
    return np.array_split(np.arange(n), parts)[index]


class Mesh:
    """A process group seen as a mesh of ranks.

    ``shape`` the axis sizes, ``axis_names`` their names, ``group`` the
    process group of the mesh's ranks (None: the default group, or no
    group), ``rank`` this process's index in the mesh (None when it is not
    one of its ranks), ``coords`` its coordinates, ``device`` its device,
    ``share`` how many of the mesh's ranks drive the same card (they divide
    ``fwi._device_budget`` between them), ``axis_groups`` for each axis the
    group of the ranks that differ from this one only along it."""

    def __init__(self, shape, axis_names, group, rank, device,
                 axis_groups=None):
        self.shape = tuple(int(n) for n in shape)
        self.axis_names = tuple(axis_names)
        self.group = group
        self.rank = rank
        self.size = int(np.prod(self.shape))
        self.coords = None if rank is None else \
            tuple(int(c) for c in np.unravel_index(rank, self.shape))
        self.device = device
        self.axis_groups = axis_groups or {}
        self.share = 1 if rank is None else self._device_share()

    def _device_share(self):
        """Ranks of the mesh whose device is this rank's card: one
        all_reduce of a key a rank (host name and card index)."""
        if self.device.type != "cuda" or self.size == 1:
            return 1
        host = zlib.crc32(socket.gethostname().encode())
        key = float(host * 256 + self.device.index + 1)
        keys = torch.zeros(self.size, dtype=torch.float64,
                           device=self.device)
        keys[self.rank] = key
        all_sum_(keys, self.group)
        return int((keys == key).sum())

    def sum_(self, t):
        """Sum ``t`` in place over the mesh's ranks."""
        return all_sum_(t, self.group)

    def __repr__(self):
        return (f"Mesh({dict(zip(self.axis_names, self.shape))}, rank "
                f"{self.rank}, coords {self.coords}, {self.device}, share "
                f"{self.share})")


def _members(n, group, what):
    """(the first n global ranks of ``group``, the group of just those,
    this process's index among them or None). Every rank of ``group``
    calls this, members or not: ``dist.new_group`` needs all of them."""
    ranks = _group_ranks(group)
    if n > len(ranks):
        raise ValueError(f"{what} needs {n} ranks, only {len(ranks)} "
                         "available")
    me = _world()[0]
    if n == len(ranks) or not _initialised():
        sub = group
    else:
        sub = dist.new_group(ranks[:n])
    return ranks[:n], sub, (ranks[:n].index(me) if me in ranks[:n]
                            else None)


def shot_mesh(group=None, device="cuda"):
    """1-D mesh ``("shots",)`` over every rank of ``group`` (None: the
    default group; a world of one without ``torch.distributed``)."""
    ranks, sub, rank = _members(len(_group_ranks(group)), group,
                                "shot_mesh")
    return Mesh((len(ranks),), ("shots",), sub, rank, _rank_device(device))


def domain_mesh(axis_sizes, group=None, device="cuda",
                axis_names=("dx", "dz")):
    """N-D mesh over the grid's leading axes, e.g. ``domain_mesh((2, 2))``:
    the first prod(axis_sizes) ranks of ``group``; the others get a mesh
    with ``rank`` None, and the domain functions return None on them."""
    n = int(np.prod(axis_sizes))
    _, sub, rank = _members(n, group, f"domain_mesh {tuple(axis_sizes)}")
    return Mesh(axis_sizes, axis_names[:len(axis_sizes)], sub, rank,
                _rank_device(device))


def hier_mesh(axis_sizes, group=None, device="cuda"):
    """2-D mesh ``("shots", "dx")`` of S shot groups by D domain columns:
    each shot's wavefield lives on one row of D ranks (its "dx" group,
    which exchanges halos every step), and the shot groups' sums meet once
    at the end. Every rank of ``group`` makes every row and column group,
    in the same order, members or not."""
    S, D = (int(a) for a in axis_sizes)
    ranks, sub, rank = _members(S * D, group, f"hier_mesh {(S, D)}")
    rows = [[ranks[s * D + d] for d in range(D)] for s in range(S)]
    cols = [[ranks[s * D + d] for s in range(S)] for d in range(D)]
    axis_groups = {}
    if _initialised():
        me = _world()[0]
        for name, sets in (("dx", rows), ("shots", cols)):
            for members in sets:
                g = dist.new_group(members)
                if me in members:
                    axis_groups[name] = g
    return Mesh((S, D), ("shots", "dx"), sub, rank, _rank_device(device),
                axis_groups)


@contextlib.contextmanager
def budget_share(mesh):
    """For the length of the block, ``fwi._device_budget`` gives this rank
    its part of the card's budget: the ranks that share a card would each
    plan for all of it."""
    from .. import fwi
    saved = fwi._BUDGET_SHARE
    fwi._BUDGET_SHARE = mesh.share
    try:
        yield
    finally:
        fwi._BUDGET_SHARE = saved


# ---------------------------------------------------------------------------
# running a function on several ranks
# ---------------------------------------------------------------------------

def _rank_main(fn, args, rank, nranks, backend, store_path, out_dir):
    """A spawned rank: meet the others at the file store, run ``fn(*args)``,
    write its result (or its traceback) under ``out_dir``."""
    os.environ["LOCAL_RANK"] = str(rank)
    # one host: the ranks meet over the loopback device
    os.environ.setdefault("GLOO_SOCKET_IFNAME", "lo")
    os.environ.setdefault("NCCL_SOCKET_IFNAME", "lo")
    try:
        if backend == "nccl":
            torch.cuda.set_device(rank % torch.cuda.device_count())
        dist.init_process_group(backend, store=dist.FileStore(store_path,
                                                              nranks),
                                rank=rank, world_size=nranks)
        result = fn(*args)
        dist.destroy_process_group()
        with open(os.path.join(out_dir, f"{rank}.pkl"), "wb") as f:
            pickle.dump(result, f)
    except BaseException:
        # written before this process lets its peers go (they fail in
        # their collectives after it); the host's monotonic clock orders
        # the ranks' failures
        with open(os.path.join(out_dir, f"{rank}.err"), "w") as f:
            f.write(f"{time.monotonic_ns()}\n{traceback.format_exc()}")
        raise SystemExit(1)


def _failures(work, procs):
    """Every failed rank's traceback, the first to fail first (a rank's
    failure makes its peers fail in their collectives)."""
    errs = []
    for r in range(len(procs)):
        path = os.path.join(work, f"{r}.err")
        if os.path.exists(path):
            with open(path) as f:
                when, why = f.read().split("\n", 1)
            errs.append((int(when), r, why))
    lines = [f"rank {r} of {len(procs)} failed:\n{why}"
             for _, r, why in sorted(errs)]
    lines += [f"rank {r} of {len(procs)} exited with code {p.exitcode}"
              for r, p in enumerate(procs)
              if p.exitcode != 0 and r not in {e[1] for e in errs}]
    return "\n".join(lines)


def spawn(fn, nranks, backend="gloo", device="cpu", args=(), timeout=900):
    """Run ``fn(*args)`` on ``nranks`` new processes that form one
    ``torch.distributed`` world (``backend`` "gloo" or "nccl"), meeting at a
    ``FileStore`` in a temporary directory (no TCP port to choose, so
    concurrent callers cannot clash); return their results in rank order.
    ``device`` "cuda" needs a card (checked here, before any process
    starts); ``fn`` builds its meshes itself. A rank that fails stops the
    others and its traceback is raised here; so is a world that outlives
    ``timeout`` seconds. ``fn`` and ``args`` must pickle (``fn`` a module-
    level function of a module the children can import)."""
    import multiprocessing as mp
    from ..fwi import _resolve_device
    _resolve_device(device)
    ctx = mp.get_context("spawn")
    work = tempfile.mkdtemp(prefix="dfwi_spawn_")
    try:
        store = os.path.join(work, "store")
        procs = [ctx.Process(target=_rank_main,
                             args=(fn, args, r, nranks, backend, store,
                                   work), daemon=True)
                 for r in range(nranks)]
        for p in procs:
            p.start()
        deadline = time.monotonic() + timeout
        failed = None
        while failed is None and any(p.is_alive() for p in procs):
            if time.monotonic() > deadline:
                for p in procs:
                    p.terminate()
                    p.join()
                raise TimeoutError(f"spawn: the {nranks} ranks did not "
                                   f"finish within {timeout} s")
            failed = next((r for r, p in enumerate(procs)
                           if p.exitcode not in (None, 0)), None)
            time.sleep(0.05)
        # a failed rank leaves the others waiting in a collective
        for p in procs:
            if p.is_alive() and failed is not None:
                p.terminate()
            p.join()
        if failed is None:
            failed = next((r for r, p in enumerate(procs)
                           if p.exitcode != 0), None)
        if failed is not None:
            raise RuntimeError(_failures(work, procs))
        results = []
        for r in range(nranks):
            with open(os.path.join(work, f"{r}.pkl"), "rb") as f:
                results.append(pickle.load(f))
        return results
    finally:
        shutil.rmtree(work, ignore_errors=True)
