"""Process groups, the mesh's one collective wrapper, and the one-host
launcher of ``--mesh``.

The counterpart of ``distributed_llm_pipeline_tpu/parallel/dcn.py``. The
reference runs one controller that JAX wires to every device; PyTorch runs
one process per rank over ``torch.distributed``:

- ``initialize`` brings up this process's default group from explicit
  arguments (a rendezvous store or address, rank, world, backend) with a
  timeout, so a rank that dies or hangs makes its peers raise instead of
  wait; ``init_from_env`` does the same from ``DLP_DIST_*`` variables.
- ``Comm`` is every collective the pipeline runs: the tp all-reduce of a
  stage (the reference's ``lax.psum`` over "tp") and the send / recv of a
  chunk's hidden state between stages (its ``lax.ppermute`` over "pp").
  Gloo carries host tensors; where ranks share a card it stages each CUDA
  tensor through a pinned host buffer, explicitly. NCCL takes the device
  tensors as they are. It keeps the time it spends.
- ``spawn_followers`` starts ranks 1 … world − 1 of a one-host mesh as
  spawned processes, each with a pipe to rank 0, and a TCP store on a free
  localhost port (the OS picks it: many meshes may start at once) that
  they rendezvous on.
"""

from __future__ import annotations

import multiprocessing as mp
import os
import time
from datetime import timedelta

import torch
import torch.distributed as dist

# every process group's timeout: a collective that a dead or hung peer never
# joins raises after this long
TIMEOUT_S = 60.0


def initialize(rank: int, world: int, *, store: dist.Store | None = None,
               init_method: str | None = None, backend: str = "gloo") -> None:
    """Bring up the default process group with explicit arguments: a store
    (``spawn_followers``'s) or an ``init_method`` address such as
    ``tcp://localhost:29500``."""
    if (store is None) == (init_method is None):
        raise ValueError("initialize: give a store or an init_method, not both")
    if backend == "gloo":
        # one host: gloo's sockets on the loopback device, whatever the
        # hostname resolves to
        os.environ.setdefault("GLOO_SOCKET_IFNAME", "lo")
    dist.init_process_group(backend, store=store, init_method=init_method,
                            rank=rank, world_size=world,
                            timeout=timedelta(seconds=TIMEOUT_S))


def init_from_env(env: dict[str, str] | None = None) -> bool:
    """Bring up the default group when ``DLP_DIST_COORDINATOR`` (an
    ``init_method`` address) is set, with ``DLP_DIST_NUM_PROCESSES``,
    ``DLP_DIST_PROCESS_ID`` and optionally ``DLP_DIST_BACKEND`` (gloo).
    Returns True when the group came up."""
    e = os.environ if env is None else env
    coord = e.get("DLP_DIST_COORDINATOR")
    if not coord:
        return False
    missing = [k for k in ("DLP_DIST_NUM_PROCESSES", "DLP_DIST_PROCESS_ID")
               if k not in e]
    if missing:
        raise ValueError(f"DLP_DIST_COORDINATOR={coord!r} also needs "
                         f"{' and '.join(missing)}")
    initialize(int(e["DLP_DIST_PROCESS_ID"]), int(e["DLP_DIST_NUM_PROCESSES"]),
               init_method=coord, backend=e.get("DLP_DIST_BACKEND", "gloo"))
    return True


class Comm:
    """The collectives of one rank (``mesh.Mesh``): ``all_reduce`` over its
    stage's tp group, ``send`` / ``recv`` to another rank. Gloo on a CUDA
    rank goes through pinned host buffers. The blocks hand the all-reduce
    their row-parallel partial products in f32 (one rounding to the
    activation dtype after the sum, where the reference rounds each bf16
    partial first). ``seconds`` and ``calls`` count the time spent in
    them (host clock, copies included)."""

    def __init__(self, mesh):
        self.mesh = mesh
        self.stage_host = mesh.backend == "gloo" and mesh.device.type == "cuda"
        self.seconds = 0.0
        self.calls = 0
        self._pinned: dict[tuple, torch.Tensor] = {}

    def _host(self, shape: torch.Size, dtype: torch.dtype) -> torch.Tensor:
        key = (tuple(shape), dtype)
        buf = self._pinned.get(key)
        if buf is None:
            buf = self._pinned[key] = torch.empty(shape, dtype=dtype, pin_memory=True)
        return buf

    def _timed(self, t0: float) -> None:
        self.seconds += time.perf_counter() - t0
        self.calls += 1

    def all_reduce(self, t: torch.Tensor) -> torch.Tensor:
        """The sum of ``t`` over this stage's tp ranks (``t`` at tp = 1)."""
        if self.mesh.tp_group is None:
            return t
        t0 = time.perf_counter()
        if self.stage_host:
            h = self._host(t.shape, t.dtype)
            h.copy_(t)
            dist.all_reduce(h, group=self.mesh.tp_group)
            t.copy_(h)
        else:
            dist.all_reduce(t, group=self.mesh.tp_group)
        self._timed(t0)
        return t

    def send(self, t: torch.Tensor, dst: int) -> None:
        t0 = time.perf_counter()
        if self.stage_host:
            h = self._host(t.shape, t.dtype)
            h.copy_(t)
            t = h
        dist.send(t.contiguous(), dst)
        self._timed(t0)

    def recv(self, shape: tuple[int, ...], dtype: torch.dtype, src: int) -> torch.Tensor:
        t0 = time.perf_counter()
        if self.stage_host:
            h = self._host(torch.Size(shape), dtype)
            dist.recv(h, src)
            out = h.to(self.mesh.device)
        else:
            out = torch.empty(shape, dtype=dtype, device=self.mesh.device)
            dist.recv(out, src)
        self._timed(t0)
        return out

    def describe(self) -> str:
        """The placement event's transport line."""
        m = self.mesh
        if m.backend == "nccl":
            return (f"inter-stage transport: NCCL send/recv, intra-stage: NCCL "
                    f"all-reduce ({m.world} ranks, one GPU each)")
        if self.stage_host:
            return (f"inter-stage transport: gloo through host memory ({m.world} "
                    f"ranks share {m.device})")
        return f"inter-stage transport: gloo over loopback TCP ({m.world} CPU ranks)"


def spawn_followers(world: int, target, args: tuple):
    """Start ranks 1 … world − 1 as spawned processes running
    ``target(conn, rank, store_port, *args)``, with a pipe each to this
    process (rank 0), and the TCP store they rendezvous on, on a free
    localhost port. Returns (store, [(process, conn), ...]); the processes
    are daemons, ended with this one."""
    store = dist.TCPStore("127.0.0.1", 0, world, is_master=True,
                          timeout=timedelta(seconds=TIMEOUT_S), wait_for_workers=False)
    ctx = mp.get_context("spawn")
    followers = []
    for rank in range(1, world):
        parent, child = ctx.Pipe()
        proc = ctx.Process(target=target, args=(child, rank, store.port, *args),
                           daemon=True, name=f"mesh-rank-{rank}")
        proc.start()
        child.close()
        followers.append((proc, parent))
    return store, followers


def connect(rank: int, world: int, port: int, backend: str) -> None:
    """A follower's half of the rendezvous: the store rank 0 serves, then
    the default group."""
    store = dist.TCPStore("127.0.0.1", port, world, is_master=False,
                          timeout=timedelta(seconds=TIMEOUT_S))
    initialize(rank, world, store=store, backend=backend)
