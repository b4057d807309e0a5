"""The pp × tp mesh of one serving process group.

The counterpart of ``distributed_llm_pipeline_tpu/parallel/mesh.py``.
``MeshSpec`` is the reference's, copied: the axes of the ``--mesh`` flag
(``"2x2"`` is pp = 2 stages × tp = 2 ranks a stage). Where the reference
builds one ``jax.sharding.Mesh`` over devices that one controller drives,
the port runs one process per rank; ``Mesh`` is one rank's view of the
group: its place (stage, tp rank), its neighbours, the process group of its
stage's tp ranks, its device and the backend that carries the collectives.

Ranks are numbered stage-major, tp innermost, as the reference reshapes its
devices ``(dp, pp, tp)``: rank = stage · tp + tp_rank. Rank 0 (stage 0, tp
rank 0) drives the others; the last stage's tp rank 0 sends the hidden rows the
head needs to it.
"""

from __future__ import annotations

import re
from dataclasses import dataclass

import torch
import torch.distributed as dist


@dataclass(frozen=True)
class MeshSpec:
    pp: int = 1
    tp: int = 1
    dp: int = 1

    @classmethod
    def parse(cls, text: str) -> "MeshSpec":
        """'2x1' → pp=2, tp=1 · '2x2x2' → dp=2, pp=2, tp=2 · 'pp=4,tp=2' also ok."""
        text = text.strip().lower()
        if "=" in text:
            kv = dict(p.split("=") for p in re.split(r"[,; ]+", text) if p)
            return cls(pp=int(kv.get("pp", 1)), tp=int(kv.get("tp", 1)),
                       dp=int(kv.get("dp", 1)))
        dims = [int(d) for d in text.split("x")]
        if len(dims) == 1:
            return cls(pp=dims[0])
        if len(dims) == 2:
            return cls(pp=dims[0], tp=dims[1])
        if len(dims) == 3:
            return cls(dp=dims[0], pp=dims[1], tp=dims[2])
        raise ValueError(f"cannot parse mesh spec {text!r}")

    @property
    def n_devices(self) -> int:
        return self.dp * self.pp * self.tp


def placement(spec: MeshSpec, device: torch.device) -> tuple[list[str], str]:
    """Each rank's device and the backend of the group. CPU ranks use gloo.
    On CUDA, rank r takes card r mod the card count; NCCL carries the
    collectives when every rank has a card of its own, gloo when ranks
    share one (NCCL refuses two ranks on one card), staged through host
    memory."""
    world = spec.pp * spec.tp
    if device.type == "cpu":
        return ["cpu"] * world, "gloo"
    n = torch.cuda.device_count()
    if n < 1:
        raise RuntimeError("no CUDA device for the mesh ranks")
    return [f"cuda:{r % n}" for r in range(world)], "nccl" if n >= world else "gloo"


@dataclass
class Mesh:
    """One rank's place in a pp × tp group whose default process group is
    up (``dist.initialize``)."""

    spec: MeshSpec
    rank: int
    device: torch.device
    backend: str
    tp_group: object = None   # this stage's tp ranks (None at tp = 1)

    @classmethod
    def build(cls, spec: MeshSpec, rank: int, device: torch.device,
              backend: str) -> "Mesh":
        """Every rank calls this in the same order: each stage's tp group is
        created collectively by all ranks."""
        if spec.dp != 1:
            raise ValueError(f"mesh {spec}: the port serves dp = 1 meshes")
        mesh = cls(spec, rank, device, backend)
        if spec.tp > 1:
            for s in range(spec.pp):
                group = dist.new_group(list(range(s * spec.tp, (s + 1) * spec.tp)))
                if s == mesh.stage:
                    mesh.tp_group = group
        return mesh

    @property
    def world(self) -> int:
        return self.spec.pp * self.spec.tp

    @property
    def pp(self) -> int:
        return self.spec.pp

    @property
    def tp(self) -> int:
        return self.spec.tp

    @property
    def stage(self) -> int:
        return self.rank // self.spec.tp

    @property
    def tp_rank(self) -> int:
        return self.rank % self.spec.tp

    @property
    def prev_rank(self) -> int:
        """The same tp rank of the stage before (stage > 0)."""
        return self.rank - self.spec.tp

    @property
    def next_rank(self) -> int:
        """The same tp rank of the stage after (stage < pp - 1)."""
        return self.rank + self.spec.tp

    @property
    def head_rank(self) -> int:
        """The last stage's tp rank 0: it sends the head's rows to rank 0."""
        return (self.spec.pp - 1) * self.spec.tp
