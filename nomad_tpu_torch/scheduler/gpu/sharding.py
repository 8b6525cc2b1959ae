"""Node-axis sharding for the batched solver: the mesh route.

The counterpart of nomad_tpu's scheduler/tpu/sharding.py. There the node
axis is split over a ``jax.sharding.Mesh`` of chips; here one process
drives every shard, as JAX's single controller does, and the shards are
assigned to an explicit list of torch devices:

  * ``SolverMesh(n_shards, devices=None, device="cuda")`` — D node
    shards; shard d owns rows [d*w, (d+1)*w) with w = Np / D. By default
    the shards go on the visible cards of the device type in contiguous
    blocks (shard d on ``cuda:(d * cards // D)``); with one card every
    shard lives on ``cuda:0``, and ``device="cpu"`` puts them all on the
    CPU, where the kernels' plain twins run. D counts shards, not
    devices, so a mesh larger than the card count is a real mesh, never
    a single-card fallback. A mesh on "cuda" with no card raises
    RuntimeError: it never runs on the CPU.
  * the kernels — ``solver(max_count, compact)`` (kernels.sharded_solver,
    named sharded_solver[_compact]_d{D}) and ``preempt_solver()``
    (kernels.sharded_solver_preempt, sharded_solver_preempt_d{D}).
  * placement of node-axis tensors — every card holds one tensor of its
    contiguous shards' rows; on one card that is the whole [Np, ...]
    tensor and the shards are views of it. The exchange between cards
    is kernels._exchange, outside the kernels.
  * ``pad_nodes``, ``shard_occupancy`` and ``allgather_bytes``, as in
    nomad_tpu. The all-gather bytes are the reference's model of what
    the gathers move between devices; between shards of one card
    nothing moves.

The code between cards (more than one card in ``cards``) has not run on
a machine with several cards.
"""

from __future__ import annotations

import threading
from typing import Optional

import numpy as np
import torch

from .kernels import (
    MAX_SHARDS,
    _pad_to,
    pad_c,
    pad_n,
    sharded_solver,
    sharded_solver_preempt,
)


def rows_shape(x) -> tuple:
    """The global shape of a node-axis tensor held whole or per card."""
    if isinstance(x, (list, tuple)):
        return (sum(p.shape[0] for p in x),) + tuple(x[0].shape[1:])
    return tuple(x.shape)


def rows_device(x) -> torch.device:
    """The device of a node-axis tensor (its first card's, per card)."""
    return x[0].device if isinstance(x, (list, tuple)) else x.device


def gather_rows(x, dim: int = 0):
    """A per-card node-axis result joined on its first card (peer copies,
    for a readback); a whole tensor is returned as it is."""
    if not isinstance(x, (list, tuple)):
        return x
    dev = x[0].device
    return torch.cat([p.to(dev, non_blocking=True) for p in x], dim=dim)


class SolverMesh:
    """D node shards on an explicit list of torch devices, with the
    sharded kernels built for them. Build once per (D, device) and reuse:
    ``solver_mesh()`` below is the process cache."""

    def __init__(self, n_shards: int, devices=None,
                 device="cuda") -> None:
        from .solver import resolve_device

        n_shards = int(n_shards)
        if not 1 <= n_shards <= MAX_SHARDS:
            raise ValueError(
                f"a mesh takes 1 to {MAX_SHARDS} shards, "
                f"not {n_shards}"
            )
        if devices is None:
            base = torch.device(device)
            dev = resolve_device(device)
            if dev.type == "cuda" and base.index is None:
                cards = torch.cuda.device_count()
                devices = [torch.device("cuda", d * cards // n_shards)
                           for d in range(n_shards)]
            else:
                devices = [dev] * n_shards
        else:
            devices = [resolve_device(d) for d in devices]
            if len(devices) != n_shards:
                raise ValueError(
                    f"{len(devices)} devices for {n_shards} shards"
                )
        self.n_dev = n_shards
        self.devices = devices
        # (device, first shard, shard count): the cards in shard order,
        # each holding a contiguous block of shards
        self.cards: list = []
        for d, dev in enumerate(devices):
            if self.cards and self.cards[-1][0] == dev:
                card = self.cards[-1]
                self.cards[-1] = (dev, card[1], card[2] + 1)
            elif any(c[0] == dev for c in self.cards):
                raise ValueError(
                    f"the shards on {dev} are not contiguous: {devices}"
                )
            else:
                self.cards.append((dev, d, 1))
        self.primary = devices[0]
        self._lock = threading.Lock()
        self._solvers: dict = {}
        self._preempt = None

    # -- kernels --------------------------------------------------------

    def solver(self, max_count: Optional[int] = None,
               compact: bool = False):
        """(solve function, k bucket) for the node-sharded solve.
        max_count bounds every group's count in the batch; it is
        bucketed (pad_c) so the launch signature stays stable while the
        batch's biggest group drifts. None = the full-gather waterfill.
        compact=True returns the [G, maxC] instance-list readback
        (requires max_count). The function takes (cap, used, asks,
        counts, feas, bias, units_cap) as numpy arrays or tensors, whole
        or per card, and places them on the mesh."""
        if compact and max_count is None:
            raise ValueError("compact sharded solver requires max_count")
        k = None if max_count is None else pad_c(max(1, int(max_count)))
        key = (k, compact)
        with self._lock:
            fn = self._solvers.get(key)
            if fn is None:

                def sharded_solve(cap, used, asks, counts, feas, bias,
                                  units_cap):
                    return sharded_solver(
                        self.place(cap), self.place(used),
                        self.replicate(asks), self.replicate(counts),
                        self.place(feas, 1), self.place(bias, 1),
                        self.place(units_cap, 1),
                        n_shards=self.n_dev, max_count=k, compact=compact,
                    )

                sharded_solve.__name__ = (
                    f"sharded_solver_compact_d{self.n_dev}" if compact
                    else f"sharded_solver_d{self.n_dev}"
                )
                fn = self._solvers[key] = sharded_solve
            return fn, k

    def preempt_solver(self):
        with self._lock:
            if self._preempt is None:

                def sharded_solve(cap, used_exist, prefix_used, asks, counts,
                                  feas, bias, units_cap, tier_limit):
                    out = sharded_solver_preempt(
                        self.place(cap), self.place(used_exist),
                        self.place(prefix_used, 1), self.replicate(asks),
                        self.replicate(counts), self.place(feas, 1),
                        self.place(bias, 1), self.place(units_cap, 1),
                        self.replicate(tier_limit), n_shards=self.n_dev,
                    )
                    # the launch ledger reads the route (solverobs)
                    sharded_solve.last_route = sharded_solver_preempt.last_route
                    return out

                sharded_solve.__name__ = f"sharded_solver_preempt_d{self.n_dev}"
                self._preempt = sharded_solve
            return self._preempt

    # -- placement of node-axis tensors ---------------------------------

    def replicate(self, x) -> torch.Tensor:
        """A replicated operand as a tensor on the first card (the
        kernels copy it to the others)."""
        if isinstance(x, np.ndarray):
            x = torch.from_numpy(np.ascontiguousarray(x))
        return x.to(self.primary)

    def place(self, x, dim: int = 0):
        """A node-axis operand (node axis `dim`) on the mesh: one tensor
        on the card when the mesh has one card, else a list of each
        card's contiguous rows. Per-card lists pass through."""
        if isinstance(x, (list, tuple)):
            return list(x)
        if isinstance(x, np.ndarray):
            x = torch.from_numpy(np.ascontiguousarray(x))
        if len(self.cards) == 1:
            return x.to(self.primary)
        w = x.shape[dim] // self.n_dev
        return [
            x.narrow(dim, d0 * w, nd * w).to(dev).contiguous()
            for dev, d0, nd in self.cards
        ]

    def shard_map(self) -> list[dict]:
        """Which device holds each shard."""
        return [{"shard": d, "device": str(dev)}
                for d, dev in enumerate(self.devices)]

    def pad_nodes(self, n: int) -> int:
        """pad_n extended to a multiple of the mesh size. pad_n buckets
        (powers of two >= 256, then 2048-multiples) already divide any
        power-of-two mesh <= 256; the round-up only moves for odd mesh
        sizes, and stays a stable bucket either way."""
        return _pad_to(pad_n(n), self.n_dev)

    # -- shard accounting ----------------------------------------------

    def shard_occupancy(self, n: int, np_: int) -> list[dict]:
        """Per-shard real-row occupancy of one dispatch: shard d owns
        rows [d*w, (d+1)*w); rows past the cluster's real n are pad."""
        w = np_ // self.n_dev
        out = []
        for d in range(self.n_dev):
            real = min(max(n - d * w, 0), w)
            out.append({
                "shard": d,
                "rows": w,
                "real_rows": real,
                "occupancy": round(real / w, 4) if w else 0.0,
            })
        return out

    def allgather_bytes(self, g: int, np_: int, k: Optional[int]) -> int:
        """Modeled bytes one solve's all-gathers move (the transfer
        ledger's ``allgather`` direction). Per scan step each device
        receives the other shards' contribution:

          top-k path: (D-1) * k candidate triples (score f32 + units
          i32 + index i32 = 12B) per device, D devices;
          argsort path: the full remote score+units vectors,
          (N - N/D) * 8B per device, D devices.
        """
        d = self.n_dev
        if k is not None:
            per_step = d * (d - 1) * k * 12
        else:
            per_step = d * (np_ - np_ // d) * 8
        return g * per_step


_MESHES: dict[tuple, SolverMesh] = {}
_MESHES_LOCK = threading.Lock()


def solver_mesh(n_shards: int, device="cuda") -> SolverMesh:
    """Process-global cache per (shard count, device): every caller
    sharing a mesh shares its solve functions."""
    key = (int(n_shards), str(device))
    with _MESHES_LOCK:
        m = _MESHES.get(key)
        if m is None:
            m = _MESHES[key] = SolverMesh(n_shards, device=device)
        return m
