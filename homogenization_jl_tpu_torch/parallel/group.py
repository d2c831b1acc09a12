"""The 1D process group of the slab-sharded solver.

``SlabGroup`` is the port's counterpart of the JAX package's 1D
``jax.sharding.Mesh`` with axis "e": one process per device, rank r holding
the r-th x-plane slab. It offers the two collectives the slab solver needs:

  * ``exchange(lo_edge, hi_edge) -> (halo_lo, halo_hi)``: the ppermute of
    edge planes (JAX ops/structured.py:946-951). Each rank sends its lowest
    planes to rank - 1 and its highest to rank + 1 and receives theirs, all
    four transfers posted in one ``batch_isend_irecv`` so that neighbours
    never wait on each other; at the domain ends nothing is sent and the
    halo is None (JAX's ppermute fills zeros there, which the slab combine
    never needs: it skips owners outside the domain).
  * ``sum(t)``: the psum. Every rank's partial is all-gathered and the parts
    are added in rank order, so every rank holds bitwise the same value and
    runs are repeatable (an ``all_reduce`` leaves the order to the
    backend's ring); with one rank the sum is the partial itself. The
    solver's host-side loop tests read these values, and ranks that read
    different bits would run different loop counts and deadlock.

CUDA tensors need an NCCL group and CPU tensors a gloo one; anything else
raises, but for one case: several ranks on ONE card, which NCCL refuses,
may share it through a gloo group (``backend="gloo"``). Gloo moves each
collective through the host and offers ``sum`` on CUDA tensors, not
``exchange``: it serves the gather-sharded solver, which needs only the sum. ``SlabGroup.from_file`` initialises the default process group from
a ``FileStore`` (no network; a world of one, or the spawned ranks of the CPU
tests); under ``torchrun`` the environment's rendezvous serves
(``SlabGroup.from_env``).
"""

from __future__ import annotations

import datetime
import os

import torch
import torch.distributed as dist

_BACKEND = {"cuda": "nccl", "cpu": "gloo"}
# every process-group call waits at most this long, so a hang fails
DEFAULT_TIMEOUT = datetime.timedelta(seconds=300)


def resolve_device(device=None) -> torch.device:
    """The rank's device: cuda:{LOCAL_RANK} (0 when unset) by default, a
    card without an index resolved to the current one; raises for a card
    that is not there."""
    dev = torch.device("cuda", int(os.environ.get("LOCAL_RANK", "0"))) if device is None \
        else torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device: the slab group runs on the card by default; pass "
                "device='cpu' (with a gloo group) to run on the CPU"
            )
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    return dev


class SlabGroup:
    """The default process group seen as a 1D mesh of x-plane slabs.

    ``device``: where this rank's tensors live (default: the card of
    LOCAL_RANK). The group's backend must be the device's: NCCL for CUDA,
    gloo for the CPU; ``backend="gloo"`` asks for gloo on CUDA (ranks that
    share a card, ``sum`` only)."""

    def __init__(self, device=None, backend=None):
        if not dist.is_initialized():
            raise RuntimeError("SlabGroup: initialise torch.distributed first")
        kind = "cuda" if device is None else torch.device(device).type
        want = "gloo" if kind == "cuda" and backend == "gloo" else _BACKEND.get(kind)
        self.backend = str(dist.get_backend())
        if want is None or self.backend != want:
            raise ValueError(
                f"SlabGroup: {kind} tensors need a {want or 'nccl/gloo'} group, "
                f"this one is {self.backend}"
            )
        self.device = resolve_device(device)
        self.rank = dist.get_rank()
        self.size = dist.get_world_size()

    @classmethod
    def from_file(cls, path, rank: int = 0, size: int = 1, device=None,
                  timeout=DEFAULT_TIMEOUT, backend=None) -> "SlabGroup":
        """Initialise the default process group from a FileStore at
        ``path`` (a file that does not exist yet, the same for every rank)
        and return the group; the backend follows the device unless
        ``backend`` names one (gloo for ranks that share a card)."""
        device = resolve_device(device)
        if device.type == "cuda":
            torch.cuda.set_device(device)
        store = dist.FileStore(str(path), size)
        dist.init_process_group(backend or _BACKEND[device.type], store=store, rank=rank,
                                world_size=size, timeout=timeout)
        return cls(device, backend)

    @classmethod
    def from_env(cls, device=None, timeout=DEFAULT_TIMEOUT) -> "SlabGroup":
        """Initialise the default process group from torchrun's environment
        (RANK, WORLD_SIZE, MASTER_ADDR, MASTER_PORT) and return the group."""
        device = resolve_device(device)
        if device.type == "cuda":
            torch.cuda.set_device(device)
        dist.init_process_group(_BACKEND[device.type], timeout=timeout)
        return cls(device)

    @staticmethod
    def destroy() -> None:
        """Tear the default process group down."""
        if dist.is_initialized():
            dist.destroy_process_group()

    def _check(self, t):
        if t.device != self.device:
            raise ValueError(f"SlabGroup: tensor on {t.device}, the group's device is {self.device}")

    @property
    def has_lo(self) -> bool:
        """Whether a rank below this one exists (else: the domain's low end)."""
        return self.rank > 0

    @property
    def has_hi(self) -> bool:
        """Whether a rank above this one exists (else: the domain's high end)."""
        return self.rank < self.size - 1

    def exchange(self, lo_edge, hi_edge):
        """Send ``lo_edge`` to rank - 1 and ``hi_edge`` to rank + 1; return
        (halo_lo, halo_hi): rank - 1's hi_edge and rank + 1's lo_edge. At a
        domain end there is no neighbour: the edge there is not sent (pass
        None) and its halo is None, for the slab combine reads no owner
        outside the domain. The edges must be contiguous and of one shape on
        every rank."""
        if self.device.type == "cuda" and self.backend == "gloo":
            raise ValueError("SlabGroup.exchange: CUDA tensors need an NCCL group")
        for side, t, want in (("lo", lo_edge, self.has_lo), ("hi", hi_edge, self.has_hi)):
            if t is None:
                if want:
                    raise ValueError(f"SlabGroup.exchange: rank {self.rank} needs its {side} edge")
                continue
            self._check(t)
            if not t.is_contiguous():
                raise ValueError("SlabGroup.exchange: edges must be contiguous")
        halo_lo = torch.empty_like(lo_edge) if self.has_lo else None
        halo_hi = torch.empty_like(hi_edge) if self.has_hi else None
        ops = []
        if self.has_lo:
            ops += [dist.P2POp(dist.isend, lo_edge, self.rank - 1),
                    dist.P2POp(dist.irecv, halo_lo, self.rank - 1)]
        if self.has_hi:
            ops += [dist.P2POp(dist.isend, hi_edge, self.rank + 1),
                    dist.P2POp(dist.irecv, halo_hi, self.rank + 1)]
        if ops:
            # wait() orders the current stream after the transfers, so a
            # kernel queued next reads the received halos
            for req in dist.batch_isend_irecv(ops):
                req.wait()
        return halo_lo, halo_hi

    def sum(self, t):
        """The ranks' partials ``t`` added in rank order: bitwise the same
        on every rank; with one rank, ``t``'s value itself."""
        self._check(t)
        flat = t.reshape(-1).contiguous()
        parts = [torch.empty_like(flat) for _ in range(self.size)]
        dist.all_gather(parts, flat)
        acc = parts[0]
        for p in parts[1:]:
            acc = acc + p
        return acc.reshape(t.shape)
