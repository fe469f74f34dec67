"""Device mesh and collectives — PyTorch counterpart of
gromacs_fep_gpu_tpu/parallel/mesh.py (make_mesh, the 'ens' and 'spatial'
axes, ens_sharding, replicated) and of the jax.lax collectives that
parallel/spatial.py uses inside shard_map (ppermute, psum, psum_scatter,
all_to_all, all_gather, in their tiled forms).

The JAX package is single-controller SPMD: one process runs shard_map over
a mesh of devices.  The port keeps that shape: one process, a mesh that is
a grid of torch.devices, and a domain's data is one tensor on its device.
A collective is a plain function over the list of per-domain tensors, one
per domain in mesh order, and returns one tensor per domain on that
domain's device (the device of the input it replaces).  Several mesh slots
may name the same device: eight domains on one card, or on the CPU, where
the tests run them (the counterpart of JAX's eight virtual CPU devices).
Across cards a copy between domains is a peer copy.
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence, Tuple

import torch

ENS_AXIS = "ens"
SPATIAL_AXIS = "spatial"


@dataclasses.dataclass(frozen=True)
class DeviceMesh:
    """(n_ens, n_spatial) grid of devices; `shape` as jax.sharding.Mesh's
    (axis name -> size)."""
    devices: Tuple[Tuple[torch.device, ...], ...]

    @property
    def shape(self) -> dict:
        return {ENS_AXIS: len(self.devices),
                SPATIAL_AXIS: len(self.devices[0])}

    @property
    def spatial_devices(self) -> Tuple[torch.device, ...]:
        """The devices of the spatial axis (first ensemble row)."""
        return self.devices[0]

    @property
    def home(self) -> torch.device:
        return self.devices[0][0]

    def placement(self) -> str:
        """'8 domains on 1 card (cuda:0)'-style summary of the spatial
        axis."""
        devs = sorted({str(d) for d in self.spatial_devices})
        kind = "card" if self.home.type == "cuda" else "device"
        return (f"{len(self.spatial_devices)} domains on {len(devs)} "
                f"{kind}{'s' if len(devs) > 1 else ''} ({', '.join(devs)})")


def make_mesh(n_ens: Optional[int] = None, n_spatial: Optional[int] = None,
              devices: Optional[Sequence] = None) -> DeviceMesh:
    """The mesh of JAX make_mesh.  devices=None takes every visible CUDA
    card, assigned round-robin over the n_ens * n_spatial slots (all cards
    when neither is given); it never means the CPU.  Tests pass
    devices=["cpu"] * 8."""
    if devices is None:
        n_cards = torch.cuda.device_count()
        if n_cards == 0:
            raise RuntimeError("make_mesh: no CUDA device is visible; pass "
                               "devices=[...] (e.g. ['cpu'] * 8) to run "
                               "the domains elsewhere")
        n_slots = (n_cards if n_ens is None and n_spatial is None
                   else (n_ens or 1) * (n_spatial or 1))
        devices = [torch.device("cuda", i % n_cards) for i in range(n_slots)]
    devices = [torch.device(d) for d in devices]
    n = len(devices)
    if n_ens is None and n_spatial is None:
        n_ens, n_spatial = n, 1
    elif n_ens is None:
        n_ens = n // n_spatial
    elif n_spatial is None:
        n_spatial = n // n_ens
    if n_ens * n_spatial != n:
        raise ValueError(f"mesh ({n_ens}, {n_spatial}) does not hold "
                         f"{n} devices")
    return DeviceMesh(tuple(tuple(devices[e * n_spatial:(e + 1) * n_spatial])
                            for e in range(n_ens)))


def replicated(mesh: DeviceMesh, t: torch.Tensor) -> List[torch.Tensor]:
    """t on every domain of the spatial axis (P() placement)."""
    return [t.to(d) for d in mesh.spatial_devices]


def ens_sharding(mesh: DeviceMesh, t: torch.Tensor) -> List[torch.Tensor]:
    """t split along dim 0 over the ensemble axis, part e on the first
    device of ensemble row e (P('ens') placement)."""
    parts = torch.chunk(t, mesh.shape[ENS_AXIS], dim=0)
    return [p.to(row[0]) for p, row in zip(parts, mesh.devices)]


# -- collectives over per-domain tensors (jax.lax semantics, tiled) --------

def ppermute(parts: Sequence[torch.Tensor], perm) -> List[torch.Tensor]:
    """out[dst] = parts[src] for each (src, dst) of perm; a domain that
    receives nothing gets zeros."""
    out = [torch.zeros_like(p) for p in parts]
    for src, dst in perm:
        out[dst] = parts[src].to(parts[dst].device)
    return out


def _sum(parts: Sequence[torch.Tensor]) -> torch.Tensor:
    """Sum of the parts, in domain order, on the first domain's device."""
    total = parts[0]
    for p in parts[1:]:
        total = total + p.to(total.device)
    return total


def psum(parts: Sequence[torch.Tensor]) -> List[torch.Tensor]:
    """Every domain gets the sum of all parts."""
    total = _sum(parts)
    return [total.to(p.device) for p in parts]


def psum_scatter(parts: Sequence[torch.Tensor], dim: int = 0
                 ) -> List[torch.Tensor]:
    """Domain d gets chunk d (along dim) of the sum of all parts."""
    total = _sum(parts)
    if total.shape[dim] % len(parts):
        raise ValueError(f"dim {dim} of size {total.shape[dim]} does not "
                         f"split over {len(parts)} domains")
    chunks = torch.chunk(total, len(parts), dim=dim)
    return [c.to(p.device) for c, p in zip(chunks, parts)]


def all_to_all(parts: Sequence[torch.Tensor], split_dim: int,
               concat_dim: int) -> List[torch.Tensor]:
    """Each part is split into len(parts) chunks along split_dim; domain d
    gets chunk d of every part, concatenated in domain order along
    concat_dim."""
    n = len(parts)
    if parts[0].shape[split_dim] % n:
        raise ValueError(f"dim {split_dim} of size "
                         f"{parts[0].shape[split_dim]} does not split over "
                         f"{n} domains")
    chunks = [torch.chunk(p, n, dim=split_dim) for p in parts]
    return [torch.cat([chunks[s][d].to(parts[d].device) for s in range(n)],
                      dim=concat_dim) for d in range(n)]


def all_gather(parts: Sequence[torch.Tensor], dim: int = 0
               ) -> List[torch.Tensor]:
    """Every domain gets all parts concatenated in domain order along
    dim."""
    return [torch.cat([q.to(p.device) for q in parts], dim=dim)
            for p in parts]
