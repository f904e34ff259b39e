"""Device meshes for the distributed prover, and the collectives it uses.

Counterpart of `paillier_halo2_tpu/mesh/sharding.py:1`. The JAX package's
mesh is single-controller: one process drives every device through
`jax.shard_map`. Here one process holds the list of devices and moves shards
between them explicitly; `all_to_all`, `sum_shards` and `gather` stand in
for JAX's collectives.

A mesh of n shards on `"cuda"` takes n distinct cards and raises on a
machine with fewer; on an indexed device (`"cuda:0"`, `"cpu"`) all n shards
live on that one device, as the JAX package's tests put theirs on virtual
CPU devices. `Mesh.n_cards` says how many distinct cards a mesh spans.
"""
from __future__ import annotations

import contextlib
import dataclasses
import functools

import torch


@dataclasses.dataclass(frozen=True)
class Mesh:
    """A grid of shards: `devices` row-major over `shape`, one axis name per
    dimension ("x", or "host" and "chip")."""

    devices: tuple[torch.device, ...]
    shape: tuple[int, ...]
    axis_names: tuple[str, ...]

    @property
    def size(self) -> int:
        return len(self.devices)

    @property
    def n_cards(self) -> int:
        """Distinct CUDA devices the shards live on (0 on the CPU)."""
        return len({d for d in self.devices if d.type == "cuda"})


def _devices(n: int, device) -> tuple[torch.device, ...]:
    if n < 1:
        raise ValueError(f"a mesh needs at least one shard, got {n}")
    dev = torch.device(device)
    if dev.type == "cuda":
        have = torch.cuda.device_count() if torch.cuda.is_available() else 0
        if dev.index is None:
            if have < n:
                raise RuntimeError(
                    f"make_mesh: {n} CUDA devices asked for, {have} present; pass an indexed "
                    "device such as 'cuda:0' to put every shard on one card")
            return tuple(torch.device("cuda", i) for i in range(n))
        if dev.index >= have:
            raise RuntimeError(
                f"make_mesh: no CUDA device {dev}; pass device='cpu' to run on the CPU")
    return (dev,) * n


def make_mesh(n_devices: int, device="cuda") -> Mesh:
    """A 1-D mesh of `n_devices` shards on axis "x" (see the module
    docstring for `device`)."""
    return Mesh(_devices(n_devices, device), (n_devices,), ("x",))


def make_mesh_2d(n_hosts: int, chips_per_host: int, device="cuda") -> Mesh:
    """A (host, chip) mesh, host-major: the sharded MSM reduces over "chip"
    before "host", as chips within a host share the faster link."""
    return Mesh(_devices(n_hosts * chips_per_host, device), (n_hosts, chips_per_host),
                ("host", "chip"))


def on(device):
    """Context in which a shard's kernels launch on its own card."""
    return torch.cuda.device(device) if device.type == "cuda" else contextlib.nullcontext()


def shard_batch(mesh: Mesh, t: torch.Tensor) -> list[torch.Tensor]:
    """Split the trailing axis of `t` into `mesh.size` equal, contiguous
    shards, shard i on `mesh.devices[i]`."""
    if t.shape[-1] % mesh.size:
        raise ValueError(f"trailing axis {t.shape[-1]} does not split into {mesh.size} shards")
    parts = t.tensor_split(mesh.size, dim=-1)
    return [p.to(dev).contiguous() for p, dev in zip(parts, mesh.devices)]


def all_to_all(shards: list[torch.Tensor], split_axis: int, concat_axis: int) -> list[torch.Tensor]:
    """`jax.lax.all_to_all` (not tiled) over the shards: each shard's
    `split_axis` has one entry per shard; entry j of shard i goes to shard j,
    which stacks what it receives, in order of i, as a new axis at
    `concat_axis` (an index into the shape without `split_axis`). Output
    shard j lives where input shard j did."""
    d = len(shards)
    for s in shards:
        if s.shape[split_axis] != d:
            raise ValueError(f"all_to_all: axis {split_axis} of {tuple(s.shape)} is not {d}")
    return [torch.stack([s.select(split_axis, j).to(dst.device) for s in shards], dim=concat_axis)
            for j, dst in enumerate(shards)]


def gather(shards: list[torch.Tensor], device, dim: int) -> torch.Tensor:
    """The shards stacked along a new axis `dim` on one device."""
    return torch.stack([s.to(device) for s in shards], dim=dim)


def sum_shards(shards: list[torch.Tensor], device) -> torch.Tensor:
    """`jax.lax.psum` of integer tensors: their sum on one device."""
    return functools.reduce(torch.add, [s.to(device) for s in shards])
