"""a (module, space) mesh of torch devices, in one process, with an
optional 'space_x' axis for the 3D grids.

Port of newton_krylov_ooc_tpu/parallel/mesh.py.  The JAX mesh names two
axes:

  "module" -- block independence over tracer modules: a parameterized
      module family integrates as one batched system whose batch axis is
      split over the mesh rows;
  "space"  -- spatial decomposition: the ypos dimension of the 2D grid is
      split over the mesh columns, and the stencil tendencies exchange halo
      columns between neighbours.

Here a mesh is a (n_module, n_space) grid of torch devices, and a device
may appear more than once: 8 shards on ["cpu"] * 8 are the counterpart of
the 8 virtual CPU devices the JAX tests run on, and 4 shards on one card
exercise the halo exchange without a second card.  `shard_state` and
`gather_state` split a (module_batch, T, nz, ny) tensor into the mesh's
(module, space) blocks on their devices and join them back: they stand for
NamedSharding(P('module', None, None, 'space')), put_global and host_value.

Single process only.  The JAX package spans hosts through
jax.distributed; its counterpart here, torch.distributed with one process
per card, is ROADMAP A5.1.
"""

from __future__ import annotations

import torch

from ..ops.compute import resolve_device


class Mesh:
    """a (n_module, n_space) or (n_module, n_space, n_space_x) grid of torch
    devices

    devices[mi][sj] holds the block of module rows mi and ypos (latitude)
    blocks sj, and devices[mi][sj][sx] longitude block sx of it when the
    mesh has a space_x axis; shape is {"module": n_module, "space":
    n_space}, plus "space_x": n_space_x when given, as jax's Mesh.shape"""

    def __init__(self, devices, n_module, n_space, n_space_x=None):
        n_x = 1 if n_space_x is None else n_space_x
        if len(devices) != n_module * n_space * n_x:
            dims = (n_module, n_space) + (() if n_space_x is None else (n_x,))
            raise ValueError(
                f"mesh shape {dims} != device count {len(devices)}")
        self.shape = {"module": n_module, "space": n_space}
        if n_space_x is not None:
            self.shape["space_x"] = n_space_x
        blocks = [tuple(devices[i * n_x:(i + 1) * n_x])
                  for i in range(n_module * n_space)]
        if n_space_x is None:
            blocks = [blk[0] for blk in blocks]
        self.devices = tuple(
            tuple(blocks[mi * n_space:(mi + 1) * n_space])
            for mi in range(n_module)
        )

    @property
    def first_device(self):
        """where the solver keeps the whole state between years"""
        dev = self.devices[0][0]
        return dev[0] if isinstance(dev, tuple) else dev

    def __repr__(self):
        axes = ", ".join(f"{name}={size}" for name, size in self.shape.items())
        return f"Mesh({axes}, devices={self.devices})"


def make_mesh(n_module=1, n_space=None, devices=None, n_space_x=None):
    """build a (module, space[, space_x]) mesh over `devices` (names or
    torch.devices, repeats allowed); devices=None takes every visible CUDA
    device and raises without one -- the CPU is used only when named"""
    if devices is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "make_mesh(devices=None) takes the visible CUDA devices, but "
                "torch.cuda.is_available() is False; name the devices (e.g. "
                "['cpu'] * 8) to build a CPU mesh"
            )
        devices = [torch.device("cuda", i)
                   for i in range(torch.cuda.device_count())]
    devices = [resolve_device(dev) for dev in devices]
    if n_space is None:
        n_space = len(devices) // (n_module * (n_space_x or 1))
    return Mesh(devices, n_module, n_space, n_space_x)


def mesh_devices(device, n_shards, shards_per_device=1):
    """the device list of an n_shards mesh with shards_per_device shards on
    each of the first n_shards / shards_per_device devices of `device`'s
    kind (the CPU counts as one device that takes any number of shards)"""
    device = resolve_device(device)
    if n_shards % shards_per_device:
        raise ValueError(f"{n_shards} shards do not split into groups of "
                         f"{shards_per_device} a device")
    if device.type == "cpu":
        return [device] * n_shards
    n_dev = n_shards // shards_per_device
    if n_dev > torch.cuda.device_count():
        raise ValueError(
            f"{n_shards} shards at {shards_per_device} a device need {n_dev} "
            f"CUDA devices; {torch.cuda.device_count()} visible"
        )
    return [torch.device("cuda", i // shards_per_device)
            for i in range(n_shards)]


def shard_state(mesh, x):
    """split a (module_batch, T, nz, ny) tensor into the mesh's blocks:
    blocks[mi][sj] of shape (module_batch / n_module, T, nz, ny / n_space)
    on devices[mi][sj], contiguous copies that never alias x"""
    n_module, n_space = mesh.shape["module"], mesh.shape["space"]
    b_dim, ny = x.shape[0], x.shape[-1]
    if b_dim % n_module or ny % n_space:
        raise ValueError(
            f"state {tuple(x.shape)} does not split over the mesh "
            f"({n_module}, {n_space})"
        )
    b_loc, nyl = b_dim // n_module, ny // n_space
    return [
        [x[mi * b_loc:(mi + 1) * b_loc, ..., sj * nyl:(sj + 1) * nyl]
         .to(mesh.devices[mi][sj], copy=True).contiguous()
         for sj in range(n_space)]
        for mi in range(n_module)
    ]


def gather_state(mesh, blocks, device=None):
    """join shard_state's blocks into one tensor on `device` (by default
    the mesh's first device)"""
    device = mesh.first_device if device is None else device
    rows = [torch.cat([blk.to(device) for blk in row], dim=-1)
            for row in blocks]
    return torch.cat(rows, dim=0)


def grid_devices(mesh):
    """devices[sy][sx] of a 3D grid's latitude x longitude blocks: the
    mesh's first module row (the 3D years replicate over 'module'), one
    longitude block when it has no space_x axis"""
    row = mesh.devices[0]
    if "space_x" in mesh.shape:
        return [list(blocks) for blocks in row]
    return [[dev] for dev in row]


def shard_grid(mesh, x):
    """split a (..., nlat, nlon) tensor into blocks[sy][sx] of shape (...,
    nlat / n_space, nlon / n_space_x) on grid_devices(mesh)[sy][sx],
    contiguous copies that never alias x"""
    devs = grid_devices(mesh)
    n_y, n_x = len(devs), len(devs[0])
    nlat, nlon = x.shape[-2:]
    if nlat % n_y or nlon % n_x:
        raise ValueError(f"grid ({nlat}, {nlon}) does not split over the "
                         f"mesh's ({n_y}, {n_x}) blocks")
    nl, nx = nlat // n_y, nlon // n_x
    return [[x[..., sy * nl:(sy + 1) * nl, sx * nx:(sx + 1) * nx]
             .to(devs[sy][sx], copy=True).contiguous() for sx in range(n_x)]
            for sy in range(n_y)]


def gather_grid(mesh, blocks, device=None):
    """join shard_grid's blocks into one tensor on `device` (by default the
    mesh's first device)"""
    device = mesh.first_device if device is None else device
    rows = [torch.cat([blk.to(device) for blk in row], dim=-1)
            for row in blocks]
    return torch.cat(rows, dim=-2)
