"""The training mesh and the hybrid topology (the JAX package's
`paddle_tpu/distributed/mesh.py`, in PyTorch's idiom: one rank a device
over `torch.distributed`).

The JAX topology is a `jax.sharding.Mesh` with the named axes ``("dp",
"pp", "sharding", "mp", "sp")`` over the process's devices. The port's
`DeviceMesh` keeps the axes and their degrees (``mesh.shape``) and maps
them onto ranks as the JAX mesh maps them onto devices: rank ``r`` sits at
``np.unravel_index(r, degrees)`` over `AXES`, so ``mp`` varies fastest.
One rank a device, the caller's process rank 0, the others spawned by the
first train step built over the mesh (parallel/spmd.py) and kept for
every later step until `close`. The device and backend rules are
`distributed.ranks.RankMesh`'s, shared with serving: distinct CUDA devices
run NCCL, CPU ranks run gloo, and a CUDA device named twice (ranks sharing
one card) runs only over an explicit ``backend="gloo"``.

**Groups.** Besides the world group of every rank, each axis of degree
above 1 (and below the world's size) has one process group a line of
ranks along it (`comm_lists`): a rank's ``mesh.groups[axis]`` is its own.
Every rank walks every axis's groups in one order, `AXES` order then
group index, and joins the one it is in; each group is built straight on
a prefix of the mesh's file store (``{axis}/{index}``, no default group,
so no rank waits on a group it is not in) with the mesh's timeout.

A ``pp`` axis above 1 holds pipeline stages (parallel/pipeline.py,
models/gpt_pipeline.py): its groups are the stage lines, and above two
stages each line's first and last stage also share a group of their own
(``"pp_ends"``, `axis_group`), where a tied weight's two uses (the
embedding and the head) sum their gradients. An ``sp`` axis above 1
splits the sequence (parallel/spmd.py with ``batch_specs=(("dp",
"sp"),) * 2``): its groups are the rings of parallel/ring_attention.py
and the gathers of parallel/sequence_attention.py. It runs alone or
beside ``dp``, ``mp`` and ``sharding``; beside ``pp`` `build_mesh`
refuses it (ROADMAP Queue 1, item 8b.1): the reference's pipelined GPT
never splits the sequence (its microbatches are ``P(None, "dp", None,
None)``), so an ``sp`` axis there would only replicate.

**Topology** (JAX `:87-262`): `CommunicateTopology` (coordinates and
ranks over named dims), `HybridCommunicateGroup` (a rank's degrees,
indices and `AxisGroup`s over a mesh) and the process's
`set_hybrid_communicate_group` / `get_hybrid_communicate_group`, as
`fleet.init` installs them.
"""
from __future__ import annotations

import numpy as np
import torch

from .._device import resolve_device
from .ranks import RankMesh, leave_group

AXES = ("dp", "pp", "sharding", "mp", "sp")

_GLOBAL_MESH = None


class DeviceMesh(RankMesh):
    """A mesh of ``prod(degrees)`` ranks, one a device (`devices`, rank
    order). ``shape`` maps every axis of `AXES` to its degree. `ranks` is
    the `RankSet` of ranks 1 .. N-1 once a train step has started them;
    `close` ends them. `groups` holds this rank's axis groups once the
    ranks have joined (empty in a copy for another rank)."""

    def __init__(self, degrees, devices, backend=None, timeout=1800.0):
        shape = _degrees(degrees)
        world = int(np.prod(list(shape.values())))
        if len(devices) != world:
            raise ValueError(f"mesh degrees {degrees} need {world} "
                             f"devices, have {len(devices)}")
        super().__init__(devices, backend=backend, timeout=timeout)
        self.shape = shape
        self.ranks = None
        self.groups = {}
        self.in_job = 0      # > 0 while the controller runs its job share

    def for_rank(self, rank):
        other = super().for_rank(rank)
        other.groups = {}
        other.ranks = None
        return other

    def coords(self, rank=None):
        """{axis: index} of rank `rank` (default: this process's rank)."""
        return coords_of(self.shape, self.rank if rank is None else rank)

    def rank_of(self, **coords):
        """The rank at `coords` (missing axes are 0)."""
        return rank_at(self.shape, **coords)

    def comm_lists(self, axis):
        """The groups along `axis`: lists of ranks that differ only in
        their `axis` index, each in that index's order (JAX
        `CommunicateTopology.get_comm_list`)."""
        grid = np.arange(self.size).reshape(tuple(self.shape[a]
                                                  for a in AXES))
        moved = np.moveaxis(grid, AXES.index(axis), -1)
        return moved.reshape(-1, self.shape[axis]).tolist()

    def group_axes(self):
        """The axes that have groups of their own: degree above 1 and
        below the world (an axis that spans every rank uses the world
        group)."""
        return [a for a in AXES if 1 < self.shape[a] < self.size]

    def group_lists(self):
        """{name: lists of ranks}: every group a rank joins besides the
        world, in the order every rank walks them (`group_axes`, then
        ``"pp_ends"`` above two stages: each stage line's first and last
        rank)."""
        out = {a: self.comm_lists(a) for a in self.group_axes()}
        if self.shape["pp"] > 2:
            out["pp_ends"] = [[line[0], line[-1]]
                              for line in self.comm_lists("pp")]
        return out

    def axis_group(self, axis):
        """This rank's `RankGroup` along `axis`: its own group, the world
        group when the axis spans every rank, None at degree 1.
        ``"pp_ends"`` is the group of its stage line's first and last
        rank (the ``pp`` group itself at two stages; None elsewhere in
        the line)."""
        if axis == "pp_ends":
            if self.shape["pp"] <= 2:
                return self.axis_group("pp")
            return self.groups.get("pp_ends")
        if self.shape[axis] <= 1:
            return None
        if self.shape[axis] == self.size:
            return self.group
        return self.groups[axis]

    def in_step(self):
        """Whether every rank of the mesh runs the caller's code now, so a
        collective over its groups meets its peers: in a rank of a running
        mesh other than the controller (a rank runs only what the
        controller asks of it), in a mesh of threads (no rank set), and in
        the controller inside its share of a job (`parallel.spmd.RankJob`);
        never in the controller between jobs, where the ranks wait on the
        channel for its next operation."""
        return self.group is not None and (self.ranks is None
                                           or self.in_job > 0)

    def close(self):
        """End the mesh's rank processes (and, over NCCL, every rank's
        communicators together); this process's groups go with them.
        Idempotent; the next step built over the mesh starts new ones."""
        ranks, self.ranks = self.ranks, None
        if ranks is not None:
            ranks.close(leave=lambda: leave_group(self))
            self.group, self.groups = None, {}


def coords_of(shape, rank):
    """{axis: index} of rank `rank` on a mesh of `shape` ({axis: degree}):
    the rank's place in ``np.arange(world).reshape(degrees over AXES)``."""
    idx = np.unravel_index(int(rank), tuple(shape[a] for a in AXES))
    return {a: int(i) for a, i in zip(AXES, idx)}


def rank_at(shape, **coords):
    """The rank at `coords` (missing axes are 0) on a mesh of `shape`."""
    return int(np.ravel_multi_index(
        tuple(int(coords.get(a, 0)) for a in AXES),
        tuple(shape[a] for a in AXES)))


def _degrees(degrees):
    """Every axis's degree from `degrees` (missing axes are 1); raises for
    an unknown axis, and for ``sp`` above 1 beside ``pp`` above 1."""
    unknown = sorted(set(degrees) - set(AXES))
    if unknown:
        raise ValueError(f"unknown mesh axes {unknown}; the axes are {AXES}")
    shape = {a: int(degrees.get(a, 1)) for a in AXES}
    if any(d < 1 for d in shape.values()):
        raise ValueError(f"mesh degrees must be >= 1; got {degrees}")
    if shape["sp"] > 1 and shape["pp"] > 1:
        raise NotImplementedError(
            f"mesh degrees {degrees}: sp={shape['sp']} beside "
            f"pp={shape['pp']} is not ported (ROADMAP Queue 1, item 8b.1): "
            "the pipelined GPT never splits the sequence, so 'sp' there "
            "would only replicate; 'sp' runs beside 'dp', 'mp' and "
            "'sharding'")
    return shape


def build_mesh(degrees, devices=None, backend=None, timeout=1800.0,
               device=None):
    """A `DeviceMesh` of `degrees` (e.g. ``{"dp": 2, "mp": 2}``; missing
    axes are 1) over the first ``prod(degrees)`` of `devices`. `devices`
    defaults to CPU ranks when `device` is the CPU, else to ``cuda:0 ..
    cuda:n-1`` (which must exist: the port never falls back to the CPU).
    `backend` and `timeout` (seconds a collective may wait) as `RankMesh`
    takes them."""
    shape = _degrees(degrees)
    world = int(np.prod(list(shape.values())))
    if devices is None:
        if torch.device(resolve_device(device)).type == "cpu":
            devices = ["cpu"] * world
        else:
            n = torch.cuda.device_count()
            devices = [f"cuda:{i}" for i in range(n)]
    devices = list(devices)
    if world > len(devices):
        raise ValueError(
            f"mesh degrees {degrees} need {world} devices, have "
            f"{len(devices)}")
    return DeviceMesh(degrees, devices[:world], backend=backend,
                      timeout=timeout)


def set_mesh(mesh):
    """Install `mesh` as the process's mesh (None clears it)."""
    global _GLOBAL_MESH
    _GLOBAL_MESH = mesh
    return mesh


def get_mesh():
    """The process's mesh, or None."""
    return _GLOBAL_MESH


def init_mesh(degrees, devices=None, backend=None, timeout=1800.0,
              device=None):
    """`build_mesh` and install it as the process's mesh."""
    return set_mesh(build_mesh(degrees, devices, backend=backend,
                               timeout=timeout, device=device))


# -- the topology (reference fleet/base/topology.py) ---------------------------


class CommunicateTopology:
    """Coordinate <-> rank bookkeeping over named dims (reference
    topology.py:54), ranks laid out row-major with the last dim fastest."""

    def __init__(self, hybrid_group_names=("data", "pipe", "sharding",
                                           "model"), dims=(1, 1, 1, 1)):
        self._parallel_names = list(hybrid_group_names)
        self._dims = list(dims)
        self.coordinate = None
        self._world = int(np.prod(self._dims))
        self._coords = np.arange(self._world).reshape(tuple(self._dims))

    def get_hybrid_group_names(self):
        return self._parallel_names

    def get_dim(self, axis_name):
        return self._dims[self._parallel_names.index(axis_name)]

    get_dim_size = get_dim

    def world_size(self):
        return self._world

    def get_rank(self, **kwargs):
        return int(self._coords[tuple(kwargs[n]
                                      for n in self._parallel_names)])

    def get_coord(self, rank):
        return tuple(int(i) for i in np.unravel_index(rank,
                                                      self._coords.shape))

    def get_axis_list(self, axis_name, index):
        sl = [slice(None)] * len(self._dims)
        sl[self._parallel_names.index(axis_name)] = index
        return self._coords[tuple(sl)].reshape(-1).tolist()

    def get_comm_list(self, axis_name):
        ax = self._parallel_names.index(axis_name)
        moved = np.moveaxis(self._coords, ax, -1)
        return moved.reshape(-1, self._dims[ax]).tolist()


class AxisGroup:
    """A mesh axis seen as a process group (the JAX `AxisGroup`): its
    degree and this rank's index along it."""

    def __init__(self, mesh, axis, rank=0):
        self.mesh = mesh
        self.axis = axis
        self._rank = int(rank)

    @property
    def nranks(self):
        return self.mesh.shape[self.axis]

    world_size = nranks

    @property
    def rank(self):
        return self._rank

    def __repr__(self):
        return f"AxisGroup(axis={self.axis}, size={self.nranks})"


class HybridCommunicateGroup:
    """A rank's hybrid topology (reference topology.py:140): the degrees
    of `topology`'s dims, this process's indices along them, and an
    `AxisGroup` an axis. Built on the mesh it installs (`init_mesh` over
    the degrees, on `device`'s ranks); this process is rank 0 of it, as
    the caller of the port's one controller is."""

    def __init__(self, topology=None, strategy=None, device=None):
        if topology is None:
            topology = CommunicateTopology()
        self._topo = topology
        names = topology.get_hybrid_group_names()

        def dim(name):
            return topology.get_dim(name) if name in names else 1

        self._dp_degree = dim("data")
        self._pp_degree = dim("pipe")
        self._sharding_degree = dim("sharding")
        self._mp_degree = dim("model")
        self._sp_degree = dim("sep")
        self.mesh = init_mesh({"dp": self._dp_degree, "pp": self._pp_degree,
                               "sharding": self._sharding_degree,
                               "mp": self._mp_degree, "sp": self._sp_degree},
                              device=device)
        self.global_rank = self.mesh.rank
        coord = topology.get_coord(self.global_rank % topology.world_size())
        cmap = dict(zip(names, coord))
        self._dp_rank = cmap.get("data", 0)
        self._pp_rank = cmap.get("pipe", 0)
        self._sharding_rank = cmap.get("sharding", 0)
        self._mp_rank = cmap.get("model", 0)
        self._sp_rank = cmap.get("sep", 0)

    def get_parallel_mode(self):
        if self._pp_degree > 1:
            return "pipeline"
        if self._sharding_degree > 1:
            return "sharding_parallel"
        if self._mp_degree > 1:
            return "model_parallel"
        if self._sp_degree > 1:
            return "segment_parallel"
        return "data_parallel"

    def topology(self):
        return self._topo

    def get_global_rank(self):
        return self.global_rank

    def get_data_parallel_rank(self):
        return self._dp_rank

    def get_data_parallel_world_size(self):
        return self._dp_degree

    def get_data_parallel_group(self):
        return AxisGroup(self.mesh, "dp", self._dp_rank)

    def get_model_parallel_rank(self):
        return self._mp_rank

    def get_model_parallel_world_size(self):
        return self._mp_degree

    def get_model_parallel_group(self):
        return AxisGroup(self.mesh, "mp", self._mp_rank)

    def get_stage_id(self):
        return self._pp_rank

    def get_pipe_parallel_rank(self):
        return self._pp_rank

    def get_pipe_parallel_world_size(self):
        return self._pp_degree

    def get_pipe_parallel_group(self):
        return AxisGroup(self.mesh, "pp", self._pp_rank)

    def is_first_stage(self):
        return self._pp_rank == 0

    def is_last_stage(self):
        return self._pp_rank == self._pp_degree - 1

    def get_sharding_parallel_rank(self):
        return self._sharding_rank

    def get_sharding_parallel_world_size(self):
        return self._sharding_degree

    def get_sharding_parallel_group(self):
        return AxisGroup(self.mesh, "sharding", self._sharding_rank)

    def get_sep_parallel_rank(self):
        return self._sp_rank

    def get_sep_parallel_world_size(self):
        return self._sp_degree

    def get_sep_parallel_group(self):
        return AxisGroup(self.mesh, "sp", self._sp_rank)


_HCG = None


def set_hybrid_communicate_group(hcg):
    global _HCG
    _HCG = hcg


def get_hybrid_communicate_group():
    return _HCG


fleet_hcg = get_hybrid_communicate_group

__all__ = ["AXES", "AxisGroup", "CommunicateTopology", "DeviceMesh",
           "HybridCommunicateGroup", "build_mesh", "fleet_hcg",
           "get_hybrid_communicate_group", "get_mesh", "init_mesh",
           "set_hybrid_communicate_group", "set_mesh"]
