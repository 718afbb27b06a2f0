"""The training mesh (the JAX package's `paddle_tpu/distributed/mesh.py`,
in PyTorch's idiom: one rank a device over `torch.distributed`).

The JAX topology is a `jax.sharding.Mesh` with the named axes ``("dp",
"pp", "sharding", "mp", "sp")`` over the process's devices. The port's
`DeviceMesh` keeps the axes and their degrees (``mesh.shape``) and maps
the ``dp`` axis onto ranks: one rank a device, the caller's process rank
0, the others spawned by the first train step built over the mesh
(parallel/spmd.py) and kept for every later step until `close`. The
device and backend rules are `distributed.ranks.RankMesh`'s, shared with
serving: distinct CUDA devices run NCCL, CPU ranks run gloo, and a CUDA
device named twice (two ranks on one card) runs only over an explicit
``backend="gloo"``.

Only the ``dp`` axis is ported. A mesh with another axis of degree > 1
(``mp``, ``sharding``, ``pp``, ``sp``) takes the JAX package's GSPMD
path, which the port does not have: `build_mesh` refuses it.
"""
from __future__ import annotations

import torch

from .._device import resolve_device
from .ranks import RankMesh, leave_group

AXES = ("dp", "pp", "sharding", "mp", "sp")

_GLOBAL_MESH = None


class DeviceMesh(RankMesh):
    """A data-parallel mesh of ``dp`` ranks, one a device (`devices`, rank
    order). ``shape`` maps every axis of `AXES` to its degree. `ranks` is
    the `RankSet` of ranks 1 .. dp-1 once a train step has started them;
    `close` ends them."""

    def __init__(self, degrees, devices, backend=None, timeout=1800.0):
        shape = _degrees(degrees)
        if len(devices) != shape["dp"]:
            raise ValueError(f"mesh degrees {degrees} need {shape['dp']} "
                             f"devices, have {len(devices)}")
        super().__init__(devices, backend=backend, timeout=timeout)
        self.shape = shape
        self.ranks = None

    def close(self):
        """End the mesh's rank processes (and, over NCCL, every rank's
        communicators together). Idempotent; the next step built over the
        mesh starts new ones."""
        ranks, self.ranks = self.ranks, None
        if ranks is not None:
            ranks.close(leave=lambda: leave_group(self))


def _degrees(degrees):
    """Every axis's degree from `degrees` (missing axes are 1); raises for
    an unknown axis and for any axis but ``dp`` above 1."""
    unknown = sorted(set(degrees) - set(AXES))
    if unknown:
        raise ValueError(f"unknown mesh axes {unknown}; the axes are {AXES}")
    shape = {a: int(degrees.get(a, 1)) for a in AXES}
    if any(d < 1 for d in shape.values()):
        raise ValueError(f"mesh degrees must be >= 1; got {degrees}")
    other = {a: d for a, d in shape.items() if a != "dp" and d > 1}
    if other:
        raise NotImplementedError(
            f"mesh axes {other}: only the 'dp' axis is ported. A mesh with "
            "an 'mp', 'sharding', 'pp' or 'sp' axis of degree > 1 takes the "
            "JAX package's GSPMD path (parallel/spmd.py:585-678), which is "
            "not ported yet (ROADMAP Queue 1, item 6d: dp x mp training)")
    return shape


def build_mesh(degrees, devices=None, backend=None, timeout=1800.0,
               device=None):
    """A `DeviceMesh` of `degrees` (e.g. ``{"dp": 2}``; missing axes are
    1) over the first ``dp`` of `devices`. `devices` defaults to ``dp``
    CPU ranks when `device` is the CPU, else to ``cuda:0 .. cuda:dp-1``
    (which must exist: the port never falls back to the CPU). `backend`
    and `timeout` (seconds a collective may wait) as `RankMesh` takes
    them."""
    dp = _degrees(degrees)["dp"]
    if devices is None:
        if torch.device(resolve_device(device)).type == "cpu":
            devices = ["cpu"] * dp
        else:
            n = torch.cuda.device_count()
            devices = [f"cuda:{i}" for i in range(n)]
    devices = list(devices)
    if dp > len(devices):
        raise ValueError(
            f"mesh degrees {degrees} need {dp} devices, have {len(devices)}")
    return DeviceMesh(degrees, devices[:dp], backend=backend, timeout=timeout)


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


__all__ = ["AXES", "DeviceMesh", "build_mesh", "get_mesh", "init_mesh",
           "set_mesh"]
