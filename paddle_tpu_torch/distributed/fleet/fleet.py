"""The fleet facade (the JAX package's
`paddle_tpu/distributed/fleet/fleet.py`: reference fleet/fleet.py:100,
init:168, distributed_optimizer:1044).

`init` builds the `CommunicateTopology` of the strategy's hybrid degrees
(``sep_degree`` above 1 adds a ``"sep"`` dim, the mesh's ``sp`` axis: a
port addition, as the JAX `init` leaves it out of the topology) and the
`HybridCommunicateGroup` over it, whose mesh (distributed/mesh.py)
it installs as the process's: the mesh a train step is then built over
(`parallel.spmd.make_sharded_train_step(..., mesh=hcg.mesh)`). In the
port's idiom the caller's process is rank 0 of that mesh, and the step
starts the other ranks. `init` takes one argument the JAX function has
not: `device`, where the ranks run (None: CUDA, which must exist; the
tests pass ``"cpu"``). `distributed_model` and `distributed_optimizer`
return the wrappers of `meta_parallel.parallel_wrappers` (a pipeline
mesh's model its `PipelineParallel`), which the train step unwraps;
`distributed_scaler` the `HybridParallelGradScaler`. `barrier_worker`
waits for every rank of a running mesh (nothing to wait for before the
ranks start), `minimize` is the optimizer's eager one, and
`stop_worker` and `save_persistables` do nothing, as in the JAX package.
"""
from __future__ import annotations

from ..mesh import (CommunicateTopology, HybridCommunicateGroup,
                    set_hybrid_communicate_group)
from .strategy import DistributedStrategy


class Fleet:
    def __init__(self):
        self._strategy = None
        self._hcg = None
        self._is_initialized = False

    def init(self, role_maker=None, is_collective=True, strategy=None,
             log_level="INFO", device=None):
        self._strategy = strategy or DistributedStrategy()
        hc = self._strategy.hybrid_configs
        names = ("data", "pipe", "sharding", "model")
        dims = (hc["dp_degree"], hc["pp_degree"], hc["sharding_degree"],
                hc["mp_degree"])
        if int(hc.get("sep_degree", 1)) > 1:
            # the mesh's sp axis (distributed/mesh.py), last: fastest
            names, dims = names + ("sep",), dims + (hc["sep_degree"],)
        topo = CommunicateTopology(hybrid_group_names=names, dims=dims)
        self._hcg = HybridCommunicateGroup(topo, self._strategy,
                                           device=device)
        set_hybrid_communicate_group(self._hcg)
        self._is_initialized = True
        return self

    def get_hybrid_communicate_group(self):
        return self._hcg

    @property
    def worker_num(self):
        return 1 if self._hcg is None else self._hcg.mesh.size

    def worker_index(self):
        return 0

    def is_first_worker(self):
        return True

    def barrier_worker(self):
        """Wait until every rank of the running mesh gets here
        (`parallel.spmd.barrier`: in the controller between steps, the
        ranks take it as an operation of their channel)."""
        if self._hcg is not None:
            from ...parallel.spmd import barrier

            barrier(self._hcg.mesh)

    def distributed_model(self, model):
        from .meta_parallel import (DataParallel, PipelineParallel,
                                    TensorParallel)

        if self._hcg is None:
            self.init()
        if self._hcg.get_pipe_parallel_world_size() > 1:
            return PipelineParallel(model, self._hcg, self._strategy)
        if self._hcg.get_model_parallel_world_size() > 1:
            return TensorParallel(model, self._hcg, self._strategy)
        return DataParallel(model)

    def distributed_optimizer(self, optimizer, strategy=None):
        from .meta_parallel import HybridParallelOptimizer

        return HybridParallelOptimizer(optimizer, self._hcg,
                                       strategy or self._strategy)

    def distributed_scaler(self, scaler):
        from .meta_parallel import HybridParallelGradScaler

        return HybridParallelGradScaler(scaler, self._hcg)

    def state_dict(self):
        return {}

    def minimize(self, optimizer, loss, startup_program=None,
                 parameter_list=None, no_grad_set=None):
        return optimizer.minimize(loss)

    def stop_worker(self):
        pass

    def save_persistables(self, executor=None, dirname=None,
                          main_program=None):
        pass


fleet = Fleet()


def init(role_maker=None, is_collective=True, strategy=None,
         log_level="INFO", device=None):
    return fleet.init(role_maker, is_collective, strategy, log_level, device)


def distributed_model(model):
    return fleet.distributed_model(model)


def distributed_optimizer(optimizer, strategy=None):
    return fleet.distributed_optimizer(optimizer, strategy)


def distributed_scaler(scaler):
    return fleet.distributed_scaler(scaler)


def get_hybrid_communicate_group():
    return fleet.get_hybrid_communicate_group()


__all__ = ["Fleet", "distributed_model", "distributed_optimizer",
           "distributed_scaler", "fleet", "get_hybrid_communicate_group",
           "init"]
