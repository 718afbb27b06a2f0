"""Continuous-batching serving over a paged KV cache (PyTorch port).

`LLMEngine` steps the model; `AsyncLLMEngine` (frontend.py) drives it from
one background thread under the fault-tolerance layer (supervisor.py,
faults.py) and fans tokens out to asyncio streams; `ServingServer`
(server.py) exposes it over HTTP/SSE (``python -m
paddle_tpu_torch.serving.server``). Tracing (trace.py), the SLO ledger
(slo.py), the flight recorder (postmortem.py), the scheduling policy
(policy.py) and the replica lifecycle (lifecycle.py) hook into the engine,
each off by default. `ReplicaRouter` (router.py) fronts N replicas with
prefix-affinity routing, ejection, retry-elsewhere and rolling drain,
`AutoScaler` (autoscale.py) spawns and retires them on SLO signals, and
`RouterServer` (server.py) exposes the fleet over HTTP. A replica built
with ``LLMEngine(skeleton, checkpoint_path=...)`` streams its weights from
disk (distributed/checkpoint.py). ``LLMEngine(model, mesh=N)`` serves over
N tensor-parallel ranks (sharded.py, tp_worker.py).
"""
from ..distributed.ranks import RankFailed
from . import faults  # noqa: F401
from .autoscale import AutoScaler
from .block_pool import (BlockPool, PagedState, chain_block_hashes,
                         kv_capacity_blocks)
from .engine import LLMEngine, StepOutput
from .faults import FaultInjected, FaultPlan, FaultPoint
from .frontend import (AsyncLLMEngine, EngineClosedError,
                       EngineOverloadedError, RequestStream)
from .kv_tier import KVTier
from .lifecycle import LifecycleError, ReplicaLifecycle
from .metrics import ServingMetrics
from .policy import SchedulingPolicy, as_policy
from .postmortem import FlightRecorder
from .router import Replica, ReplicaRouter, RoutedStream
from .scheduler import Request, Scheduler
from .server import RouterServer, ServingServer
from .sharded import (ServingMesh, as_serving_mesh, build_serving_mesh,
                      serving_collective_budget, serving_param_specs)
from .slo import SLOLedger
from .spec import NgramDrafter
from .supervisor import EngineHealth, EngineSupervisor, StepWatchdog
from .trace import EngineTracer

__all__ = ["AsyncLLMEngine", "AutoScaler", "BlockPool",
           "EngineClosedError", "EngineHealth", "EngineOverloadedError",
           "EngineSupervisor", "EngineTracer", "FaultInjected", "FaultPlan",
           "FaultPoint", "FlightRecorder", "KVTier", "LLMEngine",
           "LifecycleError", "NgramDrafter", "PagedState", "RankFailed",
           "Replica", "ReplicaLifecycle", "ReplicaRouter", "Request",
           "RequestStream", "RoutedStream", "RouterServer", "SLOLedger",
           "Scheduler", "SchedulingPolicy", "ServingMesh", "ServingMetrics",
           "ServingServer", "StepOutput", "StepWatchdog", "as_policy",
           "as_serving_mesh", "build_serving_mesh", "chain_block_hashes",
           "kv_capacity_blocks", "serving_collective_budget",
           "serving_param_specs"]
