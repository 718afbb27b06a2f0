"""Continuous-batching serving over a paged KV cache (PyTorch port).

`LLMEngine` steps the model; `AsyncLLMEngine` (frontend.py) drives it from
one background thread under the fault-tolerance layer (supervisor.py,
faults.py) and fans tokens out to asyncio streams; `ServingServer`
(server.py) exposes it over HTTP/SSE (``python -m
paddle_tpu_torch.serving.server``). Tracing (trace.py), the SLO ledger
(slo.py), the flight recorder (postmortem.py), the scheduling policy
(policy.py) and the replica lifecycle (lifecycle.py) hook into the engine,
each off by default.
"""
from . import faults  # noqa: F401
from .block_pool import (BlockPool, PagedState, chain_block_hashes,
                         kv_capacity_blocks)
from .engine import LLMEngine, StepOutput
from .faults import FaultInjected, FaultPlan, FaultPoint
from .frontend import (AsyncLLMEngine, EngineClosedError,
                       EngineOverloadedError, RequestStream)
from .lifecycle import LifecycleError, ReplicaLifecycle
from .metrics import ServingMetrics
from .policy import SchedulingPolicy, as_policy
from .postmortem import FlightRecorder
from .scheduler import Request, Scheduler
from .server import ServingServer
from .slo import SLOLedger
from .spec import NgramDrafter
from .supervisor import EngineHealth, EngineSupervisor, StepWatchdog
from .trace import EngineTracer

__all__ = ["AsyncLLMEngine", "BlockPool", "EngineClosedError",
           "EngineHealth", "EngineOverloadedError", "EngineSupervisor",
           "EngineTracer", "FaultInjected", "FaultPlan", "FaultPoint",
           "FlightRecorder", "LLMEngine", "LifecycleError", "NgramDrafter",
           "PagedState", "ReplicaLifecycle", "Request", "RequestStream",
           "SLOLedger", "Scheduler", "SchedulingPolicy", "ServingMetrics",
           "ServingServer", "StepOutput", "StepWatchdog", "as_policy",
           "chain_block_hashes", "kv_capacity_blocks"]
