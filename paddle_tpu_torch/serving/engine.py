"""LLMEngine: continuous-batching generation over the paged KV cache.

`add_request` enqueues, `step` runs ONE mixed device step (decode rows plus
chunked-prefill rows, planned by the scheduler), `stream` yields a request's
tokens as they land, `generate` runs a batch to completion.

- Every planned row is ragged: a decode row feeds its 1 pending token, a
  prefill row its next ``<= prefill_chunk`` tokens, a speculative row its
  pending token plus up to ``num_spec_tokens`` drafted candidates. A step's
  width is the smallest **width bucket** covering its widest row (by
  default ``{1, 1 + num_spec_tokens (spec engines), prefill_chunk}``), and
  the ragged kernel keeps a narrow row cheap inside a wide step.
- **Sampling and the speculative accept decision run on the device**
  (serving/spec.py), and the step returns ONE packed int32 tensor
  ``[B, K + 3]`` (emitted run, accept length, row-finite flag), which the
  host reads with exactly one ``.cpu()`` per step, counted in the
  ``host_syncs`` counter.
- **Prefix caching** (on by default): full-block prompt hashes are chained
  once at `add`, the scheduler pins a cached prefix at admission, and freed
  blocks park in the pool's cached-free LRU tier.
- A row whose logits are not finite is aborted with
  ``error:nonfinite_logits`` instead of sampling garbage (``step_faults``).
- ``kv_dtype="int8"`` stores the KV arena in int8 with per-(layer, head,
  block) float32 scales (serving/block_pool.py): at one ``kv_hbm_bytes``
  budget it holds about twice the blocks of a bf16 arena. The step's
  touched-block lists ride the same one int32 transfer.
- ``lora_slots`` serves many LoRA adapters over the one base model
  (models/lora.py): `load_adapter` writes an adapter into a slot of the
  stacked tables in place, a request names it with ``adapter=``, and the
  step body gathers each lane's rows by its ``adapter_slots`` entry (one
  more field of the packed int32 input). Which adapters a step mixes never
  keys a program.
- ``host_kv_blocks`` adds the host KV tier (serving/kv_tier.py): evicted
  prefix blocks are copied to host memory and copied back when a later
  prompt matches them, on the stream the step programs replay on.
- ``quantize="int8"`` rounds the blocks' Linear weights to an int8 grid
  with AdaRound (quantization/adaround.py) at construction, calibrated on
  ``calib_prompts``, and serves the dequantized values.

Greedy outputs are token-for-token identical to `GPT.generate`: the same
attention math runs through the block table instead of a contiguous cache
(the plain version on the CPU; the CUDA kernel on the card matches it to
kernel-accumulation tolerance).

**The step program table** (the JAX engine's compiled programs, one per
``(max_batch, W)`` width bucket): `_get_step_fn` builds a `_StepProgram` at
a bucket's first step. On a CUDA engine it captures the step's whole body
(forward, scored window, non-finite check, sampler and accept decision)
once as a `torch.cuda.CUDAGraph`, and every later step of that width
replays it; on a CPU engine the same body runs eagerly. `warmup()` (or
``warmup=True``) builds the whole table before the first request. Each
build counts once in the ``jit_traces`` counter; a surplus build sets the
``jit_retraces`` gauge and warns once (the recompile sentinel). A capture
bakes in device addresses: the arena (never reallocated), its own
workspace, and the model's parameters, so weights are loaded
(`weights.from_jax_state_dict`) before the engine is built and never
replaced while it serves.

**Fault tolerance and observability**, each off by default behind one
pointer test per hook site, as in the JAX engine: ``step(only=...)``
restricts a step to a set of request ids (the supervisor's bisection,
serving/supervisor.py, with ``requeue`` re-queueing the rest); a fault plan
(serving/faults.py, ``PADDLE_TPU_FAULTS``) fires at the step and alloc
hook sites; ``trace=`` (serving/trace.py) records request lifecycles and a
per-step phase timeline (``plan``, ``build``, ``dispatch``, ``sync``,
``emit``), the dispatch running under a `torch.profiler.record_function`
range named after the step id; ``slo=`` (serving/slo.py) keeps the
per-request phase clock and per-(tenant, priority) rollups;
``postmortem_dir=`` (serving/postmortem.py) writes a bundle per fault
event; ``request_log=`` logs one JSON line per finished request; a
``policy`` (serving/policy.py) orders admission by priority and tenant
fairness and early-rejects deadline-doomed requests. `lifecycle`
(serving/lifecycle.py) walks cold -> loading -> warm here and serving ->
draining -> stopped under the async frontend (serving/frontend.py). None
of these hooks reads a device value or touches a captured graph: they
read host clocks and the one packed result the step already copies back.

Every keyword left as None reads the JAX engine's environment switch
(``PADDLE_TPU_PREFIX_CACHE``, ``_SPEC_DECODE``, ``_KV_DTYPE``,
``_WIDTH_BUCKETS``, ``_HOST_KV_BLOCKS``, ``_TRACE``, ``_TRACE_BUF``,
``_REQUEST_LOG``, ``_SLO``, ``_POSTMORTEM_DIR``, ``_POSTMORTEM_KEEP``,
``_FAULTS``) exactly as that engine does. ``PADDLE_TPU_TP`` and
``_QUANT_ALLREDUCE`` name parts the port has not reached: set to anything
but their "off" value, they raise `NotImplementedError`.

The engine runs on CUDA unless `device` says otherwise; the model must
live on the engine's device. Options of the JAX engine that this port does
not have yet raise `NotImplementedError` at construction.
"""
from __future__ import annotations

import contextlib
import json
import logging
import os
import threading
import time
import warnings
from collections import namedtuple

import numpy as np
import torch

from .._device import resolve_device
from ..models import lora as lora_mod
from ..profiler.tracing import trace_capacity_from_env, trace_sample_from_env
from . import faults
from .block_pool import (BlockPool, PagedState, blocks_for,
                         chain_block_hashes, kv_capacity_blocks)
from .faults import FaultInjected
from .lifecycle import ReplicaLifecycle
from .metrics import ServingMetrics
from .policy import as_policy
from .postmortem import FlightRecorder
from .scheduler import WAITING, Request, Scheduler
from .slo import SLOLedger
from .spec import NgramDrafter, spec_emit_arrays
from .trace import EngineTracer

_request_log = logging.getLogger("paddle_tpu_torch.serving.request")

StepOutput = namedtuple("StepOutput", ["request_id", "token", "finished"])


def _env_flag(name, default):
    v = os.environ.get(name)
    if v is None:
        return default
    return v.strip().lower() not in ("0", "false", "off", "no", "")

# constructor options of the JAX engine that later slices of the port add
# (ROADMAP.md), with the value that means "off"
_LATER = {
    "mesh": (None, "tensor-parallel serving"),
    "checkpoint_path": (None, "checkpoint streaming"),
    "quant_allreduce": (None, "the quantized tensor-parallel all-reduce"),
    "param_hbm_bytes": (None, "the parameter memory budget"),
}

# host metadata packed into one int32 transfer per step: [B, W] fields,
# then [B, max_blocks] tables, then the [B] fields, then (int8 arena)
# touch_idx [B, W] and touched [B, T]
_ROW_FIELDS = ("ids", "qpos", "slots", "offs")
_LANE_FIELDS = ("q_start", "kv_live", "last_idx", "spec_lens", "top_ks",
                "adapter_slots")

# environment switches of the JAX engine that name a part the port has not
# reached: (variable, what it turns on, its "off" test)
_LATER_ENV = (
    ("PADDLE_TPU_TP", "tensor-parallel serving",
     lambda v: int(v or 1) <= 1),
    ("PADDLE_TPU_QUANT_ALLREDUCE", "the quantized tensor-parallel all-reduce",
     lambda v: v.strip().lower() in ("", "0", "false", "off", "no")),
)


def _adaround_model_int8(model, calib_prompts, iters=300):
    """Int8 weight quantization for a GPT serving model, in place: AdaRound
    (quantization/adaround.py `learn_rounding`) on every Linear of the
    blocks (qkv, proj, fc1, fc2) with per-output-channel absmax scales,
    written back as ``q * s`` in the weight's own dtype, so every later
    consumer (the step programs included) sees the quantized values with
    no layer swaps. Norms, embeddings (the tied head) and biases stay as
    they are. Calibration inputs are captured per layer, as float32, by
    forward pre-hooks over full forwards of `calib_prompts` (token-id
    sequences; a small fixed set when None). ``iters=0`` is round-to-
    nearest. The JAX engine's function, on the model's device."""
    from ..quantization.adaround import learn_rounding

    if calib_prompts is None:
        vocab = int(model.cfg.vocab_size)
        calib_prompts = [
            [(7 * i + 3 * j + 1) % vocab for j in range(16)]
            for i in range(4)
        ]
    subs = []
    for blk in model.blocks:
        subs += [blk.attn.qkv, blk.attn.proj, blk.fc1, blk.fc2]
    captured = {id(s): [] for s in subs}

    def _capture(store):
        return lambda layer, inputs: store.append(
            inputs[0].detach().float())

    hooks = [s.register_forward_pre_hook(_capture(captured[id(s)]))
             for s in subs]
    try:
        with torch.no_grad():
            for prompt in calib_prompts:
                model(torch.tensor([list(prompt)], device=model.device))
    finally:
        for h in hooks:
            h.remove()
    for s in subs:
        xs = captured[id(s)]
        w = s.weight.detach().float().t()                     # [in, out]
        scales = torch.clamp(w.abs().amax(dim=0), min=1e-8)[None, :] / 127.0
        bias = None if s.bias is None else s.bias.detach().float()

        def apply_fn(wq, x, _b=bias):
            y = x.float() @ wq
            return y if _b is None else y + _b

        with torch.no_grad():
            targets = [apply_fn(w, x) for x in xs]
        q = learn_rounding(w, scales, apply_fn, xs, targets, 127.0,
                           iters=int(iters))
        with torch.no_grad():
            s.weight.copy_((q * scales).to(s.weight.dtype).t())


def _refuse_later_env():
    for name, what, off in _LATER_ENV:
        v = os.environ.get(name)
        if v is not None and not off(v):
            raise NotImplementedError(
                f"{name}={v!r}: {what} is not in the PyTorch port yet; "
                "ROADMAP.md queues it for a later slice")


class LLMEngine:
    def __init__(self, model, device=None, block_size=16, num_blocks=None,
                 max_batch=4, prefill_chunk=None, token_budget=None,
                 max_seq_len=None, seed=0, prefix_cache=None,
                 spec_decoding=None, num_spec_tokens=4, spec_max_ngram=3,
                 spec_min_ngram=1, kv_hbm_bytes=None, width_buckets=None,
                 kv_dtype=None, prefill_buckets=None, prefill_interval=None,
                 trace=None, trace_buffer=None, request_log=None, slo=None,
                 postmortem_dir=None, postmortem_keep=None, policy=None,
                 host_kv_blocks=None, host_swap_chunk=4, quantize=None,
                 calib_prompts=None, quantize_iters=300, lora_slots=0,
                 lora_rank=8, lora_targets=None, warmup=False, **later):
        if quantize is not None and quantize is not False:
            if quantize != "int8":
                raise ValueError(
                    f"quantize={quantize!r} not supported — only 'int8'")
            if later.get("mesh") is not None:
                raise ValueError(
                    "quantize='int8' requires mesh=None: AdaRound "
                    "calibrates against the eager single-device model "
                    "before placement — quantize first, then build the "
                    "sharded engine from the quantized model")
        for name, value in later.items():
            if name not in _LATER:
                raise TypeError(f"LLMEngine got an unexpected keyword "
                                f"argument {name!r}")
            off, what = _LATER[name]
            if value is not None and value is not False and value != off:
                raise NotImplementedError(
                    f"{name}={value!r}: {what} is not in the PyTorch port "
                    "yet; ROADMAP.md queues it for a later slice")
        _refuse_later_env()
        if kv_dtype is None:
            kv_dtype = os.environ.get("PADDLE_TPU_KV_DTYPE", "") or None
        if kv_dtype is not None and kv_dtype != "int8":
            raise ValueError(
                f"kv_dtype {kv_dtype!r} not supported: pass 'int8' for the "
                "quantized arena or None for the weight dtype")
        quantized = kv_dtype == "int8"
        self.device = resolve_device(device)
        if model.device != self.device:
            raise ValueError(
                f"model lives on {model.device} but the engine runs on "
                f"{self.device}: build the model on the engine's device")
        model.eval()
        if quantize:
            # AdaRound int8 weights, in place on the caller's model
            _adaround_model_int8(model, calib_prompts,
                                 iters=int(quantize_iters))
        self.quantize = quantize or None
        self.model = model
        cfg = model.cfg
        self.max_seq_len = int(max_seq_len or cfg.max_seq_len)
        if self.max_seq_len > cfg.max_seq_len:
            raise ValueError(
                f"max_seq_len {self.max_seq_len} exceeds the model's "
                f"max_seq_len {cfg.max_seq_len}")
        self.block_size = int(block_size)
        self.max_blocks = -(-self.max_seq_len // self.block_size)
        self.max_batch = int(max_batch)
        head_dim = cfg.hidden_size // cfg.num_heads
        if kv_hbm_bytes is not None:
            if num_blocks is not None:
                raise ValueError(
                    "pass num_blocks OR kv_hbm_bytes, not both — the byte "
                    "budget would be silently ignored")
            # an int8 block costs itemsize 1 plus its scale sidecar entries
            num_blocks = kv_capacity_blocks(
                kv_hbm_bytes, cfg.num_layers, cfg.num_heads, self.block_size,
                head_dim,
                1 if quantized else model.wte.weight.element_size(),
                scale_itemsize=4 if quantized else 0)
            worst = blocks_for(self.max_seq_len - 1, self.block_size)
            if num_blocks < 1 + worst:
                raise ValueError(
                    f"kv_hbm_bytes {kv_hbm_bytes} buys only {num_blocks} KV "
                    f"blocks but one max_seq_len={self.max_seq_len} "
                    f"sequence needs {worst} (+ the null block)")
        if num_blocks is None:
            # a full decode batch of max-length sequences (+ the null block)
            num_blocks = self.max_batch * self.max_blocks + 1
        # prefill_buckets/prefill_interval are accepted for API compatibility
        # with the bucketed engine and ignored: chunked prefill replaced the
        # per-bucket programs with one mixed program
        del prefill_buckets, prefill_interval
        if prefill_chunk is None:
            prefill_chunk = min(128, self.max_seq_len)
        self.prefill_chunk = max(1, min(int(prefill_chunk), self.max_seq_len))
        if token_budget is None:
            token_budget = self.max_batch * self.prefill_chunk
        self.prefill_chunk = min(self.prefill_chunk, int(token_budget))
        # the constructor argument wins, then the env switch
        self.prefix_cache = (_env_flag("PADDLE_TPU_PREFIX_CACHE", True)
                             if prefix_cache is None else bool(prefix_cache))
        self.spec_decoding = (_env_flag("PADDLE_TPU_SPEC_DECODE", False)
                              if spec_decoding is None
                              else bool(spec_decoding))
        self.num_spec_tokens = int(num_spec_tokens)
        drafter = None
        if self.spec_decoding:
            if self.num_spec_tokens + 1 > self.max_seq_len:
                raise ValueError(
                    f"num_spec_tokens {self.num_spec_tokens} does not fit "
                    f"max_seq_len {self.max_seq_len}")
            drafter = NgramDrafter(num_spec_tokens=self.num_spec_tokens,
                                   max_ngram=spec_max_ngram,
                                   min_ngram=spec_min_ngram)
        # ragged width buckets: {1, 1 + num_spec_tokens, prefill_chunk}
        # plus any intermediate widths the caller (or
        # PADDLE_TPU_WIDTH_BUCKETS, "8,32") asks for
        if width_buckets is None:
            wb = os.environ.get("PADDLE_TPU_WIDTH_BUCKETS", "")
            width_buckets = [int(w) for w in wb.split(",") if w.strip()]
        buckets = {1, self.prefill_chunk}
        if self.spec_decoding:
            buckets.add(min(1 + self.num_spec_tokens, self.max_seq_len))
        top = max(buckets)
        for w in width_buckets:
            w = int(w)
            if w < 1:
                raise ValueError(f"width_buckets entries must be >= 1; "
                                 f"got {w}")
            if w <= top:
                buckets.add(w)
        self.width_buckets = sorted(buckets)
        self.metrics = ServingMetrics()
        # cold -> loading -> warm here; the async frontend drives serving,
        # draining and stopped
        self.lifecycle = ReplicaLifecycle(metrics=self.metrics)
        # tracing: a value in (0, 1) samples that fraction of requests;
        # the step timeline is recorded whenever the tracer exists
        if trace is None:
            sample = trace_sample_from_env()
        elif trace is True:
            sample = 1.0
        elif trace is False:
            sample = 0.0
        else:
            sample = min(max(float(trace), 0.0), 1.0)
        cap = (trace_capacity_from_env() if trace_buffer is None
               else max(16, int(trace_buffer)))
        self.tracer = (EngineTracer(capacity=cap, sample=sample)
                       if sample > 0.0 else None)
        self.request_log = (_env_flag("PADDLE_TPU_REQUEST_LOG", False)
                            if request_log is None else bool(request_log))
        pm_dir = (os.environ.get("PADDLE_TPU_POSTMORTEM_DIR")
                  if postmortem_dir is None else postmortem_dir) or None
        self.recorder = None
        if pm_dir:
            keep = (int(postmortem_keep) if postmortem_keep is not None
                    else int(os.environ.get("PADDLE_TPU_POSTMORTEM_KEEP",
                                            "16") or 16))
            self.recorder = FlightRecorder(pm_dir, keep=keep).attach(self)
        # the SLO ledger rides along whenever the request log or the
        # flight recorder is on: both embed its decomposition
        slo_on = (_env_flag("PADDLE_TPU_SLO", False) if slo is None
                  else bool(slo))
        self.slo = (SLOLedger(metrics=self.metrics)
                    if slo_on or self.request_log
                    or self.recorder is not None else None)
        self.lifecycle.to("loading", "placing weights")
        # the stream the step programs stage their inputs and replay on
        # (and the host tier copies on): the constructing thread's
        # (warmup's), which `device_scope` hands to the async frontend's
        # loop thread
        self._stream = (torch.cuda.current_stream(self.device)
                        if self.device.type == "cuda" else None)
        self.pool = BlockPool(num_blocks, cfg.num_layers, self.block_size,
                              cfg.num_heads, head_dim, dtype=model.dtype,
                              device=self.device, metrics=self.metrics,
                              tracer=self.tracer, kv_dtype=kv_dtype)
        # host-memory KV tier (serving/kv_tier.py): None/0 = off, one
        # pointer, every hook a single test
        if host_kv_blocks is None:
            host_kv_blocks = int(
                os.environ.get("PADDLE_TPU_HOST_KV_BLOCKS", "0") or 0)
        self.tier = None
        if host_kv_blocks:
            from .kv_tier import KVTier

            self.tier = KVTier(self.pool, host_kv_blocks,
                               metrics=self.metrics,
                               swap_chunk=host_swap_chunk,
                               stream=self._stream)
            self.pool.attach_tier(self.tier)
        mi = self.mesh_info()
        self.metrics.set_gauge("mesh_tp_degree", mi["tp_degree"])
        self.metrics.set_gauge("mesh_device_count", mi["device_count"])
        self.metrics.set_info("mesh", {"backend": mi["backend"]})
        self.metrics.set_gauge("kv_bytes_per_block",
                               self.pool.bytes_per_block())
        self.metrics.set_info("kv", {"dtype": self.pool.kv_dtype})
        self.policy = as_policy(policy)
        self.scheduler = Scheduler(
            self.pool, max_batch=self.max_batch,
            token_budget=int(token_budget), prefill_chunk=self.prefill_chunk,
            metrics=self.metrics, prefix_cache=self.prefix_cache,
            drafter=drafter, tracer=self.tracer, slo=self.slo,
            width_buckets=self.width_buckets, policy=self.policy)
        # per-request LoRA adapters over the shared base model
        # (models/lora.py): `lora_slots` table slots (slot 0 = the
        # all-zeros "no adapter"), each holding a rank <= lora_rank adapter
        # over the column-parallel targets, gathered per row inside the
        # step body. 0 slots = off: no tables, and the step body is the
        # lora-off one.
        self.lora_slots = int(lora_slots)
        self.lora_rank = int(lora_rank)
        self._lora_tables = {}
        self._adapters = {}            # name -> slot (1-based; 0 = base)
        self._adapter_inflight = {}    # name -> live request count
        self._adapter_lru = []         # names, least-recent first
        self.lora_targets = ()
        if self.lora_slots:
            if self.lora_rank < 1:
                raise ValueError("lora_rank must be >= 1 with lora_slots")
            self.lora_targets = tuple(lora_targets
                                      or lora_mod.LORA_TARGETS)
            self._lora_tables = lora_mod.init_adapter_tables(
                cfg, 1 + self.lora_slots, self.lora_rank,
                self.lora_targets, device=self.device)
        self._requests = {}
        self._phases = {}   # current step's {phase: (t0, t1)} when tracing
        # stamped by AsyncLLMEngine.start(): while that thread lives, the
        # synchronous drive surface refuses other threads (`_guard_thread`)
        self._engine_thread = None
        self._gen = torch.Generator(device=self.device)
        self._gen.manual_seed(int(seed))
        # arm the PADDLE_TPU_FAULTS plan if one is configured
        faults.maybe_install_from_env()
        # supervision surface (serving/supervisor.py reads these)
        self.step_count = 0      # planned steps run (bisection probes too)
        self.last_planned = []   # request ids of the most recent plan
        self.step_faults = []    # (rid, detail) rows contained this step
        # the step program table, (max_batch, W) -> _StepProgram, and the
        # one private memory pool its CUDA graphs share
        self._step_fns = {}
        self._graph_pool = (torch.cuda.graph_pool_handle()
                            if self.device.type == "cuda" else None)
        self._retrace_warned = False
        if warmup:
            self.warmup()
        self.lifecycle.to("warm", "weights placed"
                          + (" + programs built" if warmup else ""))

    def warmup(self):
        """Build the engine's whole width-bucket program table by serving
        one synthetic greedy request per bucket, one at a time (a batch of
        mixed widths would build only its widest bucket):

        - a bucket ``W <= prefill_chunk`` is reached by a prompt of exactly
          ``W`` tokens: its first prefill chunk has width W;
        - a spec bucket wider than ``prefill_chunk`` is reachable only as a
          drafted decode step, so its request carries a cyclic prompt the
          n-gram drafter always matches, forcing one full-width verify step.

        The engine must be idle. Prefix caching is suspended meanwhile
        (synthetic prompts must neither seed the cache nor skip a build
        through a hit), and each synthetic request is dropped once its
        bucket is built. After warmup a served step builds nothing
        (``jit_traces`` stays at the table's size). Sets the
        ``warmup_programs`` and ``warmup_seconds`` gauges and returns the
        number of programs built."""
        if self.has_unfinished():
            raise RuntimeError(
                "warmup() requires an idle engine — it serves synthetic "
                "requests through the real step path")
        t0 = time.monotonic()
        expected = self.expected_program_count()
        pc_engine, pc_sched = self.prefix_cache, self.scheduler.prefix_cache
        self.prefix_cache = self.scheduler.prefix_cache = False
        try:
            for W in self.width_buckets:
                if (self.max_batch, W) in self._step_fns:
                    continue
                if W <= self.prefill_chunk:
                    plen = min(W, self.max_seq_len - 1)
                    prompt = [0] * plen
                    mnt = 1
                else:
                    # drafted-only bucket (1 + num_spec_tokens beyond the
                    # chunk): a cyclic prompt makes the drafter propose a
                    # full draft on the first decode step
                    mnt = self.num_spec_tokens + 2
                    plen = max(1, min(self.prefill_chunk,
                                      self.max_seq_len - mnt))
                    prompt = [(i % 3) + 1 for i in range(plen)]
                rid = self.add_request(prompt, max_new_tokens=mnt,
                                       temperature=0.0, tenant="_warmup")
                for _ in range(8 * mnt + 8):
                    if not self.has_unfinished():
                        break
                    self.step()
                    if (self.max_batch, W) in self._step_fns:
                        self.abort(rid)   # the rest is redundant work
                        break
                else:
                    raise RuntimeError(
                        f"warmup: synthetic request for bucket {W} never "
                        "finished")
                self._requests.pop(rid, None)
        finally:
            self.prefix_cache = pc_engine
            self.scheduler.prefix_cache = pc_sched
        built = len(self._step_fns)
        if built < expected:
            missing = [W for W in self.width_buckets
                       if (self.max_batch, W) not in self._step_fns]
            raise RuntimeError(
                f"warmup built {built}/{expected} width-bucket programs — "
                f"buckets {missing} were never exercised")
        self.lifecycle.warmed = True
        self.lifecycle.programs_compiled = built
        self.metrics.set_gauge("warmup_programs", float(built))
        self.metrics.set_gauge("warmup_seconds",
                               round(time.monotonic() - t0, 3))
        return built

    # -- request lifecycle -------------------------------------------------

    def add_request(self, prompt_ids, max_new_tokens=16, temperature=0.0,
                    eos_token_id=None, request_id=None, top_k=None,
                    top_p=None, spec_decoding=None, num_spec_tokens=None,
                    trace=None, tenant=None, priority=None,
                    deadline_s=None, adapter=None):
        """Enqueue one generation request; returns its id. Admission
        happens inside a later `step()`. `trace` forces this request into
        (out of) the tracer's sample; `tenant`/`priority` label its SLO
        and policy class and `deadline_s` its attainment target;
        `adapter` names a loaded LoRA adapter to decode through
        (`load_adapter`)."""
        prompt_ids = [int(t) for t in np.asarray(prompt_ids).reshape(-1)]
        req = Request(prompt_ids, max_new_tokens=max_new_tokens,
                      temperature=temperature, eos_token_id=eos_token_id,
                      request_id=request_id, top_k=top_k, top_p=top_p,
                      spec_decoding=spec_decoding,
                      num_spec_tokens=num_spec_tokens, trace=trace,
                      tenant=tenant, priority=priority,
                      deadline_s=deadline_s, adapter=adapter)
        return self.add(req)

    def mesh_info(self):
        """Topology of this replica — {tp_degree, device_count, backend,
        kv_dtype} — for /healthz and the ``mesh_*`` gauges. A one-card
        engine reports degree and count 1 on its device's backend
        ("cuda" or "cpu"); `kv_dtype` is the arena's."""
        return {"tp_degree": 1, "device_count": 1,
                "backend": self.device.type, "kv_dtype": self.pool.kv_dtype}

    # -- LoRA adapter registry (models/lora.py owns the math) --------------

    def _touch_adapter(self, name):
        """Move `name` to the recently-used end of the LRU order."""
        if name in self._adapter_lru:
            self._adapter_lru.remove(name)
        self._adapter_lru.append(name)

    def _find_adapter_slot(self, name):
        """Slot for a (re)load of `name`: its current slot, else a free
        one, else the least-recently-used idle adapter's (evicting it).
        Raises when every slot holds an adapter with requests in
        flight."""
        if name in self._adapters:
            return self._adapters[name]
        used = set(self._adapters.values())
        for slot in range(1, 1 + self.lora_slots):
            if slot not in used:
                return slot
        for victim in self._adapter_lru:
            if not self._adapter_inflight.get(victim, 0):
                slot = self._adapters.pop(victim)
                self._adapter_lru.remove(victim)
                self._adapter_inflight.pop(victim, None)
                self.metrics.inc("lora_adapter_evictions")
                self.metrics.inc_labeled("lora_adapter_evictions",
                                         {"adapter": victim})
                return slot
        inflight = {k: v for k, v in self._adapter_inflight.items() if v}
        raise RuntimeError(
            f"all {self.lora_slots} adapter slots hold adapters with "
            f"requests in flight — raise lora_slots or drain first "
            f"(inflight: {inflight})")

    def load_adapter(self, name, weights, alpha=None):
        """Load (or replace) a named LoRA adapter into a table slot so
        requests can decode through it (``add_request(adapter=name)``).
        `weights` maps target op names to ``(A [L, in, r], B [L, r, out])``
        host arrays with ``r <= lora_rank`` (`models.lora.pack_adapter`
        validates; `alpha` folds the ``alpha / r`` scale into B). When all
        ``lora_slots`` are taken, the least-recently-used adapter with no
        request in flight is evicted; if every adapter is busy this raises.
        The slot is written in place on the engine's stream (the step
        programs read the tables by address), from the thread that drives
        the engine. Returns the slot index."""
        self._guard_thread("load_adapter()")
        if not self.lora_slots:
            raise RuntimeError(
                "engine built without LoRA slots (lora_slots=0)")
        name = str(name)[:64]
        packed = lora_mod.pack_adapter(self.model.cfg, weights,
                                       self.lora_rank, self.lora_targets,
                                       alpha=alpha)
        slot = self._find_adapter_slot(name)
        with self.device_scope():
            lora_mod.write_slot(self._lora_tables, slot, packed)
        self._adapters[name] = slot
        self._adapter_inflight.setdefault(name, 0)
        self._touch_adapter(name)
        self.metrics.set_gauge("lora_adapters_loaded", len(self._adapters))
        return slot

    def unload_adapter(self, name):
        """Free a named adapter's slot. Refuses while any request on it is
        still in flight (their lanes index this slot: zeroing it mid-decode
        would silently serve base-model tokens). The freed slot is zeroed
        in place so no stale weights linger."""
        self._guard_thread("unload_adapter()")
        if name not in self._adapters:
            raise ValueError(f"unknown adapter {name!r} "
                             f"(loaded: {sorted(self._adapters)})")
        n = self._adapter_inflight.get(name, 0)
        if n:
            raise RuntimeError(
                f"adapter {name!r} has {n} request(s) in flight — drain "
                "or abort them before unloading")
        slot = self._adapters.pop(name)
        self._adapter_inflight.pop(name, None)
        if name in self._adapter_lru:
            self._adapter_lru.remove(name)
        with self.device_scope():
            lora_mod.zero_slot(self._lora_tables, slot)
        self.metrics.set_gauge("lora_adapters_loaded", len(self._adapters))

    def kv_capacity_blocks(self):
        """Usable KV blocks (the null block excluded)."""
        return self.pool.num_blocks - 1

    def validate(self, req):
        """Raise ValueError on a request that could never complete: too
        long for the model, needing more KV blocks at its worst case than
        the pool holds, or naming a LoRA adapter this engine has not
        loaded (or has no slots for). Returns that worst-case block
        need."""
        if req.adapter is not None:
            if not self.lora_slots:
                raise ValueError(
                    f"request {req.request_id}: adapter {req.adapter!r} "
                    "on an engine built without LoRA slots (lora_slots=0)")
            if req.adapter not in self._adapters:
                raise ValueError(
                    f"request {req.request_id}: unknown adapter "
                    f"{req.adapter!r} — load_adapter() it first "
                    f"(loaded: {sorted(self._adapters)})")
        if req.num_tokens + req.max_new_tokens > self.max_seq_len:
            raise ValueError(
                f"request {req.request_id}: prompt {req.num_tokens} + "
                f"{req.max_new_tokens} new tokens exceeds max_seq_len "
                f"{self.max_seq_len}")
        need = self.pool.blocks_for(req.num_tokens + req.max_new_tokens - 1)
        if need > self.kv_capacity_blocks():
            raise ValueError(
                f"request {req.request_id}: needs up to {need} KV blocks "
                f"but the pool only has {self.kv_capacity_blocks()} usable "
                "— raise num_blocks or shorten the request")
        return need

    def add(self, req):
        """Enqueue a pre-built Request. Returns the request id."""
        self.validate(req)
        if req.request_id in self._requests:
            raise ValueError(f"duplicate request id {req.request_id}")
        if req.adapter is not None:
            # pin the adapter's slot for the request's whole life (a
            # preempted request replays through the same adapter) and hold
            # it against LRU eviction while any request is in flight
            req.adapter_slot = self._adapters[req.adapter]
            self._adapter_inflight[req.adapter] = (
                self._adapter_inflight.get(req.adapter, 0) + 1)
            self._touch_adapter(req.adapter)
            self.metrics.inc("lora_requests")
            self.metrics.inc_labeled("lora_requests",
                                     {"adapter": req.adapter})
        if self.prefix_cache and not req.block_hashes:
            # the adapter name salts the chain: KV is computed through the
            # adapter, so one prompt under two adapters never shares blocks
            req.block_hashes = chain_block_hashes(
                req.prompt_ids, self.block_size, salt=req.adapter)
        self._requests[req.request_id] = req
        if self.slo is not None:
            self.slo.begin(req)   # the `queued` phase opens at arrival
        self.scheduler.add(req)
        self.metrics.inc("requests_added")
        tr = self.tracer
        if tr is not None and tr.should_trace(req):
            req.traced = True
            tr.begin_request(req)
        return req.request_id

    def abort(self, request_id, reason="aborted"):
        """Cancel a request in any live state; its KV blocks return to the
        pool. Returns True if a live request was aborted."""
        req = self._requests.get(request_id)
        if req is None or req.finished:
            return False
        self.scheduler.abort(req)
        del self._requests[request_id]
        self._finalize(req, reason)
        return True

    def requeue(self, request_id):
        """Re-queue a live request by preempt-by-recompute: its KV blocks
        return to the pool and it replays from scratch on re-admission
        (the supervisor's recovery path). Returns True if the request is
        (now) queued, False for unknown or finished ids."""
        req = self._requests.get(request_id)
        if req is None or req.finished:
            return False
        if req.state == WAITING:
            return True          # already queued (e.g. a prior probe)
        return self.scheduler.preempt(req)

    def live_requests(self):
        """Ids of requests not yet finished or aborted."""
        return [rid for rid, r in self._requests.items() if not r.finished]

    def peek_request(self, request_id):
        """The request record (live or finished but unreleased), else
        None; unlike `get_request` this never raises."""
        return self._requests.get(request_id)

    def has_unfinished(self):
        return self.scheduler.has_unfinished()

    def get_request(self, request_id):
        return self._requests[request_id]

    def release(self, request_id):
        """Drop a finished request's host-side record."""
        req = self._requests.pop(request_id)
        if not req.finished:
            self._requests[request_id] = req
            raise ValueError(
                f"request {request_id} is still {req.state}; release only "
                "finished requests")

    # -- the device step -----------------------------------------------------

    def _draft_capacity(self, W):
        """Draft capacity K of a width-``W`` step: the packed result is
        ``[B, K + 3]``. Width 1 degenerates to the one-token sampler."""
        return min(self.num_spec_tokens if self.spec_decoding else 0, W - 1)

    def expected_program_count(self):
        """The program-count contract: the engine builds at most one step
        program per ragged width bucket (a CUDA graph on the card, the
        eager body on the CPU), so ``jit_traces <=
        expected_program_count()``, with equality once traffic (or
        `warmup`) has reached every width."""
        return len(self.width_buckets)

    def step_program_shapes(self):
        """{name: (B, W)} of every program this engine can build: one
        unified ragged step per width bucket, named ``w<width>``."""
        return {f"w{W}": (self.max_batch, W) for W in self.width_buckets}

    def _get_step_fn(self, B, W):
        """The step program of width bucket `W`, built at its first use."""
        prog = self._step_fns.get((B, W))
        if prog is None:
            prog = self._step_fns[(B, W)] = _StepProgram(self, W)
        return prog

    def _width_for(self, w):
        for b in self.width_buckets:
            if b >= w:
                return b
        raise AssertionError(
            f"step width {w} exceeds the top width bucket "
            f"{self.width_buckets[-1]} — scheduler width capping broke")

    def _touched_width(self, W):
        """Columns of an int8 step's per-row ``touched`` block list: ``W``
        consecutive fed positions straddle at most ``(W + bs - 2) // bs +
        1`` blocks, plus slot 0 reserved for the null block."""
        return (W + self.block_size - 2) // self.block_size + 2

    def _input_fields(self, W):
        """(name, shape) of the int32 step inputs of width `W`, in the
        order of their one packed buffer (`_ROW_FIELDS` above)."""
        B = self.max_batch
        fields = ([(f, (B, W)) for f in _ROW_FIELDS]
                  + [("tables", (B, self.max_blocks))]
                  + [(f, (B,)) for f in _LANE_FIELDS])
        if self.pool.quantized:
            fields += [("touch_idx", (B, W)),
                       ("touched", (B, self._touched_width(W)))]
        return fields

    @torch.inference_mode()
    def _device_step(self, t, W):
        """The unified ragged step on the device, the body of a width-`W`
        step program: the forward over every row's fed tokens (writing
        their K/V into the arena), the scored window of ``K + 1`` positions
        from each row's last chunk token, the row-finite check, sampling
        and the speculative accept decision. Branch-free, as the JAX
        program is: the sampler always runs, greedy rows take the argmax
        through its `torch.where`s, and nothing reads a device value on the
        host, so a CUDA graph can capture it. Returns the packed
        ``[B, K + 3]`` int32 tensor (still on the device)."""
        K = self._draft_capacity(W)
        last_idx, spec_lens = t["last_idx"], t["spec_lens"]
        # per-row live width for the ragged kernel: chunk tokens through
        # last_idx plus the drafted candidates
        q_lens = last_idx + 1 + spec_lens
        pool = self.pool
        state = PagedState(pool.k, pool.v, t["tables"], t["slots"],
                           t["offs"], t["qpos"], q_start=t["q_start"],
                           kv_live=t["kv_live"], q_lens=q_lens,
                           k_scale=pool.k_scale, v_scale=pool.v_scale,
                           touched=t.get("touched"),
                           touch_idx=t.get("touch_idx"),
                           # each lane's adapter rows, or None on a
                           # lora-off engine (no gather, no add)
                           lora=lora_mod.gather_adapter_rows(
                               self._lora_tables, t["adapter_slots"]))
        h, _ = self.model.hidden(t["ids"], caches=state)
        # the scored window: position last_idx + j scores the distribution
        # after fed token last_idx + j (j = 0 samples, j >= 1 verifies)
        win = (last_idx[:, None].long()
               + torch.arange(K + 1, device=self.device)[None, :])
        win = win.clamp(0, W - 1)
        hw = torch.gather(h, 1, win[..., None].expand(-1, -1, h.shape[-1]))
        lg = self.model.logits(hw).float()
        win_ids = torch.gather(t["ids"], 1, win)
        # non-finite containment over each row's LIVE window positions
        live = torch.arange(K + 1, device=self.device)[None, :] \
            <= spec_lens[:, None]
        pos_ok = torch.isfinite(lg).all(dim=-1)
        row_ok = torch.where(live, pos_ok, torch.ones_like(pos_ok)).all(-1)
        run, n_acc = spec_emit_arrays(
            lg, win_ids, spec_lens, t["temps"], t["top_ks"], t["top_ps"],
            generator=self._gen)
        return torch.cat([run, n_acc[:, None],
                          row_ok.to(torch.int32)[:, None]], dim=1)

    # -- fault hooks (serving/faults.py; armed plans only) -------------------

    def _fire_step_faults(self):
        """Evaluate the step-scoped fault points against this step's plan,
        in the order degrade -> hang -> raise. Only reached when a plan is
        installed (the caller's one pointer test)."""
        plan = faults._PLAN
        tr = self.tracer
        fp = plan.match("slow_step_ms", step=self.step_count,
                        request_ids=self.last_planned)
        if fp is not None:
            if tr is not None:
                tr.supervisor_instant("fault[slow_step_ms]",
                                      {"step": self.step_count, "ms": fp.ms})
            time.sleep((fp.ms or 0.0) / 1e3)
        fp = plan.match("step_hang", step=self.step_count,
                        request_ids=self.last_planned)
        if fp is not None:
            if tr is not None:
                tr.supervisor_instant("fault[step_hang]",
                                      {"step": self.step_count})
            plan.hang(fp)
        fp = plan.match("step_raise", step=self.step_count,
                        request_ids=self.last_planned)
        if fp is not None:
            if tr is not None:
                tr.supervisor_instant("fault[step_raise]",
                                      {"step": self.step_count})
            raise FaultInjected(
                "step_raise",
                None if fp.exc is None
                else f"injected step fault ({fp.exc})")

    def _corrupt_row_ok(self, rows, row_ok):
        """``step_nonfinite_logits``: report the matched rows' logits as
        non-finite, driving the containment path exactly as a poisoned
        forward would. Works on the host copy of the step's one packed
        result, so it adds no transfer. Only reached with a plan."""
        plan = faults._PLAN
        row_ok = np.array(row_ok)
        for i, row in enumerate(rows):
            fp = plan.match("step_nonfinite_logits", step=self.step_count,
                            request_ids=(row.req.request_id,))
            if fp is not None:
                if self.tracer is not None:
                    self.tracer.supervisor_instant(
                        "fault[step_nonfinite_logits]",
                        {"step": self.step_count,
                         "request_id": row.req.request_id})
                row_ok[i] = False
        return row_ok

    def _annotation(self, step_id):
        """While tracing, the step's dispatch runs under a
        `torch.profiler.record_function` range named after the step id,
        the join key between a torch-profiler capture and the host step
        timeline. A no-op context when tracing is off."""
        if self.tracer is None:
            return contextlib.nullcontext()
        return torch.profiler.record_function(
            self.tracer.step_annotation(step_id))

    # -- one engine step -----------------------------------------------------

    def step(self, only=None):
        """Run one mixed (or pure-decode) step; returns [StepOutput] for
        every request that produced a token. ``only`` restricts the plan
        (admission included) to that set of request ids: the supervisor's
        bisection probes step half the suspects of a failed batch while
        everyone else holds still. Its step resolves to an existing width
        bucket like any other. Rows with non-finite logits emit nothing;
        they are aborted and listed in ``self.step_faults`` as
        ``(request_id, detail)`` pairs, as are a policy's early
        rejections."""
        self._guard_thread("step()")
        tr = self.tracer
        t_plan0 = time.monotonic() if tr is not None else 0.0
        self.step_faults = []
        # cleared before planning: a raising schedule() must not leave the
        # supervisor recovering against the previous step's plan
        self.last_planned = []
        rows = self.scheduler.schedule(only=only)
        if self.policy is not None:
            # deadline early-rejects decided during admission end as
            # aborted requests on the step_faults channel
            for req, reason in self.scheduler.drain_policy_rejects():
                self.metrics.inc("policy_early_rejections")
                self.metrics.inc_labeled("policy_early_rejections",
                                         self.policy.class_labels(req))
                self.step_faults.append((req.request_id, reason))
                self.abort(req.request_id, reason=reason)
        if self.tier is not None:
            # arena-write ordering (kv_tier.py rule 1): demotions buffered
            # by this plan's evictions gather their bytes before the step's
            # scatters land on those blocks
            self.tier.flush_saves()
        if not rows:
            return []
        self.step_count += 1
        self.last_planned = [row.req.request_id for row in rows]
        if faults._PLAN is not None:
            self._fire_step_faults()
        W = self._width_for(max(r.count + len(r.draft) for r in rows))
        if any(r.count > 1 for r in rows):
            kind = "mixed"
        elif any(r.draft for r in rows):
            kind = "verify"
        else:
            kind = "decode"
        step_id = tr.next_step_id() if tr is not None else 0
        if tr is not None:
            self._phases = {"plan": (t_plan0, time.monotonic())}
        t_step0 = time.monotonic()
        with self.metrics.timed(f"{kind}_step"):
            outs = self._run_rows(rows, W, step_id)
        if self.policy is not None:
            self.policy.observe_step(time.monotonic() - t_step0)
        if tr is not None:
            tr.record_step(step_id, kind, self._phases, {
                "rows": len(rows),
                "width": W,
                "host_syncs": 1,
                "decode_rows": sum(1 for r in rows
                                   if r.count == 1 and not r.draft),
                "prefill_rows": sum(1 for r in rows if r.count > 1),
                "spec_lanes": sum(1 for r in rows if r.draft),
                "fed_tokens": sum(r.count + len(r.draft) for r in rows),
                "emitted_tokens": len(outs),
            })
        self.metrics.inc(f"{kind}_steps")
        self.metrics.set_gauge(
            "tokens_in_flight",
            sum(r.num_tokens for r in self.scheduler.running))
        usable = self.pool.num_blocks - 1
        self.metrics.set_gauge("block_utilization",
                               (usable - self.pool.num_free) / usable)
        self.metrics.set_gauge("num_running", len(self.scheduler.running))
        self.metrics.set_gauge("num_waiting", len(self.scheduler.waiting))
        if self.policy is not None:
            # whole-family replacement: drained classes leave the scrape
            depth = {}
            for req in self.scheduler.waiting:
                lbl = tuple(sorted(self.policy.class_labels(req).items()))
                depth[lbl] = depth.get(lbl, 0) + 1
            self.metrics.set_labeled_gauges(
                "policy_queue_depth",
                [(dict(lbl), n) for lbl, n in depth.items()])
            self.metrics.set_labeled_gauges(
                "policy_served_share",
                [({"tenant": t}, sh)
                 for t, sh in self.policy.served_shares().items()])
        c = self.metrics.counters
        self.metrics.set_gauge("tokens_per_step",
                               c.get("generated_tokens", 0) / self.step_count)
        if self.spec_decoding and c.get("spec_proposed_tokens"):
            self.metrics.set_gauge(
                "spec_acceptance_rate",
                c["spec_accepted_tokens"] / c["spec_proposed_tokens"])
            self.metrics.set_gauge(
                "spec_mean_accepted_len",
                c["spec_accepted_tokens"] / c["spec_drafted_rows"])
        if self.prefix_cache:
            self.metrics.set_gauge("prefix_cached_blocks",
                                   self.pool.num_cached_blocks)
            lookup = c.get("prefix_cache_lookup_tokens", 0)
            if lookup:
                self.metrics.set_gauge(
                    "prefix_cache_hit_rate",
                    c.get("prefix_cache_hit_tokens", 0) / lookup)
        # recompile sentinel: steady state means jit_traces == programs
        # built (each bucket's program is built exactly once, and the table
        # never outgrows expected_program_count()); a surplus build is a
        # rebuild of an existing program, paid on the serving hot path
        retraces = int(c.get("jit_traces", 0)) - len(self._step_fns)
        self.metrics.set_gauge("jit_retraces", max(retraces, 0))
        if (retraces > 0 or len(self._step_fns)
                > self.expected_program_count()) and not self._retrace_warned:
            self._retrace_warned = True
            warnings.warn(
                f"LLMEngine recompile sentinel: {max(retraces, 0)} "
                f"rebuild(s) of existing step programs "
                f"({len(self._step_fns)} programs built, "
                f"{self.expected_program_count()} width buckets, "
                f"{int(c.get('jit_traces', 0))} builds) — steady-state "
                "serving builds at most one program per ragged width "
                "bucket, each exactly once",
                RuntimeWarning, stacklevel=2)
        return outs

    def _fill_row(self, a, i, req, start, w, S):
        """Everything about row `i` that does not depend on WHICH tokens
        are fed: scatter targets for positions [start, start+w), the block
        table, and the per-row sampling knobs."""
        a["qpos"][i, :w] = np.arange(start, start + w)
        a["slots"][i], a["offs"][i] = self.pool.positions_to_slots(
            req.blocks, start, w, S)
        a["tables"][i] = self.pool.table_for(req.blocks, self.max_blocks)
        a["temps"][i] = req.temperature
        a["top_ks"][i] = req.top_k or 0
        a["top_ps"][i] = 1.0 if req.top_p is None else req.top_p
        a["q_start"][i] = start
        a["kv_live"][i] = (start + w - 1) // self.block_size + 1
        a["adapter_slots"][i] = req.adapter_slot
        if self.pool.quantized:
            # unique non-null blocks this row's scatter writes, listed
            # after the null slot; pad tokens keep touch_idx 0
            sl = a["slots"][i, :w]
            uniq = np.unique(sl[sl != 0])
            a["touched"][i, 1:1 + len(uniq)] = uniq
            lut = {int(b): j + 1 for j, b in enumerate(uniq)}
            a["touch_idx"][i, :w] = [lut.get(int(s), 0) for s in sl]

    def _run_rows(self, rows, W, step_id=0):
        """Run one unified ragged step at width bucket `W` and publish its
        tokens. The host reads ONE packed tensor (the step's single
        device->host transfer). Rejected speculative tails roll back:
        their KV slots are stale (overwritten before they are ever
        attended) and their reserved blocks return via
        `reclaim_spec_blocks`."""
        tr = self.tracer
        t_build = time.monotonic() if tr is not None else 0.0
        prog = self._get_step_fn(self.max_batch, W)
        a = prog.host_arrays()
        for i, row in enumerate(rows):
            req, start, count, k = row.req, row.start, row.count, len(row.draft)
            if start == req.num_tokens - 1:
                a["ids"][i, 0] = req.last_token   # decode fast path
            else:
                a["ids"][i, :count] = req.all_ids[start:start + count]
            if k:
                a["ids"][i, count:count + k] = row.draft
            a["last_idx"][i] = count - 1
            a["spec_lens"][i] = k
            self._fill_row(a, i, req, start, count + k, W)
        K = self._draft_capacity(W)
        t_disp = time.monotonic() if tr is not None else 0.0
        with self._annotation(step_id):
            packed_dev = prog()
        t_sync = time.monotonic() if tr is not None else 0.0
        # THE host sync of the step
        packed = packed_dev.cpu().numpy()
        self.metrics.inc("host_syncs")
        run, n_accs, row_ok = (packed[:, :K + 1], packed[:, K + 1],
                               packed[:, K + 2])
        if faults._PLAN is not None:
            row_ok = self._corrupt_row_ok(rows, row_ok)
        t_emit = time.monotonic() if tr is not None else 0.0
        outs = []
        for i, row in enumerate(rows):
            req, k = row.req, len(row.draft)
            if not row_ok[i]:
                self._poison(req, "nonfinite_logits")
                continue
            n_acc = min(int(n_accs[i]), k)
            if k:
                self.metrics.inc("spec_drafted_rows")
                self.metrics.inc("spec_proposed_tokens", k)
                self.metrics.inc("spec_accepted_tokens", n_acc)
                req.spec_accepted += n_acc
            # the fed run [chunk tokens, accepted drafts] is real content:
            # advance num_cached BEFORE emitting (release publishes full
            # prompt blocks off num_cached)
            req.num_cached += row.count + n_acc
            if self.policy is not None:
                # fairness charges the device work consumed: fed chunk
                # tokens plus accepted drafts
                self.policy.note_served(req, row.count + n_acc)
            if tr is not None and req.traced:
                tr.row_span(
                    req,
                    ("verify" if k else
                     "prefill_chunk" if row.count > 1 else "decode"),
                    t_disp, t_emit,
                    {"step": step_id, "start": row.start,
                     "count": row.count, "emit": row.emit,
                     **({"drafted": k, "accepted": n_acc} if k else {})})
            if not row.emit:
                continue
            for tok in run[i, :n_acc + 1]:
                outs.append(self._emit(req, int(tok)))
                if req.finished:
                    break
            if k and not req.finished:
                self.scheduler.reclaim_spec_blocks(req)
        if tr is not None:
            self._phases.update(build=(t_build, t_disp),
                                dispatch=(t_disp, t_sync),
                                sync=(t_sync, t_emit),
                                emit=(t_emit, time.monotonic()))
        return outs

    def _poison(self, req, detail):
        """Abort one row with non-finite logits, never publishing the
        blocks its own prefill wrote."""
        req.block_hashes = req.block_hashes[:req.num_matched_blocks]
        self.metrics.inc("nonfinite_rows")
        self.step_faults.append((req.request_id, detail))
        self.abort(req.request_id, reason=f"error:{detail}")
        if self.recorder is not None:
            # after the abort: the bundle carries the victim's final
            # ledger decomposition (record never raises)
            self.recorder.record("nonfinite_row", detail=detail, victim=req)

    def _emit(self, req, token):
        if not req.output_ids:
            now = time.monotonic()
            req.first_token_time = now
            self.metrics.observe("ttft", now - req.arrival_time,
                                 interval=False)
            if self.slo is not None:
                # the first token closes prefill: decode begins
                self.slo.transition(req, "decode_compute", now)
            if req.traced:
                self.tracer.first_token(req, now)
        req.output_ids.append(token)
        self.metrics.inc("generated_tokens")
        done = (len(req.output_ids) >= req.max_new_tokens
                or (req.eos_token_id is not None
                    and token == req.eos_token_id))
        if done:
            if self.slo is not None:
                # `emit` covers the final token's bookkeeping; its open
                # time is the last token's emission for TPOT
                self.slo.transition(req, "emit")
            self.scheduler.finish(req)
            self.metrics.inc("requests_finished")
            self._finalize(req, "finished")
        return StepOutput(req.request_id, token, done)

    def _finalize(self, req, reason):
        """Every terminal path (finish, abort) ends here: the request
        records why it ended, and the tracer's request span, the SLO
        ledger's clock, the request log and the flight recorder's tail
        close. All no-ops in the default configuration. The request's
        adapter pin is released here on every terminal path (finish,
        abort, policy reject)."""
        req.finish_reason = reason
        if req.adapter is not None and self._adapter_inflight.get(
                req.adapter, 0) > 0:
            self._adapter_inflight[req.adapter] -= 1
        if req.traced:
            self.tracer.end_request(req, reason)
        if self.slo is None:
            return   # request_log/recorder imply a ledger (constructor)
        now = time.monotonic()
        summary = self.slo.finalize(req, reason, now)
        if not self.request_log and self.recorder is None:
            return
        ms = lambda t: None if t is None else round(t * 1e3, 3)  # noqa: E731
        line = {
            "event": "request_done",
            "request_id": str(req.request_id),
            "reason": reason,
            "tenant": req.tenant,
            "priority": req.priority,
            "adapter": req.adapter,
            "policy_reject": (reason if reason.startswith("policy_reject")
                              else None),
            "deadline_s": req.deadline_s,
            "deadline": summary["deadline"],
            "prompt_tokens": len(req.prompt_ids),
            "output_tokens": len(req.output_ids),
            "prefix_hit_tokens": req.prefix_hit_tokens,
            "spec_accepted_tokens": req.spec_accepted,
            "preemptions": req.preemptions,
            "queue_wait_ms": ms(None if req.admit_time is None
                                else req.admit_time - req.arrival_time),
            "ttft_ms": ms(summary["ttft_s"]),
            "tpot_ms": ms(summary["tpot_s"]),
            # the ledger's e2e: the phase_<name>_ms fields sum to it
            "total_ms": ms(summary["e2e_s"]),
        }
        for ph, v in summary["phases_ms"].items():
            line[f"phase_{ph}_ms"] = v
        if self.recorder is not None:
            self.recorder.note_request_line(line)
        if self.request_log:
            _request_log.info(json.dumps(line, sort_keys=True))

    def pool_stats(self):
        """Block-pool occupancy by tier plus scheduler queue depths (and
        the policy's state, when one is installed)."""
        usable = self.pool.num_blocks - 1
        stats = {
            "kv_dtype": self.pool.kv_dtype,
            "kv_bytes_per_block": self.pool.bytes_per_block(),
            "blocks_total": usable,
            "blocks_truly_free": self.pool.num_truly_free,
            "blocks_cached_free": self.pool.num_cached_blocks,
            "blocks_allocated": usable - self.pool.num_free,
            "requests_running": len(self.scheduler.running),
            "requests_waiting": len(self.scheduler.waiting),
        }
        if self.tier is not None:
            # host-tier occupancy and swap/migration counters ride the same
            # dict, so /healthz "pool" and the /metrics pool_* gauges agree
            stats.update(self.tier.stats())
        if self.policy is not None:
            stats["policy"] = self.policy.snapshot(
                waiting=self.scheduler.waiting,
                running=self.scheduler.running)
        if self.lora_slots:
            stats["lora"] = {
                "slots": self.lora_slots,
                "rank": self.lora_rank,
                "loaded": sorted(self._adapters),
                "inflight": {k: v for k, v in
                             self._adapter_inflight.items() if v},
            }
        return stats

    def swap_program_shapes(self):
        """{name: chunk width} of the host tier's two copy paths (the
        gather out, the copy back in); empty when the tier is off."""
        if self.tier is None:
            return {}
        return {"swap_out": self.tier.swap_chunk,
                "swap_in": self.tier.swap_chunk}

    # -- host-tier migration -------------------------------------------------

    def export_kv_tier(self, demote=True):
        """This engine's reusable prefix blocks as a payload for another
        engine's `import_kv_tier`, or None when the tier is off. With
        ``demote=True`` every device cached-free block is first saved into
        the host tier (it stays device-resident and matchable: demotion
        copies), which needs a quiescent engine; ``demote=False`` reads
        only settled host slabs under the tier's lock."""
        if self.tier is None:
            return None
        if demote:
            for b, h in self.pool.cached_blocks():
                self.tier.save(h, b)
            self.tier.settle()
        return self.tier.export()

    def import_kv_tier(self, payload):
        """Adopt another engine's exported host tier into ours (geometry
        must match: `KVTier.import_payload`). Returns blocks imported (0
        when the tier is off or the payload is None)."""
        if self.tier is None or payload is None:
            return 0
        return self.tier.import_payload(payload)

    def close(self):
        """Release engine-owned background resources (the tier's drain
        thread). Idempotent; a no-op without the tier."""
        if self.tier is not None:
            self.tier.close()

    # -- conveniences --------------------------------------------------------

    def device_scope(self):
        """The context a thread other than the constructor's must step
        this engine in: the engine's CUDA device and the stream its
        programs stage and replay on (current device and stream are per
        thread in PyTorch). A no-op on the CPU."""
        if self._stream is None:
            return contextlib.nullcontext()
        scope = contextlib.ExitStack()
        scope.enter_context(torch.cuda.device(self.device))
        scope.enter_context(torch.cuda.stream(self._stream))
        return scope

    def _guard_thread(self, what):
        """While an AsyncLLMEngine's loop thread owns this engine, any
        other thread driving it would interleave two schedulers over one
        block pool and one arena: raise instead. The owning thread
        passes."""
        owner = self._engine_thread
        if (owner is not None and owner.is_alive()
                and threading.current_thread() is not owner):
            raise RuntimeError(
                f"{what} called while an AsyncLLMEngine background loop "
                f"({owner.name}) is driving this engine — two schedulers "
                "would interleave over one block pool. Submit through "
                "the AsyncLLMEngine (submit()/stream()), or stop() it "
                "before driving the engine synchronously.")

    def stream(self, prompt_ids, **kwargs):
        """Add one request and yield its StepOutputs as tokens land; other
        in-flight requests keep decoding in the same steps."""
        self._guard_thread("stream()")
        rid = self.add_request(prompt_ids, **kwargs)
        req = self._requests[rid]
        emitted = 0
        while True:
            if emitted < len(req.output_ids):
                tok = req.output_ids[emitted]
                emitted += 1
                last = req.finished and emitted == len(req.output_ids)
                yield StepOutput(rid, tok, last)
                if last:
                    self.release(rid)
                    return
                continue
            if req.finished:
                self.release(rid)
                return
            self.step()

    def generate(self, prompts, **kwargs):
        """Add every prompt, run to completion, return each request's
        generated token list (in input order)."""
        self._guard_thread("generate()")
        rids = [self.add_request(p, **kwargs) for p in prompts]
        while self.has_unfinished():
            self.step()
        outs = [list(self._requests[r].output_ids) for r in rids]
        for r in rids:
            self.release(r)
        return outs


def _counted_wrappers():
    """The kernel wrappers of the serve step that count their launches."""
    from ..ops.kv_quantize_scatter import kv_quantize_scatter
    from ..ops.paged_attention import ragged_paged_attention

    return (ragged_paged_attention, kv_quantize_scatter)


def _launch_counts():
    """A copy of every counted wrapper's counters: {(wrapper, name):
    int, or {step width: int}}."""
    return {(fn, name): dict(v) if isinstance(v, dict) else v
            for fn in _counted_wrappers() for name, v in vars(fn).items()}


class _StepProgram:
    """One width bucket's step program: the port's counterpart of one
    compiled executable of the JAX engine's table.

    It owns the bucket's static inputs: one int32 buffer in the packed
    layout of `LLMEngine._input_fields` and one float32 ``[2, B]`` buffer
    (temperatures, top-p), each with a host staging twin (pinned on CUDA).
    A step fills the staging buffers through `host_arrays` and calling the
    program copies them in with non-blocking transfers, then runs the body.
    Its output is the packed ``[B, K + 3]`` int32 tensor.

    On a CUDA engine the body is captured once, at construction, as a
    `torch.cuda.CUDAGraph` in the engine's shared memory pool, and every
    call replays it; a capture that fails raises. On a CPU engine the same
    body runs eagerly at every call. A captured graph launches its kernels
    without their Python wrappers, so the wrappers' launch counters tick
    once, at capture: the program takes that capture's counts and adds
    them at each replay, so a count still says how many kernels ran.
    """

    def __init__(self, engine, W):
        self.engine = engine
        self.W = W
        self.replays = 0
        B, dev = engine.max_batch, engine.device
        pin = dev.type == "cuda"
        fields = engine._input_fields(W)
        n = sum(int(np.prod(shape)) for _, shape in fields)
        self._host_ints = torch.zeros(n, dtype=torch.int32, pin_memory=pin)
        self._host_floats = torch.zeros((2, B), dtype=torch.float32,
                                        pin_memory=pin)
        self._ints = torch.zeros(n, dtype=torch.int32, device=dev)
        self._floats = torch.zeros((2, B), dtype=torch.float32, device=dev)
        self._host, self.inputs, o = {}, {}, 0
        host_ints = self._host_ints.numpy()
        for name, shape in fields:
            size = int(np.prod(shape))
            self._host[name] = host_ints[o:o + size].reshape(shape)
            self.inputs[name] = self._ints[o:o + size].view(shape)
            o += size
        host_floats = self._host_floats.numpy()
        self._host["temps"], self._host["top_ps"] = host_floats
        self.inputs["temps"], self.inputs["top_ps"] = self._floats
        self.graph = self.out = None
        self._launch_delta = {}
        engine.metrics.inc("jit_traces")
        if dev.type == "cuda":
            self._capture()

    def host_arrays(self):
        """The staging buffers as numpy views by input name, reset to an
        all-idle step: zeros, every lane walking just the null block
        (``kv_live`` 1), top-p 1. On an int8 arena the zeroed ``touched``
        rows (slot 0 = the null block) are inert."""
        self._host_ints.zero_()
        self._host_floats.zero_()
        self._host["kv_live"][:] = 1
        self._host["top_ps"][:] = 1.0
        return self._host

    def body(self):
        """The step's device work on the static inputs, run eagerly."""
        return self.engine._device_step(self.inputs, self.W)

    def load_inputs(self):
        """Copy the staged step into the static inputs (non-blocking from
        pinned memory on CUDA, on the current stream)."""
        self._ints.copy_(self._host_ints, non_blocking=True)
        self._floats.copy_(self._host_floats, non_blocking=True)

    def __call__(self):
        """Copy the staged step in and run it: replay the graph (CUDA) or
        the body (CPU). Returns the packed result on the device."""
        self.load_inputs()
        if self.graph is None:
            return self.body()
        self.graph.replay()
        self.replays += 1
        for (fn, name), d in self._launch_delta.items():
            if isinstance(d, dict):
                counts = getattr(fn, name)
                for k, v in d.items():
                    counts[k] = counts.get(k, 0) + v
            else:
                setattr(fn, name, getattr(fn, name) + d)
        return self.out

    def _capture(self):
        """Capture the body on an all-idle step: every lane reads and
        writes only the null block, so nothing live in the arena changes.
        One eager run on the capture stream first does what must not
        happen under capture (the kernels' lazy build, their shared-memory
        attributes, cuBLAS's workspace); the engine's generator is
        registered so each replay draws new numbers."""
        self.host_arrays()
        self.load_inputs()
        before = _launch_counts()
        stream = torch.cuda.Stream(self.engine.device)
        stream.wait_stream(torch.cuda.current_stream(self.engine.device))
        with torch.cuda.stream(stream):
            self.body()
        warm = _launch_counts()
        graph = torch.cuda.CUDAGraph()
        graph.register_generator_state(self.engine._gen)
        with torch.cuda.graph(graph, pool=self.engine._graph_pool,
                              stream=stream):
            self.out = self.body()
        captured = _launch_counts()
        torch.cuda.current_stream(self.engine.device).wait_stream(stream)
        for key, v in captured.items():
            if isinstance(v, dict):
                self._launch_delta[key] = {k: n - warm[key].get(k, 0)
                                           for k, n in v.items()
                                           if n != warm[key].get(k, 0)}
            else:
                self._launch_delta[key] = v - warm[key]
        for (fn, name), v in before.items():
            setattr(fn, name, v)
        self.graph = graph
