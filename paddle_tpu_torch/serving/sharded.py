"""Tensor-parallel serving: the mesh layer under `LLMEngine` (the JAX
package's `serving/sharded.py`, in PyTorch's idiom).

The JAX engine is one controller over a ``('tp',)`` device mesh. The port
keeps that contract with one rank a device over `torch.distributed`: the
caller's process is rank 0 and owns the scheduler, prefix cache, block
tables, front door and metrics exactly as a one-card engine does;
``mesh=N`` starts N - 1 rank processes (serving/tp_worker.py), each holding
its shard of the weights and of the KV arena on its own device, and every
device-mutating operation runs on every rank in the same order. Every
scheduling decision stays on rank 0's host, byte for byte as on one card.

The tp layout (Megatron; `serving_param_specs` gives the sharded dimension
of each parameter in `nn.Linear`'s ``[out, in]`` layout):

====================  =========================  ===========================
tensor                shape                      shard
====================  =========================  ===========================
wte (vocab embed)     [vocab, hidden]            dim 0 (vocab rows)
attn qkv weight/bias  [3*hidden, hidden]/[3*h]   dim 0 (head groups)
attn proj weight      [hidden, hidden]           dim 1 (+ all-reduce)
ffn fc1 weight/bias   [4*hidden, hidden]/[4*h]   dim 0 (columns)
ffn fc2 weight        [hidden, 4*hidden]         dim 1 (+ all-reduce)
layernorms, wpe, row-parallel biases             replicated
KV arena k/v          [layers, heads, blocks,    dim 1 (heads)
                       block_size, head_dim]
====================  =========================  ===========================

The fused QKV projection is per-head-grouped (models/gpt.py
`_split_fused_qkv`), so a contiguous shard of its output rows is a head
group: each rank attends its own ``heads / tp`` heads through the same
ragged kernel, over its own slab of the arena, with no regroup. A step
makes ``2 * layers + 1`` all-reduces (the two row-parallel projections of
each layer and the vocab-parallel embedding) and one all-gather (the
scored window's full vocab rows before the sampler); `quantized_row_
parallel` trades an op's all-reduce for two int8/float32 all-gathers
(`serving_collective_budget` states the arithmetic).

Single-card parity: every rank runs the whole step body, sampler included,
on the same replicated logits with a generator seeded identically, so a
tp engine emits what the one-card engine emits (greedy and sampled); rank
0's packed result is the one the host reads.

**Backends.** The data plane is NCCL when the mesh's devices are distinct
CUDA devices (the step programs capture the collectives in their CUDA
graphs), and gloo on the CPU (the steps run eagerly). One departure from
the JAX function: a device list that names one CUDA device more than once
is accepted with an explicit ``backend="gloo"``, so that one card can hold
a two-rank engine. Its steps run eagerly, every collective staged through
host memory (gloo cannot be captured); `ServingMesh.info` states the mode
in ``backend``.
"""
from __future__ import annotations

import torch
from torch import nn

from ..distributed.ranks import RankMesh
from ..nn.layer import meta_copy
from ..parallel.collectives import all_gather, quantized_allgather_sum
from .block_pool import kv_capacity_blocks  # noqa: F401  (re-export)

# the sharded dimension of each tensor-parallel parameter, by name suffix,
# in nn.Linear's [out, in] layout; every other parameter is replicated
_TP_DIMS = (
    ("wte.weight", 0),
    ("attn.qkv.weight", 0), ("attn.qkv.bias", 0),
    ("attn.proj.weight", 1),
    ("fc1.weight", 0), ("fc1.bias", 0),
    ("fc2.weight", 1),
)


class ServingMesh(RankMesh):
    """The serving topology: one rank a device, over ``tp`` ranks
    (`distributed.ranks.RankMesh`'s device and backend rules: a CUDA
    device named twice needs an explicit ``backend="gloo"``, the one-card
    departure of the module docstring). `timeout` bounds each
    collective."""

    @property
    def tp_degree(self):
        return self.size

    @property
    def device_count(self):
        """Devices the ranks span: each CPU rank counts as one (a process
        of its own, as the JAX package's fake CPU devices are), CUDA ranks
        count their distinct cards."""
        if self.device_type == "cpu":
            return self.tp_degree
        return len(set(self.devices))

    @property
    def graphs(self):
        """Whether the step programs capture CUDA graphs (NCCL only)."""
        return self.backend == "nccl"

    @property
    def backend_label(self):
        """The mode `info` reports: "cpu" for CPU ranks (the JAX value),
        "cuda" for NCCL across cards (graphs, as one card), "cuda-gloo"
        for CUDA ranks over gloo (eager steps, collectives through the
        host)."""
        if self.device_type == "cpu":
            return "cpu"
        return "cuda" if self.backend == "nccl" else "cuda-gloo"

    def tp_head_ranges(self, num_heads):
        """The arena head axis cut into per-rank ``(h0, h1)`` ranges, in
        rank order: each rank's arena and host-tier slab hold one."""
        tp = self.tp_degree
        if num_heads % tp:
            raise ValueError(
                f"tp_degree {tp} does not divide num_heads {num_heads}")
        per = num_heads // tp
        return [(i * per, (i + 1) * per) for i in range(tp)]

    def validate_model(self, cfg):
        """Reject a model the tp degree cannot shard evenly: attention
        heads, FFN columns and the vocab-parallel embedding rows must all
        divide. One loud error at engine construction."""
        tp = self.tp_degree
        for name, dim in (("num_heads", cfg.num_heads),
                          ("intermediate_size", cfg.intermediate_size),
                          ("vocab_size", cfg.vocab_size)):
            if dim % tp:
                raise ValueError(
                    f"tp_degree {tp} does not divide {name} {dim} — pick "
                    "a tp degree that divides the head/FFN/vocab dims")

    def info(self):
        """Topology facts for /healthz and the mesh gauges."""
        return {"tp_degree": self.tp_degree,
                "device_count": self.device_count,
                "backend": self.backend_label}


def build_serving_mesh(tp_degree, devices=None, backend=None, device=None,
                       timeout=1800.0):
    """A ``tp_degree``-rank serving mesh over the first `tp_degree` of
    `devices`. `devices` defaults to ``cuda:0 .. cuda:tp-1``, or to CPU
    ranks when `device` is the CPU (the engine passes its own)."""
    tp = int(tp_degree)
    if tp < 2:
        raise ValueError("build_serving_mesh needs tp_degree >= 2 "
                         "(single-chip engines pass mesh=None)")
    if devices is None:
        if device is not None and torch.device(device).type == "cpu":
            devices = ["cpu"] * tp
        else:
            n = torch.cuda.device_count() if torch.cuda.is_available() else 0
            devices = [f"cuda:{i}" for i in range(n)]
    devices = list(devices)
    if tp > len(devices):
        raise ValueError(
            f"tp_degree {tp} needs {tp} devices, have {len(devices)}")
    return ServingMesh(devices[:tp], backend=backend, timeout=timeout)


def as_serving_mesh(mesh, device=None):
    """Coerce `LLMEngine(mesh=...)`'s forms (a ServingMesh, or an int tp
    degree; `device` places an int's ranks) to a ServingMesh. Any form of
    degree <= 1 coerces to None: ``mesh=1`` is the explicit single-card
    request, which beats the PADDLE_TPU_TP default."""
    if mesh is None:
        return None
    if isinstance(mesh, ServingMesh):
        return None if mesh.tp_degree <= 1 else mesh
    try:
        tp = int(mesh)
    except (TypeError, ValueError):
        raise TypeError(f"mesh={mesh!r}: pass a ServingMesh or an int tp "
                        "degree") from None
    return None if tp <= 1 else build_serving_mesh(tp, device=device)


def tp_dim(name):
    """The sharded dimension of parameter `name` (``[out, in]`` layout),
    or None when it is replicated."""
    for suffix, dim in _TP_DIMS:
        if name == suffix or name.endswith("." + suffix):
            return dim
    return None


def serving_param_specs(model, smesh=None):
    """{parameter name: sharded dimension or None}: the table above, in
    `nn.Linear`'s ``[out, in]`` layout (the JAX package's PartitionSpecs
    are in its ``[in, out]`` one)."""
    del smesh   # one layout for every degree
    return {name: tp_dim(name) for name, _ in model.named_parameters()}


def shard_of(t, dim, rank, tp):
    """Rank `rank`'s contiguous slice of `t` along `dim` (None: all of
    it)."""
    if dim is None:
        return t
    n = t.shape[dim] // tp
    return t.narrow(dim, rank * n, n)


def shard_module(model, smesh, device):
    """This rank's serving module: a copy of `model`'s structure whose
    tensor-parallel parameters have their shard's shape, with
    uninitialised storage on `device` and each attention module's local
    head count. The caller's tensors are never copied (the caller fills
    the shard next); the caller's model is not touched."""
    tp = smesh.tp_degree
    own = meta_copy(model)
    for name, p in list(own.named_parameters()):
        dim = tp_dim(name)
        if dim is None:
            continue
        shape = list(p.shape)
        shape[dim] //= tp
        owner, _, leaf = name.rpartition(".")
        setattr(own.get_submodule(owner), leaf, nn.Parameter(
            torch.empty(shape, dtype=p.dtype, device="meta"),
            requires_grad=False))
    own.to_empty(device=device)
    for blk in own.blocks:
        blk.attn.num_heads //= tp
    own.eval()
    return own


def serving_collective_budget(cfg, tp_degree, quant_collectives=()):
    """Exact collective calls of one serving step at this tp degree, the
    JAX function's arithmetic:

    - ``all-reduce``: one per float32 row-parallel projection (attn proj
      and ffn fc2, 2 a layer, minus the quantized ones) plus one for the
      vocab-parallel embedding -> ``(2 - n_quant) * num_layers + 1``;
    - ``all-gather``: one for the scored window's full vocab rows, plus two
      a layer for each EQuARX-quantized projection (``"attn_proj"`` /
      ``"ffn_fc2"``: the int8 payload and its float32 scale) ->
      ``2 * n_quant * num_layers + 1``;
    - everything else: zero (the head-major arena and per-head-grouped QKV
      need no regroup).

    One-card programs (tp <= 1) make no collective."""
    if int(tp_degree) <= 1:
        return {"all-reduce": 0, "all-gather": 0, "all-to-all": 0,
                "reduce-scatter": 0, "collective-permute": 0,
                "collective-broadcast": 0}
    n_quant = len(set(quant_collectives) & {"attn_proj", "ffn_fc2"})
    L = int(cfg.num_layers)
    return {"all-reduce": (2 - n_quant) * L + 1,
            "all-gather": 2 * n_quant * L + 1,
            "all-to-all": 0, "reduce-scatter": 0, "collective-permute": 0,
            "collective-broadcast": 0}


def quantized_row_parallel(x, w, bias, group, live=None):
    """EQuARX-quantized row-parallel projection: the tp output collective
    moves int8, not float32.

    Each rank computes its float32 partial sum ``x @ w.T`` (`w` is its
    ``[out, in / tp]`` shard, `x` its ``[.., in / tp]`` slice), quantizes
    it with one absmax/127 scale, all-gathers payload and scale (two
    gathers), and dequantizes and sums the tp partials in float32. The
    replicated `bias` adds after the sum, outside the quantization.
    Returns the replicated ``[.., out]`` float32 result.

    `live` (a bool mask of `x`'s rows, ``x.shape[:-1]``) zeroes the rows
    that carry no token (a step's padding and idle lanes) before the
    product: one scale covers the whole partial, and the ragged kernel
    leaves those rows of its output unwritten, so whatever they hold
    (NaN included) would otherwise set the scale of every live row."""
    from ..ops.fused_ce import mm_f32

    if live is not None:
        x = torch.where(live[..., None], x, torch.zeros_like(x))
    lead = x.shape[:-1]
    part = mm_f32(x.reshape(-1, x.shape[-1]), w.t())
    out = quantized_allgather_sum(part, group).reshape(*lead, w.shape[0])
    if bias is not None:
        out = out + bias.float()
    return out


def gather_vocab(lg, group):
    """Full vocab rows from each rank's ``[..., vocab / tp]`` slice: the
    one all-gather of a step, before the sampler."""
    g = all_gather(lg, group)                      # [tp, ..., V/tp]
    return torch.movedim(g, 0, -2).reshape(*lg.shape[:-1], -1)
