"""Training over ranks: the explicit ZeRO weight-update path, the GSPMD
path's counterpart over dp x sharding x mp meshes, gradient merge and
LocalSGD (the JAX package's `paddle_tpu/parallel/spmd.py`, in PyTorch's
idiom: one rank a device over `torch.distributed`).

**One controller.** The JAX step is one compiled program called from one
process over a mesh. The port keeps that contract: the caller's process
is rank 0, and a mesh of dp ranks (distributed/mesh.py) runs dp - 1 rank
processes, spawned by the first step built over it
(`distributed.ranks.RankSet`) and kept for every later one until
``mesh.close()``. Building a step sends every rank a pickled `meta_copy`
of the model, the optimizer's `settings()`, and rank 0's weights and
optimizer state over the data plane; each rank (rank 0 too) builds its
own replica from them, so the caller's model and optimizer are the
template and stay as they were. Each step the channel carries the rank's
batch rows, the learning rate and a seed; gradients and parameters move
over the data plane only.

**The explicit path** (``explicit_update``, on by default for
``zero_stage >= 2`` on a pure-dp mesh) is "Automatic Cross-Replica
Sharding of Weight Update in Data-Parallel Training" (arXiv:2004.13336):
each gradient leaf is flattened in the port's own ``[out, in]`` layout,
padded to a dp multiple, divided by dp and reduce-scattered in its own
dtype (with ``quant_grads``: through `quantized_psum_scatter` in float32,
int8 on the wire); the optimizer updates 1/dp of each leaf, shard by
shard, as an optimizer of the same settings over the flat shards under
the original names (optimizer/optimizer.py `from_settings`, the rule
unchanged); stage 2 all-gathers the updated shards back into the natural
parameters; stage 3 keeps the parameters resident as flat dp-sharded
leaves, all-gathers them, one call a leaf, at the start of each step and
frees the full copies after the update. The loss is all-reduced and
divided by dp; buffers are averaged over the ranks. The collective shape
is exact: `train_collective_budget` states it, and the counted wrappers
of parallel/collectives.py let a step's calls be held against it.

**The hybrid path** (the JAX GSPMD path: ``zero_stage`` 0 or 1, or
``explicit_update=False``, or any mesh with a ``sharding`` or ``mp`` axis
above 1). Where JAX partitions one program from sharding annotations, each
rank here holds its shards and makes the collectives:

- ``mp``: the Megatron layers (distributed/fleet/meta_parallel/
  mp_layers.py) hold their slices (`module_param_specs`: the ``mp`` axis
  of each mp layer's ``sharding_axes``) and make their collectives over
  the rank's mp group; the mp peers of a dp replica see the same rows and
  draw the same dropout masks (the step's seed keys on the data index);
- ``dp``: each rank's rows are its dp index's share of the batch
  (`batch_specs`: ``"dp"``, JAX's ``P("dp")``, replicates rows over the
  ``sharding`` and ``mp`` ranks; ``("dp", "sharding")`` splits them over
  both); each gradient leaf is divided by the degree and all-reduced over
  the rank's dp group (and sharding group, when rows split over it);
- ``sharding``: the legacy ZeRO 1/2/3 with `_zero_shard_spec`'s layout
  (the largest divisible dim, at least ``degree * 128`` elements; never a
  leaf that mp already shards): each sharding rank updates its slice of
  the optimizer state (stage 1), of the gradient (stage 2) and at stage 3
  of the parameter, which stays resident as that slice and is gathered at
  the step's start; stages 1 and 2 all-gather the updated slice over the
  sharding group after the update.

The global-norm clip sums each leaf's squared norm over the group that
shards it (nn/clip.py), so a replicated leaf counts once; AMP O2 masters
are kept per shard. As in the JAX package, stage 1 on a pure-dp mesh
shards nothing: the JAX layout rule keys on a ``sharding`` axis that such
a mesh does not carry (its module docstring), and the port mirrors that
for parity (ROADMAP Queue 3). **Stated departure:** JAX partitions any
parameter whose ``sharding_axes`` name ``mp``; here only the modules that
make their own mp collectives shard over ``mp`` (the mp layers and the
models built on them, and `distributed/moe.py`'s `MoELayer`, whose experts
each mp rank holds ``E / mp`` of), since a per-rank shard needs the
layer's collectives. A parameter of any other module carrying an ``mp``
annotation stays replicated: the same numbers, more bytes.

**Experts** (`MoELayer`): on the hybrid path each MoE layer routes over
the global batch, as JAX's one program does: it takes the step's row
groups (`MoELayer.shard_rows`), so its capacity counts every row share's
tokens and a share's slots follow the lower shares'
(`hybrid_collective_budget` states a step's calls, beside the mp
layers' and the ring's). The explicit path and LocalSGD route each
replica's shard alone (capacity from the shard's tokens, slots from 0),
as JAX's shard_map and vmap do. Experts on an axis other than ``mp`` above 1 raise
`NotImplementedError` (ROADMAP Queue 1, item 8b.5).

**Gradient merge** (``gradient_merge_k``, ``gradient_merge_avg``): a
float32 accumulator in the update's layout, applied every k-th step. The
port's control flow is eager, so a Python ``if`` takes the place of JAX's
``where``; the numbers are the same. A stage-2 step that applies no
update gathers nothing (the parameters did not change).

**Dropout**: JAX folds the replica's index into the step's key; here each
rank reseeds its model's `DropoutGenerators` from the step's seed and its
data index (its dp index, or its row share's index), so the mp, sharding
and sp peers of one row share draw one set of masks: an mp rank draws the
whole hidden width's elementwise masks and its heads' attention keep
bits (their offset), an sp rank its slice of the whole row's (its rows).
A model without dropout draws nothing, so the stages stay
bit-comparable. **Remat**: each rank's forward goes through
`distributed/fleet/utils.recompute` with the model's generators, at any
``sp`` and ``mp``: the recomputed forward replays its masks and makes its
collectives again (each gathered layer's all-gather of K/V or each ring's
forward hops, the mp layers' forward all-reduces), which
`hybrid_collective_budget` counts. **Losses**: a loss whose mean runs
over a count that differs between row shares names it (`loss_weight`,
the MLM loss's labelled positions), and the hybrid path weights each
share's mean by its count, the whole batch's mean that JAX's GSPMD step
takes; a loss the
model's own head computes (`tied_head`, GPT's `gpt_loss_fn`) runs there at
mp > 1, vocab-parallel, instead of on gathered logits.

**Departures from the JAX signature.** The JAX step threads ``(params,
buffers, opt_state)`` through each call (``init_state()``, then
``step(params, buffers, opt_state, lr, key, *batch)``). PyTorch keeps
state in modules and optimizers, and here the state lives on the ranks,
in other processes, so the port's step holds it itself: ``step(*batch,
lr=None, seed=None)`` returns the mean loss over the ranks as a float
(``lr`` defaults to the caller's optimizer's learning rate or scheduler
value, read as its own `step()` reads it); `shard_batch` gives each
rank's rows; `gather_params`, `state_dict` and `set_state_dict` give and
take natural-shape state under the JAX package's optimizer keys;
`per_chip_opt_state_bytes` and `collective_counts` report each rank's.
`mesh_donate_argnums` has no counterpart: an eager step updates its
tensors in place, so there is no buffer to donate.

**Trust-ratio rules.** Lamb and Lars take their per-tensor norms through
`optimizer.optimizers._tensor_norm`: on the explicit path each rank's
update runs inside `sharded_norms` over the dp ranks (each norm one
counted all-reduce of the shard-local squared sum: the whole leaf's
norm), and on the hybrid path each mp or sharding slice's norm sums over
the group that slices it. A rule with another per-tensor reduction (DGC's
top-k) runs on neither kind of shard.

**LocalSGD** runs over any mesh, as the JAX step does: the replicas lie
on ``dp`` (each dp index its own parameters and optimizer state), and
every other axis holds them as the hybrid path does (an mp group shards
each replica's Megatron layers, an sp group splits its rows' sequence and
averages the replica's gradient over its slices every step, an MLM mean
weighed over those slices alone); every k-th step averages each rank's
values over its dp group. The JAX step splits
no sequence (its sp devices hold the same rows), so LocalSGD under sp
gives LocalSGD over dp's numbers.

**The sequence split** (``sp``, beside ``dp``, ``mp`` and ``sharding``):
with
``batch_specs=(("dp", "sp"),) * 2`` (JAX's ``P("dp", "sp")``) each rank's
rows are its dp index's share, and its slice of their sequence (dim 1)
its sp index's: ``S / sp`` positions from ``sp_index * S / sp`` (the
model's `pos_offset`). An array whose spec is ``"dp"`` alone (ERNIE's
padding mask) keeps its whole sequence on every sp rank. The model runs
as its rank of the ``sp`` group (`GPT.shard_sequence`,
`Bert.shard_sequence`): attention across the group, the ring
(parallel/ring_attention.py) under ``attn_impl="ring"`` and K/V gathered
over the group otherwise (parallel/sequence_attention.py), the dropout
masks the slice of the whole row's draw (every sp peer of a row share
takes its seed). GPT's loss is the mean of the ranks' means, exact since
every rank holds S / sp positions of each row (its labels are the
targets themselves, cut like the ids); the MLM loss weighs each rank's
mean by its labelled positions over the dp and sp groups (`loss_weight`,
below). Each gradient leaf is averaged over the dp, sharding (when the
rows split over it) and sp groups, an mp layer's on its slice only, and
ZeRO stages 1 and 2 then update the rank's sharding slice and gather it
(`sp_collective_budget` and `hybrid_collective_budget` state a step's
calls). Beside ``mp`` each rank runs its heads over its sp group (the
ring over them, or the gathered attention with their offset) and its
loss through the vocab-parallel head on its slice; BERT's pooler takes
sp rank 0's first token on every mp rank. A model without
`shard_sequence` raises `NotImplementedError` rather than compute
attention over a slice alone (distributed/mesh.py refuses ``sp`` beside
``pp``, ROADMAP Queue 1, item 8b.1).

``pp`` meshes train through `models/gpt_pipeline.py` (the pipelined GPT's
step, built on this module's rank jobs).
"""
from __future__ import annotations

import contextlib
import functools
import itertools
import os
import sys
import time
import warnings

import numpy as np
import torch
import torch.nn.functional as F

from ..distributed.fleet.meta_parallel.mp_layers import (MPGroup, mp_cut,
                                                         mp_join, mp_layout,
                                                         shard_for_mp)
from ..distributed.mesh import coords_of, rank_at
from ..distributed.ranks import (RankFailed, RankSet, leave_group,
                                 rank_loop, rank_spec)
from ..nn.layer import meta_copy
from ..optimizer.lr import LRScheduler
from ..optimizer.optimizer import from_settings, state_bytes
from ..optimizer.optimizers import sharded_norms
from ..profiler.tracing import InstrumentedStep
from .collectives import (all_gather, all_reduce, collective_counts,
                          quantized_psum_scatter, reduce_scatter,
                          reset_collective_counts)
from .ring_attention import ring_hops
from .sequence_attention import gathered_calls

_JOB_IDS = itertools.count(1)


# -- the JAX module's pure functions -------------------------------------------


def explicit_update_eligible(mesh):
    """True when the mesh is pure-dp — dp degree > 1 and every other axis
    degree 1 — the topology the explicit weight-update path runs on."""
    dp = int(mesh.shape.get("dp", 1))
    return dp > 1 and all(
        int(d) == 1 for ax, d in mesh.shape.items() if ax != "dp")


def train_collective_budget(n_param_leaves, dp_degree, quant_grads=False,
                            n_buffer_leaves=0):
    """EXACT collective counts of ONE explicit-path train step — the
    layout stated as arithmetic (the train-side sibling of
    `serving_collective_budget`):

    - ``reduce-scatter``: one per param leaf (the dp grad reduction,
      arXiv:2004.13336) — ZERO when `quant_grads`, because the int8 wire
      replaces each with...
    - ``all-to-all``: TWO per param leaf when `quant_grads` (int8 payload
      + f32 per-chunk scales — `collectives.quantized_psum_scatter`),
      zero otherwise;
    - ``all-gather``: one per param leaf — stage 2 gathers the UPDATED
      shards after the update, stage 3 gathers the resident flat shards
      before the forward; either way exactly one per leaf and never a
      full-size grad;
    - ``all-reduce``: one scalar loss psum, plus one per mutated-buffer
      leaf (BN running stats average over dp). A full-size grad
      all-reduce sneaking back in moves this count.

    dp_degree <= 1 (or the plain path) has no layout-derived budget."""
    if int(dp_degree) <= 1:
        return {k: 0 for k in ("all-reduce", "all-gather", "all-to-all",
                               "reduce-scatter", "collective-permute",
                               "collective-broadcast")}
    n = int(n_param_leaves)
    return {
        "all-reduce": 1 + int(n_buffer_leaves),
        "all-gather": n,
        "all-to-all": 2 * n if quant_grads else 0,
        "reduce-scatter": 0 if quant_grads else n,
        "collective-permute": 0,
        "collective-broadcast": 0,
    }


def hybrid_collective_budget(n_param_leaves=0, row_degrees=(), *,
                             sp_degree=1, ring_layers=0, gathered_layers=0,
                             first_token=False, weighted_loss=False,
                             mp_degree=1, mp_calls=(0, 0), moe_layers=0,
                             n_zero_leaves=0, remat=False,
                             mp_forward=(0, 0)):
    """EXACT collective counts of ONE hybrid-path train step on every
    rank, the sum of each feature's term:

    - the data groups (each row axis of `row_degrees` — ``dp``,
      ``sharding`` — and ``sp``, of degree above 1): one ``all-reduce``
      of the loss and one a gradient leaf over each (the mean over the
      data ranks), and with `weighted_loss` (a loss naming its
      `loss_weight`: the MLM loss's labelled positions) one more of the
      share's count;
    - ZeRO stages 1 and 2 over ``sharding``: one ``all-gather`` a leaf
      whose update that axis slices (`n_zero_leaves`: the updated
      slices);
    - at mp above 1, the mp layers' own calls, ``mp_calls = (all-reduces,
      all-gathers)`` a step as the model makes them (a column-parallel
      input's gradient and a row-parallel output one all-reduce each);
    - each of `moe_layers` `MoELayer`s: at mp above 1 one ``all-reduce``
      forward (the sum of the ranks' experts' outputs) and one backward
      (the partial gradients into its input and its router's
      probabilities, one ``[T, H + 1]`` tensor); one ``all-gather`` a
      row axis above 1 (the ``[E]`` routed counts that place a share's
      slots after the lower shares');
    - each of `ring_layers` ring attentions: its hops, each one ``send``
      and one ``recv`` (`ring_attention.ring_hops`);
    - each of `gathered_layers` gathered attentions over ``sp``: one
      ``all-gather`` of K/V forward and one ``reduce-scatter`` of the
      dK/dV partials backward (`sequence_attention.gathered_calls`);
    - `first_token`: at sp above 1, BERT's pooler input handed from sp
      rank 0 (one ``all-gather``; no loss of the port reads the NSP
      head, so its gradient makes no call);
    - `remat` (the step's ``remat=True``): the backward runs the model's
      forward once more, and with it every call the forward makes: the
      mp layers' forward share of `mp_calls` (`mp_forward`, the same
      pair), each ring's ``sp - 1`` forward hops, each gathered
      attention's ``all-gather`` of K/V and the first token's
      ``all-gather``;
    - nothing else: no reduction of activations."""
    rows = sum(int(d) > 1 for d in row_degrees)
    sp = int(int(sp_degree) > 1)
    groups = rows + sp
    mp = int(mp_degree) > 1
    moe = int(moe_layers)
    again = int(bool(remat))
    fwd_hops, bwd_hops = ring_hops(sp_degree)
    hops = int(ring_layers) * ((1 + again) * fwd_hops + bwd_hops)
    ag, rs = (int(gathered_layers) * c for c in gathered_calls(sp_degree))
    mp_ar, mp_ag = ((int(c) + again * int(f) for c, f in
                     zip(mp_calls, mp_forward)) if mp else (0, 0))
    return {"all-reduce": groups * (1 + int(n_param_leaves)
                                    + int(bool(weighted_loss)))
            + mp_ar + (2 * moe if mp else 0),
            "all-gather": rows * moe + int(n_zero_leaves)
            + (1 + again) * (ag + sp * int(bool(first_token))) + mp_ag,
            "reduce-scatter": rs,
            "all-to-all": 0, "send": hops, "recv": hops}


def sp_collective_budget(num_layers, sp_degree, dp_degree=1,
                         n_param_leaves=0, ring=True, bert=False):
    """`hybrid_collective_budget` of a sequence-parallel step of
    `num_layers` layers over a mesh of ``dp`` x ``sp``: each layer's ring
    makes ``sp - 1`` hops forward and ``sp`` backward, or with `ring`
    False (GPT's ``"flash"`` / ``"xla"``, and `bert`) each layer gathers
    K/V forward and reduce-scatters the partials backward; the loss and
    one a gradient leaf are all-reduced over each of the dp and sp groups
    of degree above 1. `bert` (with `bert_pretrain_loss_fn`): the
    labelled positions' count all-reduced over each group too, and the
    pooler's first token gathered from sp rank 0."""
    ring = ring and not bert
    return hybrid_collective_budget(
        n_param_leaves, (dp_degree,), sp_degree=sp_degree,
        ring_layers=num_layers if ring else 0,
        gathered_layers=0 if ring else num_layers,
        first_token=bert,
        weighted_loss=bert)


def moe_collective_budget(num_moe_layers, mp_degree=1, row_degrees=(),
                          n_param_leaves=0, n_zero_leaves=0):
    """`hybrid_collective_budget` of a step of a model with
    `num_moe_layers` `MoELayer`s (experts over ``mp``, nothing else
    sharded over it), its rows split over axes of degrees `row_degrees`
    (``("dp",)``'s or ``("dp", "sharding")``'s)."""
    return hybrid_collective_budget(n_param_leaves, row_degrees,
                                    mp_degree=mp_degree,
                                    moe_layers=num_moe_layers,
                                    n_zero_leaves=n_zero_leaves)


def _largest_divisible_dim(shape, degree):
    best = None
    for i, s in enumerate(shape):
        if degree > 0 and s % degree == 0 and (best is None or s > shape[best]):
            best = i
    return best


def _zero_shard_spec(shape, mesh):
    """The one place the ZeRO 'sharding'-axis layout is derived: shard the
    largest divisible dim when the tensor is big enough to be worth it
    (>= degree*128 elements). Param (stage 3), grad (stage 2) and optimizer
    slot (stage 1) layouts all come from here so they can never diverge.
    Returns a spec (a tuple of axis names and None, the JAX
    ``PartitionSpec``'s entries) or None."""
    if mesh.shape.get("sharding", 1) <= 1:
        return None
    deg = mesh.shape["sharding"]
    dim = _largest_divisible_dim(tuple(shape), deg)
    if dim is None or int(np.prod(shape)) < deg * 128:
        return None
    spec = [None] * len(shape)
    spec[dim] = "sharding"
    return tuple(spec)


def param_pspec(param, mesh, zero3=False, linear=False):
    """A parameter's spec: its ``sharding_axes`` over the mesh's live axes,
    else at stage 3 the ZeRO layout, else replicated ``()``. In the port's
    layout; `linear` (an `nn.Linear` weight, ``[out, in]``) takes the ZeRO
    layout of the JAX ``[in, out]`` shape, so the spec is JAX's
    transposed."""
    axes = getattr(param, "sharding_axes", None)
    if axes:
        spec = [a if (a and mesh.shape.get(a, 1) > 1) else None for a in axes]
        if any(spec):
            return tuple(spec)
    if zero3:
        spec = _zero_shard_spec(_jax_shape(param.shape, linear), mesh)
        if spec is not None:
            return _jax_shape(spec, linear)
    return ()


def _jax_shape(shape, linear):
    """A shape or spec in the other package's order (reversed for a
    Linear weight)."""
    return tuple(shape)[::-1] if linear else tuple(shape)


def _linear_names(layer):
    return {f"{name}.weight" if name else "weight"
            for name, m in layer.named_modules()
            if isinstance(m, torch.nn.Linear)}


def module_param_specs(layer, mesh, zero_stage=0):
    """{name: spec} of `layer`'s parameters (`param_pspec`)."""
    linear = _linear_names(layer)
    return {name: param_pspec(p, mesh, zero3=(zero_stage >= 3),
                              linear=name in linear)
            for name, p in layer.named_parameters()}


def _state_spec_like(pspec, param_shape, slot_arr, mesh, zero_stage,
                     linear=False):
    """Optimizer slot sharding: follow the param's sharding; for ZeRO>=1 also
    shard unsharded slots over 'sharding' when divisible."""
    if slot_arr.ndim == 0 or tuple(slot_arr.shape) != tuple(param_shape):
        return ()
    if any(pspec):
        return pspec
    if zero_stage >= 1:
        spec = _zero_shard_spec(_jax_shape(slot_arr.shape, linear), mesh)
        if spec is not None:
            return _jax_shape(spec, linear)
    return ()


def grad_pspec(pspec, param_shape, mesh, zero_stage, linear=False):
    """Gradient sharding for ZeRO stage >= 2: over the 'sharding' axis
    (the reference's GroupShardedStage2 reduce-scatter); a tp-sharded
    gradient keeps its parameter's spec."""
    if any(pspec):
        return pspec
    if zero_stage >= 2:
        spec = _zero_shard_spec(_jax_shape(param_shape, linear), mesh)
        if spec is not None:
            return _jax_shape(spec, linear)
    return pspec


def per_chip_opt_state_bytes(opt_state):
    """Bytes of optimizer state one rank holds: the tensors of a nested
    ``{name: {slot: tensor or scalar}}`` state at their (shard's) size,
    four bytes a host scalar (a float32)."""
    total = 0
    stack = [opt_state]
    while stack:
        v = stack.pop()
        if isinstance(v, dict):
            stack.extend(v.values())
        elif torch.is_tensor(v):
            total += v.numel() * v.element_size()
        elif v is not None:
            total += int(getattr(v, "nbytes", 4))
    return total


def leaf_layouts(model, mesh, zero_stage=0):
    """How every parameter of `model` lies over `mesh`: {name: (mp, zp,
    zs)} with ``mp`` ``(dim, blocks)`` of an mp layer's parameter sharded
    over ``mp`` (None otherwise), ``zp`` the dim of a parameter that lives
    sharded over ``sharding`` (stage 3, or annotated by
    `shard_parameters_over`), ``zs`` the dim its optimizer state (and
    update) is sharded on. One derivation, on the controller; every rank
    takes it in the step's spec."""
    modules = dict(model.named_modules())
    specs = module_param_specs(model, mesh, zero_stage)
    linear = _linear_names(model)
    out = {}
    for name, p in model.named_parameters():
        owner, _, leaf = name.rpartition(".")
        spec = specs[name]
        if "mp" in spec:
            # only the modules that make mp collectives shard over mp
            # (the stated departure)
            out[name] = (mp_layout(modules[owner], leaf), None, None)
        elif "sharding" in spec:
            out[name] = (None, spec.index("sharding"),
                         spec.index("sharding"))
        else:
            st = _state_spec_like(spec, p.shape, p, mesh, zero_stage,
                                  name in linear)
            out[name] = (None, None,
                         st.index("sharding") if "sharding" in st else None)
    return out


# -- the models' wrappers ------------------------------------------------------


def _unwrap(model, optimizer):
    """The inner model and optimizer of the Group Sharded markers
    (distributed/fleet/meta_parallel/sharding.py): the step takes them as
    the JAX step takes any layer and optimizer, so parameter names and
    state keys are the inner model's."""
    model = getattr(model, "_layers", model)
    while hasattr(optimizer, "_inner_opt"):
        optimizer = optimizer._inner_opt
    return model, optimizer


def _rank_seed(seed, rank):
    """A rank's dropout seed for a step's `seed`: each replica draws its
    own masks (JAX folds the replica's index into the key)."""
    ss = np.random.SeedSequence([int(seed), int(rank)])
    return int(ss.generate_state(1, np.uint64)[0] >> np.uint64(1))


def _launch_counts(zero=False):
    """The flash kernels' launch counters of this process (reset after
    reading with `zero`)."""
    from ..ops import flash_attention as fa

    out = {}
    for d, f in (("fwd", fa.flash_attention_fwd),
                 ("bwd", fa.flash_attention_bwd)):
        for n in ("launches", "mask_launches", "dropout_launches"):
            out[f"{d}_{n}"] = getattr(f, n)
            if zero:
                setattr(f, n, 0)
    return out


def _report(device, zero=False):
    """A rank's report: its kernel launches and collective calls since the
    last reset (reset after reading with `zero`), its peak device memory,
    its pid and the top-level modules its process has imported."""
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    out = {"pid": os.getpid(), "launches": _launch_counts(zero),
           "collectives": collective_counts(),
           "peak_bytes": (torch.cuda.max_memory_allocated(device)
                          if device.type == "cuda" else None),
           "modules": sorted({m.split(".")[0] for m in sys.modules})}
    if zero:
        reset_collective_counts()
        if device.type == "cuda":
            torch.cuda.reset_peak_memory_stats(device)
    return out


# -- the state's layout --------------------------------------------------------
#
# A step's state travels and is gathered as entries: ("p", name) a trainable
# parameter, ("f", name) a frozen one, ("b", name) a buffer, ("o", name,
# slot) an optimizer slot, ("g", name) a gradient-merge accumulator. On the
# explicit path an entry that is sharded lives and travels as each rank's
# slice of the leaf's padded flat layout; on the hybrid path as the rank's
# slice over mp (an mp layer's parameter-shaped entries) or over sharding
# (`leaf_layouts`).


def _flat_shard(t, meta, dp, rank):
    """Rank `rank`'s slice of `t` in the padded flat layout of a leaf whose
    layout is `meta` (natural shape, element count, pad)."""
    _, num, pad = meta
    flat = t.reshape(-1)
    if pad:
        flat = F.pad(flat, (0, pad))
    slen = (num + pad) // dp
    return flat[rank * slen:(rank + 1) * slen]


class _Placement:
    """Where each entry of a step's state lives on each rank, and how a
    natural tensor is cut into a rank's value and joined back: the one
    rule the controller and every rank share (it travels in the step's
    spec)."""

    def __init__(self, mesh_shape, explicit, stage3, meta, layouts,
                 data_axes, seq_axis=None):
        self.shape = dict(mesh_shape)
        self.explicit = explicit
        self.stage3 = stage3
        self.meta = meta               # explicit path: flat layouts
        self.layouts = layouts         # hybrid path: leaf_layouts
        self.data_axes = tuple(data_axes)    # the rows split over these
        self.seq_axis = seq_axis             # the sequence over this

    def coords(self, rank):
        return coords_of(self.shape, rank)

    def rank_of(self, **c):
        return rank_at(self.shape, **c)

    def data_index(self, rank):
        """The index of rank `rank`'s share of the batch's rows."""
        c, idx = self.coords(rank), 0
        for a in self.data_axes:
            idx = idx * self.shape[a] + c[a]
        return idx

    @property
    def data_degree(self):
        return int(np.prod([self.shape[a] for a in self.data_axes]))

    def seq_index(self, rank):
        """The index of rank `rank`'s slice of the sequence (0 without a
        sequence split)."""
        return self.coords(rank)[self.seq_axis] if self.seq_axis else 0

    @property
    def seq_degree(self):
        return self.shape[self.seq_axis] if self.seq_axis else 1

    @property
    def mean_axes(self):
        """The axes a step's loss and gradients average over: the rows'
        and the sequence's."""
        return self.data_axes + ((self.seq_axis,) if self.seq_axis else ())

    def _dims(self, kind, name):
        """(mp, sharding dim) of entry kind `kind` of leaf `name`."""
        mp, zp, zs = self.layouts.get(name, (None, None, None))
        if kind in ("p", "f"):
            return mp, zp
        return mp, zs

    def varies(self, kind, name, param_shaped=True):
        """Whether ranks hold different values of the entry."""
        if kind == "b" or (kind == "o" and not param_shaped):
            return False
        if self.explicit:
            return (self.stage3 if kind == "p" else kind in ("o", "g"))
        mp, z = self._dims(kind, name)
        return mp is not None or z is not None

    def cut(self, kind, name, t, rank, param_shaped=True):
        """Rank `rank`'s value of entry (`kind`, `name`) whose natural
        value is `t`."""
        if not self.varies(kind, name, param_shaped):
            return t
        if self.explicit:
            return _flat_shard(t, self.meta[name], self.shape["dp"], rank)
        c = self.coords(rank)
        mp, z = self._dims(kind, name)
        if mp is not None:
            return mp_cut(t, mp[0], c["mp"], self.shape["mp"], mp[1])
        n = t.shape[z] // self.shape["sharding"]
        return t.narrow(z, c["sharding"] * n, n)

    def join(self, kind, name, stack):
        """The natural value from ``[world, *rank's shape]`` `stack` of
        every rank's value (rank order)."""
        if self.explicit:
            shape, num, _ = self.meta[name]
            return stack.reshape(-1)[:num].view(shape)
        mp, z = self._dims(kind, name)
        if mp is not None:
            return mp_join([stack[self.rank_of(mp=m)]
                            for m in range(self.shape["mp"])], mp[0], mp[1])
        return torch.cat([stack[self.rank_of(sharding=s)]
                          for s in range(self.shape["sharding"])], z)


# -- one rank's replica --------------------------------------------------------


@contextlib.contextmanager
def _counted_syncs(device, on):
    """Count the host syncs made inside: a one-entry list, filled on exit
    with the number `torch.cuda.set_sync_debug_mode("warn")` reported on
    a CUDA `device` when `on`, else left None."""
    box = [None]
    if not on or device.type != "cuda":
        yield box
        return
    with warnings.catch_warnings(record=True) as seen:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            yield box
        finally:
            torch.cuda.set_sync_debug_mode(0)
    box[0] = sum("called a synchronizing CUDA operation" in str(w.message)
                 for w in seen)


class _Replica:
    """One rank's share of a train step: its model replica (its mp shard on
    a mesh with mp > 1), its optimizer (over flat shards on the explicit
    path, over its parameters or their sharding slices otherwise), the
    gradient-merge accumulators, and the step body every rank runs in the
    same order of collectives."""

    def __init__(self, spec, mesh):
        self.spec = spec
        self.kind = spec["kind"]
        self.place = spec["place"]
        self.group = mesh.group
        self.rank = mesh.rank
        # the ranks the loss and each gradient average over
        self.dp = mesh.size if self.place.explicit else \
            self.place.data_degree * self.place.seq_degree
        self.device = mesh.device
        self.loss_fn = spec["loss_fn"]
        self.names = spec["names"]
        self.meta = spec["meta"]
        self.stage3 = spec["stage3"]
        self.explicit = spec["explicit"]
        self.quant = spec["quant"]
        self.gm_k = spec["gm_k"]
        self.gm_avg = spec["gm_avg"]
        self.remat = spec["remat"]
        self.k_steps = spec["k_steps"]
        coords = self.place.coords(self.rank)
        self.coords = coords
        # the data groups (rows or sequence slices differ across them)
        # and the model groups
        self.data_groups = [mesh.axis_group(a) for a in self.place.mean_axes
                            if mesh.shape[a] > 1]
        self.row_groups = [mesh.axis_group(a) for a in self.place.data_axes
                           if mesh.shape[a] > 1]
        self.mp_group = mesh.axis_group("mp")
        self.zgroup = mesh.axis_group("sharding")
        self.sp_group = (mesh.axis_group(self.place.seq_axis)
                         if self.place.seq_axis else None)
        model = spec["skeleton"]
        if self.mp_group is not None:
            shard_for_mp(model, MPGroup(self.mp_group, coords["mp"],
                                        mesh.shape["mp"]))
        if not self.explicit and self.kind != "localsgd":
            # one program over the global batch (JAX's GSPMD step): the
            # MoE layers route over every row share's tokens
            for module in model.modules():
                if hasattr(module, "shard_rows"):
                    module.shard_rows(self.row_groups)
        if self.sp_group is not None:
            model.shard_sequence(self.sp_group)
        model.to_empty(device=self.device)
        model.train()
        self.model = model
        self.params = dict(model.named_parameters())
        self.buffers = dict(model.named_buffers())
        self.shards = {}
        for n in self.names:
            p = self.params[n]
            if self.explicit:
                slen = self._slen(n)
                if self.stage3 or self.meta[n][2]:
                    shard = torch.zeros(slen, dtype=p.dtype,
                                        device=self.device)
                else:
                    # stage 2, no padding: this rank's slice of the
                    # parameter itself, so the update lands in place
                    shard = p.data.view(-1)[self.rank * slen:
                                            (self.rank + 1) * slen]
                self.shards[n] = torch.nn.Parameter(shard)
            elif self._resident(n):
                shard = self.place.cut("p", n, torch.empty(
                    p.shape, dtype=p.dtype, device="meta"), self.rank)
                self.shards[n] = torch.nn.Parameter(torch.zeros(
                    shard.shape, dtype=p.dtype, device=self.device))
            elif self._zdim(n) is not None:
                # stages 1 and 2: this rank's slice of the parameter
                # itself (a view), so the update lands in place
                self.shards[n] = torch.nn.Parameter(
                    self.place.cut("o", n, p.data, self.rank))
        self.target = {n: self.shards.get(n, self.params[n])
                       for n in self.names}
        self.opt = from_settings(spec["opt"], [(n, self.target[n])
                                               for n in self.names])
        if not self.explicit:
            # the clip's groups: the one that shards each leaf
            self.opt._shard_groups = {
                id(self.target[n]): (self.mp_group
                                     if self.place.layouts[n][0] else
                                     self.zgroup if self._zdim(n) is not None
                                     else None)
                for n in self.names}
        self.accum = {}
        if self.gm_k > 1:
            self.accum = {n: torch.zeros_like(t, dtype=torch.float32)
                          for n, t in self.target.items()}
        self.gm_count = 0
        self.count = 0
        self._marks = []
        self._count_syncs = False

    def _slen(self, n):
        _, num, pad = self.meta[n]
        return (num + pad) // self.place.shape["dp"]

    def _zdim(self, n):
        """The dim leaf `n`'s update is sharded on over ``sharding`` (the
        hybrid path), or None."""
        return None if self.explicit else self.place.layouts[n][2]

    def _resident(self, n):
        """Whether leaf `n`'s parameter lives as its sharding slice between
        steps (stage 3: explicit flat shards, or hybrid ZeRO-3 leaves)."""
        if self.explicit:
            return self.stage3
        return self.place.layouts[n][1] is not None

    # -- state ---------------------------------------------------------------

    @torch.no_grad()
    def load(self, values, scalars):
        """Take `values` ({entry key: tensor}; a sharded entry holds this
        rank's slice, any other the natural tensor) and `scalars` (host
        slots, the step count, the merge count); the keys are the state's
        entries (above)."""
        slots = {}
        for key, v in values.items():
            kind, n = key[0], key[1]
            if kind == "p":
                if self._resident(n):
                    self.shards[n].copy_(v.view(self.shards[n].shape))
                else:
                    self.params[n].copy_(v.view(self.params[n].shape))
                    if n in self.shards:
                        cut = (_flat_shard(v, self.meta[n], self.dp,
                                           self.rank) if self.explicit else
                               self.place.cut("o", n, v, self.rank))
                        self.shards[n].copy_(cut.reshape(
                            self.shards[n].shape))
            elif kind == "f":
                self.params[n].copy_(v.view(self.params[n].shape))
            elif kind == "b":
                self.buffers[n].copy_(v.view(self.buffers[n].shape))
            elif kind == "o":
                t = self.target[n]
                v = v.to(torch.float32, copy=True)
                slots.setdefault(n, {})[key[2]] = (
                    v.reshape(t.shape) if v.numel() == t.numel() else v)
            elif kind == "g":
                self.accum[n].copy_(v.view(self.accum[n].shape))
        for key, v in scalars.items():
            if isinstance(key, tuple) and key[0] == "o":
                slots.setdefault(key[1], {})[key[2]] = np.float32(v)
        for n, st in slots.items():
            t = self.target[n]
            self.opt.state[t] = {}
            self.opt._state_of(t).update(st)
        self.opt._step_count = int(scalars.get("@step", 0))
        self.gm_count = int(scalars.get("gm_count", 0))
        self.count = int(scalars.get("count", 0))
        self._free_params()

    def entries(self):
        """This rank's state as ``[(key, tensor, varies)]`` and scalars, in
        the order every rank lists them (`collect`); `varies`: ranks hold
        different values of it."""
        place = self.place
        out, scalars = [], {"@step": self.opt._step_count,
                            "gm_count": self.gm_count, "count": self.count}
        for n in self.names:
            out.append((("p", n), (self.shards if self._resident(n) else
                                   self.params)[n].detach(),
                        place.varies("p", n)))
        for n, p in self.params.items():
            if n not in self.meta:
                out.append((("f", n), p.detach(), place.varies("f", n)))
        for n, b in self.buffers.items():
            out.append((("b", n), b, False))
        for n in self.names:
            t = self.target[n]
            for slot, v in self.opt.state.get(t, {}).items():
                if torch.is_tensor(v):
                    out.append((("o", n, slot), v, place.varies(
                        "o", n, v.numel() == t.numel())))
                else:
                    scalars[("o", n, slot)] = float(v)
        for n, a in self.accum.items():
            out.append((("g", n), a, place.varies("g", n)))
        return out, scalars

    def _natural(self, key, t):
        """Every rank's value of entry `key` (this rank's `t`) joined to
        the natural tensor (one uncounted all-gather over the world)."""
        stack = self.group.all_gather(t.contiguous())
        return self.place.join(key[0], key[1], stack)

    def collect(self):
        """Gather this step's state to natural shapes (every rank takes part
        in one uncounted all-gather a varying entry). Returns ``({key:
        natural tensor}, scalars)`` on rank 0, None elsewhere."""
        entries, scalars = self.entries()
        vals = {key: (self._natural(key, t) if varies else t)
                for key, t, varies in entries}
        return (vals, scalars) if self.rank == 0 else None

    def gather(self):
        """Natural-shape parameters on rank 0 (every rank takes part in one
        uncounted all-gather a sharded leaf); None elsewhere."""
        out = {}
        for key, t, varies in self.entries()[0]:
            if key[0] == "p":
                out[key[1]] = (self._natural(key, t) if varies
                               else t).clone()
        return out if self.rank == 0 else None

    def gather_replicas(self):
        """Every dp replica's natural parameters stacked in dp order,
        ``{name: [dp, *shape]}`` on rank 0 (one uncounted all-gather a
        leaf; an mp layer's slices joined); None elsewhere. The LocalSGD
        replicas differ between averaging steps."""
        place, out = self.place, {}
        for n in self.names:
            stack = self.group.all_gather(self.params[n].detach())
            mp = None if self.explicit else place.layouts[n][0]
            reps = []
            for d in range(place.shape["dp"]):
                if mp is None:
                    reps.append(stack[place.rank_of(dp=d)])
                else:
                    reps.append(mp_join([
                        stack[place.rank_of(dp=d, mp=m)]
                        for m in range(place.shape["mp"])], mp[0], mp[1]))
            out[n] = torch.stack(reps)
        return out if self.rank == 0 else None

    def opt_bytes(self):
        """The optimizer-state bytes this rank holds (the gradient-merge
        accumulators and count included, as the JAX state carries them)."""
        total = state_bytes(self.opt)
        if self.accum:
            total += sum(a.numel() * a.element_size()
                         for a in self.accum.values()) + 4
        return total

    def unsharded_opt_bytes(self):
        """What one rank would hold with every leaf unsharded: the same
        slots and dtypes over each leaf's natural element count."""
        total = 0
        for n in self.names:
            num = self.meta[n][1]
            for v in self.opt.state.get(self.target[n], {}).values():
                total += num * v.element_size() if torch.is_tensor(v) else 4
        if self.accum:
            total += sum(self.meta[n][1] * 4 for n in self.accum) + 4
        return total

    def param_bytes(self):
        """Bytes of parameter storage this rank holds between steps (natural
        parameters and shards)."""
        seen, total = set(), 0
        for t in list(self.params.values()) + list(self.shards.values()):
            key = t.untyped_storage().data_ptr()
            if t.numel() and key not in seen:
                seen.add(key)
                total += t.untyped_storage().nbytes()
        return total

    # -- the step ------------------------------------------------------------

    def _free_params(self):
        """Drop the full copies of the leaves that live as slices."""
        for n in self.names:
            if self._resident(n):
                p = self.params[n]
                p.data = torch.empty(0, dtype=p.dtype, device=self.device)
                p.grad = None

    def _joined(self, n, shard):
        """Leaf `n`'s full value from every sharding rank's `shard` (one
        counted all-gather over the explicit path's dp ranks, or over the
        sharding group)."""
        if self.explicit:
            full = all_gather(shard.detach(), self.group)
            shape, num, _ = self.meta[n]
            return full.reshape(-1)[:num].view(shape)
        full = all_gather(shard.detach(), self.zgroup)
        return torch.cat(list(full), self._zdim(n))

    def _gather_params(self):
        for n in self.names:
            if self._resident(n):
                self.params[n].data = self._joined(n, self.shards[n])

    def _forward(self, batch):
        inputs, labels = batch[:-1], batch[-1]
        kw = {}
        if self.sp_group is not None:
            # this rank's slice of the sequence starts here
            kw["pos_offset"] = self.sp_group.rank * inputs[0].shape[1]
        head = getattr(self.loss_fn, "tied_head", False) and (
            self.mp_group is not None or self.sp_group is not None)
        if head:
            # the model's own head computes this loss (models/gpt.py
            # `gpt_loss_fn`): vocab-parallel at mp > 1, no gathered
            # logits; the slice's mean under sp
            kw["labels"] = labels
        if self.remat:
            from ..distributed.fleet.utils import recompute

            gens = getattr(self.model, "dropout_generators", None)
            out = recompute(functools.partial(self.model, **kw), *inputs,
                            generators=(() if gens is None else
                                        (gens.attn, gens.elem)))
        else:
            out = self.model(*inputs, **kw)
        return out if head else self.loss_fn(out, labels)

    def _mark(self, name):
        """End the step's phase `name` here: a CUDA event on the current
        stream (the device's clock, no wait), or the host clock on the
        CPU."""
        if self.device.type == "cuda":
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            self._marks.append((name, ev))
        else:
            self._marks.append((name, time.perf_counter()))

    def _phase_ms(self):
        """{phase: ms} between consecutive marks of the last step (read
        after the step's final host sync)."""
        out = {}
        for (_, a), (name, b) in zip(self._marks, self._marks[1:]):
            out[name] = (a.elapsed_time(b) if self.device.type == "cuda"
                         else (b - a) * 1e3)
        return out

    def count_syncs(self, on):
        """Count the host syncs of each later step (`step`)."""
        self._count_syncs = bool(on)

    def step(self, lr, seed, rows):
        """One step on this rank's `rows`: forward, backward, the gradient
        reduction and the update. Returns ``(mean loss over the ranks,
        seconds, peak device bytes, {phase: ms}, host syncs)``: the phases
        ``gather`` (stage 3's parameters), ``forward_backward`` (under a
        sequence split ``forward`` and ``backward``, the ring's two
        halves), ``loss_reduce`` (loss and buffers), ``grad_reduce``,
        ``update`` and ``param_gather`` (the updated shards; LocalSGD's
        average), on the device's clock on CUDA. After `count_syncs` on a
        CUDA rank, the host syncs the step made (each one
        `torch.cuda.set_sync_debug_mode` reports), else None."""
        with _counted_syncs(self.device, self._count_syncs) as syncs:
            out = self._step(lr, seed, rows)
        return out + (syncs[0],)

    def _step(self, lr, seed, rows):
        t0 = time.perf_counter()
        self._marks = []
        self._mark("start")
        batch = [torch.as_tensor(a).to(self.device) for a in rows]
        self._gather_params()
        self._mark("gather")
        if hasattr(self.model, "seed_dropout"):
            self.model.seed_dropout(_rank_seed(
                seed, self.place.data_index(self.rank)))
        loss = self._forward(batch)
        weigh = getattr(self.loss_fn, "loss_weight", None)
        # a LocalSGD replica's loss is its own rows' mean (JAX vmaps the
        # loss over the replicas): only its sequence slices weigh
        local = self.kind == "localsgd"
        wgroups = ([self.sp_group] if self.sp_group is not None else []) \
            if local else self.data_groups
        if weigh is not None and not self.explicit and wgroups:
            # a mean over a count that differs between row shares and
            # sequence slices (the MLM loss's labelled positions): weight
            # this share's mean by its count over the mean count, so the
            # average over the groups is the whole batch's mean (JAX's
            # GSPMD step computes it whole), or the replica's
            w = torch.as_tensor(weigh(batch[-1]), dtype=torch.float32,
                                device=self.device).reshape(1)
            total = w.clone()
            for g in wgroups:
                all_reduce(total, g)
            n = self.sp_group.size if local else self.dp
            loss = loss * (w * n / total)[0]
        if self.sp_group is not None:
            self._mark("forward")
        loss.backward()
        self._mark("backward" if self.sp_group is not None
                   else "forward_backward")
        loss = loss.detach().reshape(1).clone()
        with torch.no_grad():
            groups = [self.group] if self.explicit else self.data_groups
            for g in groups:
                all_reduce(loss, g)
            if self.dp > 1:
                for b in self.buffers.values():
                    t = b.float()
                    for g in groups:
                        all_reduce(t, g)
                    b.copy_((t / self.dp).to(b.dtype))
            loss = loss / self.dp
            self._mark("loss_reduce")
            if self.kind == "localsgd":
                self._local_update(lr)
            elif self.explicit:
                self._explicit_update(lr)
            else:
                self._hybrid_update(lr)
        out = float(loss[0])
        peak = (torch.cuda.max_memory_allocated(self.device)
                if self.device.type == "cuda" else None)
        return out, time.perf_counter() - t0, peak, self._phase_ms()

    def _grad(self, n):
        p = self.params[n]
        g = p.grad if p.grad is not None else torch.zeros_like(p)
        p.grad = None
        return g

    def _apply(self, grads, lr):
        """Gradient merge, then the optimizer's update of `self.target` with
        `grads` (in the target's layout). Returns whether it updated."""
        if self.gm_k > 1:
            for n, g in grads.items():
                self.accum[n] += g.float()
            self.gm_count += 1
            if self.gm_count % self.gm_k:
                return False
            scale = (1.0 / self.gm_k) if self.gm_avg else 1.0
            grads = {n: (a * scale).to(grads[n].dtype)
                     for n, a in self.accum.items()}
            for a in self.accum.values():
                a.zero_()
        for n, g in grads.items():
            self.target[n].grad = g
        self.opt.set_lr(float(lr))
        if self.explicit and not self.opt._elementwise_update:
            # a trust-ratio rule on flat 1/dp shards: each per-tensor norm
            # sums the shards' squares over the dp ranks
            with sharded_norms(self.group, self.opt):
                self.opt.step()
        else:
            self.opt.step()
        for t in self.target.values():
            t.grad = None
        return True

    def _hybrid_update(self, lr):
        """The GSPMD path's update: each leaf's gradient divided by the
        data degree and all-reduced over the data groups, cut to the
        rank's sharding slice where the update is sharded; the update;
        then the updated slices gathered over the sharding group (stages
        1 and 2; stage 3 keeps them resident)."""
        grads = {}
        for n in self.names:
            g = self._grad(n)
            if self.dp > 1:
                g = g / self.dp
                for grp in self.data_groups:
                    all_reduce(g, grp)
            if n in self.shards:
                g = self.place.cut("o", n, g, self.rank).contiguous()
            grads[n] = g
        self._mark("grad_reduce")
        applied = self._apply(grads, lr)
        self._mark("update")
        self._free_params()
        if applied:
            for n, shard in self.shards.items():
                if not self._resident(n):
                    self.params[n].copy_(self._joined(n, shard))
        self._mark("param_gather")

    def _explicit_update(self, lr):
        grads = {}
        for n in self.names:
            _, _, pad = self.meta[n]
            flat = self._grad(n).reshape(-1) / self.dp
            if pad:
                flat = F.pad(flat, (0, pad))
            if self.quant:
                gs = quantized_psum_scatter(flat.float(), self.group).to(
                    flat.dtype)
            else:
                gs = reduce_scatter(flat, self.group)
            grads[n] = gs
        self._mark("grad_reduce")
        applied = self._apply(grads, lr)
        self._mark("update")
        if self.stage3:
            self._free_params()
        elif applied:
            for n in self.names:
                self.params[n].copy_(self._joined(n, self.shards[n]))
        self._mark("param_gather")

    def _local_update(self, lr):
        grads = {}
        for n in self.names:
            g = self._grad(n)
            if self.sp_group is not None:
                # the replica's gradient: the mean over its sequence slices
                g = g / self.sp_group.size
                all_reduce(g, self.sp_group)
            grads[n] = g
        self._apply(grads, lr)
        self._mark("update")
        self.count += 1
        replicas = self.place.data_degree
        if self.count % self.k_steps == 0 and replicas > 1:
            # each rank's values averaged over the replicas (its dp group)
            for n in self.names:
                p = self.params[n]
                t = p.detach().float()
                for g in self.row_groups:
                    all_reduce(t, g)
                p.copy_((t / replicas).to(p.dtype))
        self._mark("param_gather")


# -- the rank processes --------------------------------------------------------


class _RankJobs:
    """A rank process's replicas, one a step built over its mesh."""

    def __init__(self, mesh):
        self.mesh = mesh
        self.jobs = {}

    def close(self):
        self.jobs.clear()
        leave_group(self.mesh)


def rank_main(mesh, store, spec, conn):
    """A data-parallel rank process's entry point: serve the channel's
    operations (`_OPS`) over this rank's replicas until ``close``."""
    rank_loop(mesh, store, spec, conn,
              build=lambda: (_RankJobs(mesh), {"rank": mesh.rank,
                                               "pid": os.getpid()}),
              ops=_OPS, finish=lambda jobs: jobs.close())


_MESSAGE = 1 << 28      # elements a point-to-point message carries at most


def _unpack(group, layout, device, src=0):
    """Receive from rank `src` the tensors of `layout` (``[(key, shape,
    dtype)]``), one buffer a dtype in order of first appearance, in
    messages of at most `_MESSAGE` elements (`_pack`)."""
    out, by_dtype = {}, {}
    for key, shape, dtype in layout:
        by_dtype.setdefault(dtype, []).append((key, shape))
    for dtype, items in by_dtype.items():
        sizes = [int(np.prod(shape)) for _, shape in items]
        buf = torch.empty(sum(sizes), dtype=dtype, device=device)
        for part in torch.split(buf, _MESSAGE):
            group.recv_(part, src)
        for (key, shape), part in zip(items, torch.split(buf, sizes)):
            out[key] = part.view(shape)
    return out


def _pack(group, tensors, dst):
    """Send `tensors` (``[(key, tensor)]``) to rank `dst`: one buffer a
    dtype, in order of first appearance, in messages of at most
    `_MESSAGE` elements (so a copy staged through the host holds at most
    that much; a whole gpt_1p3b is 5.3 GB)."""
    by_dtype = {}
    for _, t in tensors:
        by_dtype.setdefault(t.dtype, []).append(t.reshape(-1))
    for parts in by_dtype.values():
        for part in torch.split(torch.cat(parts), _MESSAGE):
            group.send(part, dst)


def gather_shares(mesh, mine, layouts):
    """Every rank's `mine` (``[(key, tensor)]``, in the order of its entry
    of `layouts`: ``[(key, shape, dtype)]`` a rank) to rank 0, uncounted
    over the world group: ``{rank: {key: CPU tensor}}`` on rank 0, None
    elsewhere. Every rank calls it in its share of one job operation."""
    if mesh.rank != 0:
        _pack(mesh.group, mine, 0)
        return None
    out = {0: {k: t.detach().cpu().clone() for k, t in mine}}
    for r in range(1, mesh.size):
        got = _unpack(mesh.group, layouts[r], mesh.device, src=r)
        out[r] = {k: t.cpu() for k, t in got.items()}
    return out


def _op_open(jobs, job_id, spec, payload=None):
    """Build this rank's share of a job from `spec` (its ``factory``, a
    class taking ``(spec, mesh)``; default `_Replica`), then load it
    (unless there is no `payload`)."""
    jobs.jobs[job_id] = spec.get("factory", _Replica)(spec, jobs.mesh)
    if payload is not None:
        _op_load(jobs, job_id, payload)


def _op_load(jobs, job_id, payload):
    """Receive this rank's values of a state (``payload``: their layout
    and the scalars) from rank 0 and load them."""
    layout, scalars = payload
    jobs.jobs[job_id].load(_unpack(jobs.mesh.group, layout, jobs.mesh.device),
                           scalars)


def _op_job(jobs, job_id, op, *args):
    job = jobs.jobs[job_id]
    if op not in getattr(job, "JOB_OPS", _JOB_OPS):
        raise KeyError(op)
    return getattr(job, op)(*args)


def _op_drop(jobs, job_id):
    jobs.jobs.pop(job_id, None)


def _op_report(jobs, zero=False):
    return dict(_report(jobs.mesh.device, zero), rank=jobs.mesh.rank)


def _op_barrier(jobs):
    jobs.mesh.group.barrier(jobs.mesh.device)


_OPS = {"open": _op_open, "load": _op_load, "job": _op_job,
        "drop": _op_drop, "report": _op_report, "barrier": _op_barrier}
_JOB_OPS = frozenset(("step", "count_syncs", "collect", "gather",
                      "gather_replicas", "opt_bytes", "param_bytes"))


def _ranks_of(mesh):
    """The mesh's rank processes, started by the first step over it."""
    if mesh.size <= 1:
        return None
    if mesh.ranks is None:
        import weakref

        ranks = RankSet.start(mesh, rank_main, rank_spec(mesh.device_type),
                              name="dp-rank")
        try:
            ranks.wait_ready()
        except BaseException:
            ranks.close()
            raise
        mesh.ranks = ranks
        weakref.finalize(mesh, ranks.close)
    return mesh.ranks


# -- the controller ------------------------------------------------------------


def _data_axes(batch_specs):
    """``(row axes, sequence axis)`` of the batch, from `batch_specs` (one
    spec an array, every array's rows alike): None or ``"dp"`` (JAX's
    ``P("dp")``) or a tuple of the axes the rows split over (``("dp",
    "sharding")``); ``("dp", "sp")``, or ``(rows, "sp")``, splits the rows
    over dp and the sequence (dim 1) over ``sp`` (JAX's ``P("dp",
    "sp")``). The sequence axis is None when no spec names ``"sp"``; an
    array whose spec does not name it keeps its whole sequence
    (`_seq_split_arrays`)."""
    axes, seqs = set(), set()
    for spec in batch_specs or ("dp",):
        spec = (spec,) if spec is None or isinstance(spec, str) \
            else tuple(spec)
        seq = None
        if "sp" in spec:
            if len(spec) != 2 or spec[1] != "sp":
                raise ValueError(
                    f"batch_specs {batch_specs}: 'sp' splits the "
                    "sequence, a spec's second entry: ('dp', 'sp')")
            spec, seq = spec[:1], "sp"
        if spec and isinstance(spec[0], (tuple, list)):
            spec = tuple(spec[0])     # a JAX-style spec of the rows' axes
        axes.add(tuple(a for a in spec if a is not None) or ("dp",))
        seqs.add(seq)
    if len(axes) != 1:
        raise ValueError(f"batch_specs {batch_specs}: every batch array "
                         "splits its rows over the same axes")
    (got,), seq = axes, ("sp" if "sp" in seqs else None)
    if got[0] != "dp" or not set(got) <= {"dp", "sharding"} \
            or len(set(got)) != len(got):
        raise ValueError(
            f"batch_specs {batch_specs}: the rows split over 'dp' (JAX's "
            "P('dp')), or over ('dp', 'sharding'); mp peers must hold the "
            "same rows")
    return got, seq


def _seq_split_arrays(batch_specs):
    """Whether each batch array's spec splits its sequence over ``sp``
    (`_data_axes`'s specs, in order)."""
    return tuple("sp" in ((spec,) if spec is None or isinstance(spec, str)
                          else tuple(spec))
                 for spec in batch_specs or ("dp",))


def _sequence_guard(model, mesh, batch_specs):
    """Raise unless the sequence split covers this step (module
    docstring): on a mesh with ``sp`` above 1, the batch must split its
    sequence over ``sp``, and the model must split its attention over the
    group (`shard_sequence`)."""
    if mesh.shape.get("sp", 1) <= 1:
        return
    if _data_axes(batch_specs)[1] != "sp":
        raise ValueError(
            f"a mesh with sp={mesh.shape['sp']} splits each row's sequence "
            "over its sp ranks: batch_specs=(('dp', 'sp'),) * 2")
    if not hasattr(model, "shard_sequence"):
        raise NotImplementedError(
            f"{type(model).__name__} at sp={mesh.shape['sp']}: attention "
            "over a sequence slice must span the sp group, and this model "
            "has no shard_sequence (GPT and Bert have)")


def _expert_guard(model, mesh):
    """Raise unless every MoE layer's experts lie on ``mp`` or on an axis
    of degree 1 (ROADMAP Queue 1, item 8b.5)."""
    for name, module in model.named_modules():
        ep = getattr(module, "ep_axis", None)
        if ep is not None and ep != "mp" and mesh.shape.get(ep, 1) > 1:
            raise NotImplementedError(
                f"{type(module).__name__} {name!r} with ep_axis={ep!r} "
                f"over {dict(mesh.shape)}: experts on an axis other than "
                "'mp' are not ported (ROADMAP Queue 1, item 8b.5)")


def job_spec(kind, model, loss_fn, optimizer, mesh, zero_stage=0,
             explicit=False, stage3=False, data_axes=("dp",), seq_axis=None,
             **opts):
    """What every rank builds its replica of a step from, but the model's
    skeleton: the trainable parameters' names, each leaf's flat layout
    (natural shape, element count, pad to the next dp multiple), the
    state's placement over `mesh` (`_Placement`: one derivation, used by
    every rank), the loss, the optimizer's settings and the step's
    options."""
    dp = mesh.shape["dp"]
    names = [n for n, p in model.named_parameters() if p.requires_grad]
    meta = {}
    for n, p in model.named_parameters():
        if p.requires_grad:
            shape = tuple(p.shape)
            num = int(np.prod(shape)) if shape else 1
            meta[n] = (shape, num, (-num) % dp)
    layouts = {} if explicit else leaf_layouts(model, mesh, zero_stage)
    place = _Placement(mesh.shape, explicit, stage3, meta, layouts,
                       data_axes, seq_axis)
    return dict(kind=kind, loss_fn=loss_fn, names=names, meta=meta,
                place=place, opt=optimizer.settings(), explicit=explicit,
                stage3=stage3, **opts)


class RankJob:
    """A job over a mesh's ranks, driven from rank 0 (this process): its
    share on every rank (``_replica`` here, the same job id on the
    others), run by `_everywhere` and `_call`. Subclasses set ``mesh``,
    ``_ranks`` (`_ranks_of(mesh)`), ``_job`` and ``_replica``."""

    def _everywhere(self, local, op, *args, per_rank=None):
        """``local()`` here and operation `op` on every other rank (its
        `per_rank` value, when given, last among its arguments): ``[local's
        result, rank 1's, ...]``. Anything that escapes while the ranks
        were told raises as a `RankFailed` (`RankSet.failure`)."""
        ranks = self._ranks
        if ranks is not self.mesh.ranks:
            raise RuntimeError(f"{type(self).__name__}: its mesh's ranks "
                               "were closed; build a new step")
        if ranks is None:
            return [local()]
        try:
            ranks.post(op, *args, per_rank=per_rank, reply=True)
            self.mesh.in_job += 1
            try:
                out = local()
            finally:
                self.mesh.in_job -= 1
            rest = ranks.collect()
        except RankFailed:
            raise
        except Exception as e:
            ranks.failure(e)
        ranks.check()
        return [out] + rest

    def _call(self, op, *args, per_rank=None):
        """Run job op `op` on every rank (rank 0 here, the others over the
        channel). Returns ``[rank 0's result, rank 1's, ...]``."""
        mine = (per_rank[0],) if per_rank is not None else ()
        return self._everywhere(
            lambda: getattr(self._replica, op)(*args, *mine), "job",
            self._job, op, *args,
            per_rank=None if per_rank is None else per_rank[1:])

    def _give(self, shares, spec=None):
        """Send each rank its share (``shares[r]``: ``[(key, tensor)]`` on
        rank 0's device) over the data plane and load it into the job's
        share there; with `spec`, first build the job on every rank from
        it (its ``factory``, taking ``(spec, mesh)``)."""
        def local():
            for r in range(1, self.mesh.size):
                _pack(self.mesh.group, shares[r], r)
            if spec is not None:
                self._replica = spec["factory"](spec, self.mesh)
            self._replica.load(dict(shares[0]), {})

        layouts = [([(k, tuple(t.shape), t.dtype) for k, t in sh], {})
                   for sh in shares[1:]]
        if spec is not None:
            self._everywhere(local, "open", self._job, spec,
                             per_rank=layouts)
        else:
            self._everywhere(local, "load", self._job, per_rank=layouts)

    def rank_reports(self, zero=False):
        """Each rank's report (rank order): its flash launches and
        collective calls since the last reset (reset after reading with
        `zero`), its peak device memory, pid and imported top-level
        modules. The counters are each process's own: everything the
        process ran since the last reset."""
        return self._everywhere(
            lambda: dict(_report(self.mesh.devices[0], zero), rank=0),
            "report", zero)

    def collective_counts(self, zero=False):
        """Each rank's collective calls since the last reset (rank
        order)."""
        return [r["collectives"] for r in self.rank_reports(zero)]

    def close(self):
        """Drop this job on every rank (the mesh's ranks stay up for other
        jobs). Idempotent."""
        ranks = self._ranks
        if ranks is not None and ranks.failed is None and ranks.conns:
            ranks.send("drop", self._job)
        self._replica = None


class _MeshOps(RankJob):
    """A running mesh's operations that belong to no job."""

    def __init__(self, mesh):
        self.mesh, self._ranks = mesh, mesh.ranks


class _FactoryJob(RankJob):
    """A job whose share on every rank is ``factory(spec, mesh)``, built
    with nothing to load."""

    def __init__(self, mesh, factory):
        self.mesh, self._ranks = mesh, _ranks_of(mesh)
        self._job = next(_JOB_IDS)
        self._replica = None
        spec = {"factory": factory}

        def local():
            self._replica = factory(spec, mesh)

        self._everywhere(local, "open", self._job, spec)


def run_on_ranks(mesh, factory, *calls):
    """Build ``factory(spec, mesh)`` on every rank of `mesh` (this process
    rank 0), run each of `calls` (``(op, *args)``: a method the share
    names in its ``JOB_OPS``) on every rank in turn, then drop the
    shares. Returns each call's ``[rank 0's result, rank 1's, ...]``."""
    job = _FactoryJob(mesh, factory)
    try:
        return [job._call(op, *args) for op, *args in calls]
    finally:
        job.close()


def barrier(mesh):
    """Return once every rank of `mesh` has reached it; nothing to wait for
    without running ranks. Where every rank runs this code (`DeviceMesh.
    in_step`) it is one uncounted all-reduce over the world group; in the
    controller between jobs, where the ranks wait on the channel, each
    rank runs it as an operation beside the controller."""
    if mesh.group is None:
        return
    if mesh.in_step():
        mesh.group.barrier(mesh.device)
    else:
        _MeshOps(mesh)._everywhere(lambda: mesh.group.barrier(mesh.device),
                                   "barrier")


class _TrainStep(RankJob):
    """What `ShardedTrainStep` and `LocalSGDTrainStep` share: the replicas
    on every rank, the channel, the state carry and the reports."""

    _kind = None

    def _open(self, model, loss_fn, optimizer, mesh, batch_specs,
              zero_stage=0, **opts):
        data_axes, seq_axis = _data_axes(batch_specs)
        self._seq_arrays = _seq_split_arrays(batch_specs)
        _expert_guard(model, mesh)
        if mesh.device_type == "cuda" and torch.cuda.is_available():
            torch.cuda.set_device(mesh.devices[0])
        self.model = model
        self.loss_fn = loss_fn
        self.optimizer = optimizer
        self.mesh = mesh
        self._seed_gen = torch.Generator().manual_seed(
            int(getattr(model, "_seed", 0)))
        params = dict(model.named_parameters())
        self._shapes = {n: tuple(p.shape) for n, p in params.items()}
        self._spec = job_spec(self._kind, model, loss_fn, optimizer, mesh,
                              zero_stage, data_axes=data_axes,
                              seq_axis=seq_axis, **opts)
        self.names = self._spec["names"]
        self._flat_meta = self._spec["meta"]
        self._place = self._spec["place"]
        # the batch's row shares: dp on the explicit path, else the data
        # axes' degree
        self.dp = mesh.size if self._place.explicit else \
            self._place.data_degree
        self._job = next(_JOB_IDS)
        # each rank's seconds, peak device bytes, phases and (after
        # `count_host_syncs`, on CUDA) host syncs of the last step
        self.last_step = None
        self._ranks = _ranks_of(mesh)
        self._replica = None
        opt_sd = {f"{n}_{slot}": v for n in self.names
                  for slot, v in optimizer.state.get(params[n], {}).items()}
        opt_sd["@step"] = optimizer._step_count
        self._send_state({"params": {n: p.detach()
                                     for n, p in params.items()},
                          "buffers": dict(model.named_buffers()),
                          "optimizer": opt_sd}, opening=model)
        self._traced = InstrumentedStep(self._step, {
            "source": type(self).__name__})

    # -- state carry ----------------------------------------------------------

    def _param_shaped(self, key, t):
        """Whether entry `key` (a tensor `t` of natural shape) has its
        leaf's elements (an optimizer slot may be a scalar)."""
        return key[0] != "o" or t.numel() == int(np.prod(
            self._shapes[key[1]]))

    def _entries(self, state):
        """``([(key, natural tensor)], scalars)`` of a natural-shape state
        (`state_dict`'s form), keyed as the state's entries (above)."""
        entries, scalars = [], {}
        for n, t in state.get("params", {}).items():
            entries.append((("p" if n in self._flat_meta else "f", n), t))
        for n, t in state.get("buffers", {}).items():
            entries.append((("b", n), t))
        opt_sd = state.get("optimizer", {})
        slot_names = tuple(self.optimizer._slot_names) + ("master_weight",)
        for n in self.names:
            for slot in slot_names:
                v = opt_sd.get(f"{n}_{slot}")
                if v is None:
                    continue
                if torch.is_tensor(v):
                    entries.append((("o", n, slot), v))
                else:
                    scalars[("o", n, slot)] = float(v)
        for n, t in state.get("gm_accum", {}).items():
            entries.append((("g", n), t))
        scalars["@step"] = int(opt_sd.get("@step", 0))
        for k in ("gm_count", "count"):
            if k in state:
                scalars[k] = int(state[k])
        return entries, scalars

    def _rank_shape(self, key, t):
        """The shape of a rank's value of entry `key` (the same on every
        rank)."""
        return tuple(self._rank_value(
            key, torch.empty(t.shape, dtype=t.dtype, device="meta"),
            0).shape)

    def _rank_value(self, key, t, r):
        """Rank `r`'s value of entry `key`: its slice or `t`."""
        if key[0] == "b":
            return t.detach()
        return self._place.cut(key[0], key[1], t.detach(), r,
                               self._param_shaped(key, t))

    def _send_state(self, state, opening=None):
        """Give every rank its part of a natural-shape `state`: on opening
        (`opening` is the model the replicas copy), build the replicas
        first. Rank 0 packs each rank's values and sends them over the
        data plane; the channel carries the layout and the scalars."""
        dev = self.mesh.devices[0]
        entries, scalars = self._entries(state)
        entries = [(k, torch.as_tensor(t).to(dev)) for k, t in entries]
        payload = ([(k, self._rank_shape(k, t), t.dtype) for k, t in entries],
                   scalars)
        skeleton = None if opening is None else meta_copy(opening)

        def local():
            for r in range(1, self.mesh.size):
                _pack(self.mesh.group, [
                    (k, self._rank_value(k, t, r)) for k, t in entries], r)
            if skeleton is not None:
                # the ranks have their pickled copy of the skeleton
                self._replica = _Replica(dict(self._spec, skeleton=skeleton),
                                         self.mesh)
            self._replica.load({k: self._rank_value(k, t, 0)
                                for k, t in entries}, scalars)

        if skeleton is not None:
            self._everywhere(local, "open", self._job,
                             dict(self._spec, skeleton=skeleton), payload)
        else:
            self._everywhere(local, "load", self._job, payload)

    # -- the user's surface ---------------------------------------------------

    def shard_batch(self, *arrays):
        """Each rank's rows of `arrays`, in rank order: ``[(rank 0's arrays),
        (rank 1's), ...]`` as numpy arrays, each array split along its first
        axis as its spec splits it (``P("dp")``: the dp index's share, the
        same on the sharding and mp peers), and under ``("dp", "sp")``
        along its second too (the sp index's slice of the sequence; an
        array whose spec is ``"dp"`` alone stays whole on the sp ranks)."""
        place = self._place
        out = [[] for _ in range(self.mesh.size)]
        if place.seq_degree > 1 and len(arrays) != len(self._seq_arrays):
            raise ValueError(
                f"{len(arrays)} batch arrays against "
                f"{len(self._seq_arrays)} batch_specs: under sp each array "
                "names whether its sequence splits")
        for i, a in enumerate(arrays):
            sp = place.seq_degree if place.seq_degree > 1 and \
                self._seq_arrays[i] else 1
            a = a.detach().cpu().numpy() if torch.is_tensor(a) else \
                np.asarray(a)
            if a.shape[0] % self.dp:
                raise ValueError(f"batch of {a.shape[0]} rows does not split "
                                 f"over {self.dp} row shares")
            if sp > 1 and (a.ndim < 2 or a.shape[1] % sp):
                raise ValueError(
                    f"batch array of shape {a.shape}: its sequence (dim 1) "
                    f"does not split over sp={sp} ranks")
            parts = np.split(a, self.dp)
            for r in range(self.mesh.size):
                rows = parts[r if place.explicit else place.data_index(r)]
                if sp > 1:
                    rows = np.split(rows, sp, axis=1)[place.seq_index(r)]
                out[r].append(rows)
        return [tuple(rows) for rows in out]

    def step(self, *batch, lr=None, seed=None):
        """One train step on the global `batch` (inputs..., labels): every
        rank runs its rows. `lr` defaults to the caller's optimizer's
        learning rate or scheduler value; `seed` (the dropout masks' root;
        default: drawn from a generator seeded with the model's seed).
        Returns the mean loss over the ranks."""
        return self._traced(*batch, lr=lr, seed=seed)

    __call__ = step

    def _step(self, *batch, lr=None, seed=None):
        lr = np.float32(self.optimizer.get_lr() if lr is None else lr)
        if seed is None:
            seed = int(torch.randint(0, 2**62, (1,),
                                     generator=self._seed_gen))
        rows = self.shard_batch(*batch)
        results = self._call("step", lr, seed, per_rank=rows)
        self.last_step = [{"seconds": s, "peak_bytes": pk, "phases_ms": ph,
                           "host_syncs": hs}
                          for _, s, pk, ph, hs in results]
        return results[0][0]

    def count_host_syncs(self, on=True):
        """Count every rank's host syncs in each later step (CUDA ranks:
        ``last_step[r]["host_syncs"]``)."""
        self._call("count_syncs", bool(on))

    def gather_params(self):
        """Natural-shape parameters ({name: tensor} on rank 0's device):
        stage 3 gathers the resident shards; every other path's parameters
        are replicated and come from rank 0."""
        return self._call("gather")[0]

    def state_dict(self):
        """The step's state at natural shapes: ``{"params": {name: tensor},
        "buffers": {...}, "optimizer": {...}}`` (and with gradient merge
        ``"gm_accum"`` and ``"gm_count"``; LocalSGD adds ``"count"``). The
        optimizer part uses the JAX package's keys (``{name}_{slot}``,
        ``@step``, ``@param_order``, and ``LR_Scheduler`` from the caller's
        optimizer), so a one-process optimizer over the same model takes it
        too."""
        vals, scalars = self._call("collect")[0]
        out = {"params": {}, "buffers": {}, "optimizer": {}}
        for key, t in vals.items():
            t = t.detach().cpu().clone()
            if key[0] in ("p", "f"):
                out["params"][key[1]] = t
            elif key[0] == "b":
                out["buffers"][key[1]] = t
            elif key[0] == "o":
                out["optimizer"][f"{key[1]}_{key[2]}"] = t
            elif key[0] == "g":
                out.setdefault("gm_accum", {})[key[1]] = t
        for key, v in scalars.items():
            if isinstance(key, tuple):
                out["optimizer"][f"{key[1]}_{key[2]}"] = np.float32(v)
        opt = out["optimizer"]
        opt["@step"] = scalars["@step"]
        opt["@param_order"] = list(self.names)
        sched = self.optimizer._learning_rate
        if isinstance(sched, LRScheduler):
            opt["LR_Scheduler"] = sched.state_dict()
        if self._spec["gm_k"] > 1:
            out["gm_count"] = scalars["gm_count"]
        if self._kind == "localsgd":
            out["count"] = scalars["count"]
        return out

    def set_state_dict(self, state):
        """Load a natural-shape state (`state_dict`'s form, saved at any dp
        degree) and re-shard it over this step's ranks. The optimizer's
        ``LR_Scheduler`` goes to the caller's optimizer's scheduler."""
        opt = state.get("optimizer", {})
        sched = self.optimizer._learning_rate
        if "LR_Scheduler" in opt and isinstance(sched, LRScheduler):
            sched.set_state_dict(opt["LR_Scheduler"])
        self._send_state(state)

    load_state_dict = set_state_dict

    def per_chip_opt_state_bytes(self):
        """Bytes of optimizer state each rank holds, rank order (the
        gradient-merge accumulators included)."""
        return self._call("opt_bytes")

    def unsharded_opt_state_bytes(self):
        """The bytes one rank would hold with every leaf unsharded: rank 0's
        slots and dtypes over each leaf's natural element count (computed,
        not built)."""
        return self._replica.unsharded_opt_bytes()

    def param_bytes(self):
        """Bytes of parameter storage each rank holds between steps, rank
        order."""
        return self._call("param_bytes")

class ShardedTrainStep(_TrainStep):
    """Data-parallel training over `mesh`'s ranks (the module docstring):
    forward, loss, backward, the gradient reduction and the optimizer's
    update a step, on the explicit ZeRO path or the plain one."""

    _kind = "sharded"

    def __init__(self, model, loss_fn, optimizer, mesh, batch_specs=None,
                 zero_stage=0, remat=False, gradient_merge_k=1,
                 gradient_merge_avg=True, explicit_update=None,
                 quant_grads=False):
        model, optimizer = _unwrap(model, optimizer)
        self.zero_stage = int(zero_stage)
        self.remat = bool(remat)
        self.gm_k = int(gradient_merge_k)
        self.gm_avg = bool(gradient_merge_avg)
        eligible = explicit_update_eligible(mesh)
        if explicit_update is None:
            self.explicit_update = self.zero_stage >= 2 and eligible
        elif explicit_update:
            if self.zero_stage < 2:
                raise ValueError(
                    "explicit_update needs zero_stage >= 2 (the path IS "
                    "the stage-2/3 grad reduce-scatter + sharded update)")
            if not eligible:
                raise ValueError(
                    "explicit_update needs a pure-dp mesh (dp > 1, every "
                    f"other axis degree 1); got {dict(mesh.shape)} — "
                    "dp x mp / 'sharding'-axis meshes take the GSPMD path")
            self.explicit_update = True
        else:
            self.explicit_update = False
        self.quant_grads = bool(quant_grads)
        if self.quant_grads and not self.explicit_update:
            raise ValueError(
                "quant_grads rides the explicit weight-update path "
                "(int8 reduce-scatter) — it needs zero_stage >= 2 on a "
                "pure-dp mesh, or explicit_update=True")
        _sequence_guard(model, mesh, batch_specs)
        if self.explicit_update:
            if optimizer._grad_clip is not None:
                raise ValueError(
                    "explicit_update cannot honor grad_clip: the global "
                    "grad norm needs every leaf while the update only "
                    "holds 1/dp shards — clip eagerly or use the GSPMD "
                    "path (explicit_update=False)")
            if (not getattr(optimizer, "_elementwise_update", True)
                    and not getattr(optimizer, "_sharded_norm_ready",
                                    False)):
                raise ValueError(
                    f"{type(optimizer).__name__} computes per-tensor "
                    "reductions in its update rule; the shard-local "
                    "explicit update would change its semantics — use "
                    "the GSPMD path (explicit_update=False)")
        if (not self.explicit_update
                and not getattr(optimizer, "_elementwise_update", True)
                and not getattr(optimizer, "_sharded_norm_ready", False)
                and any(mp is not None or zs is not None for mp, _, zs in
                        leaf_layouts(model, mesh, self.zero_stage).values())):
            raise ValueError(
                f"{type(optimizer).__name__} computes per-tensor "
                "reductions in its update rule, and this mesh slices "
                "leaves over 'mp' or 'sharding': the slice-local update "
                "would change its semantics")
        self._open(model, loss_fn, optimizer, mesh, batch_specs,
                   zero_stage=self.zero_stage,
                   stage3=self.explicit_update and self.zero_stage >= 3,
                   explicit=self.explicit_update, quant=self.quant_grads,
                   gm_k=self.gm_k, gm_avg=self.gm_avg, remat=self.remat,
                   k_steps=1)


def make_sharded_train_step(model, loss_fn, optimizer, mesh, batch_specs=None,
                            zero_stage=0, remat=False, gradient_merge_k=1,
                            gradient_merge_avg=True, explicit_update=None,
                            quant_grads=False):
    """``loss_fn(model_outputs, labels) -> scalar tensor``; the batch is
    ``(inputs..., labels)``, each array split along its first axis over
    the axes `batch_specs` names (None: ``"dp"`` for every array, JAX's
    ``P("dp")``; or ``("dp", "sharding")``), and with ``("dp", "sp")``
    along its second over ``sp`` (the sequence split)."""
    return ShardedTrainStep(model, loss_fn, optimizer, mesh, batch_specs,
                            zero_stage, remat, gradient_merge_k,
                            gradient_merge_avg,
                            explicit_update=explicit_update,
                            quant_grads=quant_grads)


class LocalSGDTrainStep(_TrainStep):
    """LocalSGD over the dp ranks (reference
    fleet/meta_optimizers/localsgd_optimizer.py:28). Each dp replica keeps
    its own parameters and optimizer state and steps on its rows with no
    gradient sync; every `k_steps`-th step one all-reduce a leaf over the
    dp group averages the parameters. On a hybrid mesh the other axes
    hold each replica as the hybrid path does (mp shards its Megatron
    layers; sp splits its rows' sequence, with ``batch_specs=(("dp",
    "sp"),) * 2``, and averages its gradient over the sp group every
    step). Buffers are averaged every step; the loss is the mean over the
    replicas."""

    _kind = "localsgd"

    def __init__(self, model, loss_fn, optimizer, mesh, k_steps=1,
                 batch_specs=None):
        model, optimizer = _unwrap(model, optimizer)
        if mesh.shape.get("pp", 1) > 1:
            raise ValueError(
                f"LocalSGDTrainStep over {dict(mesh.shape)}: a 'pp' mesh "
                "trains through models/gpt_pipeline.py")
        _sequence_guard(model, mesh, batch_specs)
        self.k = int(k_steps)
        self._open(model, loss_fn, optimizer, mesh, batch_specs,
                   stage3=False, explicit=False, quant=False, gm_k=1,
                   gm_avg=True, remat=False, k_steps=self.k)

    def replica_params(self):
        """Every rank's natural parameters (rank order): the replicas
        diverge between averaging steps."""
        return self._call("gather_replicas")[0]


__all__ = ["LocalSGDTrainStep", "RankJob", "ShardedTrainStep",
           "explicit_update_eligible", "hybrid_collective_budget",
           "make_sharded_train_step", "moe_collective_budget", "run_on_ranks",
           "sp_collective_budget", "train_collective_budget"]
