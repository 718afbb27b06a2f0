"""Mixture of Experts with expert parallelism (the JAX package's
`paddle_tpu/distributed/moe.py`, in PyTorch's idiom).

**Routing** is the JAX package's: top-1 by ``argmax`` of the router's
softmax (the first index on a tie), a token's slot in its expert the
count of earlier tokens routed there (``cumsum(onehot) * onehot - 1``),
and a token whose slot is at or beyond the capacity ``ceil(cf * T / E)``
dropped: it adds nothing to its expert's input and nothing to the output.
`NaiveGate`, `SwitchGate` and `GShardGate` share that routing; GShard's
top-2 is dispatched top-1, as the JAX package does it (ROADMAP Queue 3).

**The layer** (`MoELayer`) runs each expert's MLP, ``gelu_tanh(x w1 +
b1) w2 + b2`` on its ``[C, H]`` slots, as one batched product over the
stacked ``[E, ...]`` weights. The JAX package packs and unpacks the
slots with two dense one-hot tensors (`_dense_dispatch`: ``[E, C, H]``
and ``[T, E, C]``) and contracts them in einsums, which at gpt_1p3b's
widths spends half again the experts' own operations on zeros. Here a
token is written into its slot and its output read back by index (the
same values: a sum of zeros and one product is that product); the dense
form stays as `dense_moe`, the tests' and the card's oracle.

**Expert parallelism** (`ep_axis="mp"`, the JAX default). On a train
step over a mesh with ``mp`` above 1 (parallel/spmd.py), each mp rank
holds ``E / mp`` of the experts (``w1``, ``b1``, ``w2``, ``b2`` cut on
dim 0, the ``sharding_axes`` the JAX package annotates them with), and
the router stays whole. The mp peers of a row share see the same tokens
and route them alike; each runs its own experts' slots and adds its
tokens' outputs, and one all-reduce over the mp group sums the ranks'
outputs (one rank holds each token's expert, so the sum is exact).
Backward, a rank sees only its own tokens' share of two gradients of
replicated values: the dispatch's into x and the combine's into the
router's probabilities. Both ride one ``[T, H + 1]`` all-reduce over the
group (`copy_to_mp` of x beside the kept probabilities), once; the
Switch loss's gradient into the router is whole on every rank and is not
summed.

**Capacity over the global batch.** JAX's GSPMD step routes the whole
batch in one program, so a token's slot counts every earlier token of
the batch: at a row split (dp, or dp x sharding) a rank's tokens take
their slots after those the lower row shares routed to the same expert,
and ``T`` in the capacity is the global count. `shard_rows` gives the
layer the row groups of the step; each forward all-gathers the ``[E]``
routed counts over each (one call a row axis) and offsets the slots by
the lower shares' counts. The JAX explicit ZeRO step and LocalSGD run a
replica's program on its shard (shard_map, vmap), so their capacity is
the shard's, and the port gives those steps no row groups.
`aux_loss` is the rank's tokens' Switch loss (the step's loss does not
read it).

`moe_alltoall_block` is the JAX package's functional block for code that
runs on every rank of an expert group itself: the tokens for each rank's
experts go there by one counted `all_to_all` (`AllToAll`, whose backward
is the reverse exchange), and the outputs come back by another.
"""
from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from .._device import resolve_device
from ..parallel.collectives import all_gather, all_to_all
from .fleet.meta_parallel.mp_layers import active, copy_to_mp, reduce_from_mp


def expert_capacity(capacity_factor, tokens, num_experts):
    """Slots an expert: ``ceil(cf * T / E)`` in the JAX package's float
    expression."""
    return int(np.ceil(capacity_factor * tokens / num_experts))


def route(gates, capacity, offset=None):
    """Top-1 routing of ``[T, E]`` router probabilities: ``(expert [T],
    slot [T], keep [T], prob [T])``. A token's slot is the count of earlier
    tokens routed to its expert, plus ``offset[expert]`` (the lower row
    shares' counts, `MoELayer.shard_rows`); it is kept while the slot is
    below `capacity`, and `prob` is its router probability, 0 where
    dropped."""
    expert = torch.argmax(gates, -1)
    onehot = F.one_hot(expert, gates.shape[-1])
    slot = (torch.cumsum(onehot, 0) * onehot).sum(-1) - 1
    if offset is not None:
        slot = slot + offset[expert]
    keep = slot < capacity
    prob = gates.gather(-1, expert[:, None])[:, 0]
    return expert, slot, keep, torch.where(keep, prob, torch.zeros_like(prob))


def _dense_dispatch(x, gates, capacity):
    """The JAX package's dense dispatch: x ``[T, H]``, gates ``[T, E]`` ->
    (dispatched ``[E, C, H]``, combine ``[T, E, C]``). A dropped token
    adds zero at its expert's last slot and writes a zero weight there."""
    T, E = gates.shape
    expert, slot, keep, prob = route(gates, capacity)
    pos = slot.clamp(0, capacity - 1)
    disp = x.new_zeros((E, capacity) + tuple(x.shape[1:])).index_put(
        (expert, pos), torch.where(keep[:, None], x, torch.zeros_like(x)),
        accumulate=True)
    combine = gates.new_zeros((T, E, capacity)).index_put(
        (torch.arange(T, device=x.device), expert, pos), prob)
    return disp, combine


def expert_mlp(disp, w1, b1, w2, b2):
    """Each expert's MLP on its ``[C, H]`` slots: ``gelu_tanh(disp w1 +
    b1) w2 + b2`` (jax.nn.gelu's default is the tanh form)."""
    h = F.gelu(torch.bmm(disp, w1) + b1[:, None], approximate="tanh")
    return torch.bmm(h, w2) + b2[:, None]


def dispatch(x, expert, slot, keep, n_experts, capacity):
    """The indexed dispatch of x ``[T, H]`` into ``n_experts`` experts'
    slots: ``(disp [n_experts, C, H], dest [T])``, each kept token written
    at ``expert * C + slot`` of `dest`, every other token (dropped, or
    routed to an expert outside ``[0, n_experts)``) at ``n_experts * C``,
    a row that is cut off."""
    n = n_experts * capacity
    dest = torch.where(keep & (expert >= 0) & (expert < n_experts),
                       expert * capacity + slot, torch.full_like(slot, n))
    disp = x.new_zeros((n + 1, x.shape[-1])).index_put((dest,), x)[:n]
    return disp.view(n_experts, capacity, -1), dest


def combine(eout, dest, prob):
    """Each token's expert output ``[T, H]``: its slot's row of `eout`
    scaled by `prob`, zero where `dest` is the cut-off row."""
    n = eout.shape[0] * eout.shape[1]
    rows = eout.reshape(n, -1)[dest.clamp(max=n - 1)]
    return rows * torch.where(dest < n, prob, torch.zeros_like(prob))[:, None]


def dense_moe(x, gates, w1, b1, w2, b2, capacity):
    """The JAX package's whole layer in its dense form (`_dense_dispatch`,
    the experts, the ``tec,ech->th`` combine): the oracle of the indexed
    form (`dispatch`, `combine`) `MoELayer` runs."""
    disp, comb = _dense_dispatch(x, gates, capacity)
    return torch.einsum("tec,ech->th", comb,
                        expert_mlp(disp, w1, b1, w2, b2))


def switch_aux_loss(gates, expert):
    """The Switch Transformer's load-balancing loss, ``E * sum_e f_e P_e``
    (f_e the share of tokens routed to e, P_e its mean probability)."""
    E = gates.shape[-1]
    frac = F.one_hot(expert, E).to(gates.dtype).mean(0)
    return E * torch.sum(frac * gates.mean(0))


def _xavier_uniform_(t, generator):
    """The JAX package's XavierUniform: a 2-D ``[in, out]`` weight's fans
    are its dims; a stacked ``[E, in, out]`` one's are ``in * out`` and
    ``E * out``."""
    shape = t.shape
    if t.dim() > 2:
        rf = int(np.prod(shape[2:]))
        fi, fo = shape[1] * rf, shape[0] * rf
    else:
        fi, fo = shape[0], shape[1]
    limit = math.sqrt(6.0 / (fi + fo))
    return t.uniform_(-limit, limit, generator=generator)


class NaiveGate(nn.Module):
    """The linear router (reference moe/gate/naive_gate.py): ``softmax(x
    gate)`` over the experts, `gate` ``[d_model, E]`` cast to x's dtype in
    the product. Drawn on `device` (None: the card) from a generator
    seeded with `seed`."""

    has_aux_loss = False

    def __init__(self, d_model, num_experts, topk=1, device=None,
                 dtype=torch.float32, seed=0):
        super().__init__()
        device = resolve_device(device)
        self.gate = nn.Parameter(torch.zeros((d_model, num_experts),
                                             device=device, dtype=dtype))
        self.topk = topk
        if device.type != "meta":
            g = torch.Generator(device=device).manual_seed(int(seed))
            with torch.no_grad():
                _xavier_uniform_(self.gate, g)

    def gate_fn(self, x):
        return torch.softmax(x @ self.gate.to(x.dtype), -1)


class SwitchGate(NaiveGate):
    """Top-1 routing with the load-balancing loss (reference
    switch_gate.py; `MoELayer.aux_loss`)."""

    has_aux_loss = True


class GShardGate(NaiveGate):
    """GShard's router (reference gshard_gate.py): top-2 by its `topk`,
    dispatched top-1 as the JAX package does."""

    def __init__(self, d_model, num_experts, topk=2, device=None,
                 dtype=torch.float32, seed=0):
        super().__init__(d_model, num_experts, topk, device, dtype, seed)


GATES = {"naive": NaiveGate, "switch": SwitchGate, "gshard": GShardGate}


class MoELayer(nn.Module):
    """Router -> experts -> combine (module docstring). Stacked expert
    weights ``w1 [E, d, f]``, ``b1 [E, f]``, ``w2 [E, f, d]``, ``b2 [E,
    d]`` annotated ``(ep_axis, ...)``; the forward takes ``[..., d]`` and
    sets `aux_loss` to the Switch loss whatever the gate. Weights are
    drawn on `device` (None: the card) from generators seeded with `seed`
    (the router's with ``seed + 1``), with the JAX package's
    initialisers; the biases are zero."""

    def __init__(self, d_model, d_hidden, num_experts, gate="naive",
                 capacity_factor=1.25, ep_axis="mp", device=None,
                 dtype=torch.float32, seed=0):
        super().__init__()
        device = resolve_device(device)
        self.d_model = d_model
        self.num_experts = num_experts
        self.capacity_factor = capacity_factor
        self.ep_axis = ep_axis
        E = num_experts

        def param(*shape):
            return nn.Parameter(torch.zeros(shape, device=device,
                                            dtype=dtype))

        self.w1 = param(E, d_model, d_hidden)
        self.b1 = param(E, d_hidden)
        self.w2 = param(E, d_hidden, d_model)
        self.b2 = param(E, d_model)
        self.gate = GATES[gate](d_model, E, device=device, dtype=dtype,
                                seed=seed + 1)
        for p in (self.w1, self.b1, self.w2, self.b2):
            p.sharding_axes = (ep_axis,) + (None,) * (p.dim() - 1)
        if device.type != "meta":
            g = torch.Generator(device=device).manual_seed(int(seed))
            with torch.no_grad():
                for w in (self.w1, self.w2):
                    _xavier_uniform_(w, g)
        self.mp = None
        self.row_groups = ()
        self.aux_loss = None

    def __getstate__(self):
        # the last forward's loss is a graph's output: not copied (a
        # skeleton, `nn.layer.meta_copy`, deep-copies the module)
        return dict(self.__dict__, aux_loss=None)

    @property
    def mp_dims(self):
        """{leaf: dim} of the leaves an ``mp`` train step cuts over its mp
        ranks (mp_layers.py `shard_for_mp`): the experts' dim 0 when they
        lie on ``mp``."""
        if self.ep_axis != "mp":
            return {}
        return {"w1": 0, "b1": 0, "w2": 0, "b2": 0}

    def shard_rows(self, groups):
        """Route over the global batch of a step whose rows split over
        `groups` (the `RankGroup` of each row axis above 1, major first):
        the capacity counts every share's tokens, and this share's slots
        follow the lower shares'."""
        self.row_groups = tuple(groups)

    def _row_offset(self, gates):
        """(the row shares' count, ``[E]`` slots the lower shares filled
        in each expert): one counted all-gather of this share's routed
        counts a row group."""
        counts = F.one_hot(torch.argmax(gates, -1), gates.shape[-1]).sum(0)
        every = counts[None]
        for g in reversed(self.row_groups):
            every = all_gather(every, g).reshape(-1, counts.shape[0])
        index = 0
        for g in self.row_groups:
            index = index * g.size + g.rank
        return every.shape[0], every[:index].sum(0)

    def forward(self, x):
        shape = x.shape
        flat = x.reshape(-1, shape[-1])
        E = self.num_experts
        gates = self.gate.gate_fn(flat)
        shares, offset = 1, None
        if self.row_groups:
            shares, offset = self._row_offset(gates)
        capacity = expert_capacity(self.capacity_factor,
                                   flat.shape[0] * shares, E)
        expert, slot, keep, prob = route(gates, capacity, offset)
        self.aux_loss = switch_aux_loss(gates, expert)
        mp = self.mp if active(self.mp) else None
        e_local = self.w1.shape[0]
        if mp is not None:
            # one backward all-reduce carries both partial gradients
            both = copy_to_mp(torch.cat([flat, prob[:, None]], -1), mp)
            flat, prob = both[:, :-1], both[:, -1]
            expert = expert - mp.rank * e_local
        disp, dest = dispatch(flat, expert, slot, keep, e_local, capacity)
        out = combine(expert_mlp(disp, self.w1, self.b1, self.w2, self.b2),
                      dest, prob)
        if mp is not None:
            out = reduce_from_mp(out.float(), mp).to(x.dtype)
        return out.reshape(shape)


class AllToAll(torch.autograd.Function):
    """The counted `all_to_all` of ``[size, ...]`` rows over `group`
    (row j to rank j); backward, the reverse exchange of the gradient
    (what rank j received from this rank comes back as the gradient of
    what this rank sent it)."""

    @staticmethod
    def forward(ctx, t, group):
        ctx.group = group
        return all_to_all(t, group)

    @staticmethod
    def backward(ctx, g):
        return all_to_all(g.contiguous(), ctx.group), None


def moe_alltoall_block(x, gate_w, w1, b1, w2, b2, group,
                       capacity_factor=1.25):
    """The functional MoE block over an expert group (JAX
    `moe_alltoall_block`), run by every rank of `group` on its own tokens
    x ``[T, H]``: its local experts' weights ``[E_local, ...]`` (rank r
    holds experts ``[r E_local, (r + 1) E_local)``) and the whole router
    `gate_w` ``[H, E]``. The capacity is the rank's, ``ceil(cf T / E)``.
    Each rank's dispatch ``[E, C, H]`` goes out by one `AllToAll`; a rank
    receives ``[E_local, n_ep, C, H]`` (every rank's slots for its
    experts), runs them, and the outputs ``[n_ep, E_local, C, H]`` come
    back by another; the combine reads each token's slot. Returns ``[T,
    H]``; the gradients of every input flow back through both
    exchanges."""
    e_local, n_ep = w1.shape[0], group.size
    E, H = e_local * n_ep, x.shape[-1]
    capacity = expert_capacity(capacity_factor, x.shape[0], E)
    gates = torch.softmax(x @ gate_w.to(x.dtype), -1)
    expert, slot, keep, prob = route(gates, capacity)
    disp, dest = dispatch(x, expert, slot, keep, E, capacity)
    recv = AllToAll.apply(disp.view(n_ep, e_local, capacity, H), group)
    recv = recv.transpose(0, 1)            # [E_local, n_ep, C, H], JAX's
    eout = expert_mlp(recv.reshape(e_local, n_ep * capacity, H),
                      w1, b1, w2, b2)
    eout = eout.view(e_local, n_ep, capacity, H).transpose(0, 1)
    back = AllToAll.apply(eout.contiguous(), group)  # [n_ep, E_local, C, H]
    return combine(back.reshape(E, capacity, H), dest, prob)


__all__ = ["AllToAll", "GShardGate", "MoELayer", "NaiveGate", "SwitchGate",
           "combine", "dense_moe", "dispatch", "expert_capacity",
           "expert_mlp", "moe_alltoall_block", "route", "switch_aux_loss"]
