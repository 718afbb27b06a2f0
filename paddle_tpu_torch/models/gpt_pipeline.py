"""The pipelined GPT: training over ``pp`` x ``mp`` x ``dp`` (the JAX
package's `paddle_tpu/models/gpt_pipeline.py`; BASELINE config 3, GPT-3
1.3B tensor + pipeline parallel), in PyTorch's idiom: one rank a device.

**The model** is the JAX module's, leaf for leaf: the embedding ``wte``
(tied to the head) and ``wpe``; blocks of pre-LN attention and a tanh-GELU
MLP whose weights are in the JAX layout (``x @ w``, ``[in, out]``); the
final norm ``lnf_g``, ``lnf_b``; the mean next-token cross-entropy in
float32. The fused QKV is head-major (``[heads, 3, head_dim]`` columns,
`_block_fn` :69-76), so a contiguous column shard is a whole set of heads
and any mp degree computes the model of mp=1. Attention is causal with
scale 1/sqrt(head_dim) through `ops/common_nn.py`: the flash kernels on
the card, the plain version on the CPU.

**The natural parameters** (what `make_pipelined_gpt` returns, and what
`gather_params` and `weights.from_jax_pipeline_params` /
`to_jax_pipeline_params` carry) are the JAX step's pytree as torch
tensors: ``blocks`` leaves ``[pp, K, ...]`` (K = layers / pp; stage s
holds layers ``s K .. s K + K - 1``), or under the interleaved schedule
``[pp, V, K, ...]`` (entry ``[s, c]`` is virtual stage ``c pp + s``, the
layout of `parallel.pipeline.stack_interleaved_params`), plus ``wte``,
``wpe``, ``lnf_g``, ``lnf_b``. The port cannot draw JAX's ``PRNGKey(0)``:
its own initial weights come from a torch generator (normal times 0.02,
ones and zeros where the JAX module puts them); the tests hand both
packages one set of weights.

**Each rank** (the controller's process is rank 0, the stage-0 rank of dp
replica 0; the others are spawned by the step, `parallel/spmd.py`'s rank
jobs) holds its stage's blocks, mp-sliced (qkv and fc1 on their output
columns, proj and fc2 on their input rows, as the JAX specs shard them),
``wte`` and ``wpe`` on the first stage, ``wte`` and the final norm on the
last. A step: the first stage embeds its dp share of the rows (the
microbatches, ``[M, mb, S, H]``); `parallel.pipeline.make_pipeline_loss`
runs the schedule ("gpipe", "1f1b" or "interleaved") with the final norm,
the tied unembedding and the loss fused into the last stage's backward;
``loss.backward()`` carries the input gradients into the embedding. Then:

- **the tied embedding.** ``wte`` is used twice, as the embedding on the
  first stage and as the unembedding on the last. Its gradient is the sum
  of both uses, summed over the line's first and last rank (one counted
  all-reduce, the mesh's ``"pp_ends"`` group) before the update, or the two
  copies drift apart after the first step (GSPMD gives the JAX step this
  for free);
- **dp**: the loss and every gradient are averaged over the rank's dp
  group (the mean over the dp shares, as the JAX ``_ce`` takes it);
- **mp**: every block's column-parallel input is `copy_to_mp` and its
  row-parallel output `reduce_from_mp` (distributed/fleet/meta_parallel/
  mp_layers.py), which also covers the JAX ``mp_copy`` / ``mp_psum``
  dialect of its 1F1B executor; replicated weights get equal gradients on
  every mp rank;
- **the update** is SGD in float32, ``w - lr g`` (JAX :226-229).

**Departures.** The JAX step threads the parameters through each call
(``loss, params = step(params, ids, labels, lr)``); here they live on the
ranks, so ``step(ids, labels, lr)`` returns the loss, and
`gather_params` / `set_params` read and write the natural parameters. The
JAX module offers "gpipe" and "1f1b"; the port adds "interleaved" with
``n_chunks`` V (the schedule the JAX package runs on its MLP stages).
"""
from __future__ import annotations

import time

import numpy as np
import torch
import torch.nn.functional as F

from .._device import resolve_device
from ..distributed.fleet.meta_parallel.mp_layers import (MPGroup,
                                                         copy_to_mp,
                                                         reduce_from_mp)
from ..ops.common_nn import scaled_dot_product_attention
from ..parallel import spmd
from ..parallel.collectives import all_reduce
from ..parallel.pipeline import (Pipe, make_pipeline_loss,
                                 stack_interleaved_params,
                                 stack_stage_params)

BLOCK_LEAVES = ("ln1_g", "ln1_b", "wqkv", "bqkv", "wproj", "bproj", "ln2_g",
                "ln2_b", "w1", "b1", "w2", "b2")
# the mp-sharded block leaves and the dim (of a [K, ...] chunk) they cut
_COLUMN = ("wqkv", "bqkv", "w1", "b1")     # output columns: the last dim
_ROW = ("wproj", "w2")                     # input rows: dim 1 of [K, in, out]


def _ln(x, g, b, eps=1e-5):
    return F.layer_norm(x, (x.shape[-1],), g, b, eps)


def block_fn(bp, x, n_heads_local, mp=None):
    """One block on this rank's mp shards (the JAX `_block_fn`): x
    ``[mb, s, H]`` replicated over mp."""
    h = _ln(x, bp["ln1_g"], bp["ln1_b"])
    qkv = copy_to_mp(h, mp) @ bp["wqkv"] + bp["bqkv"]      # [mb, s, 3H/mp]
    mb, s, three = qkv.shape
    hd = three // (3 * n_heads_local)
    qkv = qkv.view(mb, s, n_heads_local, 3, hd)
    q, k, v = qkv[:, :, :, 0], qkv[:, :, :, 1], qkv[:, :, :, 2]
    out = scaled_dot_product_attention(q, k, v, is_causal=True)
    proj = reduce_from_mp(out.reshape(mb, s, -1) @ bp["wproj"], mp) \
        + bp["bproj"]
    x = x + proj
    h = _ln(x, bp["ln2_g"], bp["ln2_b"])
    a = F.gelu(copy_to_mp(h, mp) @ bp["w1"] + bp["b1"], approximate="tanh")
    return x + reduce_from_mp(a @ bp["w2"], mp) + bp["b2"]


def stage_fn(stage_params, x, n_heads_local, mp=None):
    """A stage's (or chunk's) K blocks: `stage_params` leaves ``[K,
    ...]``."""
    for i in range(stage_params["wqkv"].shape[0]):
        x = block_fn({k: v[i] for k, v in stage_params.items()}, x,
                     n_heads_local, mp)
    return x


def head_loss(head, y, labels):
    """The final norm, the tied unembedding and the mean cross-entropy in
    float32 (the JAX ``head_loss`` and ``_ce``)."""
    logits = _ln(y, head["lnf_g"], head["lnf_b"]) @ head["wte"].t()
    return F.cross_entropy(logits.float().reshape(-1, logits.shape[-1]),
                           labels.reshape(-1).long())


def embed(wte, wpe, ids):
    """The first stage's prologue: ``wte[ids] + wpe[:s]``."""
    return F.embedding(ids.long(), wte) + wpe[:ids.shape[-1]]


# -- the natural parameters ----------------------------------------------------


def _block_shapes(cfg):
    H, Fd = cfg.hidden_size, cfg.intermediate_size
    return {"ln1_g": (H,), "ln1_b": (H,), "wqkv": (H, 3 * H),
            "bqkv": (3 * H,), "wproj": (H, H), "bproj": (H,),
            "ln2_g": (H,), "ln2_b": (H,), "w1": (H, Fd), "b1": (Fd,),
            "w2": (Fd, H), "b2": (H,)}


def init_params(cfg, pp, n_chunks=1, seed=0, device=None,
                dtype=torch.float32):
    """Natural parameters from a torch generator seeded with `seed`: the
    JAX module's initialisation (normal times 0.02 for the matrices and
    the embeddings, ones for the norms' gains, zeros for the biases), in
    its layout for `pp` stages (and `n_chunks` chunks a stage), on
    `device` (None: the card, as `_device.resolve_device` says)."""
    L = cfg.num_layers
    if L % (pp * n_chunks):
        raise ValueError(f"{L} layers do not split into {pp} stages x "
                         f"{n_chunks} chunks")
    device = resolve_device(device)
    gen = torch.Generator(device=device).manual_seed(int(seed))
    kw = dict(dtype=dtype, device=device)

    def normal(shape):
        return torch.randn(shape, generator=gen, **kw).mul_(0.02)

    layers = {}
    for k, shape in _block_shapes(cfg).items():
        full = (L,) + shape
        layers[k] = (torch.ones(full, **kw) if k.endswith("_g") else
                     normal(full) if k.startswith("w") else
                     torch.zeros(full, **kw))
    H = cfg.hidden_size
    return {"wte": normal((cfg.vocab_size, H)),
            "wpe": normal((cfg.max_seq_len, H)),
            "lnf_g": torch.ones(H, **kw), "lnf_b": torch.zeros(H, **kw),
            "blocks": stage_stack(layers, pp, n_chunks)}


def to_device(params, device, dtype=torch.float32):
    """The natural parameters (tensors or numpy arrays) as `dtype` tensors
    on `device`."""
    def conv(a):
        t = a if torch.is_tensor(a) else torch.from_numpy(np.array(a))
        return t.to(device=device, dtype=dtype)

    return {k: ({n: conv(a) for n, a in v.items()} if k == "blocks"
                else conv(v)) for k, v in params.items()}


def layer_stack(blocks, n_chunks=1):
    """Natural ``blocks`` (``[pp, K, ...]``, or ``[pp, V, K, ...]`` with
    `n_chunks` V > 1) -> ``[L, ...]`` in layer order."""
    out = {}
    for k, a in blocks.items():
        a = a if torch.is_tensor(a) else torch.from_numpy(np.array(a))
        if n_chunks > 1:
            # [pp, V, K] -> [V, pp, K]: virtual stage c * pp + s in order
            a = a.transpose(0, 1)
            out[k] = a.reshape((-1,) + tuple(a.shape[3:]))
        else:
            out[k] = a.reshape((-1,) + tuple(a.shape[2:]))
    return out


def stage_stack(layers, pp, n_chunks=1):
    """``[L, ...]`` layers -> natural ``blocks`` for `pp` stages (and
    `n_chunks` chunks a stage): `parallel.pipeline.stack_stage_params` of
    each stage's K layers, or `stack_interleaved_params` of each virtual
    stage's."""
    layers = {k: a if torch.is_tensor(a) else torch.from_numpy(np.array(a))
              for k, a in layers.items()}
    L = next(iter(layers.values())).shape[0]
    K = L // (pp * n_chunks)
    virtual = [{k: a[g * K:(g + 1) * K] for k, a in layers.items()}
               for g in range(pp * n_chunks)]
    if n_chunks > 1:
        return stack_interleaved_params(virtual, pp)
    return stack_stage_params(virtual)


def _mp_slice(leaf, t, rank, size):
    """Rank `rank`'s slice of a ``[K, ...]`` block leaf over `size` mp
    ranks."""
    if size <= 1 or leaf not in _COLUMN + _ROW:
        return t
    dim = t.dim() - 1 if leaf in _COLUMN else 1
    n = t.shape[dim] // size
    return t.narrow(dim, rank * n, n)


def rank_entries(params, shape, coords, n_chunks=1):
    """``[(key, tensor)]``: what the rank at `coords` ({axis: index}) of a
    mesh of `shape` holds of the natural `params`, in a fixed order
    (``("blocks", chunk, leaf)``, then ``("wte",)``, ``("wpe",)``,
    ``("lnf_g",)``, ``("lnf_b",)`` where the stage holds them)."""
    s, P = coords["pp"], shape["pp"]
    m, mp = coords["mp"], shape["mp"]
    out = []
    for c in range(n_chunks):
        for leaf in BLOCK_LEAVES:
            a = params["blocks"][leaf][s]
            if n_chunks > 1:
                a = a[c]
            out.append((("blocks", c, leaf), _mp_slice(leaf, a, m, mp)))
    if s == 0:
        out += [(("wte",), params["wte"]), (("wpe",), params["wpe"])]
    if s == P - 1:
        if s != 0:
            out.append((("wte",), params["wte"]))
        out += [(("lnf_g",), params["lnf_g"]), (("lnf_b",), params["lnf_b"])]
    return out


def _join(params_like, shape, n_chunks, by_rank):
    """The natural parameters (CPU tensors shaped as `params_like`'s) from
    ``{rank: {key: tensor}}`` of the dp index 0 ranks."""
    from ..distributed.mesh import rank_at

    P, mp = shape["pp"], shape["mp"]
    out = {k: torch.empty(v.shape, dtype=v.dtype)
           for k, v in params_like.items() if k != "blocks"}
    out["blocks"] = {}
    for leaf in BLOCK_LEAVES:
        like = params_like["blocks"][leaf]
        full = torch.empty(like.shape, dtype=like.dtype)
        for s in range(P):
            for c in range(n_chunks):
                parts = [by_rank[rank_at(shape, pp=s, mp=m)][
                    ("blocks", c, leaf)] for m in range(mp)]
                if mp > 1 and leaf in _COLUMN + _ROW:
                    dim = parts[0].dim() - 1 if leaf in _COLUMN else 1
                    whole = torch.cat(parts, dim)
                else:
                    whole = parts[0]
                (full[s, c] if n_chunks > 1 else full[s]).copy_(whole)
        out["blocks"][leaf] = full
    first, last = by_rank[rank_at(shape, pp=0)], by_rank[rank_at(
        shape, pp=P - 1)]
    out["wte"].copy_(first[("wte",)])
    out["wpe"].copy_(first[("wpe",)])
    out["lnf_g"].copy_(last[("lnf_g",)])
    out["lnf_b"].copy_(last[("lnf_b",)])
    return out


# -- one rank's share ----------------------------------------------------------


class _Clock:
    """Per-phase time of a step: CUDA events on the card (read after the
    step's final sync), the host clock on the CPU."""

    def __init__(self, device):
        self.cuda = device.type == "cuda"
        self.spans = []

    def now(self):
        if self.cuda:
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            return ev
        return time.perf_counter()

    def add(self, name, a, b):
        self.spans.append((name, a, b))

    def totals(self):
        out = {}
        for name, a, b in self.spans:
            ms = a.elapsed_time(b) if self.cuda else (b - a) * 1e3
            out[name] = out.get(name, 0.0) + ms
        return out


class _TimedGroup:
    """An mp group whose all-reduces are timed as ``mp_all_reduce`` on a
    step's clock (every other attribute the group's own)."""

    def __init__(self, group):
        self._group = group
        self.clock = None

    def __getattr__(self, name):
        return getattr(self._group, name)

    def all_reduce_(self, t, op="sum"):
        if self.clock is None:
            return self._group.all_reduce_(t, op)
        a = self.clock.now()
        out = self._group.all_reduce_(t, op)
        self.clock.add("mp_all_reduce", a, self.clock.now())
        return out


class _StageJob:
    """One rank's share of a pipelined GPT step (a rank job of
    `parallel/spmd.py`): its stage's weights, its groups and the step."""

    JOB_OPS = frozenset(("step", "collect", "param_bytes"))

    def __init__(self, spec, mesh):
        self.spec = spec
        self.mesh = mesh
        self.device = mesh.device
        self.rank = mesh.rank
        self.shape = dict(mesh.shape)
        self.coords = mesh.coords()
        self.n_chunks = spec["n_chunks"]
        self.dtype = spec["dtype"]
        self.pipe = Pipe.of_mesh(mesh)
        mpg = mesh.axis_group("mp")
        self.mp_timed = None if mpg is None else _TimedGroup(mpg)
        self.mp = (MPGroup(self.mp_timed, self.coords["mp"],
                           self.shape["mp"]) if mpg is not None else None)
        self.dp_group = mesh.axis_group("dp")
        self.ends = mesh.axis_group("pp_ends")
        self.first = self.coords["pp"] == 0
        self.last = self.coords["pp"] == self.shape["pp"] - 1
        self.heads = spec["num_heads"] // self.shape["mp"]
        self.plosses = {}
        self.params = {key: torch.zeros(shp, dtype=self.dtype,
                                        device=self.device,
                                        requires_grad=True)
                       for key, shp in spec["layouts"][self.rank]}
        self.chunks = [{leaf: self.params[("blocks", c, leaf)]
                        for leaf in BLOCK_LEAVES}
                       for c in range(self.n_chunks)]

    @torch.no_grad()
    def load(self, values, scalars):
        for key, v in values.items():
            self.params[key].copy_(v.view(self.params[key].shape))

    def collect(self):
        """Every rank's weights to rank 0 (`spmd.gather_shares`):
        ``{rank: {key: tensor}}`` on rank 0, None elsewhere."""
        return spmd.gather_shares(
            self.mesh, [(k, p.detach()) for k, p in self.params.items()],
            [[(k, s, self.dtype) for k, s in lay]
             for lay in self.spec["layouts"]])

    def param_bytes(self):
        return sum(p.numel() * p.element_size() for p in self.params.values())

    def _ploss(self, schedule):
        if schedule not in self.plosses:
            self.plosses[schedule] = make_pipeline_loss(
                lambda p, x: stage_fn(p, x, self.heads, self.mp), head_loss,
                self.pipe, schedule, self.n_chunks)
        return self.plosses[schedule]

    def step(self, lr, schedule, rows):
        """One step on this rank's rows (``ids, labels``, each ``[M, mb,
        S]``). Returns ``(loss, seconds, peak device bytes, {phase: ms},
        peak in-flight microbatches)``: the phases ``schedule`` (the
        embedding and the whole schedule, which holds ``forward``,
        ``backward``, ``p2p`` (stage-to-stage receives, posts and the
        final waits) and ``mp_all_reduce`` (inside the forward and
        backward spans)), ``grad_reduce`` (dp), ``tied_sum`` and
        ``update``."""
        t0 = time.perf_counter()
        dev = self.device
        clock = _Clock(dev)
        self.pipe.clock = clock
        if self.mp_timed is not None:
            self.mp_timed.clock = clock
        ids, labels = (torch.as_tensor(a).to(dev) for a in rows)
        M, mb, S = ids.shape
        for p in self.params.values():
            p.grad = None
        a = clock.now()
        if self.first:
            x = embed(self.params[("wte",)], self.params[("wpe",)], ids)
        else:
            x = torch.zeros((M, mb, S, self.spec["hidden_size"]),
                            dtype=self.dtype, device=dev)
        head = ({"lnf_g": self.params[("lnf_g",)],
                 "lnf_b": self.params[("lnf_b",)],
                 "wte": self.params[("wte",)]} if self.last else None)
        loss = self._ploss(schedule)(self.chunks if self.n_chunks > 1
                                     else self.chunks[0], head, x, labels)
        loss.backward()
        clock.add("schedule", a, clock.now())
        with torch.no_grad():
            loss = loss.detach().reshape(1).clone()
            a = clock.now()
            dp = self.shape["dp"]
            if dp > 1:
                all_reduce(loss, self.dp_group)
                loss /= dp
                for p in self.params.values():
                    p.grad /= dp
                    all_reduce(p.grad, self.dp_group)
            b = clock.now()
            clock.add("grad_reduce", a, b)
            if self.shape["pp"] > 1 and (self.first or self.last):
                all_reduce(self.params[("wte",)].grad, self.ends)
            c = clock.now()
            clock.add("tied_sum", b, c)
            lr32 = float(np.float32(lr))
            for p in self.params.values():
                p.sub_(p.grad * lr32)
            clock.add("update", c, clock.now())
        out = float(loss[0])
        peak = None
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
            peak = torch.cuda.max_memory_allocated(dev)
        self.pipe.clock = None
        if self.mp_timed is not None:
            self.mp_timed.clock = None
        return (out, time.perf_counter() - t0, peak, clock.totals(),
                self.pipe.peak_in_flight)


# -- the controller ------------------------------------------------------------


class PipelinedGPTStep(spmd.RankJob):
    """The pipelined GPT's train step over `mesh`'s ranks (module
    docstring): ``step(ids, labels, lr)`` trains one step on the global
    batch ``[B, S]`` (B divisible by ``n_microbatches`` x dp) and returns
    the mean loss."""

    def __init__(self, cfg, mesh, n_microbatches, schedule="gpipe",
                 n_chunks=1, params=None, seed=0, dtype=torch.float32):
        if schedule not in ("gpipe", "1f1b", "interleaved"):
            raise ValueError(f"schedule {schedule!r}: 'gpipe', '1f1b' or "
                             "'interleaved'")
        if schedule != "interleaved" and n_chunks != 1:
            raise ValueError("n_chunks > 1 needs schedule='interleaved'")
        pp, mp = mesh.shape["pp"], mesh.shape["mp"]
        if any(mesh.shape[a] > 1 for a in ("sharding", "sp")):
            raise ValueError(f"the pipelined GPT runs over pp, mp and dp; "
                             f"got {dict(mesh.shape)}")
        if cfg.num_layers % (pp * n_chunks):
            raise ValueError(f"{cfg.num_layers} layers over {pp} stages x "
                             f"{n_chunks} chunks")
        if cfg.num_heads % mp:
            raise ValueError(f"{cfg.num_heads} heads over mp={mp}")
        if mesh.device_type == "cuda" and torch.cuda.is_available():
            torch.cuda.set_device(mesh.devices[0])
        self.cfg, self.mesh = cfg, mesh
        self.M = int(n_microbatches)
        self.schedule, self.n_chunks, self.dtype = schedule, n_chunks, dtype
        dev = mesh.devices[0]
        if params is None:
            params = init_params(cfg, pp, n_chunks, seed, dev, dtype)
        self.params_like = to_device(params, "meta", dtype)
        self.last_step = None
        self._job = next(spmd._JOB_IDS)
        self._ranks = spmd._ranks_of(mesh)
        self._replica = None
        layouts = [[(k, tuple(t.shape)) for k, t in rank_entries(
            self.params_like, mesh.shape, mesh.coords(r), n_chunks)]
            for r in range(mesh.size)]
        self._spec = dict(factory=_StageJob, schedule=schedule,
                          n_chunks=n_chunks, dtype=dtype, layouts=layouts,
                          num_heads=cfg.num_heads,
                          hidden_size=cfg.hidden_size)
        self._send(params, opening=True)

    def _send(self, params, opening=False):
        """Give every rank its share of the natural `params`."""
        params = to_device(params, self.mesh.devices[0], self.dtype)
        self._give([rank_entries(params, self.mesh.shape,
                                 self.mesh.coords(r), self.n_chunks)
                    for r in range(self.mesh.size)],
                   self._spec if opening else None)

    def shard_batch(self, ids, labels, n_microbatches=None):
        """Each rank's ``(ids, labels)``, ``[M, mb / dp, S]`` numpy: the
        batch cut into M microbatches of consecutive rows, each split over
        the dp replicas (the JAX ``P(None, "dp", ...)``)."""
        dp = self.mesh.shape["dp"]
        M = self.M if n_microbatches is None else int(n_microbatches)
        out = []
        arrays = [np.asarray(a.cpu() if torch.is_tensor(a) else a)
                  for a in (ids, labels)]
        B = arrays[0].shape[0]
        if B % (M * dp):
            raise ValueError(f"batch of {B} rows does not split into {M} "
                             f"microbatches over {dp} dp ranks")
        for r in range(self.mesh.size):
            d, n = self.mesh.coords(r)["dp"], B // M // dp
            out.append(tuple(a.reshape((M, B // M) + a.shape[1:])
                             [:, d * n:(d + 1) * n] for a in arrays))
        return out

    def step(self, ids, labels, lr, schedule=None, n_microbatches=None):
        """One SGD step at learning rate `lr`; the mean loss. `schedule`
        and `n_microbatches` override the step's for this call ("gpipe"
        and "1f1b" take each other's place; the interleaved layout stays
        interleaved)."""
        schedule = self.schedule if schedule is None else schedule
        if (schedule == "interleaved") != (self.schedule == "interleaved"):
            raise ValueError(f"a {self.schedule!r} step cannot run "
                             f"{schedule!r}: the weights' layout differs")
        rows = self.shard_batch(ids, labels, n_microbatches)
        res = self._call("step", float(lr), schedule, per_rank=rows)
        self.last_step = [{"seconds": s, "peak_bytes": pk, "phases_ms": ph,
                           "peak_in_flight": fl}
                          for _, s, pk, ph, fl in res]
        return res[0][0]

    __call__ = step

    def gather_params(self):
        """The natural parameters (CPU tensors)."""
        by_rank = self._call("collect")[0]
        return _join(self.params_like, self.mesh.shape, self.n_chunks,
                     by_rank)

    def set_params(self, params):
        """Load natural parameters (tensors or numpy arrays in the layout
        of this step's stages) onto the ranks."""
        self._send(params)

    def param_bytes(self):
        """Bytes of weights each rank holds (rank order)."""
        return self._call("param_bytes")


def make_pipelined_gpt(cfg, mesh, n_microbatches, schedule="gpipe",
                       n_chunks=1, seed=0, params=None, dtype=torch.float32):
    """``(params, train_step)``: the natural initial parameters (module
    docstring; drawn from `seed` unless `params` is given) and the step
    over `mesh` (`PipelinedGPTStep`), which holds them on its ranks."""
    if params is None:
        params = init_params(cfg, mesh.shape["pp"], n_chunks, seed,
                             mesh.devices[0], dtype)
    return params, PipelinedGPTStep(cfg, mesh, n_microbatches, schedule,
                                    n_chunks, params, seed, dtype)


def pipeline_collective_budget(cfg, shape, n_microbatches, stage,
                               n_chunks=1):
    """One step's counted calls on a rank of stage `stage` of a mesh of
    `shape`, as arithmetic: ``send`` / ``recv``, one a microbatch for each
    chunk with a next (previous) virtual stage, forward and backward;
    ``all-reduce``: the loss over the stage line (pp > 1), 4 a layer and
    microbatch at mp > 1 (the two column-parallel inputs' gradients and the
    two row-parallel sums), the tied embedding's sum on the first and last
    stage (pp > 1), and at dp > 1 the loss and one a weight."""
    P, mp, dp = shape["pp"], shape["mp"], shape["dp"]
    M, V = int(n_microbatches), int(n_chunks)
    VP = V * P
    gs = [c * P + stage for c in range(V)]
    fwd = sum(g < VP - 1 for g in gs)
    bwd = sum(g > 0 for g in gs)
    layers = cfg.num_layers // P
    ar = (P > 1) + (4 * layers * M if mp > 1 else 0)
    ends = stage in (0, P - 1)
    ar += int(P > 1 and ends)
    if dp > 1:
        n = len(BLOCK_LEAVES) * V + 2 * (stage == 0)
        if stage == P - 1:
            n += 3 if P > 1 else 2          # (wte,) lnf_g, lnf_b
        ar += 1 + n
    return {"all-reduce": ar, "all-gather": 0, "reduce-scatter": 0,
            "all-to-all": 0, "send": M * (fwd + bwd), "recv": M * (fwd + bwd)}


__all__ = ["PipelinedGPTStep", "block_fn", "head_loss", "init_params",
           "layer_stack", "make_pipelined_gpt", "pipeline_collective_budget",
           "rank_entries", "stage_fn", "stage_stack"]
