"""Meta-parallel model and optimizer wrappers (the JAX package's
`paddle_tpu/distributed/fleet/meta_parallel/parallel_wrappers.py`:
reference meta_parallel/tensor_parallel.py:27,
dygraph_optimizer/hybrid_parallel_optimizer.py:186,
hybrid_parallel_gradscaler.py:24).

`PipelineParallel` runs a `PipelineLayer`'s homogeneous trunk as a 1F1B
pipeline over the mesh's ``pp`` ranks (its docstring). As in the JAX
package the other model wrappers mark intent: the train step over
the mesh (parallel/spmd.py) does the partitioning and the gradient sync,
and takes a wrapped model and optimizer through their inner ones
(``_layers``, ``_inner_opt``), so parameter names and state keys are the
inner model's. A wrapped model's eager forward is the inner model's; the
global-norm clip of a `HybridParallelOptimizer` inside the step sums over
the mp and sharding groups (nn/clip.py).

`HybridParallelOptimizer` runs the strategy's meta-optimizers as the JAX
wrapper does eagerly: ``lars`` swaps a Momentum for `Lars`, ``dgc`` for
`DGCMomentum` (other rules pass through), ``gradient_merge`` accumulates
k steps of gradients before one inner step (averaged with ``avg``), and
``localsgd`` averages the parameters over the dp group every k inner
steps (every step before ``begin_step``) where every rank of a running
mesh runs the step (`DeviceMesh.in_step`: a rank's share of a job). The
controller between jobs steps the one set of weights it holds: no
replicas to average, as the JAX wrapper does at world size 1. A train
step built over the wrapper takes its inner rule (after the swaps).

`HybridParallelGradScaler`: in the JAX package gradients are global
arrays, so the wrapper only delegates. Here a rank's share of a job sees
only its own gradients, so after `unscale_` the found-inf flag is
all-reduced (MAX, counted) over every hybrid group of degree above 1
(dp, sharding, pp, mp) of the rank's mesh, and every rank then skips or
steps together. The controller between jobs holds every gradient it
steps on (`PipelineParallel` gathers them) and decides alone. The scaler
sees the wrapped optimizer itself, not its inner one (JAX :300-307), so
``unscale_`` then ``step`` divides once.
"""
from __future__ import annotations

import numpy as np
import torch
from torch import nn

from ....parallel.spmd import RankJob


class _Wrapper(nn.Module):
    def __init__(self, layers):
        super().__init__()
        self._layers = layers

    def forward(self, *inputs, **kwargs):
        return self._layers(*inputs, **kwargs)

    def state_dict(self, *a, **k):
        return self._layers.state_dict(*a, **k)

    def set_state_dict(self, sd, *a, **k):
        return self._layers.load_state_dict(sd, *a, **k)


class DataParallel(_Wrapper):
    """A data-parallel marker (the JAX `distributed.DataParallel`): the
    train step all-reduces the gradients over dp."""

    def __init__(self, layers, strategy=None, comm_buffer_size=25,
                 last_comm_buffer_size=1, find_unused_parameters=False,
                 group=None):
        super().__init__(layers)
        self.find_unused_parameters = find_unused_parameters


class TensorParallel(_Wrapper):
    """A tensor-parallel marker (reference tensor_parallel.py:27)."""

    def __init__(self, layers, hcg, strategy=None):
        super().__init__(layers)
        self._hcg = hcg


def _signature(layer):
    """What makes two trunk layers the same stage body: the class name,
    each parameter's name, shape and dtype, and whether it has parameters
    and no buffers (the JAX `_trunk_partition`'s test)."""
    if not isinstance(layer, nn.Module):
        return None
    params = list(layer.named_parameters())
    buffers = list(layer.named_buffers())
    return (type(layer).__name__,
            tuple(sorted((n, tuple(p.shape), str(p.dtype))
                         for n, p in params)),
            bool(params) and not buffers)


def _functional(layer, params, x):
    return torch.func.functional_call(layer, params, (x,))


class _PipeStageJob:
    """One rank's share of `PipelineParallel`'s pipeline (a rank job of
    parallel/spmd.py): on the first stage the prologue, its stage's
    trunk layers (one template module called with each layer's weights),
    on the last the epilogue and the loss. Every weight is a leaf tensor
    and every buffer of the ends a plain one, loaded from the controller
    before each batch (keys ``(kind, layer index, name)``, the ends'
    buffers of kind ``"pro_buf"`` / ``"epi_buf"``)."""

    JOB_OPS = frozenset(("step", "collect_grads"))

    def __init__(self, spec, mesh):
        from ....parallel.pipeline import Pipe, make_pipeline_loss

        self.spec, self.mesh = spec, mesh
        self.device = mesh.device
        self.pipe = Pipe.of_mesh(mesh)
        s, P = self.pipe.stage, self.pipe.n_stages
        self.first, self.last = s == 0, s == P - 1
        self.template = spec["template"].to_empty(device=self.device)
        self.pro = [m.to_empty(device=self.device) for m in spec["prologue"]]
        self.epi = [m.to_empty(device=self.device) for m in spec["epilogue"]]
        self.loss_layer = spec["loss"]
        self.layout = spec["layouts"][mesh.rank]
        self.params = {key: torch.zeros(shape, dtype=dtype,
                                        device=self.device,
                                        requires_grad=not _is_buffer(key))
                       for key, shape, dtype in self.layout}
        self.ploss = make_pipeline_loss(self._stage, self._head, self.pipe,
                                        "1f1b")

    def _group(self, kind, n):
        """``{name: tensor}`` of layer j of `kind`, for j < n."""
        return [{key[2]: t for key, t in self.params.items()
                 if key[0] == kind and key[1] == j} for j in range(n)]

    def _stage(self, layers, x):
        for lp in layers:
            x = _functional(self.template, lp, x)
        return x

    def _head(self, head, y, label):
        # the schedule takes the epilogue's weights; its buffers stay ours
        bufs = self._group("epi_buf", len(self.epi))
        for layer, lp, bp in zip(self.epi, head, bufs):
            y = _functional(layer, {**lp, **bp}, y)
        if self.loss_layer is None:
            return y.mean()
        loss = self.loss_layer(y, label)
        return loss if loss.numel() == 1 else loss.mean()

    @torch.no_grad()
    def load(self, values, scalars):
        for key, v in values.items():
            self.params[key].copy_(v.view(self.params[key].shape))

    def step(self, act, rows):
        ins, labs = (torch.as_tensor(a).to(self.device) for a in rows)
        M = self.spec["M"]
        for p in self.params.values():
            p.grad = None
        if self.first:
            h, n = ins, len(self.pro)
            for layer, lp, bp in zip(self.pro, self._group("pro", n),
                                     self._group("pro_buf", n)):
                h = _functional(layer, {**lp, **bp}, h)
            x = h.reshape((M, h.shape[0] // M) + tuple(h.shape[1:]))
        else:
            x = torch.zeros(act[0], dtype=act[1], device=self.device)
        head = self._group("epi", len(self.epi)) if self.last else None
        labels = labs.reshape((M, labs.shape[0] // M)
                              + tuple(labs.shape[1:]))
        loss = self.ploss(self._group("trunk", self.spec["K"]), head, x,
                          labels)
        loss.backward()
        return float(loss.detach())

    def collect_grads(self):
        """Every rank's weight gradients and end buffers to rank 0
        (`spmd.gather_shares`): ``{rank: {key: tensor}}`` on rank 0."""
        from ....parallel import spmd

        mine = [(k, self.params[k].detach() if _is_buffer(k)
                 else self.params[k].grad if self.params[k].grad is not None
                 else torch.zeros_like(self.params[k]))
                for k, _, _ in self.layout]
        return spmd.gather_shares(self.mesh, mine, self.spec["layouts"])


def _is_buffer(key):
    return key[0].endswith("_buf")


class _Pipeline(RankJob):
    """`PipelineParallel`'s pipeline over the hcg mesh's ranks: the
    controller's weights and the ends' buffers go to the ranks before
    each batch, the ranks run 1F1B, and their gradients come back into the
    controller's parameters' ``.grad`` (and the ends' buffers, a
    normalisation's running statistics, into its buffers)."""

    def __init__(self, prologue, trunk, epilogue, loss, mesh, M):
        from ....nn.layer import meta_copy
        from ....parallel import spmd

        self.mesh, self.M = mesh, M
        P = mesh.shape["pp"]
        self.K = len(trunk) // P
        self.layers = {"pro": prologue, "trunk": trunk, "epi": epilogue}
        self.layouts = [[(k, tuple(t.shape), t.dtype)
                         for k, t in self._entries(r)]
                        for r in range(mesh.size)]
        self.spec = dict(factory=_PipeStageJob, M=M, K=self.K,
                         template=meta_copy(trunk[0]),
                         prologue=[meta_copy(m) for m in prologue],
                         epilogue=[meta_copy(m) for m in epilogue],
                         loss=loss, layouts=self.layouts)
        # the prologue again on the meta device, for the activation's shape
        # (rank 0's stage builds its own prologue from the spec's in place)
        self._meta_pro = [meta_copy(m) for m in prologue]
        self._job = next(spmd._JOB_IDS)
        self._ranks = spmd._ranks_of(mesh)
        self._replica = None

    def _tensors(self, kind, j):
        """``{key: tensor}`` of layer j of `kind`: its weights, and the
        ends' buffers."""
        layer = (self.layers["trunk"][j] if kind == "trunk"
                 else self.layers[kind][j])
        out = {(kind, j, n): p for n, p in layer.named_parameters()}
        if kind != "trunk":
            out.update({(kind + "_buf", j, n): b
                        for n, b in layer.named_buffers()})
        return out

    def _entries(self, r):
        """Rank `r`'s ``[(key, tensor)]`` of the controller's weights and
        buffers (trunk keys count from the stage's first layer)."""
        s, P = self.mesh.coords(r)["pp"], self.mesh.shape["pp"]
        out = []
        if s == 0:
            for j in range(len(self.layers["pro"])):
                out += self._tensors("pro", j).items()
        for i in range(self.K):
            out += [(("trunk", i, k[2]), t) for k, t in
                    self._tensors("trunk", s * self.K + i).items()]
        if s == P - 1:
            for j in range(len(self.layers["epi"])):
                out += self._tensors("epi", j).items()
        return [(k, t.detach()) for k, t in out]

    def _act(self, ins):
        """The trunk's input, ``([M, rows / M, ...], dtype)``: the
        prologue run on the meta device."""
        with torch.no_grad():
            h = ins.to("meta")
            for m in self._meta_pro:
                h = m(h)
        return (self.M, h.shape[0] // self.M) + tuple(h.shape[1:]), h.dtype

    def __call__(self, ins, labs):
        from ....distributed.mesh import rank_at

        act = self._act(ins)
        dev = self.mesh.devices[0]
        self._give([[(k, t.to(dev)) for k, t in self._entries(r)]
                    for r in range(self.mesh.size)],
                   self.spec if self._replica is None else None)
        rows = [(ins.detach().cpu().numpy(), labs.detach().cpu().numpy())
                ] * self.mesh.size
        loss = self._call("step", act, per_rank=rows)[0]
        grads = self._call("collect_grads")[0]
        for s in range(self.mesh.shape["pp"]):
            for key, g in grads[rank_at(self.mesh.shape, pp=s)].items():
                kind, j, name = key
                if kind == "trunk":
                    j = s * self.K + j
                t = self._tensors(kind.removesuffix("_buf"), j)[
                    (kind, j, name)]
                g = g.to(t.device, t.dtype)
                if _is_buffer(key):
                    with torch.no_grad():
                        t.copy_(g)
                else:
                    t.grad = g if t.grad is None else t.grad + g
        return loss


class PipelineParallel(_Wrapper):
    """The pipeline-parallel wrapper (reference pipeline_parallel.py:31;
    JAX :37-275). When the wrapped `PipelineLayer`'s middle is a
    homogeneous trunk whose length the pp degree divides (the usual
    ``[embed, N x block, head]``), `train_batch` runs it as a 1F1B
    pipeline over the hcg mesh's ``pp`` ranks (parallel/pipeline.py):
    the prologue on the first stage trains through the schedule's input
    gradients, the epilogue and the loss run fused into the last stage's
    backward, and every gradient comes back into the controller's
    parameters, where the user's optimizer steps (so a global-norm clip
    sees every stage's gradients, each tied weight once, as the JAX
    wrapper's global arrays do). The ends' buffers (a normalisation's
    running statistics, a position table) go down with the weights and
    come back with the gradients. The controller keeps the whole model
    and its optimizer state: each batch ships every stage's weights down
    and every gradient back through the host, so this wrapper spreads
    the work of a step and not its memory (the pipelined GPT,
    models/gpt_pipeline.py, keeps each stage's weights and update on its
    rank). A model without such a trunk falls back to sequential
    microbatch accumulation, with the JAX warning: the JAX semantics, no
    device fallback."""

    def __init__(self, layers, hcg, strategy):
        super().__init__(layers)
        self._hcg = hcg
        self._strategy = strategy
        cfg = strategy.pipeline_configs if strategy else {}
        self.accumulate_steps = cfg.get("accumulate_steps", 1)
        self.micro_batch_size = cfg.get("micro_batch_size", 1)
        self.total_loss = None
        self._pipe = None

    def _trunk_partition(self):
        """(prologue, trunk, epilogue): the longest run of identical
        parameterised layers, when the pp degree divides its length."""
        funcs = list(getattr(self._layers, "_funcs", []))
        pp = self._hcg.get_pipe_parallel_world_size() if self._hcg else 1
        if not funcs or pp <= 1:
            return None
        sigs = [_signature(m) for m in funcs]
        best, i = (0, 0), 0
        while i < len(sigs):
            if sigs[i] is None or not sigs[i][2]:
                i += 1
                continue
            j = i
            while j < len(sigs) and sigs[j] == sigs[i]:
                j += 1
            if j - i > best[1] - best[0]:
                best = (i, j)
            i = j
        start, end = best
        n = end - start
        if n < pp or n % pp:
            return None
        rest = funcs[:start] + funcs[end:]
        if any(not isinstance(m, nn.Module) for m in rest):
            return None
        return funcs[:start], funcs[start:end], funcs[end:]

    def _build_pipe(self):
        part = self._trunk_partition()
        if part is None:
            return None
        prologue, trunk, epilogue = part
        return _Pipeline(prologue, trunk, epilogue,
                         getattr(self._layers, "_loss_fn", None),
                         self._hcg.mesh, self.accumulate_steps)

    def train_batch(self, data, optimizer, lr_scheduler=None, scaler=None):
        """One optimizer step over ``accumulate_steps`` microbatches: the
        pipeline when the model has a pipelineable trunk, else sequential
        accumulation (the reference's semantics either way). Returns the
        mean loss. `scaler` is taken and not read, as in the JAX
        package."""
        inputs, labels = data
        n = self.accumulate_steps
        ins = inputs[0] if isinstance(inputs, (list, tuple)) else inputs
        lab = labels[0] if isinstance(labels, (list, tuple)) else labels
        batch_ok = (torch.is_tensor(ins) and ins.shape[0] % n == 0
                    and (not torch.is_tensor(lab) or lab.shape[0] % n == 0))
        if self._pipe is None and self._hcg is not None and batch_ok:
            self._pipe = self._build_pipe() or False
            if self._pipe is False:
                import warnings

                warnings.warn(
                    "PipelineParallel: model has no homogeneous trunk whose "
                    "length divides the pp degree; train_batch falls back "
                    "to sequential microbatch accumulation (no pipeline "
                    "speedup).")
        if self._pipe and batch_ok:
            loss = torch.tensor(self._pipe(ins, lab))
        else:
            total = None
            for x, y in zip(_split_batch(inputs, n), _split_batch(labels,
                                                                  n)):
                out = self._layers(x)
                loss = (self._layers.loss(out, y)
                        if hasattr(self._layers, "loss") else out)
                if loss.numel() != 1:
                    loss = loss.mean()
                (loss * (1.0 / n)).backward()
                total = loss.detach() if total is None else \
                    total + loss.detach()
            loss = total * (1.0 / n)
        optimizer.step()
        optimizer.clear_grad()
        if lr_scheduler is not None:
            lr_scheduler.step()
        self.total_loss = loss
        return loss

    def eval_batch(self, data, compute_loss=True):
        inputs, labels = data
        with torch.no_grad():
            out = self._layers(inputs)
            if compute_loss and hasattr(self._layers, "loss"):
                return self._layers.loss(out, labels)
        return out

    def close(self):
        """Drop the pipeline's share on the ranks (the mesh stays)."""
        if self._pipe:
            self._pipe.close()
        self._pipe = None


def _split_batch(x, n):
    if isinstance(x, (list, tuple)):
        return list(zip(*[_split_batch(t, n) for t in x]))
    if torch.is_tensor(x):
        return list(torch.chunk(x, n, dim=0))
    return [torch.as_tensor(a) for a in np.array_split(np.asarray(x), n)]


class HybridParallelOptimizer:
    """Wraps the inner optimizer (reference hybrid_parallel_optimizer.py:
    186) and runs the strategy's meta-optimizers (module docstring); every
    other attribute is the inner one's."""

    def __init__(self, optimizer, hcg=None, strategy=None):
        self._inner_opt = optimizer
        self._hcg = hcg
        self._strategy = strategy
        self._gm_k, self._gm_avg, self._gm_count = 1, True, 0
        self._gm_accum = {}
        self._local_k, self._local_begin, self._local_count = 1, 1, 0
        if strategy is not None:
            if getattr(strategy, "lars", False):
                self._inner_opt = self._to_lars(optimizer, strategy)
            if getattr(strategy, "dgc", False):
                self._inner_opt = self._to_dgc(self._inner_opt, strategy)
            if getattr(strategy, "gradient_merge", False):
                cfg = getattr(strategy, "gradient_merge_configs", {})
                self._gm_k = int(cfg.get("k_steps", 1))
                self._gm_avg = bool(cfg.get("avg", True))
            if getattr(strategy, "localsgd", False):
                cfg = getattr(strategy, "localsgd_configs", {"k_steps": 1})
                self._local_k = int(cfg.get("k_steps", 1))
                self._local_begin = int(cfg.get("begin_step", 1))

    @staticmethod
    def _named(optimizer):
        return [(optimizer._names[id(p)], p) for p in optimizer._params]

    @staticmethod
    def _to_dgc(optimizer, strategy):
        """A Momentum becomes `DGCMomentum` (reference dgc_optimizer.py:442)
        with its learning rate, momentum, decay, clip and Nesterov flag;
        any other rule passes through."""
        from ....optimizer.optimizers import DGCMomentum, Momentum

        if not isinstance(optimizer, Momentum):
            return optimizer
        cfg = getattr(strategy, "dgc_configs", {})
        sparsity = cfg.get("sparsity", [0.999])
        return DGCMomentum(
            learning_rate=optimizer._learning_rate,
            momentum=optimizer._momentum,
            sparsity=float(sparsity[-1] if isinstance(sparsity, (list, tuple))
                           else sparsity),
            rampup_begin_step=int(cfg.get("rampup_begin_step", 0)),
            parameters=HybridParallelOptimizer._named(optimizer),
            weight_decay=optimizer._weight_decay,
            grad_clip=optimizer._grad_clip,
            use_nesterov=optimizer._use_nesterov)

    @staticmethod
    def _to_lars(optimizer, strategy):
        """A Momentum becomes `Lars` (reference lars_optimizer.py:23): the
        strategy's coefficient, weight decay (the Momentum's own decay
        where the strategy sets none), epsilon and exclusions; any other
        rule passes through."""
        from ....optimizer.optimizers import Lars, Momentum

        if not isinstance(optimizer, Momentum):
            return optimizer
        cfg = getattr(strategy, "lars_configs", {})
        wd = optimizer._wd_coeff()
        return Lars(
            learning_rate=optimizer._learning_rate,
            momentum=optimizer._momentum,
            lars_coeff=float(cfg.get("lars_coeff", 0.001)),
            lars_weight_decay=float(cfg.get("lars_weight_decay",
                                            wd or 0.0005)),
            epsilon=float(cfg.get("epsilon", 0.0)),
            exclude_from_weight_decay=cfg.get("exclude_from_weight_decay",
                                              ()),
            use_nesterov=optimizer._use_nesterov,
            parameters=HybridParallelOptimizer._named(optimizer),
            grad_clip=optimizer._grad_clip)

    def __getattr__(self, name):
        return getattr(self._inner_opt, name)

    def step(self):
        if self._gm_k > 1 and not self._gm_merge_step():
            return
        self._inner_opt.step()
        self._localsgd_sync()

    def _gm_merge_step(self):
        """Accumulate the gradients; True only on every k-th call, when the
        inner step runs on the merged (averaged with ``avg``) gradients
        (reference gradient_merge_optimizer.py:21)."""
        self._gm_count += 1
        for p in self._inner_opt._params:
            if not p.requires_grad or p.grad is None:
                continue
            acc = self._gm_accum.get(id(p))
            self._gm_accum[id(p)] = (p.grad.detach().clone() if acc is None
                                     else acc + p.grad)
        if self._gm_count % self._gm_k:
            self._inner_opt.clear_grad()
            return False
        scale = 1.0 / self._gm_k if self._gm_avg else 1.0
        for p in self._inner_opt._params:
            acc = self._gm_accum.get(id(p))
            if acc is not None:
                p.grad = acc * torch.tensor(scale, dtype=acc.dtype)
        self._gm_accum = {}
        return True

    def _dp_group(self):
        """This rank's dp group where every rank runs this step, or
        None."""
        mesh = getattr(self._hcg, "mesh", self._hcg)
        if mesh is None or not mesh.in_step():
            return None
        return mesh.axis_group("dp")

    def _localsgd_sync(self):
        """Average the parameters over the dp group every k inner steps,
        every step before ``begin_step`` (reference
        localsgd_optimizer.py:28); nothing without a dp group."""
        if self._local_k <= 1:
            return
        self._local_count += 1
        warm = self._local_count < self._local_begin
        if not warm and self._local_count % self._local_k:
            return
        group = self._dp_group()
        if group is None or group.size <= 1:
            return
        from ....parallel.collectives import all_reduce

        with torch.no_grad():
            for p in self._inner_opt._params:
                t = p.detach().float()
                all_reduce(t, group)
                p.copy_((t / group.size).to(p.dtype))

    def minimize(self, loss, *a, **k):
        """``loss.backward()``, then this wrapper's `step`."""
        loss.backward()
        self.step()
        return None, None


class HybridParallelGradScaler:
    """A `GradScaler` whose skip decision every rank of the hybrid mesh
    takes together (module docstring; reference
    hybrid_parallel_gradscaler.py:24). `hcg` is a
    `HybridCommunicateGroup` or a `DeviceMesh`; where the ranks do not
    run this step with it (a one-process controller, or the controller
    between jobs) it is the scaler itself."""

    def __init__(self, scaler, hcg=None):
        self._scaler = scaler
        self._hcg = hcg

    def __getattr__(self, name):
        # the wrapped optimizer passes through as it is: the scaler's
        # per-optimizer state keys one identity
        return getattr(self._scaler, name)

    def _groups(self):
        mesh = getattr(self._hcg, "mesh", self._hcg)
        if mesh is None or not mesh.in_step():
            return [], None
        out = []
        for axis in ("dp", "sharding", "pp", "mp"):
            g = mesh.axis_group(axis) if mesh.shape[axis] > 1 else None
            if g is not None and all(g is not h for h in out):
                out.append(g)
        return out, mesh.device

    def unscale_(self, optimizer):
        """The scaler's `unscale_`, then the found-inf flag all-reduced
        (MAX) over every hybrid group of degree above 1."""
        sc = self._scaler
        sc.unscale_(optimizer)
        if not sc._enable:
            return
        groups, device = self._groups()
        if not groups:
            return
        from ....parallel.collectives import all_reduce

        key = id(optimizer)
        flag = torch.tensor([float(sc._optimizer_found_inf.get(key, False))],
                            device=device)
        for g in groups:
            all_reduce(flag, g, op="max")
        found = bool(flag.item() > 0)
        sc._optimizer_found_inf[key] = found
        sc._found_inf = sc._found_inf or found

    def step(self, optimizer):
        from ....amp.grad_scaler import OptimizerState

        sc = self._scaler
        if sc._enable and sc._state_of(optimizer) is OptimizerState.INIT:
            self.unscale_(optimizer)
        sc.step(optimizer)

    def minimize(self, optimizer, scaled_loss):
        scaled_loss.backward()
        self.step(optimizer)
        self._scaler.update()


__all__ = ["DataParallel", "HybridParallelGradScaler",
           "HybridParallelOptimizer", "PipelineParallel", "TensorParallel"]
