"""Pipeline parallelism over the ``pp`` axis: GPipe, 1F1B and interleaved
1F1B (the JAX package's `paddle_tpu/parallel/pipeline.py`, in PyTorch's
idiom: one rank a stage).

The JAX module compiles each schedule into one program: a `shard_map`
over ``pp`` whose `lax.scan` runs the schedule's ticks and hands
activations on with `ppermute`. Here each stage is a rank of a stage line
(`Pipe`: the ``pp`` group of a mesh, distributed/mesh.py), and every
function below is called on every rank of the line with that rank's
share:

- each microbatch's forward runs under autograd on the stage's weights,
  its output is posted to the next stage (`parallel.collectives.send`,
  counted) and its graph stashed;
- its backward is ``torch.autograd.backward(out, grad_from_next_stage)``
  (on the last stage, of the microbatch's loss, scaled by 1/M), and the
  input's gradient is posted back up the pipe;
- every weight's gradient accumulates in its ``.grad``: the gradient of
  the mean loss over the M microbatches, as the JAX executors return it.

A stage's posted sends are waited on at the end of the schedule; a
receive blocks. Each rank runs its operations in the schedule's order,
so no two ranks wait on each other's receive: every message a receive
waits for was posted earlier in the sender's order. On each link (two
neighbouring stages) both ends see the messages in one order (1F1B's
steady state receives the next forward input before it posts the last
backward's gradient), which NCCL's per-link streams need as well.

- `gpipe`: all M forwards, then all M backwards; M microbatches in flight.
- `one_f_one_b`: ``pp - stage - 1`` warm-up forwards, then one forward
  and one backward in turn, then the cool-down backwards; at most ``pp -
  stage`` microbatches in flight on a stage, whatever M
  (``pipe.peak_in_flight`` records it, so the bound holds on the CPU too).
- `interleaved_one_f_one_b`: V chunks a rank, chunk c of stage s being
  virtual stage ``c * pp + s``; the JAX executor's modular ticks give the
  order of each rank's forwards and backwards, M need not be a multiple
  of the stage count, and the last stage's output wraps to stage 0's next
  chunk.

A loss over the last stage's output is ``loss_fn(y, label)``, or
``loss_fn(head_params, y, label)`` with `head_params`: a head (final norm,
unembedding, loss) fused into the last stage's backward, whose weights'
gradients accumulate there too. With `return_input_grads` the first
stage returns the gradient of the loss in its microbatches, so a prologue
outside the pipeline (the embedding) trains through it; `make_pipeline_loss`
wraps a schedule as one differentiable loss for exactly that.

**Departures.** The JAX `gpipe` is forward only, and `jax.grad`
transposes it into the backward pipeline; in PyTorch each rank drives its
own backward, so `gpipe` here runs the whole schedule as the other two
do, and `gpipe_forward` is the forward alone. The JAX `mp_copy` /
`mp_psum` dialect (the collectives' transposes inside `shard_map`) is the
port's `copy_to_mp` / `reduce_from_mp` (distributed/fleet/meta_parallel/
mp_layers.py), one rule for every schedule. The JAX 1F1B recomputes each
stage's forward in its backward from a ring buffer of inputs; here the
stashed graph is the activation memory, bounded by the in-flight count.
"""
from __future__ import annotations

import torch

from .collectives import all_reduce, recv_, send

_FWD, _BWD = 0, 1          # the two message streams' tags


class Pipe:
    """A rank's place in its stage line: `group` (the line's
    `RankGroup`: group rank = stage; None for one stage), `stage` and
    `n_stages`. ``peak_in_flight`` holds the largest number of
    microbatches whose forward had run and whose backward had not, over
    the last schedule run on it."""

    def __init__(self, group, stage=None, n_stages=None):
        self.group = group
        self.stage = int(group.rank if stage is None else stage)
        self.n_stages = int(group.size if n_stages is None else n_stages)
        self.peak_in_flight = 0

    @classmethod
    def of_mesh(cls, mesh):
        """This rank's stage line on `mesh` (its ``pp`` group and
        index)."""
        n = mesh.shape["pp"]
        return cls(mesh.axis_group("pp"), mesh.coords()["pp"], n)


class _Links:
    """A stage's sends (posted; waited on by `finish`) and receives
    (blocking) to and from its neighbours in the line, timed as ``p2p``
    on the pipe's clock when it has one."""

    def __init__(self, pipe):
        self.pipe = pipe
        self.pending = []

    def _timed(self, fn):
        clock = getattr(self.pipe, "clock", None)
        if clock is None:
            return fn()
        a = clock.now()
        out = fn()
        clock.add("p2p", a, clock.now())
        return out

    def send(self, t, stage, tag):
        self.pending.append(self._timed(
            lambda: send(t.detach(), stage, self.pipe.group, tag)))

    def recv(self, like, stage, tag):
        return self._timed(lambda: recv_(torch.empty_like(like), stage,
                                         self.pipe.group, tag))

    def finish(self):
        for p in self.pending:
            self._timed(p.wait)
        self.pending = []


class _Span:
    """A span of the pipe's clock (``pipe.clock``: a step's phase timer,
    `models/gpt_pipeline.py`), or nothing without one."""

    def __init__(self, pipe, name):
        self.clock = getattr(pipe, "clock", None)
        self.name = name

    def __enter__(self):
        if self.clock is not None:
            self.a = self.clock.now()

    def __exit__(self, *exc):
        if self.clock is not None:
            self.clock.add(self.name, self.a, self.clock.now())


def _loss(loss_fn, head_params, y, label):
    if head_params is None:
        return loss_fn(y, label).float()
    return loss_fn(head_params, y, label).float()


def _execute(ops, stage_fn, loss_fn, chunks, microbatches, labels, pipe,
             n_chunks, head_params, return_input_grads):
    """Run this rank's `ops` (``("F" | "B", chunk, microbatch,
    prefetch)``; `prefetch` a (chunk, microbatch) whose forward input a
    backward receives before it posts its own gradient, or None). Returns
    ``(sum of the last stage's microbatch losses or None, [input
    gradients] on the first stage with `return_input_grads`, else
    None)``."""
    P, s, V = pipe.n_stages, pipe.stage, n_chunks
    VP = V * P
    M = microbatches.shape[0]
    like = microbatches[0]
    links = _Links(pipe)
    stash, inputs = {}, {}
    dmbs = [None] * M if return_input_grads and s == 0 else None
    loss_sum, in_flight, peak = None, 0, 0

    def take_input(c, i):
        g = c * P + s
        if g == 0:
            return microbatches[i]
        if (c, i) not in inputs:
            inputs[(c, i)] = links.recv(like, (s - 1) % P, _FWD)
        return inputs.pop((c, i))

    try:
        for kind, c, i, prefetch in ops:
            g = c * P + s
            if kind == "F":
                x = take_input(c, i).detach().requires_grad_(
                    g > 0 or return_input_grads)
                with torch.enable_grad(), _Span(pipe, "forward"):
                    y = stage_fn(chunks[c], x)
                    out = (_loss(loss_fn, head_params, y, labels[i])
                           if g == VP - 1 else y)
                if g < VP - 1:
                    links.send(y, (s + 1) % P, _FWD)
                stash[(c, i)] = (x, out)
                in_flight += 1
                peak = max(peak, in_flight)
                continue
            x, out = stash.pop((c, i))
            if g == VP - 1:
                lj = out.detach()
                loss_sum = lj if loss_sum is None else loss_sum + lj
                gy = torch.full_like(out, 1.0 / M)
            else:
                gy = links.recv(like, (s + 1) % P, _BWD)
            with _Span(pipe, "backward"):
                torch.autograd.backward(out, gy)
            in_flight -= 1
            if prefetch is not None and prefetch[0] * P + s > 0:
                inputs[prefetch] = links.recv(like, (s - 1) % P, _FWD)
            if g > 0:
                links.send(x.grad, (s - 1) % P, _BWD)
            elif dmbs is not None:
                dmbs[i] = x.grad
            del x, out
    finally:
        links.finish()
    pipe.peak_in_flight = peak
    return loss_sum, dmbs


def _finish(loss_sum, dmbs, params, head_params, microbatches, pipe,
            reduce_groups):
    """The schedule's results: the mean loss on every stage (one
    all-reduce over the line), the gradients averaged over
    `reduce_groups` (the groups the batch splits over), and the first
    stage's input gradients."""
    M = microbatches.shape[0]
    loss = (torch.zeros((), dtype=torch.float32, device=microbatches.device)
            if loss_sum is None else loss_sum / M).reshape(1).clone()
    if pipe.n_stages > 1:
        all_reduce(loss, pipe.group)
    for grp in reduce_groups:
        if grp is None or grp.size <= 1:
            continue
        all_reduce(loss, grp)
        loss /= grp.size
        for p in _flat(params) + _flat(head_params):
            if p.grad is not None:
                all_reduce(p.grad, grp)
                p.grad /= grp.size
        if dmbs is not None:
            dmbs = [d / grp.size for d in dmbs]
    input_grads = None if dmbs is None else torch.stack(dmbs)
    return loss[0], input_grads


def _flat(tree):
    """The tensors of a dict / list / tuple nest, in order."""
    if tree is None:
        return []
    if torch.is_tensor(tree):
        return [tree]
    if isinstance(tree, dict):
        return [t for k in tree for t in _flat(tree[k])]
    return [t for x in tree for t in _flat(x)]


def gpipe_ops(n_stages, stage, M):
    """GPipe's order on one stage: the M forwards, then the M
    backwards."""
    return ([("F", 0, i, None) for i in range(M)]
            + [("B", 0, i, None) for i in range(M)])


def one_f_one_b_ops(n_stages, stage, M):
    """1F1B's order on one stage: ``min(pp - stage - 1, M)`` warm-up
    forwards, then forward i + warm-up and backward i in turn (each
    backward receiving the next forward's input before posting its
    gradient), then the cool-down backwards."""
    warm = min(n_stages - stage - 1, M)
    ops = [("F", 0, i, None) for i in range(warm)]
    for i in range(M - warm):
        ops.append(("F", 0, warm + i, None))
        nxt = warm + i + 1
        ops.append(("B", 0, i, (0, nxt) if nxt < M else None))
    ops += [("B", 0, i, None) for i in range(M - warm, M)]
    return ops


def interleaved_ops(n_stages, stage, M, n_chunks):
    """The interleaved schedule's order on one stage, from the JAX
    executor's modular ticks (`interleaved_one_f_one_b`'s docstring
    there): each tick one chunk forward and one chunk backward when
    active."""
    P, V, s = n_stages, n_chunks, stage
    VP = V * P
    T = 2 * VP - 1 + ((M - 1) % P) + VP * ((M - 1) // P)
    ops = []
    for t in range(T):
        r_f = t - s
        c_f = min(max((r_f % VP) // P, 0), V - 1)
        i_f = (r_f // VP) * P + (r_f % VP) % P
        if r_f >= 0 and 0 <= i_f < M:
            ops.append(("F", c_f, i_f, None))
        r_b = t + s + 2 - 2 * VP
        q_b = r_b % VP
        c_b = min(max((V - q_b // P) % V, 0), V - 1)
        u_b = r_b + c_b * P
        i_b = (u_b // VP) * P + q_b % P
        if u_b >= 0 and 0 <= i_b < M:
            ops.append(("B", c_b, i_b, None))
    return ops


def _schedule(ops, stage_fn, loss_fn, chunks, microbatches, labels, pipe,
              n_chunks, head_params, return_input_grads, reduce_groups):
    loss_sum, dmbs = _execute(ops, stage_fn, loss_fn, chunks, microbatches,
                              labels, pipe, n_chunks, head_params,
                              return_input_grads)
    loss, dx = _finish(loss_sum, dmbs, chunks, head_params, microbatches,
                       pipe, reduce_groups)
    return (loss, dx) if return_input_grads else loss


def gpipe(stage_fn, loss_fn, params, microbatches, labels, pipe,
          head_params=None, return_input_grads=False, reduce_groups=()):
    """GPipe on this rank's stage: ``stage_fn(params, x) -> y`` (y shaped
    as x), `microbatches` ``[M, mb, ...]`` (read on the first stage; any
    tensor of that shape and dtype elsewhere), `labels` ``[M, ...]`` (read
    on the last). Gradients accumulate in the weights' ``.grad``. Returns
    the mean loss (every stage), and with `return_input_grads` also the
    first stage's ``[M, mb, ...]`` input gradients (None elsewhere)."""
    M = microbatches.shape[0]
    return _schedule(gpipe_ops(pipe.n_stages, pipe.stage, M), stage_fn,
                     loss_fn, [params], microbatches, labels, pipe, 1,
                     head_params, return_input_grads, reduce_groups)


def one_f_one_b(stage_fn, loss_fn, params, microbatches, labels, pipe,
                head_params=None, return_input_grads=False,
                reduce_groups=()):
    """1F1B on this rank's stage (reference pipeline_parallel.py:117);
    arguments and results as `gpipe`'s. `reduce_groups`: the groups the
    batch is split over (dp); the loss and gradients are averaged over
    them and each rank's input gradients scaled by 1/size, as the JAX
    executor's ``reduce_axes``."""
    M = microbatches.shape[0]
    return _schedule(one_f_one_b_ops(pipe.n_stages, pipe.stage, M),
                     stage_fn, loss_fn, [params], microbatches, labels, pipe,
                     1, head_params, return_input_grads, reduce_groups)


def interleaved_one_f_one_b(stage_fn, loss_fn, chunk_params, microbatches,
                            labels, pipe, n_chunks, head_params=None,
                            return_input_grads=False, reduce_groups=()):
    """Interleaved 1F1B (reference pipeline_parallel.py:461):
    `chunk_params` holds this rank's `n_chunks` chunks' weights, chunk c
    being virtual stage ``c * pp + stage`` (`stack_interleaved_params`'s
    layout). Arguments and results otherwise as `one_f_one_b`'s."""
    M = microbatches.shape[0]
    ops = interleaved_ops(pipe.n_stages, pipe.stage, M, n_chunks)
    return _schedule(ops, stage_fn, loss_fn, list(chunk_params),
                     microbatches, labels, pipe, n_chunks, head_params,
                     return_input_grads, reduce_groups)


@torch.no_grad()
def gpipe_forward(stage_fn, params, microbatches, pipe):
    """The forward pipeline alone (the JAX `gpipe`'s value): the last
    stage's ``[M, mb, ...]`` outputs on the last stage, None elsewhere."""
    P, s = pipe.n_stages, pipe.stage
    links, outs = _Links(pipe), []
    try:
        for i in range(microbatches.shape[0]):
            x = (microbatches[i] if s == 0 else
                 links.recv(microbatches[0], s - 1, _FWD))
            y = stage_fn(params, x)
            if s < P - 1:
                links.send(y, s + 1, _FWD)
            else:
                outs.append(y)
    finally:
        links.finish()
    return torch.stack(outs) if s == P - 1 else None


_SCHEDULES = {"gpipe": gpipe, "1f1b": one_f_one_b}


class _PipelineLoss(torch.autograd.Function):
    """A schedule as one differentiable loss: its forward runs the whole
    schedule on detached copies of the weights and keeps their gradients;
    its backward hands them (times the loss's cotangent) to the weights,
    the head and the microbatches."""

    @staticmethod
    def forward(ctx, run, n_params, microbatches, labels, *weights):
        leaves = [w.detach().requires_grad_(True) for w in weights]
        params, head = run.unflatten(leaves[:n_params], leaves[n_params:])
        loss, dx = run(params, head, microbatches.detach(), labels)
        ctx.grads = [w.grad for w in leaves]
        ctx.dx = dx
        return loss.detach()

    @staticmethod
    def backward(ctx, ct):
        grads = [None if g is None else g * ct for g in ctx.grads]
        dx = None if ctx.dx is None else ctx.dx * ct
        return (None, None, dx, None, *grads)


class _Run:
    """What `make_pipeline_loss`'s loss runs: the schedule and the nest
    structure of its weights."""

    def __init__(self, stage_fn, loss_fn, pipe, schedule, n_chunks,
                 reduce_groups):
        self.stage_fn, self.loss_fn, self.pipe = stage_fn, loss_fn, pipe
        self.schedule, self.n_chunks = schedule, n_chunks
        self.reduce_groups = reduce_groups
        self.params_like = self.head_like = None

    def unflatten(self, params, head):
        return _unflatten(self.params_like, params), (
            None if self.head_like is None else
            _unflatten(self.head_like, head))

    def __call__(self, params, head, microbatches, labels):
        kw = dict(head_params=head, return_input_grads=True,
                  reduce_groups=self.reduce_groups)
        if self.schedule == "interleaved":
            return interleaved_one_f_one_b(
                self.stage_fn, self.loss_fn, params, microbatches, labels,
                self.pipe, self.n_chunks, **kw)
        return _SCHEDULES[self.schedule](
            self.stage_fn, self.loss_fn, params, microbatches, labels,
            self.pipe, **kw)


def _unflatten(like, flat):
    it = iter(flat)

    def build(x):
        if torch.is_tensor(x):
            return next(it)
        if isinstance(x, dict):
            return {k: build(v) for k, v in x.items()}
        return type(x)(build(v) for v in x)

    return build(like)


def make_pipeline_loss(stage_fn, loss_fn, pipe, schedule="1f1b", n_chunks=1,
                       reduce_groups=()):
    """The JAX `make_pipeline_loss`: ``ploss(params, head_params,
    microbatches, labels)`` runs `schedule` ("gpipe", "1f1b" or
    "interleaved" with `n_chunks` chunks; `params` then a list of the
    chunks' weights) and returns the mean loss, differentiable in the
    weights, the head and the microbatches, so ``ploss(...).backward()``
    trains the trunk, the fused head and a prologue (the embedding that
    made the microbatches on the first stage) together. Every rank of
    the line calls it, and its backward, with its own share."""
    if schedule not in ("gpipe", "1f1b", "interleaved"):
        raise ValueError(f"schedule {schedule!r}: 'gpipe', '1f1b' or "
                         "'interleaved'")
    run = _Run(stage_fn, loss_fn, pipe, schedule, n_chunks, reduce_groups)

    def ploss(params, head_params, microbatches, labels):
        run.params_like, run.head_like = params, head_params
        flat_p, flat_h = _flat(params), _flat(head_params)
        return _PipelineLoss.apply(run, len(flat_p), microbatches, labels,
                                   *flat_p, *flat_h)

    return ploss


def stack_stage_params(per_stage_params):
    """A list of per-stage dicts (one structure) -> one dict of tensors
    stacked on a leading stage axis."""
    return {k: torch.stack([p[k] for p in per_stage_params])
            for k in per_stage_params[0]}


def stack_interleaved_params(per_virtual_stage_params, n_devices):
    """Virtual-stage dicts (V * P of them, in layer order) -> one dict of
    ``[P, V, ...]`` tensors: entry ``[s, c]`` is virtual stage ``c * P +
    s`` (chunk c of device s), the reference's interleaved placement."""
    vp = len(per_virtual_stage_params)
    if vp % n_devices:
        raise ValueError(f"{vp} virtual stages over {n_devices} devices")
    v = vp // n_devices
    rows = [stack_stage_params([per_virtual_stage_params[c * n_devices + s]
                                for c in range(v)])
            for s in range(n_devices)]
    return stack_stage_params(rows)


__all__ = ["Pipe", "gpipe", "gpipe_forward", "interleaved_one_f_one_b",
           "make_pipeline_loss", "one_f_one_b", "stack_interleaved_params",
           "stack_stage_params"]
