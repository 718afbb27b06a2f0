"""fleet.utils: recompute (activation checkpointing), the counterpart of
`paddle_tpu/distributed/fleet/utils/__init__.py`.

The JAX package wraps the segment in `jax.checkpoint`, which replays the
same PRNG key in the backward by construction. Here the segment runs
under `torch.utils.checkpoint` (``use_reentrant=False``): its activations
are dropped after the forward and recomputed in the backward.
`torch.utils.checkpoint` restores torch's default generators for the
recomputation (`preserve_rng_state`), but no other generator, and the
port's models draw dropout from generators of their own
(`ops/common_nn.DropoutGenerators`). A segment that draws from a
generator must name it in `generators`: each is put back where it stood
when the forward entered the segment for the recomputation, so the
backward sees the forward's keep masks and attention seeds, and is put
back afterwards where it stood before the recomputation, so a run leaves
every generator where the same run without recompute leaves it.
"""
from __future__ import annotations

import contextlib

from torch.utils.checkpoint import checkpoint


def _replay(generators):
    """`checkpoint`'s context_fn: called as the forward enters the
    segment; its second context wraps the recomputation."""
    entered = [g.get_state() for g in generators]

    @contextlib.contextmanager
    def recomputation():
        before = [g.get_state() for g in generators]
        for g, s in zip(generators, entered):
            g.set_state(s)
        try:
            yield
        finally:
            for g, s in zip(generators, before):
                g.set_state(s)

    return contextlib.nullcontext(), recomputation()


def recompute(function, *args, generators=(), **kwargs):
    """``function(*args, **kwargs)`` with its activations recomputed in
    the backward instead of kept. `generators`: the `torch.Generator`s the
    segment draws from (see the module docstring). `preserve_rng_state`
    and `use_reentrant` are taken and not read, as in the JAX package:
    torch's default generators are always restored for the
    recomputation, and the segment is always non-reentrant."""
    kwargs.pop("preserve_rng_state", None)
    kwargs.pop("use_reentrant", None)
    gens = tuple(generators)
    return checkpoint(function, *args, use_reentrant=False,
                      preserve_rng_state=True,
                      context_fn=lambda: _replay(gens), **kwargs)
