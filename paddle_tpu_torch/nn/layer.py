"""Skeleton construction for streamed checkpoint serving (the JAX
package's `paddle_tpu/nn/layer.py` `skeleton_init` / `is_skeleton`).

A skeleton is a model built on PyTorch's ``meta`` device: its config,
module tree, parameter names, shapes and dtypes are real, and no storage
stands behind any parameter. It exists for ``LLMEngine(skeleton,
checkpoint_path=...)``: each engine deep-copies the skeleton, gives the
copy storage on its own device (``to_empty``) and fills it leaf by leaf
from the checkpoint, so one skeleton serves every replica and every
spawn and never holds numbers itself::

    with skeleton_init():
        model = gpt_1p3b(dtype=torch.bfloat16)     # no weight memory
    engine = LLMEngine(model, checkpoint_path=ckpt)

Inside the context, `_device.resolve_device` answers ``meta`` whatever
device the caller names, and factory calls without a device default to
``meta`` too. A skeleton cannot run, and the engine refuses one without
``checkpoint_path``. The switch is process-global while the context is
open: build skeletons one at a time, not beside other model builds.
"""
from __future__ import annotations

import contextlib
import copy

import torch

_building = [False]


def building_skeleton():
    """True inside `skeleton_init` (read by `_device.resolve_device`)."""
    return _building[0]


@contextlib.contextmanager
def skeleton_init():
    """Build models on the ``meta`` device: shapes and dtypes, no
    storage. Models skip their weight initialisation there (a generator
    cannot draw on ``meta``) and seed their dropout generators when they
    are materialised with ``to_empty``."""
    prev = _building[0]
    _building[0] = True
    try:
        with torch.device("meta"):
            yield
    finally:
        _building[0] = prev


def is_skeleton(module):
    """True when `module` was built under `skeleton_init` (its parameters
    live on the ``meta`` device and hold no numbers)."""
    for p in module.parameters():
        return p.is_meta
    return False


def meta_copy(model):
    """A skeleton of `model`: a deep copy of its module tree whose
    parameters and buffers are ``meta`` stand-ins of the same shapes and
    dtypes (no tensor is copied) and whose dropout generators are dropped
    (`to_empty` seeds them anew). It pickles, so a spawned process can
    receive it whole."""
    memo = {id(b): torch.empty_like(b, device="meta")
            for b in model.buffers()}
    for p in model.parameters():
        q = torch.nn.Parameter(torch.empty_like(p, device="meta"),
                               requires_grad=p.requires_grad)
        q.__dict__.update(p.__dict__)      # annotations (sharding_axes)
        memo[id(p)] = q
    gens = getattr(model, "dropout_generators", None)
    if gens is not None:
        memo[id(gens)] = None
    return copy.deepcopy(model, memo)
