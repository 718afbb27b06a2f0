"""Distributed checkpoint: save, load and streamed load (the JAX package's
`paddle_tpu/distributed/checkpoint.py`, in PyTorch, for one process).

A checkpoint is a directory of npz shard files plus ``index.json``, which
records every array's global shape, dtype and the slice each stored shard
covers. The format is the JAX package's (``paddle_tpu.dist_ckpt.v1``):
the same keys (``params/<name>``, ``buffers/<name>``,
``opt/<name>/<slot>``), the same member names (``<key>::<i>``), and model
arrays in the JAX package's layout (Linear weights ``[in, out]``), so a
checkpoint written by either package loads in the other. One process
writes ``shard_0.npz`` with one shard per array.

**bfloat16 without ml_dtypes.** numpy has no bfloat16; the JAX package
writes a bf16 member through ml_dtypes, whose npy header says ``'descr':
'<V2'``. The port writes the same header and the same two-byte payload,
and reads a member's dtype from ``index.json``, never from the npy header:
a ``"bfloat16"`` member's payload is read raw and reinterpreted
(``torch.from_numpy(view.view(np.int16)).view(torch.bfloat16)``).

**Streaming load** (`stream_load_state`, `load_state(..., stream=True)`):
`np.savez` stores members uncompressed, so each member is a plain ``.npy``
at a computable offset of its zip and is memory-mapped in place
(`_ShardReader`). Each leaf goes from its mapped member to the device on
its own, one at a time; the tree is never built on the host. The
`StreamLoadReport` records the bounds (``peak_host_bytes``: the largest
leaf; ``max_chip_bytes``: everything placed on the one device) that the
engine's ``param_hbm_bytes`` budget and the tests hold.

**Per-rank streaming** (`stream_model_into` with a serving mesh, and
``load_sharded_model(mesh=...)``): a tensor-parallel rank reads only its
own slice of each sharded leaf (serving/sharded.py `tp_dim`) out of the
mapped member, so its host staging peaks at one slice and its device holds
its shard alone; each rank keeps its own report.
"""
from __future__ import annotations

import json
import os
import struct
import time
import zipfile

import numpy as np
import torch

_FORMAT = "paddle_tpu.dist_ckpt.v1"
_SEP = "/"

# index.json dtype names <-> torch dtypes (the JAX package's str(dtype))
_DTYPES = {
    "float32": torch.float32, "float64": torch.float64,
    "float16": torch.float16, "bfloat16": torch.bfloat16,
    "int64": torch.int64, "int32": torch.int32, "int16": torch.int16,
    "int8": torch.int8, "uint8": torch.uint8, "bool": torch.bool,
}
_NAMES = {v: k for k, v in _DTYPES.items()}


def _flatten(tree, prefix=""):
    """Nested dict of arrays -> {path: array} with '/'-joined keys."""
    out = {}
    if isinstance(tree, dict):
        for k, v in tree.items():
            key = f"{prefix}{_SEP}{k}" if prefix else str(k)
            out.update(_flatten(v, key))
    else:
        out[prefix] = tree
    return out


def _unflatten(flat):
    root = {}
    for path, v in flat.items():
        parts = path.split(_SEP)
        d = root
        for p in parts[:-1]:
            d = d.setdefault(p, {})
        d[parts[-1]] = v
    return root


def _shard_slices(shard_index, shape):
    """Normalize a shard's index (a tuple of slices) into [[start, stop],
    ...]."""
    out = []
    for dim, sl in enumerate(shard_index):
        start = 0 if sl.start is None else int(sl.start)
        stop = shape[dim] if sl.stop is None else int(sl.stop)
        out.append([start, stop])
    return out


def _dtype_name(t):
    name = _NAMES.get(t.dtype)
    if name is None:
        raise TypeError(f"checkpoint: unsupported dtype {t.dtype}")
    return name


def _write_member(zf, name, t):
    """One ``<name>.npy`` member of the npz, byte for byte what `np.savez`
    writes for the same values in the JAX package: bf16 as the ``'<V2'``
    header ml_dtypes gives, then the raw little-endian payload."""
    with zf.open(name + ".npy", "w", force_zip64=True) as fid:
        if t.dtype == torch.bfloat16:
            raw = t.view(torch.int16).numpy()
            np.lib.format.write_array_header_1_0(
                fid, {"descr": "<V2", "fortran_order": False,
                      "shape": tuple(raw.shape)})
            fid.write(raw.tobytes())
        else:
            np.lib.format.write_array(fid, t.numpy(), allow_pickle=False)


def save_state(state, path, save_id=None):
    """Save a nested dict of tensors (or numpy arrays) as a one-process
    checkpoint: ``shard_0.npz`` with one whole-array shard each, then
    ``index.json`` (written atomically, tmp + replace). `save_id` is
    recorded as the JAX package records it."""
    os.makedirs(path, exist_ok=True)
    index = {"format": _FORMAT, "world": 1, "save_id": save_id,
             "arrays": {}}
    shard = os.path.join(path, "shard_0.npz")
    with zipfile.ZipFile(shard, mode="w", compression=zipfile.ZIP_STORED,
                         allowZip64=True) as zf:
        for key, arr in _flatten(state).items():
            t = torch.as_tensor(arr).detach().cpu().contiguous()
            skey = f"{key}::0"
            _write_member(zf, skey, t)
            index["arrays"][key] = {
                "shape": list(t.shape), "dtype": _dtype_name(t),
                "shards": [{"file": "shard_0.npz", "key": skey,
                            "index": [[0, n] for n in t.shape]}]}
    final = os.path.join(path, "index.json")
    with open(final + ".tmp", "w") as f:
        json.dump(index, f, indent=1)
    os.replace(final + ".tmp", final)


def _read_index(path):
    with open(os.path.join(path, "index.json")) as f:
        index = json.load(f)
    if index.get("format") != _FORMAT:
        raise ValueError(f"not a paddle_tpu dist checkpoint: {path}")
    return index


def _as_tensor(view, dtype_name):
    """A host array read from a member as a torch tensor of the index's
    dtype (a bf16 member's two-byte payload reinterpreted)."""
    if dtype_name == "bfloat16":
        return torch.from_numpy(view.view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(view)


def _leaf(reader, key, entry):
    """The whole array `key` as a host tensor, read from its stored
    shards (a view of the mapped member when one shard holds it all)."""
    shape = tuple(entry["shape"])
    stored = [dict(s, index=[tuple(ab) for ab in s["index"]])
              for s in entry["shards"]]
    return _gather_slice(reader, key, stored, shape, entry["dtype"],
                         [[0, n] for n in shape])


def load_state(path, device=None, keys=None, stream=False):
    """Load a checkpoint as a nested dict of tensors: on the host (`device`
    None) or on `device`. `keys` restricts to those flat keys.
    ``stream=True`` takes the streaming path (`stream_load_state`): each
    leaf goes from its mapped member to the device on its own."""
    if stream:
        tree, _ = stream_load_state(path, device=device, keys=keys)
        return tree
    index = _read_index(path)
    reader = _ShardReader(path)
    flat = {}
    for key, entry in index["arrays"].items():
        if keys is not None and key not in keys:
            continue
        t = _leaf(reader, key, entry).clone()
        flat[key] = t if device is None else t.to(device)
    return _unflatten(flat)


class _ShardReader:
    """Lazy, zero-copy access to the members of a checkpoint's npz shards.

    `np.savez` (no compression; how both packages write) stores each member
    as a plain ``<key>.npy`` file inside the zip, byte for byte. So a
    member can be memory-mapped in place: seek to the zip local file
    header, skip its fixed 30 bytes plus the name/extra fields, parse the
    npy header, and `np.memmap` the payload (copy-on-write, so torch gets
    a writable array and the file is never written). Slicing the map reads
    only the pages the slice touches. Members that cannot be mapped
    (compressed, Fortran order, object dtype) fall back to a whole-member
    `np.load`, bounded by one stored shard."""

    def __init__(self, path):
        self._path = path
        self._members = {}   # file -> {key: (payload_offset, dtype, shape)}
        self._fallback = {}  # file -> NpzFile (only for unmappable members)

    def _index_file(self, file):
        fn = os.path.join(self._path, file)
        members = {}
        with zipfile.ZipFile(fn) as zf, open(fn, "rb") as f:
            for info in zf.infolist():
                name = info.filename
                key = name[: -len(".npy")] if name.endswith(".npy") else name
                if info.compress_type != zipfile.ZIP_STORED:
                    members[key] = None
                    continue
                # zip local file header: 30 fixed bytes; name/extra lengths
                # live at struct offsets 26/28 (the central directory's
                # copies can differ, so read the local ones)
                f.seek(info.header_offset)
                hdr = f.read(30)
                nlen, elen = struct.unpack("<HH", hdr[26:30])
                f.seek(info.header_offset + 30 + nlen + elen)
                version = np.lib.format.read_magic(f)
                if version == (1, 0):
                    shape, fortran, dtype = \
                        np.lib.format.read_array_header_1_0(f)
                elif version == (2, 0):
                    shape, fortran, dtype = \
                        np.lib.format.read_array_header_2_0(f)
                else:
                    members[key] = None
                    continue
                if fortran or dtype.hasobject:
                    members[key] = None
                    continue
                members[key] = (f.tell(), dtype, shape)
        self._members[file] = members

    def view(self, file, key):
        """An array view of one stored member (a memmap when possible)."""
        if file not in self._members:
            self._index_file(file)
        meta = self._members[file].get(key)
        if meta is None:
            npz = self._fallback.get(file)
            if npz is None:
                npz = self._fallback[file] = np.load(
                    os.path.join(self._path, file))
            return npz[key]
        offset, dtype, shape = meta
        return np.memmap(os.path.join(self._path, file), dtype=dtype,
                         mode="c", offset=offset, shape=shape)


class StreamLoadReport:
    """Measured bounds of one streaming load, held by the tests and the
    engine's `param_hbm_bytes` budget.

    - total_bytes: logical size of everything loaded (the full tree).
    - peak_host_bytes: the largest single host staging buffer: one leaf,
      never the tree.
    - chip_bytes / max_chip_bytes: bytes placed on each device (one
      device here: the engine's).
    """

    def __init__(self):
        self.arrays = 0
        self.total_bytes = 0
        self.peak_host_bytes = 0
        self.chip_bytes = {}  # torch.device -> bytes placed on it
        self.seconds = 0.0

    @property
    def max_chip_bytes(self):
        return max(self.chip_bytes.values(), default=0)

    def note_host(self, nbytes):
        self.peak_host_bytes = max(self.peak_host_bytes, int(nbytes))

    def note_chip(self, dev, nbytes):
        self.chip_bytes[dev] = self.chip_bytes.get(dev, 0) + int(nbytes)

    def summary(self):
        return {
            "arrays": self.arrays,
            "total_bytes": self.total_bytes,
            "peak_host_bytes": self.peak_host_bytes,
            "max_chip_bytes": self.max_chip_bytes,
            "devices": len(self.chip_bytes),
            "seconds": round(self.seconds, 3),
        }


def _gather_slice(reader, key, stored, shape, dtype_name, want):
    """The half-open box `want` ([[start, stop], ...] over the global
    shape) of array `key` as a host tensor, read out of the stored shards,
    touching only the bytes inside it."""
    # fast path: one stored shard holds the whole box; slice its memmap
    for s in stored:
        have = s["index"]
        if all(ha <= wa and wb <= hb
               for (wa, wb), (ha, hb) in zip(want, have)):
            view = reader.view(s["file"], s["key"])
            rel = tuple(slice(wa - ha, wb - ha)
                        for (wa, wb), (ha, hb) in zip(want, have))
            return _as_tensor(np.ascontiguousarray(view[rel]), dtype_name)
    # general path: assemble the box from the shards that intersect it
    out = None
    filled = np.zeros(tuple(b - a for a, b in want), bool)
    for s in stored:
        have = s["index"]
        inter = [(max(wa, ha), min(wb, hb))
                 for (wa, wb), (ha, hb) in zip(want, have)]
        if any(a >= b for a, b in inter):
            continue
        view = reader.view(s["file"], s["key"])
        if out is None:
            out = np.empty(filled.shape, view.dtype)
        src = tuple(slice(a - ha, b - ha)
                    for (a, b), (ha, _hb) in zip(inter, have))
        dst = tuple(slice(a - wa, b - wa)
                    for (a, b), (wa, _wb) in zip(inter, want))
        out[dst] = view[src]
        filled[dst] = True
    if out is None or not filled.all():
        raise ValueError(
            f"checkpoint: array {key!r} slice {want} has missing regions — "
            "were all ranks' shard files copied?")
    return _as_tensor(out, dtype_name)


def stream_leaves(path, device=None, keys=None, report=None, boxes=None):
    """Yield ``(key, tensor)`` for each array of the checkpoint (or of
    `keys`), one at a time: the leaf is read from its memory-mapped member
    into one host staging buffer and copied to `device` (None: stays on
    the host). `boxes` ({key: [[start, stop], ...]}) restricts a leaf to
    that box of its global shape, and only the box is read. Nothing but
    the leaf being yielded is held, so a caller that puts each leaf away
    before the next never holds the tree twice. Bounds go into `report`
    (a `StreamLoadReport`) as they are met."""
    index = _read_index(path)
    reader = _ShardReader(path)
    dev = None if device is None else torch.device(device)
    for key, entry in index["arrays"].items():
        if keys is not None and key not in keys:
            continue
        box = None if boxes is None else boxes.get(key)
        if box is None:
            piece = _leaf(reader, key, entry)
        else:
            stored = [dict(s, index=[tuple(ab) for ab in s["index"]])
                      for s in entry["shards"]]
            piece = _gather_slice(reader, key, stored, tuple(entry["shape"]),
                                  entry["dtype"], box)
        nbytes = piece.numel() * piece.element_size()
        if report is not None:
            report.note_host(nbytes)
        if dev is not None:
            piece = piece.to(dev)
            if report is not None:
                report.note_chip(dev, nbytes)
        if report is not None:
            report.total_bytes += nbytes
            report.arrays += 1
        yield key, piece
        del piece


def stream_load_state(path, device=None, keys=None, boxes=None):
    """Stream a checkpoint to `device` one leaf at a time
    (`stream_leaves`; `boxes` restricts leaves to a box each, a rank's
    slices): the full tree is never staged on the host. Returns
    ``(nested_state_dict, StreamLoadReport)``."""
    report = StreamLoadReport()
    t0 = time.monotonic()
    flat = dict(stream_leaves(path, device=device, keys=keys, report=report,
                              boxes=boxes))
    if device is not None and torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)
    report.seconds = time.monotonic() - t0
    return _unflatten(flat), report


def save_sharded_model(model, optimizer, path, opt_state=None, save_id=None):
    """Save a model's parameters and buffers (and the optimizer's slots)
    in the JAX package's layout (`weights.to_jax_state_dict`: Linear
    weights ``[in, out]``), so the JAX package's `load_sharded_model`
    reads it. `opt_state` (``{name: {slot: array}}``) wins over
    `optimizer`'s own state."""
    from ..weights import _linear_weights, to_jax_optimizer_state

    linear = _linear_weights(model)
    params = {}
    for name, p in model.named_parameters():
        t = p.detach()
        params[name] = t.t().contiguous() if name in linear else t
    state = {"params": params,
             "buffers": {k: b.detach() for k, b in model.named_buffers()}}
    if opt_state is not None:
        state["opt"] = opt_state
    elif optimizer is not None:
        state["opt"] = to_jax_optimizer_state(optimizer, model)[0]
    save_state(state, path, save_id=save_id)


def _model_targets(model, mesh=None, param_specs=None):
    """``(tp, rank, targets)``: the mesh's degree and this rank's index (1,
    0 without a mesh) and {checkpoint key: (tensor, transposed, sharded
    dim)} of a model's parameters and buffers. Under a mesh, `param_specs`
    ({name: dim or None}, the ``[out, in]`` layout; default
    `serving_param_specs`) marks the sharded ones of a rank's shard
    module."""
    from ..weights import _linear_weights

    tp, rank, specs = 1, 0, {}
    if mesh is not None:
        tp, rank = mesh.tp_degree, mesh.rank
        if param_specs is None:
            from ..serving.sharded import serving_param_specs

            param_specs = serving_param_specs(model)
        specs = param_specs
    linear = _linear_weights(model)
    targets = {f"params/{k}": (p, k in linear, specs.get(k))
               for k, p in model.named_parameters()}
    targets.update({f"buffers/{k}": (b, False, None)
                    for k, b in model.named_buffers()})
    return tp, rank, targets


def _global_shape(t, transpose, dim, tp):
    """The checkpoint (JAX-layout) shape of a leaf whose model tensor is
    `t`, `tp`-sharded along `dim` (None: whole)."""
    shape = list(t.shape)
    if dim is not None:
        shape[dim] *= tp
    return tuple(shape[::-1] if transpose else shape)


def _rank_box(shape, transpose, dim, rank, tp):
    """Rank `rank`'s box of a leaf of checkpoint `shape` sharded along the
    model dim `dim` (the checkpoint's axes are reversed for a Linear)."""
    box = [[0, n] for n in shape]
    if dim is not None:
        jdim = len(shape) - 1 - dim if transpose else dim
        n = shape[jdim] // tp
        box[jdim] = [rank * n, (rank + 1) * n]
    return box


def stream_model_into(model, path, device=None, report=None, mesh=None,
                      param_specs=None):
    """Fill `model`'s parameters and buffers in place from checkpoint
    `path`, one leaf at a time (`stream_leaves`; Linear weights transposed
    from the checkpoint's ``[in, out]``). With a serving `mesh`, `model` is
    this rank's shard module (serving/sharded.py `shard_module`) and each
    sharded parameter (`param_specs`, default `serving_param_specs`) reads
    only the rank's slice. Every array must be in the checkpoint with the
    (global) shape and dtype the model declares, else ValueError. Bounds go
    into `report`."""
    tp, rank, targets = _model_targets(model, mesh, param_specs)
    arrays = _read_index(path)["arrays"]
    missing = [k for k in targets if k not in arrays]
    if missing:
        raise ValueError(
            f"checkpoint {path!r} is missing model arrays "
            f"{missing[:4]}{' ...' if len(missing) > 4 else ''} — was "
            "it saved from this architecture (save_sharded_model)?")
    boxes = {}
    for key, (t, transpose, dim) in targets.items():
        shape = _global_shape(t, transpose, dim, tp)
        dtype = _dtype_name(t)
        got = arrays[key]
        if tuple(got["shape"]) != shape or got["dtype"] != dtype:
            kind, name = key.split("/", 1)
            raise ValueError(
                f"checkpoint {path!r}: {kind[:-1]} {name!r} is "
                f"{got['dtype']}{tuple(got['shape'])} but the model "
                f"declares {dtype}{shape} — checkpoint and model "
                "config disagree")
        if dim is not None:
            boxes[key] = _rank_box(shape, transpose, dim, rank, tp)
    with torch.no_grad():
        for key, leaf in stream_leaves(path, device=device,
                                       keys=set(targets), report=report,
                                       boxes=boxes):
            t, transpose, _ = targets[key]
            t.copy_(leaf.t() if transpose else leaf)


def load_sharded_model(model, optimizer, path, mesh=None, param_specs=None,
                       stream=False):
    """Load a checkpoint into `model` (and `optimizer`) in place: each
    parameter is copied into the model's own tensor on its device (Linear
    weights transposed back to ``[out, in]``), buffers likewise, and the
    optimizer's slots through `weights.from_jax_optimizer_state`.
    ``stream=True`` reads leaf by leaf from the mapped members. With a
    serving `mesh` (serving/sharded.py), `model` is this rank's shard
    module and each sharded parameter (`param_specs`, {name: dim}; default
    `serving_param_specs`) loads only the rank's slice. Returns the loaded
    state (tensors on the host; a rank's slices under a mesh)."""
    from ..weights import from_jax_optimizer_state

    del stream   # one process, one device: every load reads leaf by leaf
    tp, rank, targets = _model_targets(model, mesh, param_specs)
    boxes = {}
    if mesh is not None:
        arrays = _read_index(path)["arrays"]
        boxes = {key: _rank_box(tuple(arrays[key]["shape"]), transpose, dim,
                                rank, tp)
                 for key, (_, transpose, dim) in targets.items()
                 if dim is not None and key in arrays}
    state = {}
    with torch.no_grad():
        for key, t in stream_leaves(path, boxes=boxes):
            state[key] = t
            dst = targets.get(key)
            if dst is not None:
                tensor, transpose, _ = dst
                tensor.copy_(t.t() if transpose else t)
    state = _unflatten(state)
    opt = state.get("opt")
    if opt is not None and optimizer is not None:
        from_jax_optimizer_state(
            optimizer, model,
            {k: {s: a.float().numpy() for s, a in slots.items()}
             for k, slots in opt.items()})
    return state
