"""Build the port's CUDA sources with nvcc and load them with ctypes.

Each source under ``paddle_tpu_torch/csrc`` exposes a plain C function; it
is compiled at first use into ``build/`` at the root of the checkout
(``.gitignore`` lists it) and loaded with ``ctypes``. The library's file
name carries a hash of the source, the headers beside it (``*.cuh``) and
the flags, so an edited source or header never loads a stale build. A
source named in `PARTS` is compiled as several translation units at once
(its -D flags select each unit's share) and linked into that one library.
Nothing here runs at import time: the CPU tests import every module of the
port on a machine without ``nvcc``.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "--ptxas-options=-v")

# Sources built as several translation units compiled in parallel and
# linked into one library: the -D flags of each unit (the source says what
# each holds). The flash kernels' one unit took about a minute of nvcc.
PARTS = {
    "flash_attention.cu": (("-DFLASH_KIND=0",),) + tuple(
        (f"-DFLASH_KIND={kind}", f"-DFLASH_D={d}")
        for kind in (1, 2, 3) for d in (64, 128)),
}

_LIBS = {}
_LOCK = threading.Lock()


def nvcc_path():
    """The CUDA compiler: ``nvcc`` on PATH, else under CUDA_HOME."""
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") \
        or "/usr/local/cuda"
    cand = Path(home) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    raise RuntimeError("nvcc not found: the port's CUDA kernels are built "
                       "on first use on a machine with the CUDA toolkit")


def source_digest(src, flags=NVCC_FLAGS):
    """The hash in the library name of source file `src`: its bytes, the
    name and bytes of every ``*.cuh`` header in its directory, and the
    flags."""
    src = Path(src)
    h = hashlib.sha256(src.read_bytes())
    for header in sorted(src.parent.glob("*.cuh")):
        h.update(header.name.encode() + b"\0" + header.read_bytes())
    h.update(" ".join(flags).encode())
    return h.hexdigest()[:16]


def load_library(source):
    """Build (once) and load ``csrc/<source>``; returns the ctypes CDLL.
    Builds of different sources may run in parallel threads."""
    with _LOCK:
        if source in _LIBS:
            return _LIBS[source]
    src = CSRC / source
    parts = PARTS.get(source)
    flags = NVCC_FLAGS + sum(parts or (), ())
    lib_path = BUILD_DIR / f"{src.stem}-{source_digest(src, flags)}.so"
    if not lib_path.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = lib_path.with_suffix(
            f".{os.getpid()}-{threading.get_ident()}.tmp")
        if parts is None:
            log = _nvcc(src.name, [*NVCC_FLAGS, "-o", str(tmp), str(src)])
        else:
            log = _build_parts(src, parts, tmp)
        lib_path.with_suffix(".log").write_text(log)
        os.replace(tmp, lib_path)
    lib = ctypes.CDLL(str(lib_path))
    with _LOCK:
        return _LIBS.setdefault(source, lib)


def _nvcc(name, args):
    """Run nvcc with `args`; its output, or RuntimeError naming `name`."""
    proc = subprocess.run([nvcc_path(), *args], capture_output=True,
                          text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed on {name} (exit {proc.returncode}):"
                           f"\n{proc.stderr[-4000:]}")
    return proc.stdout + proc.stderr


def _build_parts(src, parts, out):
    """Compile `src` once for each of `parts` (its -D flags), all at once,
    and link the objects into the shared library `out`; nvcc's output."""
    from concurrent.futures import ThreadPoolExecutor

    compile_flags = tuple(f for f in NVCC_FLAGS if f != "-shared")
    objs = [out.with_suffix(f".{i}.o") for i in range(len(parts))]
    try:
        with ThreadPoolExecutor(len(parts)) as ex:
            logs = list(ex.map(
                lambda p, o: _nvcc(f"{src.name} {' '.join(p)}", [
                    *compile_flags, *p, "-c", "-o", str(o), str(src)]),
                parts, objs))
        logs.append(_nvcc(src.name, [*NVCC_FLAGS, "-o", str(out),
                                     *map(str, objs)]))
    finally:
        for o in objs:
            o.unlink(missing_ok=True)
    return "".join(logs)


def build_log(source):
    """nvcc's output (ptxas register and shared-memory report) for the
    library `load_library(source)` loaded, or None."""
    logs = sorted(BUILD_DIR.glob(f"{Path(source).stem}-*.log"),
                  key=lambda p: p.stat().st_mtime)
    return logs[-1].read_text() if logs else None
