"""Build the sources of `yart_tpu_torch/csrc/` and load them with ctypes.

Each library is compiled at first use into
`build/yart_tpu_torch/<name>-<hash>/lib<name>.so` at the root of the
checkout (`build/` is git-ignored), keyed by a hash of the sources and the
flags, so a changed source rebuilds and an unchanged one loads from disk:
the CUDA kernels (LIBRARIES) with nvcc, the host BVH builder
(HOST_LIBRARIES, `yart_tpu_torch/native.py`) with g++. The sources have a
plain C interface and include no PyTorch headers, which keeps a build to
seconds.
"""

from __future__ import annotations

import ctypes
import dataclasses
import hashlib
import os
import re
import shutil
import subprocess
import tempfile
import threading
from concurrent.futures import ThreadPoolExecutor

import torch

CSRC = os.path.abspath(os.path.join(os.path.dirname(__file__), "..", "csrc"))
# Every kernel library of the port: name -> its sources under csrc/.
LIBRARIES = {
    "brute_intersect": ("brute_intersect.cu",),  # B1, kernels/brute.py
    "presort_keys": ("presort_keys.cu",),  # B2, kernels/presort.py
    "fused_trace": ("fused_trace.cu",),  # B3, kernels/fusedtrace.py
    "cluster_pairs": ("cluster_pairs.cu",),  # B4, kernels/clusterpairs.py
    "shade": ("shade.cu",),  # B5, kernels/shade.py
    "draws": ("draws.cu",),  # B6, kernels/shade.py
    "select_clusters": ("select_clusters.cu",),  # B7a, kernels/blocktrace.py
    "test_clusters": ("test_clusters.cu",),  # B7b, kernels/blocktrace.py
}
# Host libraries, built with g++: name -> its sources under csrc/.
HOST_LIBRARIES = {
    "yartnative": ("host/bvh_builder.cpp", "host/bvh8_collapse.cpp"),  # native.py
    "yartjpeg": ("host/jpeg_scan.cpp",),  # io/jpeg.py
}
# Headers a library's sources include from csrc/: hashed with them, not compiled alone.
HEADERS = {"shade": ("shade_lane.cuh",)}
BUILD_ROOT = os.path.abspath(
    os.path.join(os.path.dirname(__file__), "..", "..", "build", "yart_tpu_torch")
)
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "--fmad=false",
    "-shared", "-Xcompiler", "-fPIC",
    "-Xptxas", "-v",  # registers, shared memory and spills; kept beside the library
)
# No -march=native and no contraction of a*b + c into an FMA: the SAH
# costs, bin indices and centroids then round alike on every x86-64 host,
# so the tree and the triangle order cut from it do not depend on the
# machine that builds the scene (the JAX package's `-O3 -march=native`
# build contracts them, and its tree varies with the host).
GXX_FLAGS = ("-O3", "-std=c++17", "-shared", "-fPIC", "-ffp-contract=off")

@dataclasses.dataclass
class Counts:
    """Per kernel: its launches (also by mode, where a kernel has modes),
    and calls of its plain twin on CUDA tensors (which the render paths
    must never make)."""

    launches: int = 0
    plain_cuda: int = 0
    modes: dict = dataclasses.field(default_factory=dict)  # launches per kernel mode

    def reset(self) -> None:
        self.launches = 0
        self.plain_cuda = 0
        self.modes = {}


def refuse_grad(name: str, *tensors) -> None:
    """Raise if grad mode is on and an input requires grad. The kernels
    read raw pointers and have no backward, so a gradient through one would
    be lost without a word; the traversals take detached inputs under
    `torch.no_grad()` (as a Pallas call without a VJP fails under
    `jax.grad`). `tensors` may hold None and tuples of tensors."""
    if not torch.is_grad_enabled():
        return
    flat = []
    for t in tensors:
        flat.extend(t if isinstance(t, (tuple, list)) else (t,))
    if any(isinstance(t, torch.Tensor) and t.requires_grad for t in flat):
        raise RuntimeError(
            f"{name}: an input requires grad, but the traversal has no backward; "
            "call it on detached inputs under torch.no_grad()"
        )


class Launch:
    """One kernel call, checked and ready: its bound launcher, its ctypes
    arguments (the stream among them) and its preallocated outputs. Calling
    it launches the kernel once, uncounted, and returns the outputs, so a
    timer around the call times the launch and not the wrapper's checks and
    allocations (the wrappers' `prepare` functions make one). `inputs` are
    the tensors whose pointers `args` holds, kept alive with it."""

    __slots__ = ("name", "fn", "args", "out", "device", "inputs")

    def __init__(self, name: str, fn, args: tuple, out, device, inputs: tuple = ()):
        self.name, self.fn, self.args, self.out, self.device = name, fn, args, out, device
        self.inputs = inputs

    def __call__(self):
        with torch.cuda.device(self.device):
            err = self.fn(*self.args)
        if err != 0:
            raise RuntimeError(f"{self.name} launch failed: cudaError {err}")
        return self.out


_lock = threading.Lock()  # guards _loaded
_loaded: dict = {}


def nvcc_path() -> str:
    """nvcc from PATH, else the CUDA toolkit's default location."""
    found = shutil.which("nvcc")
    if found:
        return found
    default = "/usr/local/cuda/bin/nvcc"
    if os.path.exists(default):
        return default
    raise RuntimeError(
        "nvcc not found: the CUDA kernels build only where the CUDA toolkit "
        "is installed"
    )


def gxx_path() -> str:
    """g++ from PATH; the host libraries need it."""
    found = shutil.which("g++")
    if found:
        return found
    raise RuntimeError(
        "g++ not found on PATH: the host libraries (yart_tpu_torch/csrc/host/: "
        "the scene builder's BVH build, the JPEG scan decoder) are compiled "
        "with g++ at first use"
    )


def library_path(name: str, sources) -> str:
    flags = GXX_FLAGS if name in HOST_LIBRARIES else NVCC_FLAGS
    h = hashlib.sha256(" ".join(flags).encode())
    for src in (*sources, *HEADERS.get(name, ())):
        with open(os.path.join(CSRC, src), "rb") as f:
            h.update(src.encode() + b"\0" + f.read())
    return os.path.join(BUILD_ROOT, f"{name}-{h.hexdigest()[:16]}", f"lib{name}.so")


def load(name: str) -> tuple:
    """Build (if needed) and load library `name` of LIBRARIES or
    HOST_LIBRARIES. Returns (ctypes.CDLL, built_now). The compiler runs
    outside the lock, so threads loading different libraries build them at
    once."""
    host = name in HOST_LIBRARIES
    sources = HOST_LIBRARIES[name] if host else LIBRARIES[name]
    path = library_path(name, sources)
    with _lock:
        if path in _loaded:
            return _loaded[path], False
    built = False
    if not os.path.exists(path):
        os.makedirs(os.path.dirname(path), exist_ok=True)
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=os.path.dirname(path))
        os.close(fd)
        compiler, flags = (gxx_path(), GXX_FLAGS) if host else (nvcc_path(), NVCC_FLAGS)
        cmd = [compiler, *flags, "-o", tmp] + [os.path.join(CSRC, s) for s in sources]
        proc = subprocess.run(cmd, capture_output=True, text=True)
        if proc.returncode != 0:
            os.unlink(tmp)
            raise RuntimeError(
                f"{os.path.basename(compiler)} failed building {name} (exit {proc.returncode}):\n"
                f"{' '.join(cmd)}\n{proc.stdout}\n{proc.stderr}"
            )
        if not host:
            with open(os.path.join(os.path.dirname(path), "ptxas.txt"), "w") as f:
                f.write(proc.stdout + proc.stderr)
        os.replace(tmp, path)  # atomic: a concurrent loader sees old or new
        built = True
    lib = ctypes.CDLL(path)
    with _lock:
        return _loaded.setdefault(path, lib), built


def build_all() -> dict:
    """Build and load every library of LIBRARIES and HOST_LIBRARIES, one
    compiler per library, all started together. Returns {name: compiled_now}."""
    names = (*LIBRARIES, *HOST_LIBRARIES)
    with ThreadPoolExecutor(len(names)) as pool:
        return dict(zip(names, pool.map(lambda name: load(name)[1], names)))


def occupancy(name: str, *args: int) -> int:
    """Resident blocks per SM of library `name`'s kernel, from its
    `<name>_occupancy(int...)` function (cudaOccupancyMaxActiveBlocksPerMultiprocessor;
    B2 takes no argument, B4 its cluster size)."""
    fn = getattr(load(name)[0], f"{name}_occupancy")
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_int] * len(args)
    return int(fn(*args))


def ptxas_report(name: str) -> dict:
    """{kernel: {"registers", "spill_stores", "spill_loads"}} of library
    `name` from the `-Xptxas -v` lines its build kept (empty if it was
    built elsewhere)."""
    return parse_ptxas(os.path.join(os.path.dirname(library_path(name, LIBRARIES[name])), "ptxas.txt"))


def parse_ptxas(txt: str) -> dict:
    """The registers and spill bytes per kernel of a kept `-Xptxas -v`
    report at path `txt` (empty if there is none)."""
    if not os.path.exists(txt):
        return {}
    out, kernel = {}, None
    with open(txt) as f:
        for line in f:
            m = re.search(r"Compiling entry function '(\w+)'", line)
            if m:
                kernel = m.group(1)
            m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
            if m and kernel:
                out.setdefault(kernel, {}).update(spill_stores=int(m.group(1)), spill_loads=int(m.group(2)))
            m = re.search(r"Used (\d+) registers", line)
            if m and kernel:
                out.setdefault(kernel, {})["registers"] = int(m.group(1))
    return out
