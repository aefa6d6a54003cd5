"""Test helpers: the builders' BVH paths, shared by the port's test files.

- `jax_native_library(dir)` compiles the JAX package's own native sources
  (`yart_tpu/native/*.cpp`, read, never edited) with the port's g++ flags
  (`yart_tpu_torch/kernels/build.py` GXX_FLAGS) into `dir`, so the JAX tree
  does not depend on this host's FMA contraction or on whichever library
  the JAX loader would find; `jax_native_at(mp, path)` points
  `yart_tpu.native` at it.
- `numpy_twins(mp)` puts both builders on their numpy BVH build and BVH8
  collapse (the JAX package's fallback, the port's twins).
"""

import os
import subprocess

import yart_tpu.native
import yart_tpu_torch.native
from yart_tpu_torch.kernels import build
from yart_tpu_torch.scene import bvh as TB

JAX_NATIVE_SOURCES = tuple(os.path.join(os.path.dirname(yart_tpu.native.__file__), s)
                           for s in ("bvh_builder.cpp", "bvh8_collapse.cpp"))


def jax_native_library(out_dir) -> str:
    """Path of the JAX package's native library built with the port's flags
    in `out_dir` (built once a directory)."""
    path = os.path.join(str(out_dir), "libyartnative_jax.so")
    if not os.path.exists(path):
        cmd = [build.gxx_path(), *build.GXX_FLAGS, "-o", path, *JAX_NATIVE_SOURCES]
        subprocess.run(cmd, check=True, capture_output=True)
    return path


def jax_native_at(mp, path: str) -> None:
    """`yart_tpu.native` loads the library at `path` (monkeypatch `mp`)."""
    mp.setattr(yart_tpu.native, "_build_library", lambda: path)
    mp.setattr(yart_tpu.native, "_lib", None)
    mp.setattr(yart_tpu.native, "_lib_tried", False)


def numpy_twins(mp, jax: bool = True, collapse: bool = True) -> None:
    """The port's builder (and the JAX builder's, with `jax`) on the numpy
    BVH build, and with `collapse` the numpy BVH8 collapse too."""
    mp.setattr(yart_tpu_torch.native, "build_bvh", TB.build_bvh)
    if jax:
        mp.setattr(yart_tpu.native, "build_bvh_native", lambda *a, **k: None)
    if collapse:
        mp.setattr(yart_tpu_torch.native, "collapse_bvh8", TB.collapse_bvh8)
        if jax:
            mp.setattr(yart_tpu.native, "collapse_bvh8_native", lambda *a, **k: None)
