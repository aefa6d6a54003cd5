"""The scene builder's native host code: the binned-SAH BVH build and its
8-wide collapse in C++ (`csrc/host/bvh_builder.cpp`, `bvh8_collapse.cpp`),
over ctypes.

Port of `yart_tpu/native/__init__.py` `build_bvh_native` and
`collapse_bvh8_native` with the same C ABI (`yart_build_bvh`,
`yart_collapse_bvh8`). The library is built with g++ at first use into the
kernels' build directory (`kernels/build.py` HOST_LIBRARIES, GXX_FLAGS:
no -march=native, no FMA contraction, so the tree is the same on every
x86-64 host). There is no quiet fallback: without g++, or when it fails,
the build raises with its command and its errors. The numpy `build_bvh` /
`collapse_bvh8` of `scene/bvh.py` are the twins; they return the same
arrays in the same dtypes and shapes, and `SceneBuilder.compile` calls the
functions of this module, so a caller selects the twin by replacing them
here.
"""

from __future__ import annotations

import ctypes
import threading

import numpy as np

from yart_tpu_torch.scene.bvh import HostBVH, HostBVH8

_F32P = ctypes.POINTER(ctypes.c_float)
_I32P = ctypes.POINTER(ctypes.c_int32)
_lock = threading.Lock()
_lib = None


def library() -> ctypes.CDLL:
    """The host library with its prototypes bound; built at first use."""
    global _lib
    with _lock:
        if _lib is None:
            from yart_tpu_torch.kernels import build

            lib = build.load("yartnative")[0]
            lib.yart_build_bvh.restype = ctypes.c_int
            lib.yart_build_bvh.argtypes = [
                _F32P, _F32P, _F32P, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                _F32P, _F32P, _I32P, _I32P, _I32P, _I32P, _I32P,
            ]
            lib.yart_collapse_bvh8.restype = ctypes.c_int
            lib.yart_collapse_bvh8.argtypes = [
                _F32P, _F32P, _I32P, _I32P, ctypes.c_int, ctypes.c_int,
                _F32P, _I32P, _I32P, _I32P,
            ]
            _lib = lib
        return _lib


def _f32(a: np.ndarray):
    return a.ctypes.data_as(_F32P)


def _i32(a: np.ndarray):
    return a.ctypes.data_as(_I32P)


def build_bvh(v0, v1, v2, max_leaf: int = 4, n_bins: int = 20) -> HostBVH:
    """Binned-SAH BVH over triangles v0, v1, v2 [T, 3]: the HostBVH of
    `scene.bvh.build_bvh`, from the C++ build (`cap = 2T - 1` node buffers
    trimmed to the nodes it made)."""
    v0, v1, v2 = (np.ascontiguousarray(v, np.float32) for v in (v0, v1, v2))
    n = int(v0.shape[0])
    if not v0.shape == v1.shape == v2.shape == (n, 3):
        raise ValueError(f"build_bvh: v0, v1, v2 must be [T, 3] alike, got {v0.shape}, {v1.shape}, {v2.shape}")
    lib = library()
    cap = max(1, 2 * n - 1)
    node_min = np.empty((cap, 3), np.float32)
    node_max = np.empty((cap, 3), np.float32)
    left = np.zeros(cap, np.int32)
    count = np.zeros(cap, np.int32)
    order = np.empty(n, np.int32)
    n_nodes = np.zeros(1, np.int32)
    depth = np.zeros(1, np.int32)
    rc = lib.yart_build_bvh(_f32(v0), _f32(v1), _f32(v2), n, max_leaf, n_bins, _f32(node_min),
                            _f32(node_max), _i32(left), _i32(count), _i32(order), _i32(n_nodes),
                            _i32(depth))
    if rc != 0:
        raise ValueError(f"yart_build_bvh refused {n} triangles, max_leaf {max_leaf}, n_bins {n_bins}")
    m = int(n_nodes[0])
    return HostBVH(node_min[:m], node_max[:m], left[:m], count[:m], order, int(depth[0]))


def collapse_bvh8(hb: HostBVH) -> HostBVH8:
    """The 8-wide collapse of binary tree `hb`: the HostBVH8 of
    `scene.bvh.collapse_bvh8`, from the C++ collapse."""
    n = int(hb.left.shape[0])
    node_min = np.ascontiguousarray(hb.node_min, np.float32)
    node_max = np.ascontiguousarray(hb.node_max, np.float32)
    left = np.ascontiguousarray(hb.left, np.int32)
    count = np.ascontiguousarray(hb.count, np.int32)
    inner = left[count == 0]
    if not (node_min.shape == node_max.shape == (n, 3) and count.shape == (n,)
            and ((inner >= 1) & (inner < n - 1)).all()):
        raise ValueError("collapse_bvh8: not a binary tree of build_bvh's layout (a child outside its nodes)")
    lib = library()
    cap = max(1, n)
    boxes = np.empty((cap, 8, 6), np.float32)
    child = np.empty((cap, 8), np.int32)
    out_m = np.zeros(1, np.int32)
    out_d = np.zeros(1, np.int32)
    rc = lib.yart_collapse_bvh8(_f32(node_min), _f32(node_max), _i32(left), _i32(count), n, cap,
                                _f32(boxes), _i32(child), _i32(out_m), _i32(out_d))
    if rc != 0:
        raise ValueError(f"yart_collapse_bvh8 failed (code {rc}) on a tree of {n} nodes")
    m = int(out_m[0])
    return HostBVH8(boxes[:m].copy(), child[:m].copy(), int(out_d[0]))
