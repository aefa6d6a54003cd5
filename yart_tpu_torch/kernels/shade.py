"""B5 (fused shade) and B6 (sampler draws): Hopper kernels and plain twins.

`draws` computes one bounce's 8 sampler dimensions per lane; on CUDA
tensors it launches `csrc/draws.cu` (replacing
`yart_tpu/kernels/pallas_shade.py` `draws_pallas`), on CPU tensors it runs
`draws_plain`, the sampler's own `ops/qmc.py` draws at dims d0, +2, +3,
+4, +5, +7. `shade` computes the post-intersect bounce tail
(`shade_math.candidates` + the LUT fetches + `shade_math.finish`); on
CUDA tensors it launches `csrc/shade.cu` (replacing `shade_pallas`), on
CPU tensors it runs `shade_plain`, which is `shade_math.shade`. There is
no fallback from a kernel to its twin.

Both kernels repeat their twins' operations in order and are built with
--fmad=false, so they agree bitwise with the twins run on the same card
tensors. `COUNTS_DRAWS` and `COUNTS_SHADE` count kernel launches and twin
calls on CUDA tensors.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import torch

from yart_tpu_torch.kernels import shade_math as SM
from yart_tpu_torch.kernels.build import Counts, load
from yart_tpu_torch.ops import qmc

COUNTS_DRAWS = Counts()
COUNTS_SHADE = Counts()
DRAW_OUT = ("u0", "u1", "uc", "uc2", "uc_l", "ul0", "ul1", "u_rr")
LUT_KEYS = ("ggx_E", "ggx_Eavg", "ggx_base_E", "ggx_base_Eavg", "ggx_glass_E", "ggx_glass_inv_E")
LUT_SHAPES = {"ggx_E": (32, 32), "ggx_Eavg": (32,), "ggx_base_E": (16, 16, 16),
              "ggx_base_Eavg": (16, 16), "ggx_glass_E": (16, 16, 16), "ggx_glass_inv_E": (16, 16, 16)}
MAX_MATRIX_COLS = qmc.SOBOL_MATRIX_BITS


class DrawSetup(NamedTuple):
    """What B6 needs for one bounce: the sampler and lane state (the twin
    draws from them), the kind ("zsobol" or "hash") and its per-bounce u32
    constants."""

    sampler: object
    state: torch.Tensor  # [N] int64: ZSobol's Morton key, or the hash key
    dim0: int
    kind: str
    consts: tuple


def sampler_draw_setup(sampler, lane_state, dim0: int):
    """B6's inputs for `sampler` at bounce dimension `dim0`, or None for a
    sampler the kernel does not draw (none of the port's samplers yet:
    ZSobol with FastOwen and hash are both drawn in-kernel)."""
    d = int(dim0)
    if isinstance(sampler, qmc.ZSobolSampler):
        pc, s1, s2a, s2b = sampler._perm_c, sampler._seed_1d, sampler._seed_2d_a, sampler._seed_2d_b
        # perm_c at (d0, +2, +3, +4, +5, +7); (seed_2d_a, seed_2d_b) at d0
        # and d0 + 5; seed_1d at (+2, +3, +4, +7)
        consts = (pc[d], pc[d + 2], pc[d + 3], pc[d + 4], pc[d + 5], pc[d + 7],
                  s2a[d], s2b[d], s2a[d + 5], s2b[d + 5], s1[d + 2], s1[d + 3], s1[d + 4], s1[d + 7])
        return DrawSetup(sampler, lane_state, d, "zsobol", consts)
    if isinstance(sampler, qmc.HashSampler):
        consts = tuple(((d + k) * 0xC2B2AE35) & qmc.M32 for k in range(8))
        return DrawSetup(sampler, lane_state, d, "hash", consts)
    return None


def draws_plain(setup: DrawSetup, n: int) -> dict:
    """B6's twin: the sampler's own draws, {name: [N] float32}."""
    if setup.state.is_cuda:
        COUNTS_DRAWS.plain_cuda += 1
    s, st, d = setup.sampler, setup.state[:n], setup.dim0
    u = s.get2d(st, d)
    ul = s.get2d(st, d + 5)
    return dict(u0=u[:, 0], u1=u[:, 1], uc=s.get1d(st, d + 2), uc2=s.get1d(st, d + 3),
                uc_l=s.get1d(st, d + 4), ul0=ul[:, 0], ul1=ul[:, 1], u_rr=s.get1d(st, d + 7))


class _DrawArgs(ctypes.Structure):
    _fields_ = [
        ("kind", ctypes.c_int),  # 0 = zsobol, 1 = hash
        ("n_base4_digits", ctypes.c_int),
        ("log2spp", ctypes.c_int),
        ("n_cols", ctypes.c_int),
        ("consts", ctypes.c_uint32 * 14),
        ("matrix1", ctypes.c_uint32 * MAX_MATRIX_COLS),
    ]


@functools.cache  # loaded and bound once a process: `load` hashes the sources
def _draws_fn():
    lib, _ = load("draws")
    fn = lib.draws_launch
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p, ctypes.c_int, _DrawArgs, ctypes.c_void_p, ctypes.c_void_p]
    return fn


def draws_cuda(setup: DrawSetup, n: int) -> dict:
    """Launch B6 on the current stream; raises on input it does not take
    or if the launch is refused."""
    st = setup.state
    if not st.is_cuda:
        raise ValueError("draws_cuda needs a CUDA lane state")
    if st.dtype != torch.int64 or st.dim() != 1 or st.shape[0] < n or not st.is_contiguous():
        raise ValueError(f"lane state must be a contiguous [>= {n}] int64 tensor, got "
                         f"{st.dtype} {tuple(st.shape)}")
    args = _DrawArgs()
    if setup.kind == "zsobol":
        s = setup.sampler
        cols = s._matrix1
        args.kind, args.n_base4_digits, args.log2spp, args.n_cols = 0, s.n_base4_digits, s.log2spp, len(cols)
        for i, c in enumerate(cols):
            args.matrix1[i] = c
    elif setup.kind == "hash":
        args.kind = 1
    else:
        raise ValueError(f"unknown draw kind {setup.kind!r}")
    for i, c in enumerate(setup.consts):
        args.consts[i] = c
    out = torch.empty((len(DRAW_OUT), n), dtype=torch.float32, device=st.device)
    with torch.cuda.device(st.device):
        err = _draws_fn()(st.data_ptr(), int(n), args, out.data_ptr(),
                          torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"draws launch failed: cudaError {err}")
    COUNTS_DRAWS.launches += 1
    return {k: out[j] for j, k in enumerate(DRAW_OUT)}


def draws(setup: DrawSetup, n: int) -> dict:
    """The bounce's 8 sampler dims, {name: [N] float32}: B6 for a CUDA lane
    state, its twin for a CPU one."""
    if setup.state.is_cuda:
        return draws_cuda(setup, n)
    return draws_plain(setup, n)


# ---------------------------------------------------------------------------
# B5: the fused shade tail
# ---------------------------------------------------------------------------

_P = ctypes.c_void_p


class _ShadeIn(ctypes.Structure):
    _fields_ = ([(k, _P) for k in SM.V3_KEYS] + [(k, _P) for k in SM.F_KEYS]
                + [(k, _P) for k in SM.B_KEYS] + [(k, _P) for k in LUT_KEYS])


class _ShadeOut(ctypes.Structure):
    _fields_ = [(k, _P) for k in SM.OUT_V3 + SM.OUT_F + SM.OUT_B]


class _ShadeArgs(ctypes.Structure):
    _fields_ = [
        ("n", ctypes.c_int),
        ("use_metal", ctypes.c_int), ("use_diel", ctypes.c_int),
        ("use_coat", ctypes.c_int), ("use_aniso", ctypes.c_int),
        ("mis", ctypes.c_int), ("any_lights", ctypes.c_int),
        ("depth0", ctypes.c_int), ("rr_on", ctypes.c_int),
        ("reg_threshold", ctypes.c_float),
        ("favg15", ctypes.c_float),  # float32(FAVG15)
        ("favg15_sq", ctypes.c_float),  # float32(FAVG15 * FAVG15), the product in double
    ]


@functools.cache  # loaded and bound once a process: `load` hashes the sources
def _shade_fn():
    lib, _ = load("shade")
    fn = lib.shade_launch
    fn.restype = ctypes.c_int
    fn.argtypes = [_ShadeIn, _ShadeOut, _ShadeArgs, ctypes.c_void_p]
    return fn


def shade_plain(inp, gates, mis, any_lights, tables):
    """B5's twin: `shade_math.shade` (candidates -> fetches -> finish)."""
    if inp["active"].is_cuda:
        COUNTS_SHADE.plain_cuda += 1
    return SM.shade(inp, gates, mis, any_lights, tables)


def _needs(mis, any_lights):
    keys = [k for k in SM.V3_KEYS + SM.F_KEYS + SM.B_KEYS if not k.startswith("ls_")]
    keys.append("ls_wi")
    if mis and any_lights:
        keys += [k for k in SM.V3_KEYS + SM.F_KEYS + SM.B_KEYS if k.startswith("ls_") and k != "ls_wi"]
    return keys


def check_inputs(inp, mis, any_lights) -> None:
    """Raise unless every input B5 reads is a contiguous tensor of its
    shape and type on the lanes' device: [N, 3] float32 vectors, [N]
    float32 scalars, [N] bool flags."""
    act = inp["active"]
    n, dev = act.shape[0], act.device
    for k in _needs(mis, any_lights):
        a = inp[k]
        want = (n, 3) if k in SM.V3_KEYS else (n,)
        dtype = torch.bool if k in SM.B_KEYS else torch.float32
        if a.shape != want or a.dtype != dtype or a.device != dev or not a.is_contiguous():
            raise ValueError(f"shade input {k}: need a contiguous {dtype} {want} tensor on {dev}, "
                             f"got {a.dtype} {tuple(a.shape)} on {a.device}, "
                             f"{'' if a.is_contiguous() else 'not '}contiguous")


def shade_cuda(inp, gates, mis, any_lights, tables):
    """Launch B5 on the current stream; raises on input it does not take
    or if the launch is refused. Returns the outputs of `shade_plain`."""
    act = inp["active"]
    n = act.shape[0]
    dev = act.device
    if not act.is_cuda:
        raise ValueError("shade_cuda needs CUDA tensors")
    if n >= 2 ** 31 // 3:
        raise ValueError(f"{n} lanes overflow the kernel's int indexing")
    check_inputs(inp, mis, any_lights)
    ins = _ShadeIn()
    for k in _needs(mis, any_lights):
        setattr(ins, k, inp[k].data_ptr())
    for k in LUT_KEYS:
        t = tables[k]
        if tuple(t.shape) != LUT_SHAPES[k] or t.dtype != torch.float32 or t.device != dev:
            raise ValueError(f"LUT {k}: need float32 {LUT_SHAPES[k]} on {dev}")
        setattr(ins, k, t.data_ptr())
    out = {k: torch.empty((n, 3), dtype=torch.float32, device=dev) for k in SM.OUT_V3}
    out.update({k: torch.empty(n, dtype=torch.float32, device=dev) for k in SM.OUT_F})
    out.update({k: torch.empty(n, dtype=torch.bool, device=dev) for k in SM.OUT_B})
    outs = _ShadeOut(**{k: v.data_ptr() for k, v in out.items()})
    use_metal, use_diel, use_coat, use_aniso = (int(bool(g)) for g in gates)
    args = _ShadeArgs(n, use_metal, use_diel, use_coat, use_aniso, int(bool(mis)),
                      int(bool(any_lights)), int(bool(inp["depth0"])), int(bool(inp["rr_on"])),
                      float(inp["reg_threshold"]), SM.FAVG15, SM.FAVG15 * SM.FAVG15)
    with torch.cuda.device(dev):
        err = _shade_fn()(ins, outs, args, torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"shade launch failed: cudaError {err}")
    COUNTS_SHADE.launches += 1
    return out


def shade(inp, gates, mis, any_lights, tables):
    """The fused bounce tail: B5 for CUDA tensors, its twin for CPU ones.
    Returns {L_emit, contrib, shadow_d, o, d, atten, last_p: [N, 3];
    shadow_tmax, last_pdf, acc_rough: [N]; nee_need, active, specular: [N]
    bool}."""
    if inp["active"].is_cuda:
        return shade_cuda(inp, gates, mis, any_lights, tables)
    return shade_plain(inp, gates, mis, any_lights, tables)
