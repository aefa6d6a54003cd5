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
tensors. `prepare_draws` and `prepare_shade` check a call and allocate its
outputs, and return the `build.Launch` that launches it (timers bracket
that launch alone). `lobe_keys` and `mixed_warps` report the lobe mix that
B5's lobe-grouped warps see. `COUNTS_DRAWS` and `COUNTS_SHADE` count kernel
launches and twin calls on CUDA tensors.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import torch

from yart_tpu_torch.kernels import shade_math as SM
from yart_tpu_torch.kernels.build import Counts, Launch, load
from yart_tpu_torch.ops import qmc

COUNTS_DRAWS = Counts()
COUNTS_SHADE = Counts()
DRAW_OUT = ("u0", "u1", "uc", "uc2", "uc_l", "ul0", "ul1", "u_rr")
LUT_KEYS = ("ggx_E", "ggx_Eavg", "ggx_base_E", "ggx_base_Eavg", "ggx_glass_E", "ggx_glass_inv_E")
LUT_SHAPES = {"ggx_E": (32, 32), "ggx_Eavg": (32,), "ggx_base_E": (16, 16, 16),
              "ggx_base_Eavg": (16, 16), "ggx_glass_E": (16, 16, 16), "ggx_glass_inv_E": (16, 16, 16)}
MAX_MATRIX_COLS = qmc.SOBOL_MATRIX_BITS
SHADE_TILE = 128  # B5's lanes a tile (csrc/shade.cu SHADE_TILE)
LOBES = ("coat", "metal", "dielectric", "glossy", "dead")  # B5's lane keys, in its grouped order


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
    sampler the kernel does not draw: B6 draws ZSobol with FastOwen and the
    hash RNG; ZSobol's other scramblers and the stratified sampler draw
    through the sampler itself (yart_tpu/kernels/pallas_shade.py:299-325)."""
    d = int(dim0)
    if isinstance(sampler, qmc.ZSobolSampler) and sampler.scramble is qmc.scramble_fast_owen:
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


def bind_draws(lib):
    """The launcher `draws_launch` of a loaded B6 library, its C signature
    declared (also for another build of a B6 source)."""
    fn = lib.draws_launch
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p, ctypes.c_int, _DrawArgs, ctypes.c_void_p, ctypes.c_void_p]
    return fn


@functools.cache  # loaded and bound once a process: `load` hashes the sources
def _draws_fn():
    return bind_draws(load("draws")[0])


def prepare_draws(setup: DrawSetup, n: int, fn=None) -> Launch:
    """Check a B6 call and allocate its output; returns the `Launch` that
    runs the launcher `fn` (`bind_draws` of a B6 library; None: the
    package's kernel) on the current stream, uncounted. Raises on input the
    kernel does not take."""
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
        stream = torch.cuda.current_stream().cuda_stream
    return Launch("draws", fn or _draws_fn(), (st.data_ptr(), int(n), args, out.data_ptr(), stream),
                  {k: out[j] for j, k in enumerate(DRAW_OUT)}, st.device)


def draws_cuda(setup: DrawSetup, n: int) -> dict:
    """Launch B6 on the current stream (counted); raises on input it does
    not take or if the launch is refused."""
    out = prepare_draws(setup, n)()
    COUNTS_DRAWS.launches += 1
    return out


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


def bind_shade(lib):
    """The launcher `shade_launch` of a loaded B5 library, its C signature
    declared (also for another build of a B5 source, as
    `python -m yart_tpu_torch.compare_kernels` loads them)."""
    fn = lib.shade_launch
    fn.restype = ctypes.c_int
    fn.argtypes = [_ShadeIn, _ShadeOut, _ShadeArgs, ctypes.c_void_p]
    return fn


@functools.cache  # loaded and bound once a process: `load` hashes the sources
def _shade_fn():
    return bind_shade(load("shade")[0])


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


def shade_structs(inp, gates, mis, any_lights, tables, out):
    """The launcher's three argument structs for a checked call: B5 reads
    the pointers of `_needs` (the others stay null) and the LUTs, and
    writes `out`."""
    ins = _ShadeIn()
    for k in _needs(mis, any_lights):
        setattr(ins, k, inp[k].data_ptr())
    for k in LUT_KEYS:
        setattr(ins, k, tables[k].data_ptr())
    outs = _ShadeOut(**{k: v.data_ptr() for k, v in out.items()})
    use_metal, use_diel, use_coat, use_aniso = (int(bool(g)) for g in gates)
    args = _ShadeArgs(int(inp["active"].shape[0]), use_metal, use_diel, use_coat, use_aniso, int(bool(mis)),
                      int(bool(any_lights)), int(bool(inp["depth0"])), int(bool(inp["rr_on"])),
                      float(inp["reg_threshold"]), SM.FAVG15, SM.FAVG15 * SM.FAVG15)
    return ins, outs, args


def empty_outputs(n: int, dev) -> dict:
    """B5's outputs, allocated: [N, 3] float32 vectors, [N] float32
    scalars, [N] bool flags (each on its own allocation, so 16-byte
    aligned as the kernel writes them)."""
    out = {k: torch.empty((n, 3), dtype=torch.float32, device=dev) for k in SM.OUT_V3}
    out.update({k: torch.empty(n, dtype=torch.float32, device=dev) for k in SM.OUT_F})
    out.update({k: torch.empty(n, dtype=torch.bool, device=dev) for k in SM.OUT_B})
    return out


def prepare_shade(inp, gates, mis, any_lights, tables, fn=None) -> Launch:
    """Check a B5 call and allocate its outputs; returns the `Launch` that
    runs the launcher `fn` (`bind_shade` of a B5 library; None: the
    package's kernel) on the current stream, uncounted. Raises on input the
    kernel does not take. Inputs need no alignment: the kernel reads each
    value where it uses it, at any address."""
    act = inp["active"]
    n = act.shape[0]
    dev = act.device
    if not act.is_cuda:
        raise ValueError("shade_cuda needs CUDA tensors")
    if n >= 2 ** 31 // 3:
        raise ValueError(f"{n} lanes overflow the kernel's int indexing")
    check_inputs(inp, mis, any_lights)
    for k in LUT_KEYS:
        t = tables[k]
        if tuple(t.shape) != LUT_SHAPES[k] or t.dtype != torch.float32 or t.device != dev:
            raise ValueError(f"LUT {k}: need float32 {LUT_SHAPES[k]} on {dev}")
    out = empty_outputs(n, dev)
    ins, outs, args = shade_structs(inp, gates, mis, any_lights, tables, out)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
    return Launch("shade", fn or _shade_fn(), (ins, outs, args, stream), out, dev)


def shade_cuda(inp, gates, mis, any_lights, tables):
    """Launch B5 on the current stream (counted); raises on input it does
    not take or if the launch is refused. Returns the outputs of
    `shade_plain`."""
    out = prepare_shade(inp, gates, mis, any_lights, tables)()
    COUNTS_SHADE.launches += 1
    return out


def lobe_keys(inp, gates, tables):
    """Each lane's key as B5 orders a tile's lanes: the index in LOBES of
    its picked lobe (`shade_math.lobe_pick`, the twin's own pick), or
    "dead" for a lane neither active nor found. [N] int64."""
    c = SM.components(inp)
    fet = {}
    if gates[2]:  # the pick reads the coat's two fetches
        coords = SM.candidates(c, gates)["coords"]
        fet = SM.run_fetches(tables, {k: coords[k] for k in ("eavg_c", "e_o_c")})
    sel_coat, sel_metal, sel_diel = SM.lobe_pick(c, fet, gates)
    key = torch.full(sel_coat.shape, LOBES.index("glossy"), dtype=torch.int64, device=sel_coat.device)
    key = torch.where(sel_diel, LOBES.index("dielectric"), key)
    key = torch.where(sel_metal, LOBES.index("metal"), key)
    key = torch.where(sel_coat, LOBES.index("coat"), key)
    return torch.where(inp["active"] | inp["found"], key, LOBES.index("dead"))


def mixed_warps(keys, tile: int = SHADE_TILE) -> dict:
    """Warps (32 lanes) that hold lanes of more than one key, in lane order
    and after B5's grouping (each tile of `tile` lanes ordered by key, the
    lanes of one key in lane order), and the lanes of each key. The last
    tile's lanes past N count as no lane."""
    n = keys.shape[0]
    pad = (-n) % tile
    k = torch.cat([keys.cpu(), torch.full((pad,), -1, dtype=keys.dtype)])
    grouped = torch.sort(torch.where(k < 0, len(LOBES), k).view(-1, tile), dim=1, stable=True).values
    grouped = torch.where(grouped == len(LOBES), -1, grouped).view(-1)

    def mixed(a):
        w = a.view(-1, 32)
        first = w[:, :1]
        return int(((w != first) & (w >= 0) & (first >= 0)).any(dim=1).sum())

    return {"lanes": {name: int((keys == i).sum()) for i, name in enumerate(LOBES)},
            "warps": (n + 31) // 32, "mixed_before": mixed(k), "mixed_after": mixed(grouped)}


def shade(inp, gates, mis, any_lights, tables):
    """The fused bounce tail: B5 for CUDA tensors, its twin for CPU ones.
    Returns {L_emit, contrib, shadow_d, o, d, atten, last_p: [N, 3];
    shadow_tmax, last_pdf, acc_rough: [N]; nee_need, active, specular: [N]
    bool}."""
    if inp["active"].is_cuda:
        return shade_cuda(inp, gates, mis, any_lights, tables)
    return shade_plain(inp, gates, mis, any_lights, tables)
