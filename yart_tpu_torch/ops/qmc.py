"""Counter-based samplers: ZSobol (with its four scramblers), the
stratified sampler and the hash RNG.

Port of `yart_tpu/ops/qmc.py`. Every draw is a pure function of
(pixel, sample, dimension), bit-exact with the JAX package.

Unsigned arithmetic runs in int64 tensors: u32 values are kept in
[0, 2^32) by masking after every multiply, and 64-bit values (the Morton
sample key and pbrt's `mixBits`) are raw two's-complement int64 bit
patterns. A wrapping int64 multiply gives exactly the low 64 bits of the
unsigned product; right shifts are arithmetic on int64, so `_shr` masks
them back to logical shifts. The JAX package's (hi, lo) u32-pair emulation
is not needed. The stratified sampler's lane state, a (pixel key, sample
index) pair of u32 in the JAX package, is packed into one int64 as
(pixel key << 32) | sample, so every consumer that gathers or carries a
lane state (the staged compaction, the differentiable checkpoints) takes
it as it takes the other samplers' single tensor.

The dimension is a Python int here (the integrator's bounce loop runs on
the host), so the per-dimension hash constants are looked up on the host
and never gathered on the device.
"""

from __future__ import annotations

import functools
import math

import numpy as np
import torch

M32 = 0xFFFFFFFF
ONE_MINUS_EPS = float(np.float32(1.0 - 2.0 ** -24))
MAX_DIMS = 512  # enough for 30 bounces * 8 dims + camera dims

_M64 = (1 << 64) - 1


def _s64(c: int) -> int:
    """Unsigned 64-bit constant -> the int64 with the same bits."""
    return c - (1 << 64) if c >= 1 << 63 else c


def _shr(x: torch.Tensor, k: int) -> torch.Tensor:
    """Logical right shift of a 64-bit pattern held in int64."""
    if k == 0:
        return x
    return (x >> k) & ((1 << (64 - k)) - 1)


def mix32(x: torch.Tensor) -> torch.Tensor:
    """Low-bias 32-bit finalizer (Wellons); used for the hash RNG stream."""
    x = x & M32
    x = x ^ (x >> 16)
    x = (x * 0x7FEB352D) & M32
    x = x ^ (x >> 15)
    x = (x * 0x846CA68B) & M32
    x = x ^ (x >> 16)
    return x


def reverse_bits32(n: torch.Tensor) -> torch.Tensor:
    """Bit reversal of a u32 (src/math/math.hpp:102-109)."""
    n = ((n << 16) | (n >> 16)) & M32
    n = ((n & 0x00FF00FF) << 8) | ((n & 0xFF00FF00) >> 8)
    n = ((n & 0x0F0F0F0F) << 4) | ((n & 0xF0F0F0F0) >> 4)
    n = ((n & 0x33333333) << 2) | ((n & 0xCCCCCCCC) >> 2)
    n = ((n & 0x55555555) << 1) | ((n & 0xAAAAAAAA) >> 1)
    return n


def left_shift2_32(x: torch.Tensor) -> torch.Tensor:
    """Interleave zeros between the bits of a 16-bit value."""
    x = x & 0xFFFF
    x = (x ^ (x << 8)) & 0x00FF00FF
    x = (x ^ (x << 4)) & 0x0F0F0F0F
    x = (x ^ (x << 2)) & 0x33333333
    x = (x ^ (x << 1)) & 0x55555555
    return x


def encode_morton2_32(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """Morton-interleave two <=16-bit coords into 32 bits."""
    return (left_shift2_32(y) << 1) | left_shift2_32(x)


def u32_to_unit_float(v: torch.Tensor) -> torch.Tensor:
    """u32 (in int64) -> float32 in [0, 1), rounding exactly as the JAX
    package does: both 16-bit halves convert exactly, `* 65536` is a
    mantissa shift, and the one add performs the single correct rounding
    of a direct u32 -> f32 cast."""
    hi = (v >> 16).to(torch.float32)
    lo = (v & 0xFFFF).to(torch.float32)
    f = (hi * 65536.0 + lo) * (2.0 ** -32)
    return torch.clamp_max(f, ONE_MINUS_EPS)


def alpha_draw(seed: torch.Tensor, tri: torch.Tensor) -> torch.Tensor:
    """The stochastic alpha test's uniform draw for (lane seed, triangle):
    u32_to_unit_float(mix32(seed ^ tri * 0x9E3779B9)) in u32 arithmetic,
    the JAX package's per-(lane, tri) hash stream (render/intersect.py)."""
    return u32_to_unit_float(mix32(seed ^ (((tri.to(torch.int64) & M32) * 0x9E3779B9) & M32)))


def mix_bits64(v: torch.Tensor) -> torch.Tensor:
    """pbrt's mixBits 64-bit finalizer (src/core/rng.hpp:93-100)."""
    v = v ^ _shr(v, 31)
    v = v * _s64(0x7FB5D329728EA185)
    v = v ^ _shr(v, 27)
    v = v * _s64(0x81DADEF4BC2DD44D)
    v = v ^ _shr(v, 33)
    return v


# ---------------------------------------------------------------------------
# Host-side 64-bit hashing for per-dimension constants (plain Python ints)
# ---------------------------------------------------------------------------


def _murmur64a(key_bytes: bytes, seed: int = 0) -> int:
    """MurmurHash64A over a byte string (src/core/rng.hpp:25-69)."""
    m = 0xC6A4A7935BD1E995
    r = 47
    h = (seed ^ (len(key_bytes) * m)) & _M64
    n8 = len(key_bytes) // 8 * 8
    for off in range(0, n8, 8):
        k = int.from_bytes(key_bytes[off : off + 8], "little")
        k = (k * m) & _M64
        k ^= k >> r
        k = (k * m) & _M64
        h = ((h ^ k) * m) & _M64
    tail = key_bytes[n8:]
    if tail:
        h ^= int.from_bytes(tail, "little")
        h = (h * m) & _M64
    h ^= h >> r
    h = (h * m) & _M64
    h ^= h >> r
    return h


def hash_dim(dim: int) -> int:
    """The reference's hash() of one uint32 (src/core/rng.hpp:85-91)."""
    return _murmur64a(int(dim).to_bytes(4, "little"), 0)


SOBOL_MATRIX_BITS = 52


@functools.lru_cache()
def sobol_matrix_dim1() -> tuple:
    """Generator matrix of Sobol' dimension 1 (52 columns of 32-bit
    direction numbers, recurrence m_k = 2 m_{k-1} XOR m_{k-1})."""
    m = [1]
    for _ in range(2, SOBOL_MATRIX_BITS + 1):
        m.append((m[-1] << 1) ^ m[-1])
    v = []
    for k, mk in enumerate(m, start=1):
        if k <= 32:
            v.append((mk << (32 - k)) & M32)
        else:
            v.append(mk >> (k - 32))
    return tuple(v)


def scramble_null(v: torch.Tensor, seed: int) -> torch.Tensor:
    """No scrambling (scrambler.hpp:15-19)."""
    return v


def scramble_binary_permute(v: torch.Tensor, seed: int) -> torch.Tensor:
    """Random binary digit permutation: v XOR seed (scrambler.hpp:21-29)."""
    return v ^ seed


def scramble_fast_owen(v: torch.Tensor, seed: int) -> torch.Tensor:
    """pbrt's hash-based Owen scrambling (scrambler.hpp:53-69); the
    reference default (src/main.cpp:16). `seed` is a host u32."""
    v = reverse_bits32(v)
    v = v ^ ((v * 0x3D20ADEA) & M32)
    v = (v + seed) & M32
    v = (v * ((seed >> 16) | 1)) & M32
    v = v ^ ((v * 0x05526C56) & M32)
    v = v ^ ((v * 0x53A22864) & M32)
    return reverse_bits32(v)


def scramble_owen_exact(v: torch.Tensor, seed: int) -> torch.Tensor:
    """Exact bit-by-bit Owen scrambling (scrambler.hpp:71-87): bit 31 - b
    flips with a hash of the b bits above it; slow, the correctness
    oracle of the FastOwen approximation."""
    out = v ^ (1 << 31) if seed & 1 else v
    for b in range(1, 32):
        mask = (M32 << (32 - b)) & M32
        bit = (mix_bits64(out & mask) ^ seed) & (1 << b)
        out = torch.where(bit != 0, out ^ (1 << (31 - b)), out)
    return out


SCRAMBLERS = {
    "null": scramble_null,
    "binary": scramble_binary_permute,
    "fastowen": scramble_fast_owen,
    "owen": scramble_owen_exact,
}


# The 24 permutations of 4 base-4 digits in pbrt's order (sampler.hpp:115-140);
# the row order is load-bearing (see yart_tpu/ops/qmc.py _perm_table).
_PERMS = (
    (0, 1, 2, 3), (0, 1, 3, 2), (0, 2, 1, 3), (0, 2, 3, 1),
    (0, 3, 2, 1), (0, 3, 1, 2), (1, 0, 2, 3), (1, 0, 3, 2),
    (1, 2, 0, 3), (1, 2, 3, 0), (1, 3, 2, 0), (1, 3, 0, 2),
    (2, 1, 0, 3), (2, 1, 3, 0), (2, 0, 1, 3), (2, 0, 3, 1),
    (2, 3, 0, 1), (2, 3, 1, 0), (3, 1, 2, 0), (3, 1, 0, 2),
    (3, 2, 1, 0), (3, 2, 0, 1), (3, 0, 2, 1), (3, 0, 1, 2),
)


class HashSampler:
    """Counter-based RNG: every draw is mix32 of (pixel, sample, dim).
    Lane state is one u32 key per lane (int64 tensor)."""

    def __init__(self, spp: int, full_res=(0, 0), seed: int = 0, *, device):
        del spp, full_res, device
        self.seed = int(seed) & M32

    def init_lanes(self, px, py, sample_idx):
        px, py, s = (t.to(torch.int64) for t in (px, py, sample_idx))
        base = mix32(((px * 0x9E3779B9) & M32) ^ mix32(py ^ self.seed))
        return mix32(base ^ ((s * 0x85EBCA6B) & M32))

    def get1d(self, state, dim: int):
        return u32_to_unit_float(mix32(state ^ ((int(dim) * 0xC2B2AE35) & M32)))

    def get2d(self, state, dim: int):
        return torch.stack([self.get1d(state, dim), self.get1d(state, dim + 1)], dim=-1)

    def lane_seed(self, state):
        """Per-lane u32 key for auxiliary draws (the alpha tests)."""
        return mix32(state ^ 0xA511E9B3)


class ZSobolSampler:
    """Z-ordered scrambled Sobol' sampler (sampler.hpp:72-174); `scrambler`
    is one of SCRAMBLERS (FastOwen by default, the reference's pick). Lane
    state is the 64-bit Morton sample key per lane."""

    def __init__(self, spp: int, full_res, seed: int = 0, scrambler: str = "fastowen", *, device):
        self.scrambler = scrambler
        self.scramble = SCRAMBLERS[scrambler]
        spp = max(1, int(spp))
        self.log2spp = int(np.ceil(np.log2(spp)))
        res = int(max(full_res)) if np.iterable(full_res) else int(full_res)
        res = max(1, res)
        res_p2 = 1 << int(np.ceil(np.log2(res)))
        log4spp = (self.log2spp + 1) // 2
        self.n_base4_digits = int(np.log2(res_p2)) + log4spp
        self.seed = int(seed)

        # Per-dimension constants as host ints, exactly as the JAX package
        # builds its tables (sampler.hpp:89-106,163).
        perm_c = [(0x55555555 * d) & M32 for d in range(MAX_DIMS)]
        h1 = [hash_dim(d + 1) for d in range(MAX_DIMS)]
        h2 = [hash_dim(d + 2) for d in range(MAX_DIMS)]
        if seed:
            h1 = [_murmur64a(x.to_bytes(8, "little"), seed) for x in h1]
            h2 = [_murmur64a(x.to_bytes(8, "little"), seed) for x in h2]
            perm_c = [(p + seed) & M32 for p in perm_c]
        self._perm_c = perm_c
        self._seed_1d = [h & M32 for h in h1]
        self._seed_2d_a = [h & M32 for h in h2]
        self._seed_2d_b = [h >> 32 for h in h2]
        # Each S4 permutation packed into one byte, 2 bits per digit.
        self._perms_packed = torch.tensor(
            [p[0] | (p[1] << 2) | (p[2] << 4) | (p[3] << 6) for p in _PERMS],
            dtype=torch.int64, device=device,
        )
        # The permuted index has at most 2 * n_base4_digits bits, so the
        # Sobol' matrix product only needs that many columns.
        self._matrix1 = sobol_matrix_dim1()[: min(SOBOL_MATRIX_BITS, 2 * self.n_base4_digits)]

    def init_lanes(self, px, py, sample_idx):
        """startPixelSample (sampler.hpp:84-87): (morton(p) << log2spp) | s."""
        morton = encode_morton2_32(px.to(torch.int64), py.to(torch.int64))
        return (morton << self.log2spp) | sample_idx.to(torch.int64)

    def _sample_index(self, morton: torch.Tensor, dim: int) -> torch.Tensor:
        """Base-4 digit permutation of the Morton key (sampler.hpp:155-173)."""
        pow2_samples = bool(self.log2spp & 1)
        last_digit = 1 if pow2_samples else 0
        perm_c = self._perm_c[dim]
        out = torch.zeros_like(morton)
        for i in range(self.n_base4_digits - 1, last_digit - 1, -1):
            digit_shift = 2 * i - last_digit
            digit = _shr(morton, digit_shift) & 3
            higher = _shr(morton, digit_shift + 2)
            p = _shr(mix_bits64(higher ^ perm_c), 24) % 24
            digit = (self._perms_packed[p] >> (digit * 2)) & 3
            out = out | (digit << digit_shift)
        if pow2_samples:
            mixed = mix_bits64(_shr(morton, 1) ^ perm_c)
            out = out | ((morton & 1) ^ (mixed & 1))
        return out

    def get1d(self, state, dim: int):
        idx = self._sample_index(state, int(dim))
        v = reverse_bits32(idx & M32)  # Sobol' dim 0 (sampler.hpp:144-145)
        return u32_to_unit_float(self.scramble(v, self._seed_1d[int(dim)]))

    def get2d(self, state, dim: int):
        dim = int(dim)
        idx = self._sample_index(state, dim)
        va = reverse_bits32(idx & M32)
        vb = torch.zeros_like(idx)
        for i, col in enumerate(self._matrix1):
            vb = vb ^ (((idx >> i) & 1) * col)
        va = self.scramble(va, self._seed_2d_a[dim])
        vb = self.scramble(vb, self._seed_2d_b[dim])
        return torch.stack([u32_to_unit_float(va), u32_to_unit_float(vb)], dim=-1)

    def lane_seed(self, state):
        """Per-lane u32 key for auxiliary draws (the alpha tests): the
        Morton key's two 32-bit halves hash to a stream outside the QMC
        dimensions."""
        return mix32((state & M32) ^ mix32(_shr(state, 32) ^ 0xA511E9B3))


def permutation_element(i: torch.Tensor, l: int, p: torch.Tensor) -> torch.Tensor:
    """Kensler's hash-based random permutation of [0, l) (the reference's
    `permel`, src/core/rng.hpp:102-132): element i of the permutation
    keyed by p. `l` is a host int; i, p are u32 (int64) tensors. As in the
    JAX package, rejection runs 8 extra rounds and then clamps, and the
    final offset wraps in u32 before the modulo."""
    w = l - 1
    for sh in (1, 2, 4, 8, 16):
        w |= w >> sh

    def round_fn(i):
        i = i ^ p
        i = (i * 0xE170893D) & M32
        i = i ^ (p >> 16)
        i = i ^ ((i & w) >> 4)
        i = i ^ (p >> 8)
        i = (i * 0x0929EB3F) & M32
        i = i ^ (p >> 23)
        i = i ^ ((i & w) >> 1)
        i = (i * (1 | (p >> 27))) & M32
        i = (i * 0x6935FA69) & M32
        i = i ^ ((i & w) >> 11)
        i = (i * 0x74DCB303) & M32
        i = i ^ ((i & w) >> 2)
        i = (i * 0x9E501CC3) & M32
        i = i ^ ((i & w) >> 2)
        i = (i * 0xC860A3DF) & M32
        i = i & w
        return i ^ (i >> 5)

    out = round_fn(i & M32)
    for _ in range(8):
        out = torch.where(out >= l, round_fn(out), out)
    out = torch.clamp_max(out, l - 1)
    return ((out + p) & M32) % l


class StratifiedSampler:
    """Counter-based stratified sampler (sampler.cpp:19-44 without the
    xoshiro state): the stratum of (pixel, dim) is `permutation_element`
    of the sample index keyed by hash(pixel, dim), the jitter inside it a
    hash of (pixel, sample, dim). Lane state: (pixel key << 32) | sample
    in one int64 (module doc)."""

    def __init__(self, spp: int, full_res=(0, 0), seed: int = 0, *, device):
        del full_res, device
        n = max(1, int(spp))
        self.x_samples = max(1, int(math.sqrt(n)))
        self.y_samples = max(1, (n + self.x_samples - 1) // self.x_samples)
        self.n_strata = self.x_samples * self.y_samples
        self.seed = int(seed) & M32

    def init_lanes(self, px, py, sample_idx):
        px, py, s = (t.to(torch.int64) for t in (px, py, sample_idx))
        pix_key = mix32(((px * 0x9E3779B9) & M32) ^ mix32(py ^ self.seed))
        return (pix_key << 32) | (s & M32)

    @staticmethod
    def _unpack(state):
        return _shr(state, 32), state & M32

    def _stratum(self, state, dim: int):
        pix_key, sidx = self._unpack(state)
        key = mix32(pix_key ^ ((int(dim) * 0x85EBCA6B) & M32))
        return permutation_element(sidx, self.n_strata, key)

    def _jitter(self, state, dim: int, salt: int):
        pix_key, sidx = self._unpack(state)
        v = mix32(pix_key ^ ((sidx * 0xC2B2AE35) & M32) ^ ((int(dim) * 0x27D4EB2F) & M32) ^ salt)
        return u32_to_unit_float(v)

    def get1d(self, state, dim: int):
        s = self._stratum(state, dim)
        return (s.to(torch.float32) + self._jitter(state, dim, 0x1)) / self.n_strata

    def get2d(self, state, dim: int):
        s = self._stratum(state, dim)
        x = (s % self.x_samples).to(torch.float32)
        y = (s // self.x_samples).to(torch.float32)
        return torch.stack([(x + self._jitter(state, dim, 0x2)) / self.x_samples,
                            (y + self._jitter(state, dim, 0x3)) / self.y_samples], dim=-1)

    def lane_seed(self, state):
        """Per-lane u32 key for auxiliary draws (the alpha tests)."""
        pix_key, sidx = self._unpack(state)
        return mix32(pix_key ^ ((sidx * 0xA511E9B3) & M32))


def make_sampler(kind: str, spp: int, full_res=(1, 1), seed: int = 0, *, device):
    """Sampler factory: "zsobol" (FastOwen, the reference default,
    src/main.cpp:16), "zsobol:<scrambler>" with a scrambler of SCRAMBLERS,
    "stratified" and "hash". `device` is the caller's: there is no
    default."""
    if kind == "hash":
        return HashSampler(spp, full_res, seed, device=device)
    if kind == "stratified":
        return StratifiedSampler(spp, full_res, seed, device=device)
    if kind.startswith("zsobol"):
        scrambler = kind.split(":", 1)[1] if ":" in kind else "fastowen"
        if scrambler not in SCRAMBLERS:
            raise ValueError(f"unknown sampler kind: {kind} (scramblers: {', '.join(SCRAMBLERS)})")
        return ZSobolSampler(spp, full_res, seed, scrambler=scrambler, device=device)
    raise ValueError(f"unknown sampler kind: {kind}")
