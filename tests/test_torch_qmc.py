"""yart_tpu_torch.ops.qmc against yart_tpu.ops.qmc: every draw bit-exact.

Draws are compared as raw float32 bits on a grid of pixels x samples x
dimensions 0..244 (the camera dims plus 30 bounces of 8), for both ZSobol
digit layouts (even and odd log2 spp) and a seeded sampler."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from yart_tpu.ops import qmc as J
from yart_tpu_torch.ops import qmc as T

torch.set_num_threads(2)

DIMS = np.arange(245, dtype=np.uint32)


def _lanes(spp, res, n_pix=16, seed=0):
    rng = np.random.default_rng(seed)
    px = np.repeat(rng.integers(0, res, n_pix), spp).astype(np.int32)
    py = np.repeat(rng.integers(0, res, n_pix), spp).astype(np.int32)
    s = np.tile(np.arange(spp), n_pix).astype(np.uint32)
    return px, py, s


def _bits(a):
    return np.asarray(a).view(np.uint32)


@pytest.mark.parametrize("spp,res,seed", [(16, 64, 0), (8, 48, 0), (64, 512, 7)])
def test_zsobol_draws_bit_exact(spp, res, seed):
    px, py, s = _lanes(spp, res)
    js = J.ZSobolSampler(spp, (res, res), seed)
    ts = T.ZSobolSampler(spp, (res, res), seed, device="cpu")
    jst = js.init_lanes(jnp.asarray(px).astype(jnp.uint32), jnp.asarray(py).astype(jnp.uint32), jnp.asarray(s))
    tst = ts.init_lanes(torch.from_numpy(px), torch.from_numpy(py), torch.from_numpy(s.astype(np.int64)))
    # The 64-bit Morton keys agree (JAX holds them as (hi, lo) u32 pairs).
    key = (np.asarray(jst.hi).astype(np.uint64) << np.uint64(32)) | np.asarray(jst.lo).astype(np.uint64)
    np.testing.assert_array_equal(key.astype(np.int64), tst.numpy())

    j1 = jax.jit(jax.vmap(lambda d: js.get1d(jst, d)))(jnp.asarray(DIMS))
    j2 = jax.jit(jax.vmap(lambda d: js.get2d(jst, d)))(jnp.asarray(DIMS))
    t1 = torch.stack([ts.get1d(tst, int(d)) for d in DIMS])
    t2 = torch.stack([ts.get2d(tst, int(d)) for d in DIMS])
    np.testing.assert_array_equal(_bits(j1), _bits(t1.numpy()))
    np.testing.assert_array_equal(_bits(j2), _bits(t2.numpy()))


def test_hash_draws_bit_exact():
    px, py, s = _lanes(16, 64)
    jh = J.HashSampler(16, (64, 64), seed=3)
    th = T.HashSampler(16, (64, 64), seed=3, device="cpu")
    jst = jh.init_lanes(jnp.asarray(px), jnp.asarray(py), jnp.asarray(s))
    tst = th.init_lanes(torch.from_numpy(px), torch.from_numpy(py), torch.from_numpy(s.astype(np.int64)))
    np.testing.assert_array_equal(np.asarray(jst).astype(np.int64), tst.numpy())
    for d in (0, 2, 4, 100, 243):
        np.testing.assert_array_equal(_bits(jh.get1d(jst, d)), _bits(th.get1d(tst, d).numpy()))
        np.testing.assert_array_equal(_bits(jh.get2d(jst, d)), _bits(th.get2d(tst, d).numpy()))


def test_u32_helpers_bit_exact():
    rng = np.random.default_rng(5)
    v = np.concatenate([
        rng.integers(0, 2 ** 32, 4096, dtype=np.uint64).astype(np.uint32),
        np.asarray([0, 1, 0xFFFFFFFF, 0xFFFFFF80, 0xFFFFFF7F, 1 << 31], np.uint32),
    ])
    tv = torch.from_numpy(v.astype(np.int64))
    np.testing.assert_array_equal(_bits(J.u32_to_unit_float(jnp.asarray(v))), _bits(T.u32_to_unit_float(tv).numpy()))
    np.testing.assert_array_equal(np.asarray(J.mix32(jnp.asarray(v))).astype(np.int64), T.mix32(tv).numpy())
    np.testing.assert_array_equal(np.asarray(J.reverse_bits32(jnp.asarray(v))).astype(np.int64), T.reverse_bits32(tv).numpy())
    seed = 0x9E3779B9
    np.testing.assert_array_equal(
        np.asarray(J.scramble_fast_owen(jnp.asarray(v), jnp.uint32(seed))).astype(np.int64),
        T.scramble_fast_owen(tv, seed).numpy(),
    )
    # 64-bit mixBits on full 64-bit patterns, against the (hi, lo) emulation.
    hi, lo = v[:2048], v[2048:4096]
    x64 = (hi.astype(np.uint64) << np.uint64(32)) | lo.astype(np.uint64)
    jm = J.mix_bits64(J.U64(jnp.asarray(hi), jnp.asarray(lo)))
    want = (np.asarray(jm.hi).astype(np.uint64) << np.uint64(32)) | np.asarray(jm.lo).astype(np.uint64)
    got = T.mix_bits64(torch.from_numpy(x64.view(np.int64))).numpy().view(np.uint64)
    np.testing.assert_array_equal(want, got)


def test_make_sampler_builds_every_kind():
    assert isinstance(T.make_sampler("zsobol:fastowen", 4, (8, 8), device="cpu"), T.ZSobolSampler)
    assert isinstance(T.make_sampler("hash", 4, (8, 8), device="cpu"), T.HashSampler)
    assert isinstance(T.make_sampler("stratified", 4, (8, 8), device="cpu"), T.StratifiedSampler)
    for kind in ("zsobol:owen", "zsobol:null", "zsobol:binary"):
        assert T.make_sampler(kind, 4, (8, 8), device="cpu").scrambler == kind.split(":")[1]
    with pytest.raises(ValueError):
        T.make_sampler("sobol", 4, (8, 8), device="cpu")
