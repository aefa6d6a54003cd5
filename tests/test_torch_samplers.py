"""The samplers and scramblers ported from yart_tpu/ops/qmc.py, against
the JAX package (Dist2D and renders with these samplers:
tests/test_torch_samplers_render.py).

Draws are compared as raw float32 bits at every dimension below MAX_DIMS
on seeded lanes (16 pixels at the given spp), at seed 0 with 16 spp (even
log2 spp) and seed 7 with 5 spp (odd log2 spp, not a power of two; the
stratified sampler's 2 x 3 strata), for stratified and ZSobol with the
null, binary and exact Owen scramblers; lane seeds and lane states bit
for bit too; the scramblers and `permutation_element` on their own.

The JAX draws run under `jax.vmap` over the dimensions, ZSobol's digit
permutation and scrambler jit-compiled (op by op, the exact Owen
scrambler's 31 rounds of emulated 64-bit hashing take seconds)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from yart_tpu.ops import qmc as J
from yart_tpu_torch.ops import qmc as T

KINDS = ["stratified", "zsobol:null", "zsobol:binary", "zsobol:owen"]
DIMS = np.arange(J.MAX_DIMS, dtype=np.uint32)


@pytest.fixture(autouse=True, scope="module")
def _one_intra_op_thread():
    """The port on one intra-op thread in this module (tests/test_torch_bsdf.py's docstring)."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _lanes(spp, res, n_pix=16, seed=0):
    rng = np.random.default_rng(seed)
    px = np.repeat(rng.integers(0, res, n_pix), spp).astype(np.int32)
    py = np.repeat(rng.integers(0, res, n_pix), spp).astype(np.int32)
    s = np.tile(np.arange(spp), n_pix).astype(np.uint32)
    return px, py, s


def _bits(a):
    return np.asarray(a).view(np.uint32)


def _jax_state_as_int64(kind, jst):
    if kind == "stratified":
        pix, sidx = (np.asarray(x).astype(np.uint64) for x in jst)
        return ((pix << np.uint64(32)) | sidx).view(np.int64)
    return ((np.asarray(jst.hi).astype(np.uint64) << np.uint64(32)) | np.asarray(jst.lo).astype(np.uint64)).view(
        np.int64)


@pytest.mark.parametrize("spp,seed", [(16, 0), (5, 7)])
@pytest.mark.parametrize("kind", KINDS)
def test_new_sampler_draws_bit_exact(kind, spp, seed):
    res = 64
    px, py, s = _lanes(spp, res, n_pix=4, seed=seed + 1)
    js = J.make_sampler(kind, spp, (res, res), seed)
    ts = T.make_sampler(kind, spp, (res, res), seed, device="cpu")
    jst = js.init_lanes(jnp.asarray(px).astype(jnp.uint32), jnp.asarray(py).astype(jnp.uint32), jnp.asarray(s))
    tst = ts.init_lanes(torch.from_numpy(px), torch.from_numpy(py), torch.from_numpy(s.astype(np.int64)))
    np.testing.assert_array_equal(_jax_state_as_int64(kind, jst), tst.numpy())
    np.testing.assert_array_equal(np.asarray(js.lane_seed(jst)).astype(np.int64), ts.lane_seed(tst).numpy())
    if kind.startswith("zsobol"):
        # The JAX sampler's own functions, jit-compiled once each instead
        # of run op by op (integer results do not change under jit).
        js._sample_index = jax.jit(js._sample_index)
        js.scramble = jax.jit(js.scramble)
    dims = jnp.asarray(DIMS)
    j1 = jax.vmap(lambda d: js.get1d(jst, d))(dims)
    j2 = jax.vmap(lambda d: js.get2d(jst, d))(dims)
    t1 = torch.stack([ts.get1d(tst, int(d)) for d in DIMS])
    t2 = torch.stack([ts.get2d(tst, int(d)) for d in DIMS])
    np.testing.assert_array_equal(_bits(j1), _bits(t1.numpy()))
    np.testing.assert_array_equal(_bits(j2), _bits(t2.numpy()))
    assert 0.0 <= float(t2.min()) and float(t2.max()) < 1.0


def test_scramblers_bit_exact():
    rng = np.random.default_rng(4)
    v = np.concatenate([rng.integers(0, 2 ** 32, 2048, dtype=np.uint64).astype(np.uint32),
                        np.asarray([0, 1, 0xFFFFFFFF, 1 << 31], np.uint32)])
    tv = torch.from_numpy(v.astype(np.int64))
    for seed in (0, 1, 0x9E3779B9, 0xFFFFFFFF, 0x12345678):
        for name, jf in (("null", J.scramble_null), ("binary", J.scramble_binary_permute),
                         ("fastowen", J.scramble_fast_owen), ("owen", J.scramble_owen_exact)):
            want = np.asarray(jf(jnp.asarray(v), jnp.uint32(seed))).astype(np.int64)
            np.testing.assert_array_equal(want, T.SCRAMBLERS[name](tv, seed).numpy(), err_msg=f"{name} {seed:#x}")


@pytest.mark.parametrize("l", [1, 2, 5, 6, 16, 17, 1000, (1 << 20) + 3])
def test_permutation_element_bit_exact(l):
    rng = np.random.default_rng(l)
    i = rng.integers(0, l, 4096, dtype=np.uint64).astype(np.uint32)
    p = np.concatenate([rng.integers(0, 2 ** 32, 4092, dtype=np.uint64).astype(np.uint32),
                        np.asarray([0, 1, 0xFFFFFFFF, 0xFFFFFFFE], np.uint32)])
    want = np.asarray(J.permutation_element(jnp.asarray(i), l, jnp.asarray(p))).astype(np.int64)
    got = T.permutation_element(torch.from_numpy(i.astype(np.int64)), l, torch.from_numpy(p.astype(np.int64)))
    np.testing.assert_array_equal(want, got.numpy())
    assert got.min() >= 0 and got.max() < l


def test_make_sampler_kinds():
    for kind, cls in (("zsobol", T.ZSobolSampler), ("hash", T.HashSampler), ("stratified", T.StratifiedSampler)):
        assert isinstance(T.make_sampler(kind, 4, (8, 8), device="cpu"), cls)
    for s in T.SCRAMBLERS:
        z = T.make_sampler(f"zsobol:{s}", 4, (8, 8), device="cpu")
        assert z.scrambler == s and z.scramble is T.SCRAMBLERS[s]
    for bad in ("sobol", "zsobol:fast"):
        with pytest.raises(ValueError):
            T.make_sampler(bad, 4, (8, 8), device="cpu")
