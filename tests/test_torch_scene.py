"""The port's scene tables against the JAX package's.

- `from_numpy` carries a JAX-compiled scene across bit-exactly, including
  the int32 ids bit-cast into float32 columns (-1 is a NaN pattern, small
  ids are denormals).
- The port's own numpy builder produces cornell-mat equal to the JAX
  builder's up to the triangle permutation the JAX builder applies (BVH
  leaf order); float32 geometry and materials are exact, the light CDF
  total agrees to rtol 1e-6 (float32 cumsum in another order)."""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from yart_tpu.scene.procedural import cornell_box as j_cornell
from yart_tpu_torch.scene.convert import from_numpy
from yart_tpu_torch.scene.procedural import cornell_box as t_cornell
from yart_tpu_torch.scene.types import CompiledScene, MaterialTable, TextureStack

torch.set_num_threads(2)


@pytest.fixture(scope="module")
def jax_scene():
    js, jm = j_cornell(extra_materials=True).compile()
    return jax.tree_util.tree_map(np.asarray, js), jm


def _bits(a):
    a = a.numpy() if isinstance(a, torch.Tensor) else np.asarray(a)
    return np.atleast_1d(a).view(np.uint8)  # 0-d fields: env_power, scene_radius


def test_from_numpy_bit_exact(jax_scene):
    leaves, jm = jax_scene
    ts, tm = from_numpy(leaves, dataclasses.asdict(jm), device="cpu")
    for f in dataclasses.fields(CompiledScene):
        if f.name == "materials":
            for g in MaterialTable._fields:
                np.testing.assert_array_equal(_bits(getattr(ts.materials, g)), _bits(getattr(leaves.materials, g)))
        elif f.name.startswith("tex_"):
            for g in TextureStack._fields:
                np.testing.assert_array_equal(_bits(getattr(getattr(ts, f.name), g)),
                                              _bits(getattr(getattr(leaves, f.name), g)), err_msg=f.name)
        else:
            np.testing.assert_array_equal(_bits(getattr(ts, f.name)), _bits(getattr(leaves, f.name)), err_msg=f.name)
    # The bit-cast id columns read back as the int tables.
    assert torch.equal(ts.tri_pack[:, 9].contiguous().view(torch.int32), ts.tri_mat)
    assert torch.equal(ts.tri_pack[:, 10].contiguous().view(torch.int32), ts.tri_light)
    assert torch.equal(ts.shade_pack[:, 27].contiguous().view(torch.int32), ts.tri_mat)
    assert torch.equal(ts.shade_pack[:, 28].contiguous().view(torch.int32), ts.tri_light)
    assert (ts.tri_light == -1).any() and (ts.tri_mat == 0).any()
    assert (tm.n_tris, tm.n_materials, tm.n_lights) == (jm.n_tris, jm.n_materials, jm.n_lights)
    assert (tm.any_metallic, tm.any_transmissive, tm.any_clearcoat) == (True, True, False)
    # .to() keeps every bit (here a dtype-preserving copy on the CPU).
    moved = ts.to("cpu")
    assert torch.equal(moved.tri_pack.view(torch.int32), ts.tri_pack.view(torch.int32))


def test_builder_matches_jax_up_to_permutation(jax_scene):
    leaves, jm = jax_scene
    ts, tm = t_cornell(extra_materials=True).compile(device="cpu")
    assert (tm.n_tris, tm.n_materials, tm.n_lights) == (jm.n_tris, jm.n_materials, jm.n_lights)
    for f in ("has_env", "any_alpha", "any_textures", "any_transparent", "any_metallic",
              "any_transmissive", "any_clearcoat", "any_anisotropy"):
        assert getattr(tm, f) == getattr(jm, f), f
    for g in MaterialTable._fields:
        np.testing.assert_array_equal(getattr(ts.materials, g).numpy(), getattr(leaves.materials, g), err_msg=g)

    # Match each port triangle to the JAX triangle with identical vertices.
    jv = {leaves.tri_pack[i, :9].tobytes(): i for i in range(jm.n_tris)}
    perm = np.asarray([jv[ts.tri_pack[i, :9].numpy().tobytes()] for i in range(tm.n_tris)])
    assert sorted(perm) == list(range(jm.n_tris))
    np.testing.assert_array_equal(ts.tri_mat.numpy(), leaves.tri_mat[perm])
    np.testing.assert_array_equal(ts.shade_pack.numpy()[:, :27], leaves.shade_pack[perm, :27])
    np.testing.assert_array_equal(ts.tri_pack.numpy()[:, 9].view(np.int32), leaves.tri_mat[perm])

    # Lights: same set, in each builder's own triangle order.
    tl, jl = ts.tri_light.numpy(), leaves.tri_light[perm]
    lit = tl >= 0
    np.testing.assert_array_equal(lit, jl >= 0)
    for name in ("light_emission", "light_area", "light_power", "light_verts", "light_norms"):
        np.testing.assert_array_equal(getattr(ts, name).numpy()[tl[lit]], getattr(leaves, name)[jl[lit]], err_msg=name)
    np.testing.assert_allclose(ts.light_cdf.numpy()[-1], leaves.light_cdf[-1], rtol=1e-6)
    np.testing.assert_array_equal(ts.background.numpy(), leaves.background)


def test_builder_flags_and_errors():
    from yart_tpu_torch.scene.builder import SceneBuilder

    with pytest.raises(ValueError, match="no geometry"):
        SceneBuilder().compile(device="cpu")
    b = SceneBuilder()
    m = b.add_material(tex_base=0)
    b.add_mesh(2 * np.eye(3, dtype=np.float32), [[0, 1, 2]], m)
    s, meta = b.compile(device="cpu")
    assert meta.any_textures and meta.n_lights == 0 and s.light_cdf.tolist() == [0.0]
    np.testing.assert_array_equal(s.tri_pack[0, :9].numpy(), 2 * np.eye(3).reshape(-1))
    np.testing.assert_allclose(s.shade_pack[0, :9].numpy(), np.tile(np.full(3, 3 ** -0.5), 3), rtol=1e-6)
