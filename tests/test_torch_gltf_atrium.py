"""The flagship scene through a GLB file, port against the JAX package, on
the CPU.

`atrium(ivy=True, tex_res=64)`, built by the JAX package and written by
its `export_glb` (the ivy's alpha-tested leaves, every texture class of
the scene as 8-bit PNGs) with its sky written by its `export_env_hdr`:
- the port's `load` gives every builder array, texture and MaterialDesc
  field bit-equal to the JAX `load`;
- the sky file reads back bit-equal through both packages' `load_hdr`;
- the compiled scene tables and meta are bit-equal to the JAX builder's
  (on its numpy BVH path), so the port renders the JAX package's scene
  (the environment set from an HDR file is compiled against the JAX
  builder's in tests/test_torch_gltf.py, on a smaller scene).
No render against the JAX Renderer here: its compile for this scene on
XLA:CPU would take the file past a minute; the GLB renders against it are the
cornell-mat one (tests/test_torch_sceneio.py) and the textured quad
(tests/test_torch_gltf.py). On the card, chip_smoke.py phase 8a
holds the CLI render of this GLB against the procedural atrium-ivy's."""

import numpy as np
import pytest
import torch

from test_torch_sceneio import compare_builders, compile_both
from yart_tpu.io.glb_export import export_env_hdr, export_glb
from yart_tpu.io.image import load_hdr as j_load_hdr
from yart_tpu.scene.gltf import load as j_load
from yart_tpu.scene.showcase import atrium
from yart_tpu_torch.io.image import load_hdr as t_load_hdr
from yart_tpu_torch.scene.gltf import load as t_load

torch.set_num_threads(2)


def test_atrium_ivy_glb_loads_and_compiles_like_jax(tmp_path):
    pytest.importorskip("PIL")
    b = atrium(ivy=True, tex_res=64)
    glb, sky = str(tmp_path / "atrium_ivy.glb"), str(tmp_path / "sky.hdr")
    export_glb(b, glb)
    assert export_env_hdr(b, sky)
    jb, tb = j_load(glb), t_load(glb)
    compare_builders(jb, tb)
    assert any(m.has_alpha for m in tb._materials) and len(tb.textures_rgba) > 1
    sky_j, sky_t = j_load_hdr(sky), t_load_hdr(sky)
    assert sky_t.shape == b._env_image.shape
    np.testing.assert_array_equal(sky_t.view(np.uint32), sky_j.view(np.uint32))
    _, jm, _, tm = compile_both(jb, tb)
    assert tm.any_alpha and tm.any_textures and tm.n_tris == jm.n_tris > 100_000
