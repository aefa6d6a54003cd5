"""Differentiable rendering: gradients w.r.t. scene parameters.

Port of `yart_tpu/render/diff.py`: pixel gradients with respect to the
material table, the environment image, texture contents and vertex
positions, through the detached-sampling estimator of
`integrator.li(differentiable=True)`.

What is differentiable:
- every MaterialTable parameter that enters f or Le continuously
  (base_color, metallic, roughness*, transmission*, ior*, clearcoat*,
  emission, volume_color, volume_density),
- the env image (through the radiance lookups; its sampling table is
  fixed),
- texture contents (through the bilinear fetches),
- vertex positions (`cfg.diff_geometry`: each hit's t, u, v re-solved from
  `scene.positions` by Moller-Trumbore, the interior derivative).

What is detached: visibility (traversal, alpha tests), so geometry
gradients carry no silhouette or occlusion terms; and the sampled
directions, pdfs and lobe choices.

Each function returns `(loss, grads)` shaped as the JAX package's; the
scene is rebuilt around the differentiated leaf with `dataclasses.replace`
(the port's `CompiledScene` is a frozen dataclass) and `._replace` (its
`MaterialTable` and `TextureStack` are NamedTuples).
"""

from __future__ import annotations

import dataclasses
from typing import Callable

import torch

from yart_tpu_torch.config import RenderConfig
from yart_tpu_torch.render.camera import CameraParams
from yart_tpu_torch.render.integrator import render_wave
from yart_tpu_torch.render.lights import env_rows_from_image
from yart_tpu_torch.render.texture import qrows_from_data
from yart_tpu_torch.scene.types import CompiledScene, MaterialTable, SceneMeta

MATERIAL_FIELDS = (
    "base_color", "metallic", "roughness", "transmission", "ior", "anisotropic",
    "aniso_rotation", "clearcoat", "cc_roughness", "emission", "normal_scale",
    "volume_color", "volume_density",
)
TEXTURE_FIELDS = {"rgba": "tex_rgba", "rgb": "tex_rgb", "2ch": "tex_2ch", "mono": "tex_mono"}


def render_image_diff(scene: CompiledScene, meta: SceneMeta, cam: CameraParams, sampler,
                      cfg: RenderConfig, px, py, sample_idx):
    """Differentiable radiance for a lane batch; the contract of
    `integrator.render_wave`."""
    return render_wave(scene, meta, cam, sampler, cfg, px, py, sample_idx, differentiable=True)


def _value_and_grad(loss_of, leaves):
    """(loss, d loss / d leaves) of loss_of(*leaves), each leaf a fresh
    detached copy that requires grad."""
    xs = [x.detach().clone().requires_grad_(True) for x in leaves]
    loss = loss_of(*xs)
    grads = torch.autograd.grad(loss, xs)
    return loss.detach(), grads


def material_grads(scene: CompiledScene, meta: SceneMeta, cam: CameraParams, sampler,
                   cfg: RenderConfig, px, py, sample_idx,
                   loss_fn: Callable[[torch.Tensor], torch.Tensor], fields=None):
    """Gradient of loss_fn(radiance) w.r.t. the material table. Returns
    (loss, {field: gradient}) over every MaterialTable field, None for the
    fields not differentiated (the integer texture slots and bool flags
    never are). `fields` picks a subset of the float fields."""
    diff_fields = list(fields or MATERIAL_FIELDS)

    def loss_of(*vals):
        mats = scene.materials._replace(**dict(zip(diff_fields, vals)))
        radiance, _ = render_image_diff(dataclasses.replace(scene, materials=mats), meta, cam,
                                        sampler, cfg, px, py, sample_idx)
        return loss_fn(radiance)

    val, grads = _value_and_grad(loss_of, [getattr(scene.materials, k) for k in diff_fields])
    out = {k: None for k in MaterialTable._fields}
    out.update(zip(diff_fields, grads))
    return val, out


def env_grads(scene: CompiledScene, meta: SceneMeta, cam: CameraParams, sampler,
              cfg: RenderConfig, px, py, sample_idx,
              loss_fn: Callable[[torch.Tensor], torch.Tensor]):
    """Gradient of loss_fn(radiance) w.r.t. the environment image [H, W, 3].
    The radiance fetches read the packed env rows, so the rows are rebuilt
    from the image inside the loss; the alias table stays fixed. The
    per-cell pdfs come from column 12 of the scene's rows (bit-equal to the
    JAX scene's `env_pdf_cells`)."""
    pdf_cells = scene.env_rows[:, 12].detach()

    def loss_of(env_image):
        s = dataclasses.replace(scene, env_image=env_image,
                                env_rows=env_rows_from_image(env_image, pdf_cells))
        radiance, _ = render_image_diff(s, meta, cam, sampler, cfg, px, py, sample_idx)
        return loss_fn(radiance)

    val, (g,) = _value_and_grad(loss_of, [scene.env_image])
    return val, g


def geometry_grads(scene: CompiledScene, meta: SceneMeta, cam: CameraParams, sampler,
                   cfg: RenderConfig, px, py, sample_idx,
                   loss_fn: Callable[[torch.Tensor], torch.Tensor]):
    """Gradient of loss_fn(radiance) w.r.t. vertex positions [V, 3], or an
    instanced scene's shared object-space prototype vertices `proto_pos`
    (summed over every instance of a prototype). Interior derivative only:
    visibility is detached, the hit parameters are re-solved from the
    vertices (`cfg.diff_geometry`, `integrator._refit_hit`). Vertex normals
    are separate parameters (the `shade_pack` rows) and not derived here."""
    cfg = dataclasses.replace(cfg, diff_geometry=True)
    field = "proto_pos" if meta.n_instances else "positions"

    def loss_of(pos):
        s = dataclasses.replace(scene, **{field: pos})
        radiance, _ = render_image_diff(s, meta, cam, sampler, cfg, px, py, sample_idx)
        return loss_fn(radiance)

    val, (g,) = _value_and_grad(loss_of, [getattr(scene, field)])
    return val, g


def texture_grads(scene: CompiledScene, meta: SceneMeta, cam: CameraParams, sampler,
                  cfg: RenderConfig, px, py, sample_idx,
                  loss_fn: Callable[[torch.Tensor], torch.Tensor], kind: str = "rgba"):
    """Gradient of loss_fn(radiance) w.r.t. one atlas's texel data [H, W,
    C]: `kind` is "rgba" (base colour + alpha), "rgb" (normal maps,
    emission), "2ch" (metallic-roughness) or "mono" (transmission,
    clearcoat). The quad rows are rebuilt from the data inside the loss.
    sRGB-class atlases hold the gamma-2 encoding, so these are gradients
    w.r.t. the stored encoding."""
    field = TEXTURE_FIELDS[kind]
    stack = getattr(scene, field)

    def loss_of(data):
        s = dataclasses.replace(scene, **{field: stack._replace(data=data, qrows=qrows_from_data(data))})
        radiance, _ = render_image_diff(s, meta, cam, sampler, cfg, px, py, sample_idx)
        return loss_fn(radiance)

    val, (g,) = _value_and_grad(loss_of, [stack.data])
    return val, g
