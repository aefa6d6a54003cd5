"""Thin-lens physical camera (src/core/camera.hpp:10-165); port of
`yart_tpu/render/camera.py`. Derived properties are computed in float64 on
the host and cast to float32, as in the JAX package."""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from yart_tpu_torch.config import CameraConfig
from yart_tpu_torch.ops import warps


class CameraParams(NamedTuple):
    position: torch.Tensor  # [3]
    top_left_pixel: torch.Tensor  # [3]
    pixel_delta_u: torch.Tensor  # [3]
    pixel_delta_v: torch.Tensor  # [3]
    frame_x: torch.Tensor  # [3]
    frame_y: torch.Tensor  # [3]
    aperture_radius: float  # float32 value
    exposure_scale: float  # float32 value of 2**EV
    aperture_sides: int  # 0 = circular
    image_size: tuple  # (width, height)


def build_camera(cfg: CameraConfig, device) -> CameraParams:
    """Host-side calcDerivedProperties (camera.hpp:25-59); the tensors go
    to the caller's `device`."""
    w_px, h_px = cfg.image_size
    aspect = float(w_px) / float(h_px)
    sensor_w, sensor_h = cfg.sensor_size
    cropped_h = sensor_w / max(sensor_w / sensor_h, aspect)

    position = np.asarray(cfg.position, np.float64)
    forward = np.asarray(cfg.forward, np.float64)
    up = np.asarray(cfg.up, np.float64)

    focus_distance = float(np.linalg.norm(forward))
    vh = focus_distance * cropped_h / cfg.focal_length
    vw = vh * aspect

    up = up / np.linalg.norm(up)
    wv = -forward / focus_distance
    u = np.cross(up, wv)
    u = u / np.linalg.norm(u)
    v = np.cross(wv, u)

    viewport_u = u * vw
    viewport_v = -v * vh
    viewport_top_left = position - wv * focus_distance - (viewport_u + viewport_v) * 0.5
    pixel_delta_u = viewport_u / w_px
    pixel_delta_v = viewport_v / h_px
    top_left_pixel = viewport_top_left + (pixel_delta_u + pixel_delta_v) * 0.5
    aperture_radius = (cfg.focal_length / 2000.0) / cfg.f_number if cfg.f_number else 0.0

    f32 = lambda x: torch.from_numpy(np.asarray(x, np.float32)).to(device)
    return CameraParams(
        position=f32(position),
        top_left_pixel=f32(top_left_pixel),
        pixel_delta_u=f32(pixel_delta_u),
        pixel_delta_v=f32(pixel_delta_v),
        frame_x=f32(u),
        frame_y=f32(v),
        aperture_radius=float(np.float32(aperture_radius)),
        exposure_scale=float(np.float32(2.0 ** cfg.exposure)),
        aperture_sides=int(cfg.aperture_sides),
        image_size=(int(w_px), int(h_px)),
    )


def generate_rays(cam: CameraParams, px, py, u_film, u_lens):
    """Batched Camera::getRay (camera.hpp:138-164). px, py: [N] integer
    pixel coords; u_film, u_lens: [N, 2]. Returns (origin, unit direction)."""
    jitter = warps.pixel_jitter_gaussian(u_film, 0.3)
    jx = jitter[..., 0] + px.to(torch.float32)
    jy = jitter[..., 1] + py.to(torch.float32)
    pixel = cam.top_left_pixel + jx[..., None] * cam.pixel_delta_u + jy[..., None] * cam.pixel_delta_v

    if cam.aperture_sides == 0:
        ap = warps.sample_disk_uniform(u_lens)
    else:
        ap = warps.sample_poly_uniform(u_lens, cam.aperture_sides)
    lens_offset = (ap[..., 0:1] * cam.frame_x + ap[..., 1:2] * cam.frame_y) * cam.aperture_radius
    origin = cam.position.expand_as(pixel) + lens_offset

    d = pixel - origin
    d = d / torch.sqrt((d * d).sum(dim=-1, keepdim=True))
    return origin, d
