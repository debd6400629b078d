"""The Cornell benchmark scene (port of pbrt_tpu.models.flagship.cornell).

Area light, matte / plastic / mirror / glass, two tessellated UV spheres
(3,024 triangles each) and one glass sphere quadric: 6,060 triangles.
With tessellate=False the mirror and plastic spheres are quadrics and
there is no glass sphere: the box's 12 triangles and two spheres.
"""

from __future__ import annotations

import numpy as np

from pbrt_tpu_torch.cameras import projective
from pbrt_tpu_torch.core import device as devmod
from pbrt_tpu_torch.core import spectrum as spec
from pbrt_tpu_torch.core import transform as tfm
from pbrt_tpu_torch.scene.ir import (SceneBuilder, MaterialSpec, MAT_MATTE,
                                     MAT_MIRROR, MAT_GLASS, MAT_PLASTIC)


def _rgb(r, g, b, kind="reflectance"):
    return spec.from_rgb_np(np.asarray([r, g, b], np.float64), kind)


def _uv_sphere(n_theta=24, n_phi=48):
    th = np.linspace(1e-3, np.pi - 1e-3, n_theta)
    ph = np.linspace(0, 2 * np.pi, n_phi, endpoint=False)
    T, Ph = np.meshgrid(th, ph, indexing="ij")
    pts = np.stack([np.sin(T) * np.cos(Ph), np.sin(T) * np.sin(Ph),
                    np.cos(T)], -1).reshape(-1, 3)
    idx = []
    for i in range(n_theta - 1):
        for j in range(n_phi):
            a = i * n_phi + j
            b = i * n_phi + (j + 1) % n_phi
            idx += [[a, b, b + n_phi], [a, b + n_phi, a + n_phi]]
    return pts, np.asarray(idx)


def cornell(tessellate=True, device=None):
    """Returns (scene, camera_ctor); camera_ctor(W, H) -> camera, both on
    `device` (None: the first CUDA card).  tessellate: the spheres as
    triangle meshes plus a glass sphere (the benchmark scene), or two
    quadric spheres, as in the JAX package."""
    device = devmod.resolve(device)
    b = SceneBuilder()
    white = b.add_material(MaterialSpec(type=MAT_MATTE,
                                        kd=_rgb(.73, .73, .73)))
    red = b.add_material(MaterialSpec(type=MAT_MATTE,
                                      kd=_rgb(.65, .05, .05)))
    green = b.add_material(MaterialSpec(type=MAT_MATTE,
                                        kd=_rgb(.12, .45, .15)))
    mirror = b.add_material(MaterialSpec(type=MAT_MIRROR,
                                         kr=np.full(31, .9, np.float32)))
    glass = b.add_material(MaterialSpec(type=MAT_GLASS,
                                        kr=np.ones(31, np.float32),
                                        kt=np.ones(31, np.float32),
                                        eta=1.5))
    plastic = b.add_material(MaterialSpec(type=MAT_PLASTIC,
                                          kd=_rgb(.3, .35, .5),
                                          ks=np.full(31, .4, np.float32),
                                          rough_u=0.05, rough_v=0.05))
    blackm = b.add_material(MaterialSpec(type=MAT_MATTE))

    def quad(pts, mat, light=-1):
        b.add_triangle_mesh(pts, [[0, 1, 2], [2, 3, 0]], mat, light_id=light)

    quad([[0, 0, 0], [5, 0, 0], [5, 5, 0], [0, 5, 0]], white)
    quad([[0, 0, 5], [0, 5, 5], [5, 5, 5], [5, 0, 5]], white)
    quad([[0, 0, 0], [0, 5, 0], [0, 5, 5], [0, 0, 5]], red)
    quad([[5, 0, 0], [5, 0, 5], [5, 5, 5], [5, 5, 0]], green)
    quad([[0, 5, 0], [5, 5, 0], [5, 5, 5], [0, 5, 5]], white)
    li = b.add_area_light(
        spec.from_rgb_np(np.asarray([1.0, 0.85, 0.6]), "illuminant") * 15.0)
    quad([[1.8, 1.8, 4.99], [1.8, 3.2, 4.99], [3.2, 3.2, 4.99],
          [3.2, 1.8, 4.99]], blackm, light=li)
    if tessellate:
        pts, idx = _uv_sphere(28, 56)
        b.add_triangle_mesh(pts * 1.0 + np.array([3.5, 3.4, 1.0]), idx,
                            mirror)
        b.add_triangle_mesh(pts * 0.8 + np.array([1.4, 2.6, 0.8]), idx,
                            plastic)
        b.add_sphere(tfm.translate(2.5, 1.3, 0.6) * tfm.scale(.6, .6, .6),
                     1.0, glass)
    else:
        b.add_sphere(tfm.translate(3.5, 3.4, 1.0), 1.0, mirror)
        b.add_sphere(tfm.translate(1.4, 2.6, 0.8) * tfm.scale(.8, .8, .8),
                     1.0, plastic)
    scene = b.build(device=device)

    def camera_ctor(W, H):
        return projective.make_perspective(
            tfm.look_at([2.5, -4.5, 2.5], [2.5, 2.5, 2.5], [0, 0, 1]),
            50.0, W, H, device=device)

    return scene, camera_ctor
