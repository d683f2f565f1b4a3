"""Material shading: BRDF evaluation + next-ray sampling.

Branchless wavefront replacement for the reference's virtual
``material::scatter`` dispatch (reference main.cpp:46): all four material
models are evaluated on the whole ray front (cheap elementwise math) and the
result is selected by material id. This is the differentiable core — the
baked shading pack, material factors, and geometry all receive gradients
through this module.

Data path: per-ray material parameters ride exactly THREE gathers — a
packed float row [M,30], a packed int row [M,9], and one fetch from the
baked 8-channel shading atlas (models/scene.py build(): albedo texel,
normal texel, metallic, roughness co-baked per material). Small-table
gathers use ops/lookup.table_lookup. Procedural albedo (solid/checker) is
computed inline from the float row.

Reference semantics (quirks included, since they define the images):

  * pbrMetallicRoughness (material.h:156-245): albedo map sampled then /255;
    tangent-space normal map via TBN; metallic from the *red* channel /255,
    roughness from the *green* channel /255; cosine-ish scatter
    ``normal + randomUnitVector``; half-vector from scatter-as-light;
    ``F0 = lerp(0.4, albedoFactor, m)`` — the reference's 0.4, not the
    canonical 0.04 (material.h:228); Lambert diffuse times (1-F)(1-m) and
    the albedo *factor* applied a second time (material.h:237); specular
    D*F*G / (4 NdotV NdotL + eps); everything times NdotL; always scatters.
  * metal (material.h:87-102): mirror reflect + fuzz * random-in-unit-ball;
    absorbed if the scattered ray leaves below the surface.
  * dielectric (material.h:104-137): Schlick-probability reflect/refract
    with total internal reflection.
  * diffuseLight (material.h:139-154): never scatters; emits its emission
    texture's raw value at the hit — solid color, checker (evaluated
    inline from the hit point), or an image texel baked into the light's
    own pack layer. Matches the ctor taking any texture (material.h:141).
  * every PBR slot accepts any texture kind, like the 9 ctor overloads
    (material.h:25-70): images ride the baked pack; checker/solid values
    are evaluated inline (they are functions of the 3D hit point).
  * checker albedo: sign of sin(10x)sin(10y)sin(10z) picks even/odd * 255
    (texture.h:42-48); solid albedo passes through at its stored scale, so
    the solid-color PBR ctor's /255 quirk (material.h:165-167) holds.

BRDF terms are from pbr.h:58-81 (GGX NDF with alpha=roughness^2, Schlick
GAF with k=(r+1)^2/8, UE4 spherical-gaussian Schlick Fresnel).
"""

from __future__ import annotations

from typing import NamedTuple

import jax.numpy as jnp

from sexy_raytracer_jax.models.scene import (
    MAT_DIELECTRIC,
    MAT_LIGHT,
    MAT_METAL,
    MAT_PBR,
)
from sexy_raytracer_jax.ops.lookup import table_lookup
from sexy_raytracer_jax.utils.mathx import (
    EPSILON,
    PI,
    dot,
    near_zero,
    normal_int_to_float,
    reflect,
    refract,
    unit_vector,
)


class ScatterSample(NamedTuple):
    attenuation: jnp.ndarray  # [R,3] throughput multiplier
    emitted: jnp.ndarray      # [R,3] emitted radiance at the hit
    direction: jnp.ndarray    # [R,3] next ray direction
    scattered: jnp.ndarray    # [R] bool — False terminates the path


# -- BRDF terms (pbr.h:58-81) ----------------------------------------------

def trowbridge_reitz_ndf(n_dot_h, roughness):
    alpha = roughness * roughness
    alpha2 = alpha * alpha
    denom = PI * (n_dot_h * n_dot_h * (alpha2 - 1.0) + 1.0) ** 2
    # guard the r=0, NdotH=1 singular point (the reference computes 0/0
    # NaN there, pbr.h:62-64 — a measure-zero event we make finite).
    # 1e-12, NOT 1e-20: the VJP divides by the guard SQUARED, and 1e-40
    # underflows f32 to 0 -> 0/0 NaN gradients exactly at the singularity.
    return alpha2 / jnp.maximum(denom, 1e-12)


def schlick_gaf(n_dot_v, roughness):
    k = ((roughness + 1.0) ** 2) / 8.0
    return n_dot_v / (n_dot_v * (1.0 - k) + k)


def fresnel_epic(f0, h_dot_v):
    power = 2.0 ** ((-5.55473 * h_dot_v - 6.98316) * h_dot_v)
    return f0 + (1.0 - f0) * power[..., None]


# -- packed material rows ----------------------------------------------------

def material_packs(scene):
    """Packed material tables: float rows [M,30], int rows [M,9]."""
    mat_f = jnp.concatenate(
        [
            scene.mat_base_color,                # 0:4
            scene.mat_metallic[:, None],         # 4
            scene.mat_roughness[:, None],        # 5
            scene.mat_fuzz[:, None],             # 6
            scene.mat_ior[:, None],              # 7
            scene.mat_albedo_c0,                 # 8:11
            scene.mat_albedo_c1,                 # 11:14
            scene.mat_emit_rgb,                  # 14:17
            scene.mat_emit_c1,                   # 17:20
            scene.mat_metal_cc,                  # 20:22
            scene.mat_rough_cc,                  # 22:24
            scene.mat_normal_c0,                 # 24:27
            scene.mat_normal_c1,                 # 27:30
        ],
        axis=1,
    )
    mat_i = jnp.stack(
        [
            scene.mat_type,          # 0
            scene.mat_albedo_kind,   # 1
            scene.mat_normal_kind,   # 2
            scene.mat_metal_kind,    # 3
            scene.mat_rough_kind,    # 4
            scene.mat_pack_layer,    # 5
            scene.mat_pack_w,        # 6
            scene.mat_pack_h,        # 7
            scene.mat_emit_kind,     # 8
        ],
        axis=1,
    )
    return mat_f, mat_i


def _sample_pack(scene, mat, uv):
    """One fetch from the baked 8-channel shading atlas (0-255 scale).

    Nearest neighbor, u clamped, v flipped — texture.h:129-147 semantics.
    """
    L, H, W, C = scene.shade_atlas.shape
    layer = jnp.maximum(mat["pack_layer"], 0)
    w = mat["pack_w"]
    h = mat["pack_h"]
    uu = jnp.clip(uv[..., 0], 0.0, 1.0)
    vv = 1.0 - jnp.clip(uv[..., 1], 0.0, 1.0)
    xi = jnp.minimum((uu * w).astype(jnp.int32), w - 1)
    yj = jnp.minimum((vv * h).astype(jnp.int32), h - 1)
    flat = (layer * H + yj) * W + xi
    return scene.shade_atlas.reshape(L * H * W, C)[flat]


# -- material models --------------------------------------------------------

def _shade_pbr(scene, mat, pack, rec, ray_dir, unit_sphere_dir, checker_odd):
    base_rgb = mat["base_color"][..., :3]
    kind = mat["albedo_kind"]
    odd = checker_odd  # [R] bool: sign of sin(10x)sin(10y)sin(10z) < 0

    # procedural albedo values (texture.h:26-28, 42-48)
    checker = (
        jnp.where(odd[..., None], mat["albedo_c1"], mat["albedo_c0"]) * 255.0
    )
    map_val = jnp.where((kind == 1)[..., None], mat["albedo_c0"], pack[..., 0:3])
    map_val = jnp.where((kind == 2)[..., None], checker, map_val)
    # textured: sample / 255 (material.h:165-167); untextured: factor rgb
    attenuation = jnp.where((kind == 0)[..., None], base_rgb, map_val / 255.0)

    # normal slot: image texel from the pack, or an inline checker/solid
    # texture value (both feed normalIntToFloat, material.h:171-186)
    nk = mat["normal_kind"]
    nm_val = jnp.where(
        (nk == 2)[..., None],
        jnp.where(odd[..., None], mat["normal_c1"], mat["normal_c0"]),
        pack[..., 3:6],
    )
    nm = normal_int_to_float(nm_val)
    # TBN columns: tangent, bitangent, normal (material.h:179-185)
    world_nm = (
        rec.tangent * nm[..., 0:1]
        + rec.bitangent * nm[..., 1:2]
        + rec.normal * nm[..., 2:3]
    )
    normal = jnp.where((nk != 0)[..., None], unit_vector(world_nm), rec.normal)

    # metallic = map red channel / 255 (material.h:191); checker/solid
    # values are pre-divided at scene build (mat_metal_cc)
    mk = mat["metal_kind"]
    m_checker = jnp.where(odd, mat["metal_cc"][..., 1], mat["metal_cc"][..., 0])
    m = jnp.where(mk == 3, pack[..., 6] / 255.0, mat["metallic"])
    m = jnp.clip(jnp.where(mk == 2, m_checker, m), 0.0, 1.0)
    m = jnp.where(mk == 0, mat["metallic"], m)

    # roughness = map green channel / 255 (material.h:197)
    rk = mat["rough_kind"]
    r_checker = jnp.where(odd, mat["rough_cc"][..., 1], mat["rough_cc"][..., 0])
    r = jnp.where(rk == 3, pack[..., 7] / 255.0, mat["roughness"])
    r = jnp.clip(jnp.where(rk == 2, r_checker, r), 0.0, 1.0)
    r = jnp.where(rk == 0, mat["roughness"], r)

    # scatter direction (material.h:203-208)
    scatter_dir = normal + unit_sphere_dir
    degenerate = near_zero(scatter_dir)
    scatter_dir = jnp.where(degenerate[..., None], normal, scatter_dir)
    scatter_dir = unit_vector(scatter_dir)

    view = -unit_vector(ray_dir)
    half = unit_vector(scatter_dir + view)

    n_dot_l = jnp.maximum(dot(normal, scatter_dir), 0.0)
    n_dot_h = jnp.maximum(dot(normal, half), 0.0)
    h_dot_v = jnp.maximum(dot(half, view), 0.0)
    n_dot_v = jnp.maximum(dot(normal, view), 0.0)

    f0 = (1.0 - m[..., None]) * 0.4 + m[..., None] * base_rgb  # material.h:228
    d = trowbridge_reitz_ndf(n_dot_h, r)
    f = fresnel_epic(f0, h_dot_v)
    g = schlick_gaf(n_dot_l, r) * schlick_gaf(n_dot_v, r)

    diffuse = (attenuation / PI) * (1.0 - f) * (1.0 - m[..., None]) * base_rgb
    specular = (d * g)[..., None] * f / (4.0 * n_dot_v * n_dot_l + EPSILON)[..., None]
    out_attenuation = (diffuse + specular) * n_dot_l[..., None]
    return out_attenuation, scatter_dir


def _shade_metal(mat, rec, ray_dir, ball_sample):
    albedo = mat["base_color"][..., :3]
    fuzz = mat["fuzz"]
    reflected = reflect(unit_vector(ray_dir), rec.normal)
    direction = reflected + fuzz[..., None] * ball_sample
    ok = dot(direction, rec.normal) > 0.0  # material.h:96
    return albedo, direction, ok


def _shade_dielectric(mat, rec, ray_dir, uniform_sample):
    ir = mat["ior"]
    ratio = jnp.where(rec.front_face, 1.0 / ir, ir)
    unit_dir = unit_vector(ray_dir)
    cos_theta = jnp.minimum(dot(rec.normal, -unit_dir), 1.0)
    sin_theta = jnp.sqrt(jnp.maximum(1.0 - cos_theta * cos_theta, 0.0))
    cannot_refract = ratio * sin_theta > 1.0
    r0 = ((1.0 - ratio) / (1.0 + ratio)) ** 2
    reflectance = r0 + (1.0 - r0) * (1.0 - cos_theta) ** 5
    do_reflect = cannot_refract | (reflectance > uniform_sample)
    direction = jnp.where(
        do_reflect[..., None],
        reflect(unit_dir, rec.normal),
        refract(unit_dir, rec.normal, ratio),
    )
    return jnp.ones_like(direction), direction


def shade(scene, rec, ray_dir, rand) -> ScatterSample:
    """Evaluate all materials and select by id.

    ``rand`` is a dict with pre-drawn per-ray randomness:
      ``unit_vector`` [R,3] (PBR scatter), ``unit_ball`` [R,3] (metal fuzz),
      ``uniform`` [R] (dielectric reflect/refract choice).
    """
    mat_f, mat_i = material_packs(scene)
    gf = table_lookup(mat_f, rec.mat_id)
    gi = table_lookup(mat_i, rec.mat_id)
    mat = {
        "base_color": gf[:, 0:4],
        "metallic": gf[:, 4],
        "roughness": gf[:, 5],
        "fuzz": gf[:, 6],
        "ior": gf[:, 7],
        "albedo_c0": gf[:, 8:11],
        "albedo_c1": gf[:, 11:14],
        "emit_rgb": gf[:, 14:17],
        "emit_c1": gf[:, 17:20],
        "metal_cc": gf[:, 20:22],
        "rough_cc": gf[:, 22:24],
        "normal_c0": gf[:, 24:27],
        "normal_c1": gf[:, 27:30],
        "type": gi[:, 0],
        "albedo_kind": gi[:, 1],
        "normal_kind": gi[:, 2],
        "metal_kind": gi[:, 3],
        "rough_kind": gi[:, 4],
        "pack_layer": gi[:, 5],
        "pack_w": gi[:, 6],
        "pack_h": gi[:, 7],
        "emit_kind": gi[:, 8],
    }
    mtype = mat["type"]
    pack = _sample_pack(scene, mat, rec.uv)

    # checker parity shared by every procedural slot (texture.h:42-48)
    sines = (
        jnp.sin(10.0 * rec.p[..., 0])
        * jnp.sin(10.0 * rec.p[..., 1])
        * jnp.sin(10.0 * rec.p[..., 2])
    )
    checker_odd = sines < 0.0

    pbr_att, pbr_dir = _shade_pbr(
        scene, mat, pack, rec, ray_dir, rand["unit_vector"], checker_odd
    )
    met_att, met_dir, met_ok = _shade_metal(mat, rec, ray_dir, rand["unit_ball"])
    die_att, die_dir = _shade_dielectric(mat, rec, ray_dir, rand["uniform"])
    # diffuseLight: emitted = emit texture value at the hit, raw reference
    # scale (material.h:148-151): solid color, checker (pre-scaled *255 at
    # build), or an image texel from the light's own pack layer
    ek = mat["emit_kind"]
    emit_val = jnp.where(
        (ek == 2)[..., None],
        jnp.where(checker_odd[..., None], mat["emit_c1"], mat["emit_rgb"]),
        jnp.where((ek == 3)[..., None], pack[..., 0:3], mat["emit_rgb"]),
    )
    emitted = jnp.where((mtype == MAT_LIGHT)[..., None], emit_val, 0.0)

    def sel(mask, a, b):
        return jnp.where(mask[..., None] if a.ndim > 1 else mask, a, b)

    att = sel(mtype == MAT_PBR, pbr_att, jnp.zeros_like(pbr_att))
    att = sel(mtype == MAT_METAL, met_att, att)
    att = sel(mtype == MAT_DIELECTRIC, die_att, att)

    direction = sel(mtype == MAT_PBR, pbr_dir, ray_dir)
    direction = sel(mtype == MAT_METAL, met_dir, direction)
    direction = sel(mtype == MAT_DIELECTRIC, die_dir, direction)

    scattered = jnp.where(mtype == MAT_PBR, True, False)
    scattered = jnp.where(mtype == MAT_METAL, met_ok, scattered)
    scattered = jnp.where(mtype == MAT_DIELECTRIC, True, scattered)
    # MAT_LIGHT: never scatters (material.h:144-146)

    return ScatterSample(
        attenuation=att,
        emitted=emitted,
        direction=direction,
        scattered=scattered & rec.hit,
    )
