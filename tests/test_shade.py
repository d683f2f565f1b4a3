"""Shading kernel vs oracle, with injected random samples."""

import numpy as np

import jax.numpy as jnp

from sexy_raytracer_jax.models import SceneBuilder
from sexy_raytracer_jax.ops.intersect import find_hit_bruteforce, hit_data
from sexy_raytracer_jax.ops.shade import shade
from sexy_raytracer_jax.oracle import reference as oracle


def build_material_zoo():
    """One sphere per material kind, plus a textured triangle."""
    b = SceneBuilder()
    checker = b.add_checker_texture((0.2, 0.3, 0.1), (0.9, 0.9, 0.9))
    b.add_sphere((0, 0, 0), 1.0, b.add_pbr_material(albedo_tex=checker))
    b.add_sphere((3, 0, 0), 1.0, b.add_metal_material((0.7, 0.6, 0.5), 0.3))
    b.add_sphere((6, 0, 0), 1.0, b.add_dielectric_material(1.5))
    b.add_sphere((9, 0, 0), 1.0, b.add_light_material(color=(5.0, 4.0, 3.0)))
    # textured PBR with image maps
    img = (np.arange(16 * 16 * 3).reshape(16, 16, 3) * 17) % 256
    albedo_tex = b.add_image_texture(img.astype(np.uint8))
    normal_img = np.full((8, 8, 3), 128, np.uint8)
    normal_img[..., 2] = 255
    normal_tex = b.add_image_texture(normal_img)
    metal_img = np.zeros((8, 8, 3), np.uint8)
    metal_img[..., 0] = 200
    rough_img = np.zeros((8, 8, 3), np.uint8)
    rough_img[..., 1] = 100
    pbr_full = b.add_pbr_material(
        albedo_tex=albedo_tex,
        normal_tex=normal_tex,
        metallic_tex=b.add_image_texture(metal_img),
        roughness_tex=b.add_image_texture(rough_img),
        base_color=(0.9, 0.8, 0.7, 1.0),
    )
    b.add_sphere((0, 0, 4), 1.0, pbr_full)
    # solid-color PBR (the /255 ctor quirk)
    b.add_sphere((3, 0, 4), 1.0,
                 b.add_pbr_material(albedo_tex=b.add_solid_texture((0.4, 0.2, 0.1))))
    # factor-only PBR (no albedo map -> factor rgb, no /255)
    b.add_sphere((6, 0, 4), 1.0,
                 b.add_pbr_material(base_color=(0.8, 0.8, 0.8, 1.0),
                                    metallic=0.3, roughness=0.4))
    # textured emission: checker light (material.h:141 takes any texture;
    # checker emits color*255, texture.h:45-47) and image-texel light
    emit_checker = b.add_checker_texture((0.02, 0.01, 0.0), (0.0, 0.01, 0.02))
    b.add_sphere((9, 0, 4), 1.0, b.add_light_material(emit_tex=emit_checker))
    emit_img = ((np.arange(8 * 8 * 3).reshape(8, 8, 3) * 31) % 256)
    b.add_sphere((0, 0, 8), 1.0, b.add_light_material(
        emit_tex=b.add_image_texture(emit_img.astype(np.uint8))))
    # checker / solid textures in the non-albedo PBR slots (the reference's
    # other ctor overloads, material.h:25-70)
    slot_checker = b.add_checker_texture((0.9, 0.2, 0.4), (0.1, 0.8, 0.6))
    slot_solid = b.add_solid_texture((180.0, 90.0, 30.0))
    b.add_sphere((3, 0, 8), 1.0, b.add_pbr_material(
        base_color=(0.6, 0.6, 0.6, 1.0),
        metallic_tex=slot_checker,
        roughness_tex=slot_checker,
        normal_tex=slot_solid,
    ))
    b.add_sphere((6, 0, 8), 1.0, b.add_pbr_material(
        base_color=(0.5, 0.5, 0.9, 1.0),
        metallic_tex=slot_solid,
        roughness_tex=slot_solid,
        normal_tex=slot_checker,
    ))
    return b.build(build_bvh=False)


def test_shade_matches_oracle(rng_np):
    scene = build_material_zoo()
    scene_np = oracle._as_numpy(scene)

    rng_np = np.random.default_rng(5)
    centers = np.asarray(scene.sph_c0)
    n = 64 * centers.shape[0]
    # aim jittered rays at every sphere so each material is exercised
    org = np.repeat(centers, 64, axis=0) + np.array([8.0, 6.0, 10.0])
    org = (org + rng_np.normal(size=(n, 3))).astype(np.float32)
    targets = np.repeat(centers, 64, axis=0) + 0.3 * rng_np.normal(size=(n, 3))
    dir = (targets - org).astype(np.float32)
    time = np.zeros(n, np.float32)

    prim, _ = find_hit_bruteforce(
        scene, jnp.asarray(org), jnp.asarray(dir), jnp.asarray(time)
    )
    rec = hit_data(scene, jnp.asarray(org), jnp.asarray(dir), jnp.asarray(time), prim)

    unit_vec = rng_np.normal(size=(n, 3))
    unit_vec /= np.linalg.norm(unit_vec, axis=1, keepdims=True)
    ball = rng_np.normal(size=(n, 3))
    ball = ball / np.linalg.norm(ball, axis=1, keepdims=True) * (
        rng_np.random((n, 1)) ** (1 / 3)
    )
    uni = rng_np.random(n)
    rand = {
        "unit_vector": jnp.asarray(unit_vec, jnp.float32),
        "unit_ball": jnp.asarray(ball, jnp.float32),
        "uniform": jnp.asarray(uni, jnp.float32),
    }
    samp = shade(scene, rec, jnp.asarray(dir), rand)

    prim_np = np.asarray(prim)
    checked = {int(m): 0 for m in np.asarray(scene.mat_type)}
    for r in range(n):
        if prim_np[r] < 0:
            continue
        orec = oracle.HitRec()
        orec.p = np.asarray(rec.p[r], np.float64)
        orec.normal = np.asarray(rec.normal[r], np.float64)
        orec.tangent = np.asarray(rec.tangent[r], np.float64)
        orec.bitangent = np.asarray(rec.bitangent[r], np.float64)
        orec.uv = np.asarray(rec.uv[r], np.float64)
        orec.t = float(rec.t[r])
        orec.front_face = bool(rec.front_face[r])
        orec.mat_id = int(rec.mat_id[r])
        samples = {
            "unit_vector": unit_vec[r],
            "unit_sphere": ball[r],
            "uniform": uni[r],
        }
        ok, att, new_o, new_d = oracle.scatter(
            scene_np, orec.mat_id, dir[r].astype(np.float64), time[r], orec,
            None, samples=samples,
        )
        emit = oracle.emitted(scene_np, orec.mat_id, orec.uv, orec.p)
        np.testing.assert_allclose(
            np.asarray(samp.emitted[r]), emit, rtol=1e-4, atol=1e-5
        )
        assert bool(samp.scattered[r]) == ok
        if ok:
            np.testing.assert_allclose(
                np.asarray(samp.attenuation[r]), att, rtol=3e-3, atol=2e-4
            )
            np.testing.assert_allclose(
                np.asarray(samp.direction[r]), new_d, rtol=3e-3, atol=2e-4
            )
        mtype = int(scene_np.mat_type[orec.mat_id])
        checked[mtype] = checked.get(mtype, 0) + 1
    # every material kind must have been exercised
    assert all(v > 0 for v in checked.values()), checked
