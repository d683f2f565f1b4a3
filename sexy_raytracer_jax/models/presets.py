"""The five BASELINE acceptance scenes as named presets.

The reference configures scenes by editing ``#if`` blocks in main.cpp
(reference main.cpp:60-80); here each BASELINE.json config is a function
returning ``(SceneData, RenderConfig)``.

Asset files are read from ``data_dir`` (default: $SRT_DATA_DIR or the
reference's data directory) — the framework itself carries no binary assets.
"""

from __future__ import annotations

import os

import numpy as np

from sexy_raytracer_jax.models.gltf import load_gltf
from sexy_raytracer_jax.models.scene import SceneBuilder
from sexy_raytracer_jax.utils.config import CameraConfig, RenderConfig
from sexy_raytracer_jax.utils.png import read_png


def default_data_dir() -> str:
    return os.environ.get("SRT_DATA_DIR", "/root/reference/data")


def _add_ground_and_lights(b: SceneBuilder) -> None:
    """Shared furniture of the flagship scene (reference main.cpp:89-144)."""
    checker = b.add_checker_texture((0.2, 0.3, 0.1), (0.9, 0.9, 0.9))
    ground = b.add_pbr_material(albedo_tex=checker)
    b.add_sphere((0.0, -1000.0, 0.0), 1000.0, ground, time0=0.0, time1=1.0)
    light = b.add_light_material(color=(250.2, 220.9, 110.2))
    b.add_sphere((-7.0, 4.0, 6.0), 1.0, light)


def _add_iron_and_metal(b: SceneBuilder, data_dir: str) -> None:
    # rustediron PBR sphere (main.cpp:133-141). The reference asks for
    # "-2x1"-suffixed files that do not exist in data/, so its textures are
    # magenta sentinels — reproduced faithfully via read_png -> None.
    iron_albedo = b.add_image_texture(
        read_png(os.path.join(data_dir, "rustediron2_basecolor-2x1.png"), 3)
    )
    iron_normal = b.add_image_texture(
        read_png(os.path.join(data_dir, "rustediron2_normal-2x1.png"), 3)
    )
    iron_metal = b.add_image_texture(
        read_png(os.path.join(data_dir, "rustediron2_metallic-2x1.png"), 1)
    )
    iron_rough = b.add_image_texture(
        read_png(os.path.join(data_dir, "rustediron2_roughness-2x1.png"), 1)
    )
    iron = b.add_pbr_material(
        albedo_tex=iron_albedo,
        normal_tex=iron_normal,
        metallic_tex=iron_metal,
        roughness_tex=iron_rough,
        base_color=(1.0, 1.0, 1.0, 1.0),
    )
    b.add_sphere((-3.0, 1.0, 0.0), 1.0, iron)

    metal = b.add_metal_material((0.7, 0.6, 0.5), 0.0)  # main.cpp:143-144
    b.add_sphere((3.0, 1.0, 0.0), 1.0, metal)


def _flagship_camera() -> CameraConfig:
    # reference main.cpp:163-172
    return CameraConfig(
        eye=(0.0, 3.0, 5.0),
        look_at=(0.0, 2.5, 0.0),
        up=(0.0, 1.0, 0.0),
        vfov_degrees=70.0,
        aperture=0.1,
        focus_dist=10.0,
        time0=0.0,
        time1=1.0,
    )


# ---------------------------------------------------------------------------
# Config 1: Shirley random-spheres, 240p / 16 spp / 4 bounces (sphere-only)
# ---------------------------------------------------------------------------

def shirley_spheres(seed: int = 4, spp: int = 16, height: int = 240):
    """The book's random-sphere field (reference main.cpp:92-122, commented
    but fully present). Deterministic via a seeded numpy Generator instead
    of the reference's global mt19937.
    """
    rng = np.random.default_rng(seed)
    b = SceneBuilder()

    checker = b.add_checker_texture((0.2, 0.3, 0.1), (0.9, 0.9, 0.9))
    b.add_sphere((0, -1000, 0), 1000.0, b.add_pbr_material(albedo_tex=checker))

    for a in range(-11, 11):
        for bb in range(-11, 11):
            choose = rng.random()
            center = np.array(
                [a + 0.9 * rng.random(), 0.2, bb + 0.9 * rng.random()]
            )
            if np.linalg.norm(center - np.array([4.0, 0.2, 0.0])) <= 0.9:
                continue
            if choose < 0.8:
                albedo = rng.random(3) * rng.random(3)
                # reference ctor pbrMetallicRoughness(color3f) wraps the
                # color in a solidColor albedo map (material.h:25-28)
                mat = b.add_pbr_material(
                    albedo_tex=b.add_solid_texture(albedo)
                )
                center2 = center + np.array([0.0, rng.random() * 0.5, 0.0])
                b.add_sphere(center, 0.2, mat, center1=center2)
            elif choose < 0.95:
                albedo = 0.5 + 0.5 * rng.random(3)
                fuzz = 0.5 * rng.random()
                b.add_sphere(center, 0.2, b.add_metal_material(albedo, fuzz))
            else:
                b.add_sphere(center, 0.2, b.add_dielectric_material(1.5))

    b.add_sphere((0, 1, 0), 1.0, b.add_dielectric_material(1.5))
    b.add_sphere(
        (-4, 1, 0),
        1.0,
        b.add_pbr_material(albedo_tex=b.add_solid_texture((0.4, 0.2, 0.1))),
    )
    b.add_sphere((4, 1, 0), 1.0, b.add_metal_material((0.7, 0.6, 0.5), 0.0))

    scene = b.build()
    cfg = RenderConfig(
        width=int(height * 16 / 9),
        height=height,
        samples_per_pixel=spp,
        max_bounce=4,
        camera=CameraConfig(
            eye=(13.0, 2.0, 3.0),
            look_at=(0.0, 0.0, 0.0),
            vfov_degrees=20.0,
            aperture=0.1,
            focus_dist=10.0,
        ),
    )
    return scene, cfg


# ---------------------------------------------------------------------------
# Config 2: cube.gltf, 480p / 64 spp (ray-triangle + glTF load)
# ---------------------------------------------------------------------------

def cube(data_dir: str | None = None, spp: int = 64, height: int = 480):
    data_dir = data_dir or default_data_dir()
    b = SceneBuilder()
    _add_ground_and_lights(b)
    # lift the cube onto the ground plane, like the reference's square-branch
    # translate(0, 1, 0) (main.cpp:69); rotation -15 deg about Y (main.cpp:66)
    angle = np.deg2rad(-15.0)
    rot = np.array(
        [
            [np.cos(angle), 0.0, np.sin(angle), 0.0],
            [0.0, 1.0, 0.0, 1.0],
            [-np.sin(angle), 0.0, np.cos(angle), 0.0],
            [0.0, 0.0, 0.0, 1.0],
        ]
    )
    load_gltf(os.path.join(data_dir, "cube.gltf"), b, root_transform=rot)
    scene = b.build()
    cfg = RenderConfig(
        width=int(height * 16 / 9),
        height=height,
        samples_per_pixel=spp,
        max_bounce=4,
        camera=_flagship_camera(),
    )
    return scene, cfg


# ---------------------------------------------------------------------------
# Config 3: rustediron PBR globe, 480p
# ---------------------------------------------------------------------------

def rustediron_globe(data_dir: str | None = None, spp: int = 64, height: int = 480):
    data_dir = data_dir or default_data_dir()
    b = SceneBuilder()
    _add_ground_and_lights(b)
    _add_iron_and_metal(b, data_dir)
    scene = b.build()
    cfg = RenderConfig(
        width=int(height * 16 / 9),
        height=height,
        samples_per_pixel=spp,
        max_bounce=4,
        camera=_flagship_camera(),
    )
    return scene, cfg


# ---------------------------------------------------------------------------
# Config 4 / flagship: Master Chief + furniture, 720p
# ---------------------------------------------------------------------------

def masterchief(
    data_dir: str | None = None,
    spp: int = 1000,
    height: int = 720,
    asset: str = "masterchief2-separate-xf.gltf",
    root_transform=None,
):
    """The reference's randomScene() (main.cpp:54-154): Master Chief mesh +
    checker ground + HDR light + (sentinel-textured) iron PBR sphere +
    mirror metal sphere."""
    data_dir = data_dir or default_data_dir()
    b = SceneBuilder()
    load_gltf(os.path.join(data_dir, asset), b, root_transform=root_transform)
    _add_ground_and_lights(b)
    _add_iron_and_metal(b, data_dir)
    scene = b.build()
    cfg = RenderConfig(
        width=int(height * 16 / 9),
        height=height,
        samples_per_pixel=spp,
        max_bounce=4,
        camera=_flagship_camera(),
    )
    return scene, cfg


# ---------------------------------------------------------------------------
# Flagship via GLB container: halo.glb is the same Master Chief mesh as
# masterchief2-separate-xf.gltf but stored as binary GLB *with live node
# transforms* (the -xf file is pre-baked because the reference loader
# ignores node transforms, model.h:335-365). CHIEF_GLB_BAKE is the residual
# world transform (uniform 0.075 scale x rotation) that maps halo.glb's
# node-transformed triangles onto the -xf geometry — least-squares fit over
# all 3,042 triangle centroids, max residual 9.2e-7 (tests/test_gltf.py).
# ---------------------------------------------------------------------------

CHIEF_GLB_BAKE = np.array(
    [
        [-0.00065918, -0.00265495, -0.0749501, 0.0],
        [0.0, 0.07495299, -0.00265505, 0.0],
        [0.07499711, -0.00002334, -0.00065877, 0.0],
        [0.0, 0.0, 0.0, 1.0],
    ]
)


def masterchief_glb(data_dir: str | None = None, spp: int = 1000,
                    height: int = 720):
    """The flagship scene loaded through the GLB path (halo.glb)."""
    return masterchief(
        data_dir=data_dir,
        spp=spp,
        height=height,
        asset="halo.glb",
        root_transform=CHIEF_GLB_BAKE,
    )


# ---------------------------------------------------------------------------
# Alternate reference scene branches (main.cpp:60-80)
# ---------------------------------------------------------------------------

def _branch_transform() -> np.ndarray:
    # reference main.cpp:66-70: translate(0,1,0) * rotY(-15 deg)
    angle = np.deg2rad(-15.0)
    return np.array(
        [
            [np.cos(angle), 0.0, np.sin(angle), 0.0],
            [0.0, 1.0, 0.0, 1.0],
            [-np.sin(angle), 0.0, np.cos(angle), 0.0],
            [0.0, 0.0, 0.0, 1.0],
        ]
    )


def square(data_dir: str | None = None, spp: int = 64, height: int = 480):
    """square.gltf branch (main.cpp:60-71, `if (0)` block): the two-triangle
    quad under the same furniture/camera as the flagship."""
    data_dir = data_dir or default_data_dir()
    b = SceneBuilder()
    load_gltf(os.path.join(data_dir, "square.gltf"), b,
              root_transform=_branch_transform())
    _add_ground_and_lights(b)
    _add_iron_and_metal(b, data_dir)
    scene = b.build()
    cfg = RenderConfig(
        width=int(height * 16 / 9),
        height=height,
        samples_per_pixel=spp,
        max_bounce=4,
        camera=_flagship_camera(),
    )
    return scene, cfg


def scene_gltf(data_dir: str | None = None, spp: int = 64, height: int = 480):
    """scene.gltf branch (main.cpp:77-80, the `else` block): a 15-primitive
    scene-graph asset (real node transforms; uint32 indices — the asset the
    reference loader cannot parse, model.h:448)."""
    data_dir = data_dir or default_data_dir()
    b = SceneBuilder()
    load_gltf(os.path.join(data_dir, "scene.gltf"), b)
    _add_ground_and_lights(b)
    _add_iron_and_metal(b, data_dir)
    scene = b.build()
    cfg = RenderConfig(
        width=int(height * 16 / 9),
        height=height,
        samples_per_pixel=spp,
        max_bounce=4,
        camera=_flagship_camera(),
    )
    return scene, cfg


def _lcg_stream(seed: int):
    """The reforacle driver's deterministic 64-bit LCG (driver.cpp).

    Bit-identical to the C++: next state = state * 6364136223846793005 +
    1442695040888963407 (mod 2^64); value = top 24 bits / 2^24, exact in
    f32. This makes the Shirley field *data* shared by both renderers —
    the reference's commented branch (main.cpp:92-122) consumed the global
    mt19937, whose libstdc++ float mapping is not reproducible from here.
    """
    state = seed & 0xFFFFFFFFFFFFFFFF

    def nxt() -> np.float32:
        nonlocal state
        state = (state * 6364136223846793005 + 1442695040888963407) \
            & 0xFFFFFFFFFFFFFFFF
        return np.float32(state >> 40) / np.float32(16777216.0)

    return nxt


def shirley_parity(seed: int = 42, spp: int = 64, height: int = 240):
    """The EXACT scene tests/reforacle/driver.cpp builds for
    ``reforacle W H spp bounces out.png shirley [seed]`` — dielectric
    glass, fuzzy metal, moving (motion-blurred) diffuse spheres and
    thin-lens DoF under reference-binary statistical verification
    (VERDICT r4 missing #1; reference material.h:87-137, sphere.h:47-52,
    camera.h:40-50). Field layout restates main.cpp:92-122 with the
    shared LCG; all arithmetic in f32 to match the C++ draw-for-draw.
    """
    f32 = np.float32
    nxt = _lcg_stream(seed)
    b = SceneBuilder()

    checker = b.add_checker_texture((0.2, 0.3, 0.1), (0.9, 0.9, 0.9))
    b.add_sphere((0, -1000, 0), 1000.0, b.add_pbr_material(albedo_tex=checker))

    for a in range(-11, 11):
        for bb in range(-11, 11):
            choose = nxt()
            cx = f32(a) + f32(0.9) * nxt()
            cz = f32(bb) + f32(0.9) * nxt()
            center = np.array([cx, 0.2, cz], np.float32)
            delta = center - np.array([4.0, 0.2, 0.0], np.float32)
            if np.sqrt(f32(np.dot(delta, delta))) <= f32(0.9):
                continue
            if choose < f32(0.8):
                r1, r2 = nxt(), nxt()
                g1, g2 = nxt(), nxt()
                b1, b2 = nxt(), nxt()
                mat = b.add_pbr_material(albedo_tex=b.add_solid_texture(
                    (f32(r1 * r2), f32(g1 * g2), f32(b1 * b2))))
                dy = nxt() * f32(0.5)
                center2 = center + np.array([0.0, dy, 0.0], np.float32)
                b.add_sphere(center, 0.2, mat, center1=center2)
            elif choose < f32(0.95):
                ar = f32(0.5) + f32(0.5) * nxt()
                ag = f32(0.5) + f32(0.5) * nxt()
                ab = f32(0.5) + f32(0.5) * nxt()
                fuzz = f32(0.5) * nxt()
                b.add_sphere(center, 0.2,
                             b.add_metal_material((ar, ag, ab), float(fuzz)))
            else:
                b.add_sphere(center, 0.2, b.add_dielectric_material(1.5))

    b.add_sphere((0, 1, 0), 1.0, b.add_dielectric_material(1.5))
    b.add_sphere(
        (-4, 1, 0), 1.0,
        b.add_pbr_material(albedo_tex=b.add_solid_texture((0.4, 0.2, 0.1))),
    )
    b.add_sphere((3, 1, 0), 1.0, b.add_metal_material((0.7, 0.6, 0.5), 0.0))

    scene = b.build()
    cfg = RenderConfig(
        width=int(height * 16 / 9),
        height=height,
        samples_per_pixel=spp,
        max_bounce=4,
        camera=CameraConfig(
            eye=(13.0, 2.0, 3.0),
            look_at=(0.0, 0.0, 0.0),
            vfov_degrees=20.0,
            aperture=0.1,
            focus_dist=10.0,
        ),
    )
    return scene, cfg


# ---------------------------------------------------------------------------
# Seeded stand-ins: the flagship's shapes without the reference's assets
# ---------------------------------------------------------------------------

def _ellipsoid(center, radii, n_lon, n_lat, rng, bump):
    """Closed lat-long ellipsoid: 2 * n_lon * (n_lat - 1) triangles with
    lat-long UVs; every vertex moved radially by seeded noise of relative
    size ``bump`` (shared vertices move together, so it stays closed).
    Faces wind counter-clockwise seen from outside (back faces cull)."""
    lat = np.linspace(0.0, np.pi, n_lat + 1)
    lon = np.linspace(0.0, 2.0 * np.pi, n_lon + 1)       # seam duplicated
    th, ph = np.meshgrid(lat, lon, indexing="ij")       # [n_lat+1, n_lon+1]
    scale = 1.0 + bump * rng.standard_normal((n_lat + 1, n_lon))
    scale = np.concatenate([scale, scale[:, :1]], axis=1)   # close the seam
    scale[0], scale[-1] = scale[0, 0], scale[-1, 0]         # single poles
    unit = np.stack([np.sin(th) * np.cos(ph), np.cos(th),
                     -np.sin(th) * np.sin(ph)], axis=-1)
    pos = np.asarray(center) + unit * np.asarray(radii) * scale[..., None]
    uv = np.stack([ph / (2.0 * np.pi), th / np.pi], axis=-1)
    vid = np.arange((n_lat + 1) * (n_lon + 1)).reshape(n_lat + 1, n_lon + 1)
    a, b = vid[:-1, :-1], vid[:-1, 1:]
    c, d = vid[1:, :-1], vid[1:, 1:]
    top = np.stack([a, c, d], -1)[:-1]       # skip the degenerate pole rows
    bot = np.stack([a, d, b], -1)[1:]
    idx = np.concatenate([top.reshape(-1, 3), bot.reshape(-1, 3)])
    return pos.reshape(-1, 3), uv.reshape(-1, 2), idx


def _noise_texture(rng, size, base, amp, octaves=(8, 32, 128)):
    """[size, size, 3] uint8: a base colour plus bilinear value noise."""
    img = np.zeros((size, size, 3))
    for cells in octaves:
        grid = rng.standard_normal((cells + 1, cells + 1, 3))
        x = np.linspace(0.0, cells, size, endpoint=False)
        i = x.astype(int)
        f = (x - i)[:, None]
        rows = grid[i] * (1 - f[..., None]) + grid[i + 1] * f[..., None]
        f = (x - i)[None, :, None]
        img += (rows[:, i] * (1 - f) + rows[:, i + 1] * f) * amp / len(octaves)
    return np.clip(np.asarray(base) + img, 0, 255).astype(np.uint8)


def flagship_standin(seed: int = 0, height: int = 720, spp: int = 1000):
    """The flagship scene with a seeded mesh in place of Master Chief.

    Same shapes as ``masterchief()``: 3,042 triangles with UVs in two
    primitives (2,976 + 66, the original's split), each with its own PBR
    material carrying a 512x512 base-colour and a 512x512 tangent-space
    normal texture, so the shading atlas and the triangle pack have the
    original's sizes. The camera, checker ground, HDR light, iron sphere
    and mirror sphere are the flagship's own.

    Differences from the original asset:
      * the body is a noise-bumped ellipsoid (0.9 x 2.2 x 0.5, standing on
        the ground at the origin where the chief stands, covering a similar
        share of the screen) and the second primitive a small ellipsoid
        "visor" on its face, not the chief's armour;
      * textures are seeded value noise, not the chief's painted maps;
      * the material factors are the chief's (base colour 1, metallic and
        roughness 0) but not its texture content;
      * the iron sphere's textures are the missing-file sentinels, as in
        the reference itself; no asset file is read.
    """
    rng = np.random.default_rng(seed)
    b = SceneBuilder()
    parts = [
        # (center, radii, n_lon, n_lat, bump, base colour, noise amplitude)
        ((0.0, 2.2, 0.0), (0.9, 2.2, 0.5), 48, 32, 0.02,
         (96, 110, 72), 60.0),
        ((0.0, 3.9, 0.33), (0.25, 0.12, 0.1), 11, 4, 0.01,
         (200, 150, 40), 40.0),
    ]
    for center, radii, n_lon, n_lat, bump, base, amp in parts:
        pos, uv, idx = _ellipsoid(center, radii, n_lon, n_lat, rng, bump)
        albedo = _noise_texture(rng, 512, base, amp)
        # tangent-space normals near +z, perturbed: encoded 0..255
        normal = _noise_texture(rng, 512, (128, 128, 235), 40.0)
        mat = b.add_pbr_material(
            albedo_tex=b.add_image_texture(albedo),
            normal_tex=b.add_image_texture(normal),
            base_color=(1.0, 1.0, 1.0, 1.0), metallic=0.0, roughness=0.0,
        )
        b.add_mesh(pos, uv, idx, mat)
    _add_ground_and_lights(b)
    _add_iron_and_metal(b, data_dir="")
    scene = b.build()
    cfg = RenderConfig(
        width=int(height * 16 / 9),
        height=height,
        samples_per_pixel=spp,
        max_bounce=4,
        camera=_flagship_camera(),
    )
    return scene, cfg


def terrain_heightfield(tris: int = 300_000, height: int = 720,
                        spp: int = 16):
    """A large mesh: a tessellated terrain heightfield of about ``tris``
    triangles seen from above, under the flagship's furniture lights.
    Coherent camera rays onto one big surface — the workload a large mesh
    really sees, unlike a triangle soup that defeats any culling."""
    n = int(np.sqrt(tris / 2.0))              # n x n quads -> 2 n^2 tris
    xs = np.linspace(-30, 30, n + 1)
    X, Z = np.meshgrid(xs, xs, indexing="ij")
    Y = 2.0 * np.sin(X * 0.4) * np.cos(Z * 0.3) + 0.5 * np.sin(X * 1.7)
    verts = np.stack([X, Y, Z], axis=-1).reshape(-1, 3)
    ii, jj = np.meshgrid(np.arange(n), np.arange(n), indexing="ij")
    a = (ii * (n + 1) + jj).ravel()
    c = a + (n + 1)
    idx = np.concatenate(
        [np.stack([a, a + 1, c], 1), np.stack([a + 1, c + 1, c], 1)]
    )
    b = SceneBuilder()
    b.add_mesh(verts, None, idx,
               b.add_pbr_material(base_color=(0.5, 0.5, 0.5, 1.0)))
    light = b.add_light_material(color=(250.2, 220.9, 110.2))
    b.add_sphere((-7.0, 14.0, 6.0), 1.0, light)
    scene = b.build()
    cfg = RenderConfig(
        width=int(height * 16 / 9),
        height=height,
        samples_per_pixel=spp,
        max_bounce=4,
        camera=CameraConfig(eye=(0.0, 18.0, 42.0), look_at=(0.0, 0.0, 0.0),
                            vfov_degrees=50.0, aperture=0.0,
                            focus_dist=40.0),
    )
    return scene, cfg


PRESETS = {
    "shirley": shirley_spheres,
    "shirley_parity": shirley_parity,
    "cube": cube,
    "rustediron": rustediron_globe,
    "masterchief": masterchief,
    "masterchief_glb": masterchief_glb,
    "square": square,
    "scene": scene_gltf,
    "standin": flagship_standin,
}
