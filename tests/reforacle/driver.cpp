// Parity-test oracle driver: compiles the REFERENCE HEADERS UNMODIFIED
// (straight out of the read-only /root/reference checkout via -I) against
// the from-scratch shims in shims/ (mini-Eigen, cgltf, stb via libpng), and
// re-states the reference's driver logic (main.cpp:33-52 rayColor,
// main.cpp:54-154 randomScene active branch, main.cpp:156-242 sample loop)
// with image size / spp / bounces taken from argv instead of compile-time
// constants.
//
// Purpose: ground-truth renders of the reference's ACTUAL single-thread C++
// semantics for statistical comparison against the JAX framework — the
// checked-in golden images predate asset changes (the rustediron2-2x1
// textures referenced at main.cpp:133-136 do not exist in data/), so only a
// fresh run of the reference code itself is a valid comparison target.
//
// Build/run: see build.sh / tests/test_reference_parity.py.

#include <cstdlib>
#include <iostream>
#include <memory>
#include <new>
#include <ostream>

// Resolve the reference's uninitialized-member UB (pbrMetallicRoughness
// ctors 1-4 never set metalness/roughness, material.h:25-42; VALIDATION.md
// §3) the way the golden-era builds evidently did: zero-initialized heap
// pages. Overriding global operator new keeps the reference headers
// untouched while making every render of this binary well-defined and
// golden-consistent (metalness=0, roughness=0) — required for the
// per-pixel statistical parity test (tests/test_golden_statistical.py).
void* operator new(std::size_t n) {
  void* p = std::calloc(1, n ? n : 1);
  if (!p) throw std::bad_alloc();
  return p;
}
void* operator new[](std::size_t n) {
  void* p = std::calloc(1, n ? n : 1);
  if (!p) throw std::bad_alloc();
  return p;
}
void operator delete(void* p) noexcept { std::free(p); }
void operator delete[](void* p) noexcept { std::free(p); }
void operator delete(void* p, std::size_t) noexcept { std::free(p); }
void operator delete[](void* p, std::size_t) noexcept { std::free(p); }

#include "Eigen/Core"
#include "Eigen/Geometry"

#include "stb_image.h"
#include "stb_image_write.h"

// reference headers, included from /root/reference (never copied)
#include "globals.h"
#include "color.h"
#include "hittablelist.h"
#include "sphere.h"
#include "camera.h"
#include "material.h"
#include "bvh.h"
#include "model.h"

using namespace Eigen;
using std::uint8_t;

// main.cpp:33-52, restated
static color3f rayColor(const ray& r, const color3f& background,
                        const hittable& world, int maxBounce) {
  hitRecord record;
  if (maxBounce <= 0) return color3f(0, 0, 0);
  if (!world.hit(r, 0.001f, infinity, record)) return background;

  ray scattered;
  color3f attenuation;
  color3f emitted =
      record.matPtr->emitted(record.uv(0), record.uv(1), record.p);
  if (!record.matPtr->scatter(r, record, attenuation, scattered))
    return emitted;

  color3f next = rayColor(scattered, background, world, maxBounce - 1);
  return emitted + color3f(next(0) * attenuation(0), next(1) * attenuation(1),
                           next(2) * attenuation(2));
}

// main.cpp:54-154 active branch (masterchief2-separate-xf + ground checker +
// HDR light + rustediron sphere [textures missing -> magenta sentinel] +
// mirror metal sphere, all under one bvhNode)
static hittableList buildScene(const char* gltf_path) {
  hittableList objects;
  hittableList scene;

  auto testModel = model::create(gltf_path);
  testModel->init();
  for (const auto& m : testModel->meshes)
    for (const auto& tri : m->triangles) objects.add(tri);

  auto checkerTex = make_shared<checker>(color3f(0.2f, 0.3f, 0.1f),
                                         color3f(0.9f, 0.9f, 0.9f));
  objects.add(make_shared<sphere>(vec3f(0, -1000, 0.0f), vec3f(0, -1000, 0.0f),
                                  0, 1.0f, 1000,
                                  make_shared<pbrMetallicRoughness>(checkerTex)));

  auto lightMat =
      make_shared<diffuseLight>(color3f(250.2f, 220.9f, 110.2f));
  objects.add(make_shared<sphere>(vec3f(-7.0f, 4.0f, 6.0f),
                                  vec3f(-7.0f, 4.0f, 6.0f), 0, 1.0f, 1.0f,
                                  lightMat));

  auto ironAlbedo =
      make_shared<imagePNG>("../data/rustediron2_basecolor-2x1.png", 3);
  auto ironNMap =
      make_shared<imagePNG>("../data/rustediron2_normal-2x1.png", 3);
  auto ironMMap =
      make_shared<imagePNG>("../data/rustediron2_metallic-2x1.png", 1);
  auto ironRMap =
      make_shared<imagePNG>("../data/rustediron2_roughness-2x1.png", 1);
  auto ironMat = make_shared<pbrMetallicRoughness>(
      ironAlbedo, ironNMap, ironMMap, ironRMap,
      vec4f(1.0f, 1.0f, 1.0f, 1.0f));
  objects.add(make_shared<sphere>(vec3f(-3.0f, 1.0f, 0.0f),
                                  vec3f(-3.0f, 1.0f, 0.0f), 0, 1.0f, 1.0f,
                                  ironMat));

  auto material3 = make_shared<metal>(color3f(0.7, 0.6, 0.5), 0.0);
  objects.add(make_shared<sphere>(vec3f(3.0f, 1.0f, 0), vec3f(3.0f, 1.0f, 0),
                                  0, 1.0f, 1.0f, material3));

  scene.add(make_shared<bvhNode>(objects, 0, 1));
  return scene;
}

// Deterministic cross-language PRNG for the Shirley sphere field: the
// reference's commented random-sphere branch (main.cpp:92-122) draws from
// the global mt19937, whose libstdc++ float mapping is not reproducible
// bit-for-bit from Python — and scene GEOMETRY is just data. Both this
// driver and sexy_raytracer_jax/models/presets.shirley_parity() therefore
// draw the field from this 64-bit LCG (top 24 bits / 2^24: exact in f32,
// bit-identical in both languages), so the two renderers build the SAME
// scene and the statistical parity test compares like for like.
static std::uint64_t lcgState;
static float lcgFloat() {
  lcgState = lcgState * 6364136223846793005ULL + 1442695040888963407ULL;
  return float(std::uint32_t(lcgState >> 40)) / 16777216.0f;
}

// main.cpp:92-122 (the commented Shirley branch) restated with sequenced
// LCG draws (C++ function-argument evaluation order is unspecified, so
// every draw lands in a named local first). This is the scene that puts
// dielectric glass (material.h:104-137), fuzzy metal (material.h:87-102),
// MOVING spheres (sphere.h:47-52 motion blur) and thin-lens DoF under
// reference-binary verification — none of which the masterchief scene
// exercises (dielectric commented at main.cpp:124; flagship metal fuzz 0).
static hittableList buildShirley(std::uint64_t seed) {
  lcgState = seed;
  hittableList objects;
  hittableList scene;

  auto checkerTex = make_shared<checker>(color3f(0.2f, 0.3f, 0.1f),
                                         color3f(0.9f, 0.9f, 0.9f));
  objects.add(make_shared<sphere>(vec3f(0, -1000, 0.0f), vec3f(0, -1000, 0.0f),
                                  0, 1.0f, 1000,
                                  make_shared<pbrMetallicRoughness>(checkerTex)));

  for (int a = -11; a < 11; ++a) {
    for (int b = -11; b < 11; ++b) {
      float chooseMat = lcgFloat();
      float cx = a + 0.9f * lcgFloat();
      float cz = b + 0.9f * lcgFloat();
      vec3f center(cx, 0.2f, cz);
      if ((center - vec3f(4.0f, 0.2f, 0.0f)).norm() <= 0.9f) continue;
      if (chooseMat < 0.8f) {
        // diffuse (moving: motion blur), main.cpp:100-107
        float r1 = lcgFloat(), r2 = lcgFloat();
        float g1 = lcgFloat(), g2 = lcgFloat();
        float b1 = lcgFloat(), b2 = lcgFloat();
        auto mat = make_shared<pbrMetallicRoughness>(
            color3f(r1 * r2, g1 * g2, b1 * b2));
        float dy = lcgFloat() * 0.5f;
        vec3f center2 = center + vec3f(0, dy, 0);
        objects.add(make_shared<sphere>(center, center2, 0, 1.0f, 0.2f, mat));
      } else if (chooseMat < 0.95f) {
        // fuzzy metal, main.cpp:108-113
        float ar = 0.5f + 0.5f * lcgFloat();
        float ag = 0.5f + 0.5f * lcgFloat();
        float ab = 0.5f + 0.5f * lcgFloat();
        float fuzz = 0.5f * lcgFloat();
        auto mat = make_shared<metal>(color3f(ar, ag, ab), fuzz);
        objects.add(make_shared<sphere>(center, center, 0, 1.0f, 0.2f, mat));
      } else {
        // glass, main.cpp:114-117
        auto mat = make_shared<dielectric>(1.5f);
        objects.add(make_shared<sphere>(center, center, 0, 1.0f, 0.2f, mat));
      }
    }
  }
  // the three hero spheres (main.cpp:125-144 commented variants + active
  // material3): glass, diffuse, mirror metal
  objects.add(make_shared<sphere>(vec3f(0, 1, 0), vec3f(0, 1, 0), 0, 1.0f,
                                  1.0f, make_shared<dielectric>(1.5f)));
  objects.add(make_shared<sphere>(
      vec3f(-4, 1, 0), vec3f(-4, 1, 0), 0, 1.0f, 1.0f,
      make_shared<pbrMetallicRoughness>(color3f(0.4f, 0.2f, 0.1f))));
  objects.add(make_shared<sphere>(
      vec3f(3, 1, 0), vec3f(3, 1, 0), 0, 1.0f, 1.0f,
      make_shared<metal>(color3f(0.7f, 0.6f, 0.5f), 0.0f)));

  scene.add(make_shared<bvhNode>(objects, 0, 1));
  return scene;
}

int main(int argc, char** argv) {
  // argv: width height spp maxBounce out.png [gltf|"shirley"] [seed]
  const int imageWidth = argc > 1 ? std::atoi(argv[1]) : 426;
  const int imageHeight = argc > 2 ? std::atoi(argv[2]) : 240;
  const int numSamples = argc > 3 ? std::atoi(argv[3]) : 100;
  const int maxBounce = argc > 4 ? std::atoi(argv[4]) : 4;
  const char* outPath = argc > 5 ? argv[5] : "oracle.png";
  const char* gltfPath =
      argc > 6 ? argv[6] : "../data/masterchief2-separate-xf.gltf";
  const bool shirley = std::string(gltfPath) == "shirley";
  const std::uint64_t seed = argc > 7 ? std::strtoull(argv[7], nullptr, 10) : 42;

  // main.cpp:163-172 camera (Shirley scene: the book's classic framing,
  // matching presets.shirley_parity)
  vec3f eye = shirley ? vec3f(13.0f, 2.0f, 3.0f) : vec3f(0.0f, 3.0f, 5.0f);
  vec3f lookAt = shirley ? vec3f(0, 0, 0) : vec3f(0, 2.5f, 0);
  vec3f vUp(0, 1.0f, 0);
  float vFOV = shirley ? 20.0f : 70.0f;
  float distToFocus = 10.0f;
  float aperture = 0.1f;
  color3f background(0.53f, 0.81f, 0.92f);
  float aspect = float(imageWidth) / float(imageHeight);
  camera mainCamera(eye, lookAt, vUp, vFOV, aspect, aperture, distToFocus, 0,
                    1.0f);

  uint8_t* target = static_cast<uint8_t*>(
      std::malloc(sizeof(uint8_t) * 4 * imageWidth * imageHeight));

  hittableList world = shirley ? buildShirley(seed) : buildScene(gltfPath);

  // main.cpp:200-227 pixel/sample loops
  for (int y = 0; y < imageHeight; ++y) {
    std::cerr << "\rScanlines remaining: " << (imageHeight - y) << ' '
              << std::flush;
    for (int x = 0; x < imageWidth; ++x) {
      color3f pixelColor(0, 0, 0);
      for (int s = 0; s < numSamples; ++s) {
        auto u = float(x + randomFloat()) / (imageWidth - 1);
        auto v = float((imageHeight - y) + randomFloat()) / (imageHeight - 1);
        ray r = mainCamera.getRay(u, v);
        pixelColor += rayColor(r, background, world, maxBounce);
      }
      writeColorTarget(target, x, y, imageWidth, imageHeight, 4, pixelColor,
                       numSamples);
    }
  }

  stbi_write_png(outPath, imageWidth, imageHeight, 4, target, 4 * imageWidth);
  std::free(target);
  std::cerr << "\nDone.\n";
  return 0;
}
