// Native scene-file parser — the C++ host runtime component mirroring
// the reference's Scene loader (src/scene.cpp): the same line-oriented
// MATERIAL/OBJECT/CAMERA grammar, sequential-ID validation, and CR/LF
// tolerant line handling (utilityCore::safeGetline), parsed into flat
// struct-of-arrays buffers ready to wrap as numpy arrays over ctypes.
//
// The Python parser (pathtrace_tpu_torch/scene/parser.py) is the reference
// semantic; tests assert this parser produces identical arrays.  This
// one exists for the framework's native-runtime layer (large scene
// files and OBJ payloads parse at C++ speed, no Python tokenization).

#include <cmath>
#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <string>
#include <vector>

#include "text.h"

namespace {

struct Material {
  float color[3] = {0, 0, 0};
  float spec_exponent = 0;
  float spec_color[3] = {0, 0, 0};
  float has_reflective = 0;
  float has_refractive = 0;
  float ior = 0;
  float emittance = 0;
  float checker_scale = 0;        // CHECKER extension (0 = off)
  float checker_color[3] = {0, 0, 0};
  float bump_scale = 0;           // BUMP extension (0 = off)
  float bump_strength = 0;
  float sss_sigma = 0;            // SSS extension (0 = off)
  float sss_albedo[3] = {0, 0, 0};
};

struct Geom {
  int32_t type = 0;  // 0 sphere, 1 cube, 2 mesh
  int32_t material_id = 0;
  float translation[3] = {0, 0, 0};
  float rotation[3] = {0, 0, 0};
  float scale[3] = {1, 1, 1};
  float velocity[3] = {0, 0, 0};  // MOTION extension (motion blur)
  std::string mesh_path;
};

struct Camera {
  int32_t resolution[2] = {800, 800};
  float fovy = 45.0f;
  int32_t iterations = 10;
  int32_t depth = 8;
  std::string file = "render";
  float eye[3] = {0, 0, 0};
  float view[3] = {0, 0, -1};
  float up[3] = {0, 1, 0};
  float aperture = 0.0f;
  float focal = 1.0f;
};

struct ParsedScene {
  std::vector<Material> materials;
  std::vector<Geom> geoms;
  Camera camera;
  bool has_camera = false;
  std::string error;
};

using pt_text::tokenize;

// CR/LF/CRLF-safe line splitter (the role of safeGetline,
// src/utilities.cpp:82-112)
std::vector<std::string> split_lines(const std::string& text) {
  std::vector<std::string> lines;
  std::string cur;
  for (size_t i = 0; i < text.size(); ++i) {
    char c = text[i];
    if (c == '\n') {
      lines.push_back(cur);
      cur.clear();
    } else if (c == '\r') {
      if (i + 1 < text.size() && text[i + 1] == '\n') ++i;
      lines.push_back(cur);
      cur.clear();
    } else {
      cur += c;
    }
  }
  lines.push_back(cur);
  return lines;
}

float tof(const std::string& s) { return std::strtof(s.c_str(), nullptr); }
int toi(const std::string& s) { return std::atoi(s.c_str()); }

ParsedScene* parse_text(const std::string& text) {
  auto* sc = new ParsedScene();
  auto lines = split_lines(text);
  size_t pos = 0;
  auto next_line = [&](std::string* out) -> bool {
    if (pos >= lines.size()) return false;
    *out = lines[pos++];
    return true;
  };

  std::string line;
  while (next_line(&line)) {
    auto toks = tokenize(line);
    if (toks.empty()) continue;
    if (toks[0] == "MATERIAL") {
      int id = toi(toks[1]);
      if (id != (int)sc->materials.size()) {
        sc->error = "MATERIAL ID " + toks[1] + " does not match expected " +
                    std::to_string(sc->materials.size());
        return sc;
      }
      Material m;
      for (int i = 0; i < 7; ++i) {  // exactly 7 lines (src/scene.cpp:157)
        if (!next_line(&line)) break;
        auto t = tokenize(line);
        if (t.empty()) continue;
        if (t[0] == "RGB") {
          m.color[0] = tof(t[1]); m.color[1] = tof(t[2]);
          m.color[2] = tof(t[3]);
        } else if (t[0] == "SPECEX") {
          m.spec_exponent = tof(t[1]);
        } else if (t[0] == "SPECRGB") {
          m.spec_color[0] = tof(t[1]); m.spec_color[1] = tof(t[2]);
          m.spec_color[2] = tof(t[3]);
        } else if (t[0] == "REFL") {
          m.has_reflective = tof(t[1]);
        } else if (t[0] == "REFR") {
          m.has_refractive = tof(t[1]);
        } else if (t[0] == "REFRIOR") {
          m.ior = tof(t[1]);
        } else if (t[0] == "EMITTANCE") {
          m.emittance = tof(t[1]);
        }
      }
      // optional extension lines: CHECKER scale r g b | BUMP scale str
      while (pos < lines.size()) {
        auto peek = tokenize(lines[pos]);
        if (!peek.empty() && peek[0] == "CHECKER" && peek.size() >= 5) {
          ++pos;
          m.checker_scale = tof(peek[1]);
          m.checker_color[0] = tof(peek[2]);
          m.checker_color[1] = tof(peek[3]);
          m.checker_color[2] = tof(peek[4]);
        } else if (!peek.empty() && peek[0] == "BUMP" &&
                   peek.size() >= 3) {
          ++pos;
          m.bump_scale = tof(peek[1]);
          m.bump_strength = tof(peek[2]);
        } else if (!peek.empty() && peek[0] == "SSS" &&
                   peek.size() >= 5) {
          ++pos;
          m.sss_sigma = tof(peek[1]);
          m.sss_albedo[0] = tof(peek[2]);
          m.sss_albedo[1] = tof(peek[3]);
          m.sss_albedo[2] = tof(peek[4]);
        } else if (!peek.empty() &&
                   (peek[0] == "TEXTURE" || peek[0] == "BUMPTEX")) {
          // image-texture lines: consumed for block alignment only;
          // semantics live in the shared Python post-pass
          // (scene/textures.attach_textures) for both parsers
          ++pos;
        } else {
          break;
        }
      }
      sc->materials.push_back(m);
    } else if (toks[0] == "OBJECT") {
      int id = toi(toks[1]);
      if (id != (int)sc->geoms.size()) {
        sc->error = "OBJECT ID " + toks[1] + " does not match expected " +
                    std::to_string(sc->geoms.size());
        return sc;
      }
      Geom g;
      if (!next_line(&line)) break;
      auto t = tokenize(line);
      if (!t.empty() && t[0] == "sphere") {
        g.type = 0;
      } else if (!t.empty() && t[0] == "cube") {
        g.type = 1;
      } else if (!t.empty() && t[0] == "mesh") {
        g.type = 2;
        if (t.size() < 2) {
          sc->error = "mesh object requires an OBJ path";
          return sc;
        }
        g.mesh_path = t[1];
      } else {
        sc->error = "unknown object type: " + line;
        return sc;
      }
      if (!next_line(&line)) break;
      t = tokenize(line);
      if (t.size() >= 2) g.material_id = toi(t[1]);
      while (next_line(&line)) {
        t = tokenize(line);
        if (t.empty()) break;
        if (t[0] == "TRANS") {
          g.translation[0] = tof(t[1]); g.translation[1] = tof(t[2]);
          g.translation[2] = tof(t[3]);
        } else if (t[0] == "ROTAT") {
          g.rotation[0] = tof(t[1]); g.rotation[1] = tof(t[2]);
          g.rotation[2] = tof(t[3]);
        } else if (t[0] == "SCALE") {
          g.scale[0] = tof(t[1]); g.scale[1] = tof(t[2]);
          g.scale[2] = tof(t[3]);
        } else if (t[0] == "MOTION") {
          g.velocity[0] = tof(t[1]); g.velocity[1] = tof(t[2]);
          g.velocity[2] = tof(t[3]);
        }
      }
      sc->geoms.push_back(g);
    } else if (toks[0] == "CAMERA") {
      Camera cam;
      for (int i = 0; i < 5; ++i) {  // RES FOVY ITERATIONS DEPTH FILE
        if (!next_line(&line)) break;
        auto t = tokenize(line);
        if (t.empty()) continue;
        if (t[0] == "RES") {
          cam.resolution[0] = toi(t[1]);
          cam.resolution[1] = toi(t[2]);
        } else if (t[0] == "FOVY") {
          cam.fovy = tof(t[1]);
        } else if (t[0] == "ITERATIONS") {
          cam.iterations = toi(t[1]);
        } else if (t[0] == "DEPTH") {
          cam.depth = toi(t[1]);
        } else if (t[0] == "FILE") {
          cam.file = t[1];
        }
      }
      while (next_line(&line)) {
        auto t = tokenize(line);
        if (t.empty()) break;
        if (t[0] == "EYE") {
          cam.eye[0] = tof(t[1]); cam.eye[1] = tof(t[2]);
          cam.eye[2] = tof(t[3]);
        } else if (t[0] == "VIEW") {
          cam.view[0] = tof(t[1]); cam.view[1] = tof(t[2]);
          cam.view[2] = tof(t[3]);
        } else if (t[0] == "UP") {
          cam.up[0] = tof(t[1]); cam.up[1] = tof(t[2]);
          cam.up[2] = tof(t[3]);
        } else if (t[0] == "APERTURE") {
          cam.aperture = tof(t[1]);
        } else if (t[0] == "FOCAL") {
          cam.focal = tof(t[1]);
        }
      }
      sc->camera = cam;
      sc->has_camera = true;
    }
  }

  if (!sc->has_camera) sc->error = "scene file has no CAMERA block";
  else if (sc->materials.empty()) sc->error = "scene file has no materials";
  else if (sc->geoms.empty()) sc->error = "scene file has no objects";
  else {
    for (auto& g : sc->geoms) {
      if (g.material_id < 0 || g.material_id >= (int)sc->materials.size()) {
        sc->error = "object references material " +
                    std::to_string(g.material_id) + " but only " +
                    std::to_string(sc->materials.size()) +
                    " materials are defined";
        break;
      }
    }
  }
  return sc;
}

}  // namespace

extern "C" {

void* pt_parse_scene_file(const char* path) {
  std::string text;
  if (!pt_text::read_file(path, &text)) {
    auto* sc = new ParsedScene();
    sc->error = std::string("cannot open scene file: ") + path;
    return sc;
  }
  return parse_text(text);
}

void* pt_parse_scene_text(const char* text) {
  return parse_text(std::string(text));
}

const char* pt_scene_error(void* h) {
  auto* sc = static_cast<ParsedScene*>(h);
  return sc->error.empty() ? nullptr : sc->error.c_str();
}

void pt_scene_counts(void* h, int32_t* n_materials, int32_t* n_geoms) {
  auto* sc = static_cast<ParsedScene*>(h);
  *n_materials = (int32_t)sc->materials.size();
  *n_geoms = (int32_t)sc->geoms.size();
}

// Fill caller-allocated flat buffers.
// materials: color (M,3), spec_exponent (M), spec_color (M,3),
//            has_reflective (M), has_refractive (M), ior (M),
//            emittance (M)
void pt_scene_fill_materials(void* h, float* color, float* spec_exponent,
                             float* spec_color, float* has_reflective,
                             float* has_refractive, float* ior,
                             float* emittance, float* checker_scale,
                             float* checker_color, float* bump_scale,
                             float* bump_strength, float* sss_sigma,
                             float* sss_albedo) {
  auto* sc = static_cast<ParsedScene*>(h);
  for (size_t i = 0; i < sc->materials.size(); ++i) {
    const Material& m = sc->materials[i];
    std::memcpy(color + 3 * i, m.color, 3 * sizeof(float));
    spec_exponent[i] = m.spec_exponent;
    std::memcpy(spec_color + 3 * i, m.spec_color, 3 * sizeof(float));
    has_reflective[i] = m.has_reflective;
    has_refractive[i] = m.has_refractive;
    ior[i] = m.ior;
    emittance[i] = m.emittance;
    checker_scale[i] = m.checker_scale;
    std::memcpy(checker_color + 3 * i, m.checker_color,
                3 * sizeof(float));
    bump_scale[i] = m.bump_scale;
    bump_strength[i] = m.bump_strength;
    sss_sigma[i] = m.sss_sigma;
    std::memcpy(sss_albedo + 3 * i, m.sss_albedo, 3 * sizeof(float));
  }
}

void pt_scene_fill_geoms(void* h, int32_t* type, int32_t* material_id,
                         float* translation, float* rotation, float* scale,
                         float* velocity) {
  auto* sc = static_cast<ParsedScene*>(h);
  for (size_t i = 0; i < sc->geoms.size(); ++i) {
    const Geom& g = sc->geoms[i];
    type[i] = g.type;
    material_id[i] = g.material_id;
    std::memcpy(translation + 3 * i, g.translation, 3 * sizeof(float));
    std::memcpy(rotation + 3 * i, g.rotation, 3 * sizeof(float));
    std::memcpy(scale + 3 * i, g.scale, 3 * sizeof(float));
    std::memcpy(velocity + 3 * i, g.velocity, 3 * sizeof(float));
  }
}

const char* pt_scene_mesh_path(void* h, int32_t geom_idx) {
  auto* sc = static_cast<ParsedScene*>(h);
  if (geom_idx < 0 || geom_idx >= (int32_t)sc->geoms.size()) return nullptr;
  const std::string& p = sc->geoms[geom_idx].mesh_path;
  return p.empty() ? nullptr : p.c_str();
}

// camera scalars: resolution (2,i32), fovy, iterations, depth,
// eye (3), view (3), up (3), aperture, focal; file name via getter
void pt_scene_fill_camera(void* h, int32_t* resolution, float* fovy,
                          int32_t* iterations, int32_t* depth, float* eye,
                          float* view, float* up, float* aperture,
                          float* focal) {
  auto* sc = static_cast<ParsedScene*>(h);
  const Camera& c = sc->camera;
  resolution[0] = c.resolution[0];
  resolution[1] = c.resolution[1];
  *fovy = c.fovy;
  *iterations = c.iterations;
  *depth = c.depth;
  std::memcpy(eye, c.eye, 3 * sizeof(float));
  std::memcpy(view, c.view, 3 * sizeof(float));
  std::memcpy(up, c.up, 3 * sizeof(float));
  *aperture = c.aperture;
  *focal = c.focal;
}

const char* pt_scene_image_name(void* h) {
  return static_cast<ParsedScene*>(h)->camera.file.c_str();
}

void pt_scene_free(void* h) { delete static_cast<ParsedScene*>(h); }

}  // extern "C"
