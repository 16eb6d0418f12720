// Native Wavefront OBJ loader — the data-loader role (reference
// README.md:113-117 allows third-party OBJ code in C++; this is ours).
// Handles v positions and f faces (fan triangulation, negative and
// v/vt/vn indices).  Output is a flat (T, 3, 3) float buffer matching
// pathtrace_tpu_torch.scene.obj.load_obj exactly (tests assert equality).

#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <string>
#include <vector>

#include "text.h"

namespace {

struct ObjData {
  std::vector<float> tris;  // T*9 floats
  std::string error;
};

}  // namespace

extern "C" {

void* pt_load_obj(const char* path) {
  auto* out = new ObjData();
  std::string text;
  if (!pt_text::read_file(path, &text)) {
    out->error = std::string("cannot open OBJ file: ") + path;
    return out;
  }
  std::vector<float> verts;  // 3 per vertex
  size_t pos = 0;
  while (pos < text.size()) {
    size_t end = text.find('\n', pos);
    if (end == std::string::npos) end = text.size();
    std::string line = text.substr(pos, end - pos);
    pos = end + 1;
    if (!line.empty() && line.back() == '\r') line.pop_back();
    if (line.empty() || line[0] == '#') continue;
    auto toks = pt_text::tokenize(line);
    if (toks.empty()) continue;
    if (toks[0] == "v") {
      // three numbers, or the line is skipped
      float xyz[3];
      bool ok = toks.size() >= 4;
      for (int k = 0; ok && k < 3; ++k) {
        const char* s = toks[k + 1].c_str();
        char* stop;
        xyz[k] = std::strtof(s, &stop);
        ok = stop != s;
      }
      if (ok) verts.insert(verts.end(), xyz, xyz + 3);
    } else if (toks[0] == "f") {
      std::vector<int64_t> idx;
      int64_t n_verts = (int64_t)verts.size() / 3;
      for (size_t k = 1; k < toks.size(); ++k) {
        // index before the first '/'
        int64_t i = std::strtoll(toks[k].c_str(), nullptr, 10);
        idx.push_back(i > 0 ? i - 1 : n_verts + i);
      }
      for (size_t k = 1; k + 1 < idx.size(); ++k) {  // fan
        const int64_t tri[3] = {idx[0], idx[k], idx[k + 1]};
        for (int v = 0; v < 3; ++v) {
          int64_t vi = tri[v];
          if (vi < 0 || vi >= n_verts) {
            out->error = "OBJ face index out of range";
            return out;
          }
          out->tris.push_back(verts[3 * vi + 0]);
          out->tris.push_back(verts[3 * vi + 1]);
          out->tris.push_back(verts[3 * vi + 2]);
        }
      }
    }
  }
  return out;
}

const char* pt_obj_error(void* h) {
  auto* o = static_cast<ObjData*>(h);
  return o->error.empty() ? nullptr : o->error.c_str();
}

int64_t pt_obj_tri_count(void* h) {
  return (int64_t)static_cast<ObjData*>(h)->tris.size() / 9;
}

void pt_obj_fill(void* h, float* out) {
  auto* o = static_cast<ObjData*>(h);
  std::memcpy(out, o->tris.data(), o->tris.size() * sizeof(float));
}

void pt_obj_free(void* h) { delete static_cast<ObjData*>(h); }

}  // extern "C"
