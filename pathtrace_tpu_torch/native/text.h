// Text helpers of the native parsers (scene_parser.cpp, obj_loader.cpp),
// in C stdio and plain loops.  The parsers use no C++ stream: a formatted
// stream read (`>> float`) crashed now and then in the OBJ loader inside
// processes that had run CUDA work, and these helpers touch no locale
// facet of the process's C++ runtime.
#pragma once

#include <cstdio>
#include <string>
#include <vector>

namespace pt_text {

// The separators of `>>` on a std::string in the "C" locale.
inline bool is_space(char c) {
  return c == ' ' || c == '\t' || c == '\n' || c == '\v' || c == '\f' ||
         c == '\r';
}

// The bytes of the file at `path` into `*out`; false when it cannot be
// opened or read.
inline bool read_file(const char* path, std::string* out) {
  std::FILE* f = std::fopen(path, "rb");
  if (!f) return false;
  char buf[1 << 16];
  size_t n;
  while ((n = std::fread(buf, 1, sizeof buf, f)) > 0) out->append(buf, n);
  bool ok = !std::ferror(f);
  std::fclose(f);
  return ok;
}

// The whitespace-separated tokens of `line`.
inline std::vector<std::string> tokenize(const std::string& line) {
  std::vector<std::string> out;
  size_t i = 0;
  while (i < line.size()) {
    while (i < line.size() && is_space(line[i])) ++i;
    size_t j = i;
    while (j < line.size() && !is_space(line[j])) ++j;
    if (j > i) out.emplace_back(line, i, j - i);
    i = j;
  }
  return out;
}

}  // namespace pt_text
