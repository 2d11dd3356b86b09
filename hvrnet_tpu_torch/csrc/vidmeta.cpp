// vidmeta — the annotation scanner of the VID data layer: one VOC/VID XML
// read with a linear tag scan instead of a DOM parse (the port's counterpart
// of the JAX package's native/vidmeta.cpp, with the same scan and results).
//
// The class table is a handle made once per table and passed to each call,
// so that datasets with different tables can scan from several threads at
// once; a handle is read-only after it is made.
//
// C interface (ctypes):
//   vidmeta_classes_new(names) -> handle; names '\n'-separated, in label
//       order (labels 1, 2, ...; empty names skipped)
//   vidmeta_classes_free(handle)
//   vidmeta_parse_xml(handle, path, out, max_n, wh) -> objects kept, or -1
//       when the file cannot be read; out: up to max_n rows of
//       (xmin, ymin, xmax, ymax, label) int32, the XML's integers as they
//       are; wh: {width, height} of <size> (0 where absent)
//   vidmeta_count_objects(path, wh) -> <object> count, or -1

#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <string>
#include <unordered_map>

namespace {

using ClassTable = std::unordered_map<std::string, int>;

bool read_file(const char* path, std::string& out) {
  FILE* f = std::fopen(path, "rb");
  if (!f) return false;
  std::fseek(f, 0, SEEK_END);
  long n = std::ftell(f);
  std::fseek(f, 0, SEEK_SET);
  if (n < 0) {
    std::fclose(f);
    return false;
  }
  out.resize(static_cast<size_t>(n));
  size_t got = std::fread(&out[0], 1, static_cast<size_t>(n), f);
  std::fclose(f);
  out.resize(got);
  return true;
}

// The integer inside the first <tag>...</tag> at or after pos; advances pos
// past the close tag.
bool find_int(const std::string& s, size_t& pos, const char* open,
              const char* close, long& value) {
  size_t a = s.find(open, pos);
  if (a == std::string::npos) return false;
  a += std::strlen(open);
  size_t b = s.find(close, a);
  if (b == std::string::npos) return false;
  value = std::strtol(s.c_str() + a, nullptr, 10);
  pos = b + std::strlen(close);
  return true;
}

// The text inside the first <tag>...</tag> at or after pos, whitespace
// trimmed.
bool find_text(const std::string& s, size_t& pos, const char* open,
               const char* close, std::string& value) {
  size_t a = s.find(open, pos);
  if (a == std::string::npos) return false;
  a += std::strlen(open);
  size_t b = s.find(close, a);
  if (b == std::string::npos) return false;
  value.assign(s, a, b - a);
  size_t i = value.find_first_not_of(" \t\r\n");
  size_t j = value.find_last_not_of(" \t\r\n");
  if (i == std::string::npos) value.clear();
  else value = value.substr(i, j - i + 1);
  pos = b + std::strlen(close);
  return true;
}

void read_size(const std::string& s, int* wh) {
  long w = 0, h = 0;
  size_t at = s.find("<size>");
  if (at != std::string::npos) {
    size_t p = at;
    find_int(s, p, "<width>", "</width>", w);
    p = at;
    find_int(s, p, "<height>", "</height>", h);
  }
  wh[0] = static_cast<int>(w);
  wh[1] = static_cast<int>(h);
}

}  // namespace

extern "C" {

void* vidmeta_classes_new(const char* names) {
  auto* table = new ClassTable();
  std::string all(names);
  size_t start = 0;
  int idx = 1;
  while (start < all.size()) {
    size_t end = all.find('\n', start);
    if (end == std::string::npos) end = all.size();
    std::string name = all.substr(start, end - start);
    if (!name.empty()) (*table)[name] = idx++;
    start = end + 1;
  }
  return table;
}

void vidmeta_classes_free(void* table) {
  delete static_cast<ClassTable*>(table);
}

int vidmeta_parse_xml(const void* handle, const char* path, int* out,
                      int max_n, int* wh) {
  const ClassTable& table = *static_cast<const ClassTable*>(handle);
  std::string s;
  if (!read_file(path, s)) return -1;
  read_size(s, wh);
  int n = 0;
  size_t pos = 0;
  while (n < max_n) {
    size_t obj = s.find("<object>", pos);
    if (obj == std::string::npos) break;
    size_t obj_end = s.find("</object>", obj);
    if (obj_end == std::string::npos) break;
    size_t p = obj;
    std::string name;
    long x1 = 0, y1 = 0, x2 = 0, y2 = 0;
    bool ok = find_text(s, p, "<name>", "</name>", name);
    size_t q = obj;
    ok = ok && find_int(s, q, "<xmin>", "</xmin>", x1);
    q = obj;
    ok = ok && find_int(s, q, "<ymin>", "</ymin>", y1);
    q = obj;
    ok = ok && find_int(s, q, "<xmax>", "</xmax>", x2);
    q = obj;
    ok = ok && find_int(s, q, "<ymax>", "</ymax>", y2);
    if (ok) {
      auto it = table.find(name);
      if (it != table.end()) {
        out[n * 5 + 0] = static_cast<int>(x1);
        out[n * 5 + 1] = static_cast<int>(y1);
        out[n * 5 + 2] = static_cast<int>(x2);
        out[n * 5 + 3] = static_cast<int>(y2);
        out[n * 5 + 4] = it->second;
        ++n;
      }
    }
    pos = obj_end + 9;
  }
  return n;
}

int vidmeta_count_objects(const char* path, int* wh) {
  std::string s;
  if (!read_file(path, s)) return -1;
  read_size(s, wh);
  int n = 0;
  size_t pos = 0;
  while ((pos = s.find("<object>", pos)) != std::string::npos) {
    ++n;
    pos += 8;
  }
  return n;
}

}  // extern "C"
