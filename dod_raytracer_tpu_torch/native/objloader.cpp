// Native OBJ parser.
//
// C++ fast path for the host-side mesh load (functional equivalent of the
// reference's assimp import, src/shapes/mesh.cpp:11-14, restricted to the
// OBJ features the renderer consumes): v / vn records, f records with
// i, i/t, i//n, i/t/n and negative (relative) indices, polygon fan
// triangulation (aiProcess_Triangulate).  Same contract as the Python
// fallback mesh.load_obj.

#include <cctype>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <vector>

namespace {

struct ObjData {
  std::vector<float> verts;          // 3 per vertex
  std::vector<float> normals;        // 3 per normal
  std::vector<int32_t> faces;        // 3 vertex indices per triangle
  std::vector<int32_t> face_norms;   // 3 normal indices per triangle (or empty)
  bool all_faces_have_normals = true;
};

inline const char* skip_ws(const char* p) {
  while (*p == ' ' || *p == '\t') ++p;
  return p;
}

bool parse(const char* path, ObjData* out) {
  FILE* f = std::fopen(path, "rb");
  if (!f) return false;
  char line[8192];
  std::vector<int64_t> vi, ni;
  while (std::fgets(line, sizeof(line), f)) {
    const char* p = line;
    if (p[0] == 'v' && (p[1] == ' ' || p[1] == '\t')) {
      char* end;
      p += 2;
      for (int k = 0; k < 3; ++k) {
        out->verts.push_back(std::strtof(p, &end));
        p = end;
      }
    } else if (p[0] == 'v' && p[1] == 'n' && (p[2] == ' ' || p[2] == '\t')) {
      char* end;
      p += 3;
      for (int k = 0; k < 3; ++k) {
        out->normals.push_back(std::strtof(p, &end));
        p = end;
      }
    } else if (p[0] == 'f' && (p[1] == ' ' || p[1] == '\t')) {
      p += 2;
      vi.clear();
      ni.clear();
      const int64_t nv = static_cast<int64_t>(out->verts.size() / 3);
      const int64_t nn = static_cast<int64_t>(out->normals.size() / 3);
      while (true) {
        p = skip_ws(p);
        if (*p == '\0' || *p == '\n' || *p == '\r' || *p == '#') break;
        char* end;
        long v = std::strtol(p, &end, 10);
        if (end == p) break;
        p = end;
        vi.push_back(v > 0 ? v - 1 : nv + v);
        long n = 0;
        bool has_n = false;
        if (*p == '/') {
          ++p;  // texcoord (may be empty)
          if (*p != '/') {
            std::strtol(p, &end, 10);
            p = end;
          }
          if (*p == '/') {
            ++p;
            n = std::strtol(p, &end, 10);
            if (end != p) {
              has_n = true;
              p = end;
            }
          }
        }
        ni.push_back(has_n ? (n > 0 ? n - 1 : nn + n) : -1);
      }
      for (size_t k = 1; k + 1 < vi.size(); ++k) {  // fan triangulation
        out->faces.push_back(static_cast<int32_t>(vi[0]));
        out->faces.push_back(static_cast<int32_t>(vi[k]));
        out->faces.push_back(static_cast<int32_t>(vi[k + 1]));
        if (ni[0] < 0 || ni[k] < 0 || ni[k + 1] < 0) {
          out->all_faces_have_normals = false;
        } else {
          out->face_norms.push_back(static_cast<int32_t>(ni[0]));
          out->face_norms.push_back(static_cast<int32_t>(ni[k]));
          out->face_norms.push_back(static_cast<int32_t>(ni[k + 1]));
        }
      }
    }
  }
  std::fclose(f);
  return true;
}

}  // namespace

extern "C" {

void* obj_load(const char* path) {
  auto* d = new ObjData();
  if (!parse(path, d)) {
    delete d;
    return nullptr;
  }
  return d;
}

int64_t obj_num_verts(void* h) { return static_cast<ObjData*>(h)->verts.size() / 3; }
int64_t obj_num_faces(void* h) { return static_cast<ObjData*>(h)->faces.size() / 3; }
int64_t obj_has_normals(void* h) {
  auto* d = static_cast<ObjData*>(h);
  return (!d->normals.empty() && d->all_faces_have_normals &&
          d->face_norms.size() == d->faces.size())
             ? 1
             : 0;
}

void obj_copy(void* h, float* verts, int32_t* faces, float* face_normals) {
  auto* d = static_cast<ObjData*>(h);
  std::memcpy(verts, d->verts.data(), d->verts.size() * sizeof(float));
  std::memcpy(faces, d->faces.data(), d->faces.size() * sizeof(int32_t));
  if (obj_has_normals(h)) {
    // expand per-corner normal indices into (F, 3, 3) floats
    const size_t nf = d->faces.size() / 3;
    for (size_t i = 0; i < nf; ++i) {
      for (int c = 0; c < 3; ++c) {
        const int32_t nidx = d->face_norms[i * 3 + c];
        for (int k = 0; k < 3; ++k) {
          face_normals[(i * 3 + c) * 3 + k] = d->normals[nidx * 3 + k];
        }
      }
    }
  }
}

void obj_free(void* h) { delete static_cast<ObjData*>(h); }

}  // extern "C"
