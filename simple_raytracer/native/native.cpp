// Native runtime components: BVH build + OBJ parse.
//
// The reference implements these in C++ on the hot host path (Object.cpp:
// 225-284 BVH; Object.cpp:25-170 via tinyobjloader for OBJ).  This module is
// their JAX-framework counterpart: same observable behavior as the Python
// fallbacks in accel/bvh.py and scene/obj_loader.py (tests assert bit-equal
// outputs), built as a plain C-ABI shared object consumed through ctypes.
//
// Build: see simple_raytracer/native/build.py (g++ -O3 -shared -fPIC).

#include <algorithm>
#include <cctype>
#include <cmath>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <vector>

extern "C" {

// ---------------------------------------------------------------------------
// BVH build (mirror of accel/bvh.py::build_bvh)
// ---------------------------------------------------------------------------
// verts: [T, 9] row-major (3 vertices x xyz).  Outputs are caller-allocated:
//   node_min/node_max: [max_nodes, 3]
//   skip, leaf_first, leaf_count: [max_nodes]
//   perm: [T]
// Returns node count M (or -1 if max_nodes too small).  stats_out[0]=max_leaf,
// stats_out[1]=depth.

struct BvhCtx {
  const float* verts;   // [T, 9]
  int leaf_size;
  float* node_min;
  float* node_max;
  int32_t* skip;
  int32_t* leaf_first;
  int32_t* leaf_count;
  int32_t* perm;
  int max_nodes;
  int n_nodes;
  int n_perm;
  int max_leaf;
  int depth;
  bool overflow;
};

static const float FLT_BIG = 3.4028235e38f;

static void tri_bounds(const float* v9, float* bmin, float* bmax) {
  for (int k = 0; k < 3; ++k) {
    float a = v9[k], b = v9[3 + k], c = v9[6 + k];
    bmin[k] = std::min(a, std::min(b, c));
    bmax[k] = std::max(a, std::max(b, c));
  }
}

static void aabb(const BvhCtx& ctx, const int64_t* idx, int n, float* bmin,
                 float* bmax) {
  // Object.cpp:205-221; empty set -> inverted (FLT_MAX, -FLT_MAX) box
  for (int k = 0; k < 3; ++k) { bmin[k] = FLT_BIG; bmax[k] = -FLT_BIG; }
  for (int i = 0; i < n; ++i) {
    float tmin[3], tmax[3];
    tri_bounds(ctx.verts + idx[i] * 9, tmin, tmax);
    for (int k = 0; k < 3; ++k) {
      bmin[k] = std::min(bmin[k], tmin[k]);
      bmax[k] = std::max(bmax[k], tmax[k]);
    }
  }
}

static int longest_axis(const float* bmin, const float* bmax) {
  // Reference tie rule (Object.cpp:240-248): x only if strictly largest,
  // else y only if strictly larger than both, else z.
  float sx = std::fabs(bmax[0] - bmin[0]);
  float sy = std::fabs(bmax[1] - bmin[1]);
  float sz = std::fabs(bmax[2] - bmin[2]);
  if (sx > sy && sx > sz) return 0;
  if (sy > sx && sy > sz) return 1;
  return 2;
}

static void emit(BvhCtx& ctx, int64_t* idx, int n, const float* bmin,
                 const float* bmax, bool force_split, int depth) {
  if (ctx.overflow) return;
  if (ctx.n_nodes >= ctx.max_nodes) { ctx.overflow = true; return; }
  ctx.depth = std::max(ctx.depth, depth);
  int me = ctx.n_nodes++;
  for (int k = 0; k < 3; ++k) {
    ctx.node_min[me * 3 + k] = bmin[k];
    ctx.node_max[me * 3 + k] = bmax[k];
  }
  if (n > ctx.leaf_size || force_split) {
    ctx.leaf_first[me] = -1;
    ctx.leaf_count[me] = 0;
    int axis = longest_axis(bmin, bmax);
    const float* verts = ctx.verts;
    // stable sort by pointOne along the axis (matches np.argsort stable)
    std::stable_sort(idx, idx + n, [verts, axis](int64_t a, int64_t b) {
      return verts[a * 9 + axis] < verts[b * 9 + axis];
    });
    int half = n / 2;
    float lmin[3], lmax[3], rmin[3], rmax[3];
    aabb(ctx, idx, half, lmin, lmax);
    aabb(ctx, idx + half, n - half, rmin, rmax);
    emit(ctx, idx, half, lmin, lmax, false, depth + 1);
    emit(ctx, idx + half, n - half, rmin, rmax, false, depth + 1);
  } else {
    ctx.leaf_first[me] = ctx.n_perm;
    ctx.leaf_count[me] = n;
    ctx.max_leaf = std::max(ctx.max_leaf, n);
    for (int i = 0; i < n; ++i) ctx.perm[ctx.n_perm++] = (int32_t)idx[i];
  }
  ctx.skip[me] = ctx.n_nodes;   // preorder: skip = index after my subtree
}

int bvh_build(const float* verts, int64_t T, int leaf_size, float* node_min,
              float* node_max, int32_t* skip, int32_t* leaf_first,
              int32_t* leaf_count, int32_t* perm, int max_nodes,
              int32_t* stats_out) {
  BvhCtx ctx{verts, leaf_size, node_min, node_max, skip, leaf_first,
             leaf_count, perm, max_nodes, 0, 0, 0, 0, false};
  std::vector<int64_t> idx((size_t)T);
  for (int64_t i = 0; i < T; ++i) idx[(size_t)i] = i;
  float bmin[3], bmax[3];
  aabb(ctx, idx.data(), (int)T, bmin, bmax);
  emit(ctx, idx.data(), (int)T, bmin, bmax, /*force_split=*/T > 0, 0);
  if (ctx.overflow) return -1;
  stats_out[0] = std::max(ctx.max_leaf, 1);
  stats_out[1] = ctx.depth;
  return ctx.n_nodes;
}

// ---------------------------------------------------------------------------
// OBJ parse (core v/vt/vn/f scan; MTL + textures stay in Python)
// ---------------------------------------------------------------------------
// Two-pass C parser.  obj_count fills counts; obj_parse fills caller-allocated
// arrays:
//   positions [NV, 3] f32, texcoords [NT, 2] f32, normals [NN, 3] f32,
//   faces [NF, 9] i32  (v0,t0,n0, v1,t1,n1, v2,t2,n2; -1 = absent),
//   face_mtl [NF] i32  (index into the usemtl name table),
//   mtl_names: '\n'-joined usemtl names written into a caller buffer.
// Fan triangulation of polygons, matching obj_loader.py:183-184.

static bool read_file(const char* path, std::vector<char>& buf) {
  FILE* f = std::fopen(path, "rb");
  if (!f) return false;
  std::fseek(f, 0, SEEK_END);
  long n = std::ftell(f);
  std::fseek(f, 0, SEEK_SET);
  buf.resize((size_t)n + 1);
  size_t got = std::fread(buf.data(), 1, (size_t)n, f);
  std::fclose(f);
  buf[got] = '\0';
  buf.resize(got + 1);
  return true;
}

struct Tok { const char* p; int len; };

static int split_line(char* line, Tok* toks, int max_toks) {
  int n = 0;
  char* p = line;
  while (*p && n < max_toks) {
    while (*p == ' ' || *p == '\t' || *p == '\r') ++p;
    if (!*p) break;
    toks[n].p = p;
    while (*p && *p != ' ' && *p != '\t' && *p != '\r') ++p;
    toks[n].len = (int)(p - toks[n].p);
    ++n;
  }
  return n;
}

static void parse_index_triplet(const char* tok, int len, int64_t nv,
                                int64_t nt, int64_t nn, int32_t* out) {
  // 'v', 'v/t', 'v//n', 'v/t/n'; negative = relative (obj_loader.py:57-72)
  int64_t counts[3] = {nv, nt, nn};
  const char* p = tok;
  const char* end = tok + len;
  for (int k = 0; k < 3; ++k) {
    if (p >= end) { out[k] = -1; continue; }
    const char* q = p;
    while (q < end && *q != '/') ++q;
    if (q == p) {
      out[k] = -1;
    } else {
      long v = std::strtol(p, nullptr, 10);
      out[k] = (int32_t)(v > 0 ? v - 1 : counts[k] + v);
    }
    p = q + 1;
  }
}

int64_t obj_count(const char* path, int64_t* counts_out) {
  // counts_out: [nv, nt, nn, nfaces(triangulated), n_usemtl, mtl_bytes]
  std::vector<char> buf;
  if (!read_file(path, buf)) return -1;
  int64_t nv = 0, nt = 0, nn = 0, nf = 0, nm = 0, mb = 0;
  char* p = buf.data();
  while (*p) {
    char* line = p;
    while (*p && *p != '\n') ++p;
    if (*p) *p++ = '\0';
    while (*line == ' ' || *line == '\t') ++line;
    if (line[0] == 'v' && line[1] == ' ') ++nv;
    else if (line[0] == 'v' && line[1] == 't') ++nt;
    else if (line[0] == 'v' && line[1] == 'n') ++nn;
    else if (line[0] == 'f' && (line[1] == ' ' || line[1] == '\t')) {
      Tok toks[256];
      int n = split_line(line, toks, 256);
      if (n >= 4) nf += n - 3;     // n-1 corners -> n-3 fan triangles
    } else if (!std::strncmp(line, "usemtl", 6) &&
               (line[6] == ' ' || line[6] == '\t')) {
      Tok toks[4];
      int n = split_line(line, toks, 4);
      if (n >= 2) { ++nm; mb += toks[1].len + 1; }
    }
  }
  counts_out[0] = nv; counts_out[1] = nt; counts_out[2] = nn;
  counts_out[3] = nf; counts_out[4] = nm; counts_out[5] = mb + 1;
  return 0;
}

int64_t obj_parse(const char* path, float* positions, float* texcoords,
                  float* normals, int32_t* faces, int32_t* face_mtl,
                  char* mtl_names, int64_t mtl_cap) {
  std::vector<char> buf;
  if (!read_file(path, buf)) return -1;
  int64_t nv = 0, nt = 0, nn = 0, nf = 0;
  int32_t cur_mtl = -1;
  int64_t mtl_off = 0;
  int32_t n_mtl = 0;
  char* p = buf.data();
  while (*p) {
    char* line = p;
    while (*p && *p != '\n') ++p;
    if (*p) *p++ = '\0';
    while (*line == ' ' || *line == '\t') ++line;
    Tok toks[256];
    if (line[0] == 'v' && line[1] == ' ') {
      int n = split_line(line, toks, 8);
      for (int k = 0; k < 3; ++k)
        positions[nv * 3 + k] =
            (n > k + 1) ? std::strtof(toks[k + 1].p, nullptr) : 0.0f;
      ++nv;
    } else if (line[0] == 'v' && line[1] == 't') {
      int n = split_line(line, toks, 8);
      texcoords[nt * 2 + 0] = (n > 1) ? std::strtof(toks[1].p, nullptr) : 0.0f;
      texcoords[nt * 2 + 1] = (n > 2) ? std::strtof(toks[2].p, nullptr) : 0.0f;
      ++nt;
    } else if (line[0] == 'v' && line[1] == 'n') {
      int n = split_line(line, toks, 8);
      for (int k = 0; k < 3; ++k)
        normals[nn * 3 + k] =
            (n > k + 1) ? std::strtof(toks[k + 1].p, nullptr) : 0.0f;
      ++nn;
    } else if (line[0] == 'f' && (line[1] == ' ' || line[1] == '\t')) {
      int n = split_line(line, toks, 256);
      if (n >= 4) {
        int32_t first[3], prev[3], cur[3];
        parse_index_triplet(toks[1].p, toks[1].len, nv, nt, nn, first);
        parse_index_triplet(toks[2].p, toks[2].len, nv, nt, nn, prev);
        for (int c = 3; c < n; ++c) {
          parse_index_triplet(toks[c].p, toks[c].len, nv, nt, nn, cur);
          int32_t* F = faces + nf * 9;
          std::memcpy(F, first, 3 * sizeof(int32_t));
          std::memcpy(F + 3, prev, 3 * sizeof(int32_t));
          std::memcpy(F + 6, cur, 3 * sizeof(int32_t));
          face_mtl[nf] = cur_mtl;
          ++nf;
          std::memcpy(prev, cur, 3 * sizeof(int32_t));
        }
      }
    } else if (!std::strncmp(line, "usemtl", 6) &&
               (line[6] == ' ' || line[6] == '\t')) {
      int n = split_line(line, toks, 4);
      if (n >= 2 && mtl_off + toks[1].len + 1 < mtl_cap) {
        std::memcpy(mtl_names + mtl_off, toks[1].p, (size_t)toks[1].len);
        mtl_off += toks[1].len;
        mtl_names[mtl_off++] = '\n';
        cur_mtl = n_mtl++;
      }
    }
  }
  if (mtl_off < mtl_cap) mtl_names[mtl_off] = '\0';
  return nf;
}

}  // extern "C"
