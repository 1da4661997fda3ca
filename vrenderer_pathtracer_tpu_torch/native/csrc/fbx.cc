// Binary FBX mesh import (geometry subset).
//
// The reference imports obj/ply/fbx through Assimp (src/MeshLoader.cpp:19,
// file dialog src/NGLScene.cpp:348).  This is a dependency-free reader of
// the documented Kaydara binary FBX container (versions 7100-7700, both the
// 32-bit and the >=7500 64-bit record layouts), extracting the LAST Mesh
// geometry — matching the reference's last-mesh-only behavior
// (src/MeshLoader.cpp:33-36, README.md:54) — with:
//   * Vertices + PolygonVertexIndex (polygons fan-triangulated),
//   * LayerElementNormal / LayerElementUV layer 0 in the Direct and
//     IndexToDirect reference modes for the ByPolygonVertex, ByVertex /
//     ByVertice, ByPolygon and AllSame mapping modes,
//   * zlib-deflated array properties (encoding 1).
// Model/node transforms and material assignments are out of scope (the
// mesh is re-centered at its centroid anyway, reference parity).  The
// ASCII text form (6.x/7.x) parses through a tolerant recursive tokenizer
// into the same Geom structure.
//
// Post-processing matches vt_load_obj (loaders.cc): centroid recentering,
// v -> 1-v flip, corner dedup, smooth normals when the file has none,
// Lengyel tangents.

#include <cmath>
#include <cctype>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <string>
#include <unordered_map>
#include <vector>

#include <zlib.h>

#include "math3.h"

namespace vtrace {

// Shared with loaders.cc (defined there, C++ linkage).
void compute_tangents_shared(const std::vector<V3>& V, const std::vector<V3>& N,
                             const std::vector<float>& UV,
                             const std::vector<int>& tri_idx,
                             std::vector<V3>* T);
float* alloc_v3_shared(const std::vector<V3>& src);

namespace {

constexpr size_t kMaxArrayElems = 1u << 28;  // 256M elements: sanity bound

struct Reader {
  const uint8_t* p;
  size_t n;
  size_t off = 0;
  bool ok = true;

  bool need(size_t k) {
    if (off + k > n) {
      ok = false;
      return false;
    }
    return true;
  }
  uint8_t u8() {
    if (!need(1)) return 0;
    return p[off++];
  }
  uint32_t u32() {
    if (!need(4)) return 0;
    uint32_t v;
    std::memcpy(&v, p + off, 4);
    off += 4;
    return v;
  }
  uint64_t u64() {
    if (!need(8)) return 0;
    uint64_t v;
    std::memcpy(&v, p + off, 8);
    off += 8;
    return v;
  }
  bool bytes(void* dst, size_t k) {
    if (!need(k)) return false;
    std::memcpy(dst, p + off, k);
    off += k;
    return true;
  }
  bool skip(size_t k) {
    if (!need(k)) return false;
    off += k;
    return true;
  }
};

struct Layer {
  std::vector<double> data;     // Normals / UV values
  std::vector<int64_t> index;   // NormalsIndex / UVIndex
  std::string mapping;          // MappingInformationType
  std::string reference;        // ReferenceInformationType
  bool present = false;
};

struct Geom {
  std::vector<double> verts;    // control points, xyz triples
  std::vector<int64_t> pvi;     // PolygonVertexIndex (negative = ~i, last)
  Layer normal, uv;
  bool valid() const { return !verts.empty() && !pvi.empty(); }
};

// Decode one array property ('f','d','l','i','b') into doubles or int64s.
// Returns false on corruption.  Exactly one of out_d / out_i receives data.
bool read_array(Reader* r, char code, std::vector<double>* out_d,
                std::vector<int64_t>* out_i) {
  uint32_t len = r->u32();
  uint32_t enc = r->u32();
  uint32_t comp = r->u32();
  if (!r->ok || len > kMaxArrayElems) return false;
  size_t esize = (code == 'd' || code == 'l') ? 8 : (code == 'b' ? 1 : 4);
  size_t raw_size = (size_t)len * esize;
  std::vector<uint8_t> buf;
  const uint8_t* data;
  if (enc == 0) {
    if (!r->need(raw_size)) return false;
    data = r->p + r->off;
    r->skip(raw_size);
  } else if (enc == 1) {
    if (!r->need(comp)) return false;
    buf.resize(raw_size);
    uLongf dst_len = raw_size;
    if (uncompress(buf.data(), &dst_len, r->p + r->off, comp) != Z_OK ||
        dst_len != raw_size)
      return false;
    r->skip(comp);
    data = buf.data();
  } else {
    return false;
  }
  if (code == 'f' || code == 'd') {
    out_d->resize(len);
    for (uint32_t i = 0; i < len; ++i) {
      if (code == 'f') {
        float v;
        std::memcpy(&v, data + 4 * i, 4);
        (*out_d)[i] = v;
      } else {
        double v;
        std::memcpy(&v, data + 8 * i, 8);
        (*out_d)[i] = v;
      }
    }
  } else {
    out_i->resize(len);
    for (uint32_t i = 0; i < len; ++i) {
      if (code == 'i') {
        int32_t v;
        std::memcpy(&v, data + 4 * i, 4);
        (*out_i)[i] = v;
      } else if (code == 'l') {
        int64_t v;
        std::memcpy(&v, data + 8 * i, 8);
        (*out_i)[i] = v;
      } else {
        (*out_i)[i] = data[i];
      }
    }
  }
  return true;
}

// Skip a scalar/string property already identified by `code`.
bool skip_prop(Reader* r, char code, std::string* str_out) {
  switch (code) {
    case 'Y': return r->skip(2);
    case 'C': return r->skip(1);
    case 'I': case 'F': return r->skip(4);
    case 'D': case 'L': return r->skip(8);
    case 'S': case 'R': {
      uint32_t len = r->u32();
      if (!r->ok || !r->need(len)) return false;
      if (str_out && code == 'S')
        str_out->assign((const char*)r->p + r->off, len);
      return r->skip(len);
    }
    default: return false;
  }
}

struct Parser {
  Reader r;
  bool big = false;        // >=7500: 64-bit record headers
  Geom last_geom;          // last complete Mesh geometry seen
  bool corrupt = false;

  size_t null_record_len() const { return big ? 25 : 13; }

  // Parse the node starting at the current offset.  `path` is the chain of
  // enclosing node names.  Returns the node's end offset (0 = null record).
  uint64_t parse_node(const std::string& path, Geom* geom, Layer* layer) {
    uint64_t end = big ? r.u64() : r.u32();
    uint64_t nprops = big ? r.u64() : r.u32();
    uint64_t plen = big ? r.u64() : r.u32();
    uint8_t nlen = r.u8();
    if (!r.ok) {
      corrupt = true;
      return 0;
    }
    if (end == 0 && nprops == 0 && plen == 0 && nlen == 0) return 0;
    if (end > r.n || end < r.off) {
      corrupt = true;
      return 0;
    }
    std::string name((const char*)r.p + r.off, nlen);
    if (!r.skip(nlen)) {
      corrupt = true;
      return 0;
    }
    size_t props_end = r.off + plen;

    Geom local_geom;
    Geom* child_geom = geom;
    Layer* child_layer = layer;
    bool is_geometry = name == "Geometry" && path == "/Objects";
    if (is_geometry) child_geom = &local_geom;
    if (geom && (name == "LayerElementNormal" || name == "LayerElementUV")) {
      child_layer = name == "LayerElementNormal" ? &geom->normal : &geom->uv;
      // Only the first layer of each kind (layer index 0 comes first).
      if (child_layer->present) child_layer = nullptr;
      else child_layer->present = true;
    }

    // Properties: pull the arrays/strings the geometry subset needs.
    bool want_darr =
        geom && (name == "Vertices" ||
                 (layer && (name == "Normals" || name == "UV")));
    bool want_iarr =
        geom && (name == "PolygonVertexIndex" ||
                 (layer && (name == "NormalsIndex" || name == "UVIndex")));
    bool want_str =
        layer && (name == "MappingInformationType" ||
                  name == "ReferenceInformationType");
    for (uint64_t i = 0; i < nprops && r.ok && r.off < props_end; ++i) {
      char code = (char)r.u8();
      if (code == 'f' || code == 'd' || code == 'l' || code == 'i' ||
          code == 'b') {
        std::vector<double> darr;
        std::vector<int64_t> iarr;
        if (!read_array(&r, code, &darr, &iarr)) {
          corrupt = true;
          return 0;
        }
        if (want_darr && i == 0 && !darr.empty()) {
          if (name == "Vertices") geom->verts = std::move(darr);
          else if (name == "Normals") layer->data = std::move(darr);
          else if (name == "UV") layer->data = std::move(darr);
        } else if (want_iarr && i == 0) {
          if (name == "PolygonVertexIndex") geom->pvi = std::move(iarr);
          else if (name == "NormalsIndex") layer->index = std::move(iarr);
          else if (name == "UVIndex") layer->index = std::move(iarr);
        }
      } else {
        std::string s;
        if (!skip_prop(&r, code, want_str && i == 0 ? &s : nullptr)) {
          corrupt = true;
          return 0;
        }
        if (want_str && i == 0) {
          if (name == "MappingInformationType") layer->mapping = s;
          else layer->reference = s;
        }
      }
    }
    if (r.off > props_end) {
      corrupt = true;
      return 0;
    }
    r.off = props_end;

    // Children (nested node list ends with a null record or at `end`).
    std::string child_path = path + "/" + name;
    while (r.off + null_record_len() <= end && !corrupt) {
      uint64_t child_end = parse_node(child_path, child_geom, child_layer);
      if (corrupt) return 0;
      if (child_end == 0) break;  // null terminator
    }
    if (corrupt) return 0;
    r.off = end;

    if (is_geometry && local_geom.valid())
      last_geom = std::move(local_geom);  // reference keeps the LAST mesh
    return end;
  }
};

// Resolve a layer's value index for corner c (polygon-vertex), control
// point v, polygon pg.  Returns -1 when the layer can't supply a value.
int64_t layer_value_index(const Layer& L, int64_t c, int64_t v, int64_t pg) {
  int64_t key;
  if (L.mapping == "ByPolygonVertex") key = c;
  else if (L.mapping == "ByVertex" || L.mapping == "ByVertice") key = v;
  else if (L.mapping == "ByPolygon") key = pg;
  else if (L.mapping == "AllSame") key = 0;
  else return -1;
  if (L.reference == "IndexToDirect" || L.reference == "Index") {
    if (key < 0 || key >= (int64_t)L.index.size()) return -1;
    key = L.index[key];
  }
  return key;
}

struct CornerKey {
  int64_t v, n, uv;
  bool operator==(const CornerKey& o) const {
    return v == o.v && n == o.n && uv == o.uv;
  }
};
struct CornerKeyHash {
  size_t operator()(const CornerKey& k) const {
    return ((size_t)k.v * 73856093u) ^ ((size_t)k.n * 19349663u) ^
           ((size_t)k.uv * 83492791u);
  }
};

}  // namespace

extern "C" {

// Load a binary FBX: last Mesh geometry, triangulated and indexed, same
// output contract as vt_load_obj.  Returns 0 ok, 1 open failure, 2 corrupt
// ---------------------------------------------------------------------------
// ASCII FBX (6.x / 7.x text form).  A tolerant recursive tokenizer: node :=
// `Name:` props* `{ children }`?, where props are numbers / quoted strings /
// `*N` array-length markers / bare letters (booleans).  Only the geometry
// subset is captured — the same Geom the binary parser fills.
// ---------------------------------------------------------------------------

struct AsciiParser {
  const char* p;
  size_t n, off = 0;
  Geom last_geom;

  void skip_ws() {
    while (off < n) {
      char c = p[off];
      if (c == ';') {  // comment to end of line
        while (off < n && p[off] != '\n') ++off;
      } else if (c == '*') {
        // `*N` array-length marker: skip the star AND its count so the
        // count never lands in a data sink.
        ++off;
        while (off < n && std::isdigit((unsigned char)p[off])) ++off;
      } else if (c == ' ' || c == '\t' || c == '\r' || c == '\n' ||
                 c == ',') {
        ++off;
      } else {
        break;
      }
    }
  }

  bool ident(std::string* name) {
    // Identifier immediately followed by ':' (with no intervening space).
    size_t save = off;
    size_t s = off;
    while (off < n && (std::isalnum((unsigned char)p[off]) || p[off] == '_'))
      ++off;
    if (off > s && off < n && p[off] == ':') {
      name->assign(p + s, off - s);
      ++off;  // consume ':'
      return true;
    }
    off = save;
    return false;
  }

  // Parse one node whose name was already consumed: `Name:` props*
  // followed by at most one `{ children }` block.  A node without braces
  // ends at the next sibling identifier (the caller's loop handles it).
  // `sink_d`/`sink_i` accumulate every number in this node's subtree (how
  // `a:` blocks and FBX6 inline arrays both land in the same vector);
  // `geom`/`layer` give the capture context, as in the binary parser.
  void parse_body(const std::string& name, Geom* geom, Layer* layer,
                  std::vector<double>* sink_d, std::vector<int64_t>* sink_i,
                  std::string* sink_s, int depth) {
    Geom local_geom;
    bool is_geometry = depth == 2 && (name == "Geometry" || name == "Model");
    Geom* child_geom = is_geometry ? &local_geom : geom;
    Layer* child_layer = layer;
    if (geom && (name == "LayerElementNormal" || name == "LayerElementUV")) {
      child_layer = name == "LayerElementNormal" ? &geom->normal : &geom->uv;
      if (child_layer->present) child_layer = nullptr;
      else child_layer->present = true;
    }
    if (geom) {
      if (name == "Vertices") sink_d = &geom->verts;
      else if (name == "PolygonVertexIndex") sink_i = &geom->pvi;
      else if (layer && (name == "Normals" || name == "UV"))
        sink_d = &layer->data;
      else if (layer && (name == "NormalsIndex" || name == "UVIndex"))
        sink_i = &layer->index;
      else if (layer && name == "MappingInformationType")
        sink_s = &layer->mapping;
      else if (layer && name == "ReferenceInformationType")
        sink_s = &layer->reference;
    }

    // Properties (numbers / strings / bare-letter booleans).
    for (;;) {
      skip_ws();
      if (off >= n) return;
      char c = p[off];
      if (c == '"') {
        size_t st = ++off;
        while (off < n && p[off] != '"') ++off;
        if (sink_s && sink_s->empty()) sink_s->assign(p + st, off - st);
        if (off < n) ++off;
        continue;
      }
      if (c == '-' || c == '+' || c == '.' ||
          std::isdigit((unsigned char)c)) {
        char* endp = nullptr;
        double v = std::strtod(p + off, &endp);
        if (endp == p + off) break;
        off = (size_t)(endp - p);
        if (sink_d) sink_d->push_back(v);
        else if (sink_i) sink_i->push_back((int64_t)v);
        continue;
      }
      if (std::isalpha((unsigned char)c) && off + 1 < n &&
          !(std::isalnum((unsigned char)p[off + 1]) || p[off + 1] == '_' ||
            p[off + 1] == ':')) {
        ++off;  // single-letter boolean prop (T, W, Y, ...)
        continue;
      }
      break;  // '{', '}', or a sibling identifier
    }

    skip_ws();
    if (off < n && p[off] == '{') {  // children block
      ++off;
      for (;;) {
        skip_ws();
        if (off >= n) break;
        if (p[off] == '}') {
          ++off;
          break;
        }
        std::string child;
        if (ident(&child)) {
          bool is_a = child.size() == 1 && child[0] == 'a';
          parse_body(child, child_geom, child_layer,
                     is_a ? sink_d : nullptr, is_a ? sink_i : nullptr,
                     nullptr, depth + 1);
        } else {
          ++off;  // unknown token inside a block: skip
        }
      }
    }
    if (is_geometry && local_geom.valid()) last_geom = std::move(local_geom);
  }

  void run() {
    // Depth starts at 1 so document-level nodes (Objects, …) sit at depth
    // 1 and Geometry/Model at depth 2, matching the binary /Objects path.
    for (;;) {
      skip_ws();
      if (off >= n) break;
      std::string name;
      if (ident(&name)) {
        parse_body(name, nullptr, nullptr, nullptr, nullptr, nullptr, 1);
      } else {
        ++off;
      }
    }
  }
};

// Convert a parsed Geom (either container flavour) into the output mesh.
// Returns 0 ok, 2 invalid geometry.
int geom_to_mesh(const Geom& g, float** out_verts, float** out_normals,
                 float** out_tangents, float** out_uvs, int* out_n_verts,
                 int** out_tris, int* out_n_tris);

// or no geometry, 3 not FBX (foreign format).
int vt_load_fbx(const char* path, float** out_verts, float** out_normals,
                float** out_tangents, float** out_uvs, int* out_n_verts,
                int** out_tris, int* out_n_tris) {
  FILE* f = std::fopen(path, "rb");
  if (!f) return 1;
  std::fseek(f, 0, SEEK_END);
  long fsize = std::ftell(f);
  std::fseek(f, 0, SEEK_SET);
  if (fsize < 27) {
    std::fclose(f);
    return 3;
  }
  std::vector<uint8_t> buf(fsize);
  size_t got = std::fread(buf.data(), 1, fsize, f);
  std::fclose(f);
  if ((long)got != fsize) return 2;

  static const char kMagic[] = "Kaydara FBX Binary  ";
  if (std::memcmp(buf.data(), kMagic, 20) != 0) {
    // ASCII form?  Heuristic: text files open with a "; FBX" comment or an
    // FBXHeaderExtension node; reject obviously-binary foreign data.
    std::string head((const char*)buf.data(),
                     std::min<size_t>(buf.size(), 4096));
    if (head.find("FBX") == std::string::npos) return 3;
    AsciiParser ap{(const char*)buf.data(), (size_t)fsize};
    ap.run();
    if (!ap.last_geom.valid()) return 2;
    return geom_to_mesh(ap.last_geom, out_verts, out_normals, out_tangents,
                        out_uvs, out_n_verts, out_tris, out_n_tris);
  }

  Parser ps;
  ps.r = Reader{buf.data(), (size_t)fsize, 23, true};  // skip magic+0x1A00
  uint32_t version = ps.r.u32();
  ps.big = version >= 7500;

  // Top-level node list: parse until the null record / EOF.
  while (ps.r.off + ps.null_record_len() <= ps.r.n && !ps.corrupt) {
    uint64_t end = ps.parse_node("", nullptr, nullptr);
    if (end == 0) break;
  }
  if (ps.corrupt || !ps.last_geom.valid()) return 2;
  return geom_to_mesh(ps.last_geom, out_verts, out_normals, out_tangents,
                      out_uvs, out_n_verts, out_tris, out_n_tris);
}

int geom_to_mesh(const Geom& g, float** out_verts, float** out_normals,
                 float** out_tangents, float** out_uvs, int* out_n_verts,
                 int** out_tris, int* out_n_tris) {
  // Control points.
  size_t ncp = g.verts.size() / 3;
  if (ncp == 0) return 2;
  std::vector<V3> pos(ncp);
  for (size_t i = 0; i < ncp; ++i)
    pos[i] = V3{(float)g.verts[3 * i], (float)g.verts[3 * i + 1],
                (float)g.verts[3 * i + 2]};
  V3 centroid{0, 0, 0};
  for (const V3& p : pos) centroid = centroid + p;
  centroid = centroid * (1.f / (float)ncp);
  for (V3& p : pos) p = p - centroid;

  // Corner records from the polygon stream, fan-triangulated.
  struct Corner { int64_t v, n, uv; };
  std::vector<Corner> tri_corners;
  std::vector<int64_t> poly_c, poly_v;  // corner ids + control points
  int64_t pg = 0;
  bool has_n = g.normal.present && !g.normal.data.empty();
  bool has_uv = g.uv.present && !g.uv.data.empty();
  for (size_t c = 0; c < g.pvi.size(); ++c) {
    int64_t raw = g.pvi[c];
    int64_t v = raw < 0 ? ~raw : raw;
    if (v < 0 || v >= (int64_t)ncp) return 2;
    poly_c.push_back((int64_t)c);
    poly_v.push_back(v);
    if (raw < 0) {  // polygon closes here
      for (size_t j = 2; j < poly_v.size(); ++j) {
        size_t ids[3] = {0, j - 1, j};
        for (size_t k = 0; k < 3; ++k) {
          Corner cr;
          cr.v = poly_v[ids[k]];
          cr.n = has_n
              ? layer_value_index(g.normal, poly_c[ids[k]], cr.v, pg) : -1;
          cr.uv = has_uv
              ? layer_value_index(g.uv, poly_c[ids[k]], cr.v, pg) : -1;
          tri_corners.push_back(cr);
        }
      }
      poly_c.clear();
      poly_v.clear();
      ++pg;
    }
  }
  if (tri_corners.empty()) return 2;

  // Deduplicate (v, n, uv) corners into unique output vertices.
  std::unordered_map<CornerKey, int, CornerKeyHash> remap;
  std::vector<Corner> uniq;
  std::vector<int> tri_idx;
  tri_idx.reserve(tri_corners.size());
  for (const Corner& c : tri_corners) {
    CornerKey key{c.v, c.n, c.uv};
    auto it = remap.find(key);
    int idx;
    if (it == remap.end()) {
      idx = (int)uniq.size();
      remap.emplace(key, idx);
      uniq.push_back(c);
    } else {
      idx = it->second;
    }
    tri_idx.push_back(idx);
  }
  const int nv = (int)uniq.size();
  const int nt = (int)(tri_idx.size() / 3);

  std::vector<V3> V(nv), N(nv, V3{0, 0, 0}), T;
  std::vector<float> UV(2 * nv, 0.f);
  bool any_missing_normal = false;
  for (int i = 0; i < nv; ++i) {
    const Corner& c = uniq[i];
    V[i] = pos[c.v];
    if (c.n >= 0 && 3 * c.n + 2 < (int64_t)g.normal.data.size()) {
      N[i] = V3{(float)g.normal.data[3 * c.n],
                (float)g.normal.data[3 * c.n + 1],
                (float)g.normal.data[3 * c.n + 2]};
    } else {
      any_missing_normal = true;
    }
    if (c.uv >= 0 && 2 * c.uv + 1 < (int64_t)g.uv.data.size()) {
      UV[2 * i] = (float)g.uv.data[2 * c.uv];
      UV[2 * i + 1] = 1.f - (float)g.uv.data[2 * c.uv + 1];  // reference flip
    }
  }

  if (any_missing_normal) {
    // Area-weighted smooth normals over the shared control points.
    std::vector<V3> acc(ncp, V3{0, 0, 0});
    for (int t = 0; t < nt; ++t) {
      const Corner &a = uniq[tri_idx[3 * t]], &b = uniq[tri_idx[3 * t + 1]],
                   &c = uniq[tri_idx[3 * t + 2]];
      V3 fn = cross(pos[b.v] - pos[a.v], pos[c.v] - pos[a.v]);
      acc[a.v] = acc[a.v] + fn;
      acc[b.v] = acc[b.v] + fn;
      acc[c.v] = acc[c.v] + fn;
    }
    for (int i = 0; i < nv; ++i)
      if (uniq[i].n < 0) N[i] = normalize(acc[uniq[i].v]);
  }

  compute_tangents_shared(V, N, UV, tri_idx, &T);

  *out_verts = alloc_v3_shared(V);
  *out_normals = alloc_v3_shared(N);
  *out_tangents = alloc_v3_shared(T);
  *out_uvs = (float*)std::malloc(sizeof(float) * UV.size());
  std::memcpy(*out_uvs, UV.data(), sizeof(float) * UV.size());
  *out_tris = (int*)std::malloc(sizeof(int) * tri_idx.size());
  std::memcpy(*out_tris, tri_idx.data(), sizeof(int) * tri_idx.size());
  *out_n_verts = nv;
  *out_n_tris = nt;
  return 0;
}

}  // extern "C"
}  // namespace vtrace
