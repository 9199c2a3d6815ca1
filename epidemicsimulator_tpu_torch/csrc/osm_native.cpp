// ESUCD-TPU native geometry engine: the port's copy of
// native/esucd_native.cc.
//
// C++ replacements for the reference's Rust osm_data crate hot paths:
//  * OSM PBF reader: hand-rolled protobuf wire decoding + zlib blobs,
//    tag-classifying nodes/ways into building classes and assembling way
//    centroids/areas (osm_data/src/lib.rs:180-208 classification rules,
//    :524-673 way assembly, :69-108 boundary pre-filter).
//  * Batch point-in-polygon assignment with a uniform grid index
//    (replaces the quadtree polygon containment of
//    osm_data/src/quadtree.rs + polygon_lookup.rs used for building->OA
//    assignment, simulator_builder.rs:1322-1366).
//
// Exposed via a plain C ABI for ctypes (no pybind11 needed).
//
// Built by epidemicsimulator_tpu_torch/runtime.py (build_host) with the
// other csrc/*.cpp into the host library, linked with -lz.

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <string>
#include <unordered_map>
#include <vector>

#include <zlib.h>

namespace {

// ----------------------------------------------------------------------
// Protobuf wire-format primitives
// ----------------------------------------------------------------------
struct Slice {
  const uint8_t* p;
  const uint8_t* end;
  bool ok() const { return p <= end; }
  size_t size() const { return end - p; }
};

inline uint64_t read_varint(Slice& s) {
  uint64_t x = 0;
  int shift = 0;
  while (s.p < s.end) {
    uint8_t b = *s.p++;
    x |= uint64_t(b & 0x7F) << shift;
    if (!(b & 0x80)) return x;
    shift += 7;
  }
  return x;
}

inline int64_t zigzag(uint64_t v) {
  return int64_t(v >> 1) ^ -int64_t(v & 1);
}

struct Field {
  uint32_t num;
  uint32_t wire;
  uint64_t varint;   // wire 0
  Slice bytes;       // wire 2
};

inline bool next_field(Slice& s, Field& f) {
  if (s.p >= s.end) return false;
  uint64_t tag = read_varint(s);
  f.num = uint32_t(tag >> 3);
  f.wire = uint32_t(tag & 7);
  switch (f.wire) {
    case 0:
      f.varint = read_varint(s);
      return true;
    case 1:
      s.p += 8;
      return s.ok();
    case 2: {
      uint64_t len = read_varint(s);
      f.bytes = {s.p, s.p + len};
      s.p += len;
      return s.ok();
    }
    case 5:
      s.p += 4;
      return s.ok();
    default:
      return false;
  }
}

// ----------------------------------------------------------------------
// Building classification (osm_data/src/lib.rs:180-208)
// ----------------------------------------------------------------------
enum BuildingClass : int32_t {
  SHOP = 0,
  SCHOOL = 1,
  HOSPITAL = 2,
  HOUSEHOLD = 3,
  WORKPLACE = 4,
  UNKNOWN = 5,
};

int32_t classify(const std::vector<std::pair<std::string_view, std::string_view>>& tags) {
  const std::string_view* building = nullptr;
  for (auto& [k, v] : tags) {
    if (k == "amenity") {
      if (v == "school") return SCHOOL;
      if (v == "hospital") return HOSPITAL;
    } else if (k == "shop") {
      return SHOP;
    } else if (k == "building") {
      building = &v;
    }
  }
  if (building) {
    const std::string_view& v = *building;
    if (v == "office" || v == "industrial" || v == "commercial" ||
        v == "retail" || v == "warehouse" || v == "civic" || v == "public")
      return WORKPLACE;
    if (v == "house" || v == "detached" || v == "semidetached_house" ||
        v == "farm" || v == "hut" || v == "static_caravan" || v == "cabin" ||
        v == "apartments" || v == "terrace" || v == "residential")
      return HOUSEHOLD;
    if (v == "school") return SCHOOL;
    if (v == "hospital") return HOSPITAL;
    return WORKPLACE;  // unknown buildings can be workplaces
  }
  return UNKNOWN;
}

// ----------------------------------------------------------------------
// PBF structures
// ----------------------------------------------------------------------
struct ParseState {
  double min_lat, max_lat, min_lon, max_lon;
  // node store: id -> packed (lat, lon) in 1e-7 degrees
  std::unordered_map<int64_t, std::pair<int32_t, int32_t>> nodes;
  // outputs
  std::vector<int32_t> classes;
  std::vector<double> lats, lons, areas;
  std::vector<uint8_t> scratch;
};

void parse_dense_nodes(Slice s, const std::vector<std::string_view>& strings,
                       int64_t granularity, int64_t lat_off, int64_t lon_off,
                       ParseState& st) {
  Slice ids{nullptr, nullptr}, lats{nullptr, nullptr}, lons{nullptr, nullptr},
      kvs{nullptr, nullptr};
  Field f;
  while (next_field(s, f)) {
    if (f.num == 1 && f.wire == 2) ids = f.bytes;
    else if (f.num == 8 && f.wire == 2) lats = f.bytes;
    else if (f.num == 9 && f.wire == 2) lons = f.bytes;
    else if (f.num == 10 && f.wire == 2) kvs = f.bytes;
  }
  int64_t id = 0, lat = 0, lon = 0;
  std::vector<std::pair<std::string_view, std::string_view>> tags;
  while (ids.p < ids.end) {
    id += zigzag(read_varint(ids));
    lat += zigzag(read_varint(lats));
    lon += zigzag(read_varint(lons));
    double dlat = 1e-9 * double(lat_off + granularity * lat);
    double dlon = 1e-9 * double(lon_off + granularity * lon);
    bool inside = dlat >= st.min_lat && dlat <= st.max_lat &&
                  dlon >= st.min_lon && dlon <= st.max_lon;
    if (inside)
      st.nodes.emplace(id, std::make_pair(int32_t(dlat * 1e7), int32_t(dlon * 1e7)));
    // tags for this node
    tags.clear();
    while (kvs.p < kvs.end) {
      uint64_t k = read_varint(kvs);
      if (k == 0) break;
      uint64_t v = read_varint(kvs);
      if (k < strings.size() && v < strings.size())
        tags.emplace_back(strings[k], strings[v]);
    }
    if (inside && !tags.empty()) {
      int32_t cls = classify(tags);
      if (cls != UNKNOWN) {
        st.classes.push_back(cls);
        st.lats.push_back(dlat);
        st.lons.push_back(dlon);
        st.areas.push_back(0.0);
      }
    }
  }
}

void parse_way(Slice s, const std::vector<std::string_view>& strings,
               ParseState& st) {
  Slice keys{nullptr, nullptr}, vals{nullptr, nullptr}, refs{nullptr, nullptr};
  Field f;
  while (next_field(s, f)) {
    if (f.num == 2 && f.wire == 2) keys = f.bytes;
    else if (f.num == 3 && f.wire == 2) vals = f.bytes;
    else if (f.num == 8 && f.wire == 2) refs = f.bytes;
  }
  std::vector<std::pair<std::string_view, std::string_view>> tags;
  while (keys.p < keys.end && vals.p < vals.end) {
    uint64_t k = read_varint(keys);
    uint64_t v = read_varint(vals);
    if (k < strings.size() && v < strings.size())
      tags.emplace_back(strings[k], strings[v]);
  }
  if (tags.empty()) return;
  int32_t cls = classify(tags);
  if (cls == UNKNOWN) return;

  // assemble polygon from node refs
  int64_t ref = 0;
  double sum_lat = 0, sum_lon = 0;
  int count = 0;
  std::vector<std::pair<double, double>> poly;
  while (refs.p < refs.end) {
    ref += zigzag(read_varint(refs));
    auto it = st.nodes.find(ref);
    if (it == st.nodes.end()) continue;  // outside boundary or unseen
    double dlat = it->second.first * 1e-7, dlon = it->second.second * 1e-7;
    poly.emplace_back(dlat, dlon);
    sum_lat += dlat;
    sum_lon += dlon;
    ++count;
  }
  if (count == 0) return;
  double clat = sum_lat / count, clon = sum_lon / count;
  // approximate footprint area in m^2: local equirectangular projection
  double area = 0.0;
  if (poly.size() >= 3) {
    const double R = 6371000.0, DEG = M_PI / 180.0;
    double cosl = cos(clat * DEG);
    for (size_t i = 0; i + 1 < poly.size(); ++i) {
      double x1 = (poly[i].second - clon) * DEG * R * cosl;
      double y1 = (poly[i].first - clat) * DEG * R;
      double x2 = (poly[i + 1].second - clon) * DEG * R * cosl;
      double y2 = (poly[i + 1].first - clat) * DEG * R;
      area += x1 * y2 - x2 * y1;
    }
    area = fabs(area) * 0.5;
  }
  st.classes.push_back(cls);
  st.lats.push_back(clat);
  st.lons.push_back(clon);
  st.areas.push_back(area);
}

void parse_primitive_block(Slice s, ParseState& st) {
  std::vector<std::string_view> strings;
  int64_t granularity = 100, lat_off = 0, lon_off = 0;
  std::vector<Slice> groups;
  Field f;
  Slice body = s;
  while (next_field(body, f)) {
    if (f.num == 1 && f.wire == 2) {
      Slice t = f.bytes;
      Field sf;
      while (next_field(t, sf))
        if (sf.num == 1 && sf.wire == 2)
          strings.emplace_back(reinterpret_cast<const char*>(sf.bytes.p),
                               sf.bytes.size());
    } else if (f.num == 2 && f.wire == 2) {
      groups.push_back(f.bytes);
    } else if (f.num == 17 && f.wire == 0) {
      granularity = int64_t(f.varint);
    } else if (f.num == 19 && f.wire == 0) {
      lat_off = int64_t(f.varint);
    } else if (f.num == 20 && f.wire == 0) {
      lon_off = int64_t(f.varint);
    }
  }
  for (Slice g : groups) {
    Field gf;
    Slice body2 = g;
    while (next_field(body2, gf)) {
      if (gf.num == 2 && gf.wire == 2) {
        parse_dense_nodes(gf.bytes, strings, granularity, lat_off, lon_off, st);
      } else if (gf.num == 1 && gf.wire == 2) {
        // plain Node
        Slice ns = gf.bytes;
        Field nf;
        int64_t id = 0, lat = 0, lon = 0;
        Slice keys{nullptr, nullptr}, vals{nullptr, nullptr};
        while (next_field(ns, nf)) {
          if (nf.num == 1 && nf.wire == 0) id = zigzag(nf.varint);
          else if (nf.num == 8 && nf.wire == 0) lat = zigzag(nf.varint);
          else if (nf.num == 9 && nf.wire == 0) lon = zigzag(nf.varint);
          else if (nf.num == 2 && nf.wire == 2) keys = nf.bytes;
          else if (nf.num == 3 && nf.wire == 2) vals = nf.bytes;
        }
        double dlat = 1e-9 * double(lat_off + granularity * lat);
        double dlon = 1e-9 * double(lon_off + granularity * lon);
        if (dlat < st.min_lat || dlat > st.max_lat || dlon < st.min_lon ||
            dlon > st.max_lon)
          continue;
        st.nodes.emplace(id,
                         std::make_pair(int32_t(dlat * 1e7), int32_t(dlon * 1e7)));
        std::vector<std::pair<std::string_view, std::string_view>> tags;
        while (keys.p < keys.end && vals.p < vals.end) {
          uint64_t k = read_varint(keys);
          uint64_t v = read_varint(vals);
          if (k < strings.size() && v < strings.size())
            tags.emplace_back(strings[k], strings[v]);
        }
        if (!tags.empty()) {
          int32_t cls = classify(tags);
          if (cls != UNKNOWN) {
            st.classes.push_back(cls);
            st.lats.push_back(dlat);
            st.lons.push_back(dlon);
            st.areas.push_back(0.0);
          }
        }
      } else if (gf.num == 3 && gf.wire == 2) {
        parse_way(gf.bytes, strings, st);
      }
    }
  }
}

bool inflate_blob(const uint8_t* src, size_t n, size_t raw_size,
                  std::vector<uint8_t>& out) {
  out.resize(raw_size);
  uLongf dest_len = raw_size;
  return uncompress(out.data(), &dest_len, src, n) == Z_OK;
}

}  // namespace

extern "C" {

// Parse an OSM PBF extract.  Returns 0 on success.  Output arrays are
// malloc'd; free with esucd_free.
int esucd_parse_pbf(const char* path, double min_lat, double max_lat,
                    double min_lon, double max_lon, int32_t** out_classes,
                    double** out_lats, double** out_lons, double** out_areas,
                    int64_t* out_n) {
  FILE* fp = fopen(path, "rb");
  if (!fp) return 1;
  ParseState st;
  st.min_lat = min_lat;
  st.max_lat = max_lat;
  st.min_lon = min_lon;
  st.max_lon = max_lon;

  std::vector<uint8_t> header_buf, blob_buf, raw;
  for (;;) {
    uint8_t len_be[4];
    if (fread(len_be, 1, 4, fp) != 4) break;  // EOF
    uint32_t hlen = (uint32_t(len_be[0]) << 24) | (uint32_t(len_be[1]) << 16) |
                    (uint32_t(len_be[2]) << 8) | uint32_t(len_be[3]);
    if (hlen > (64u << 20)) { fclose(fp); return 2; }
    header_buf.resize(hlen);
    if (fread(header_buf.data(), 1, hlen, fp) != hlen) { fclose(fp); return 2; }

    Slice hs{header_buf.data(), header_buf.data() + hlen};
    Field f;
    std::string type;
    uint64_t datasize = 0;
    while (next_field(hs, f)) {
      if (f.num == 1 && f.wire == 2)
        type.assign(reinterpret_cast<const char*>(f.bytes.p), f.bytes.size());
      else if (f.num == 3 && f.wire == 0)
        datasize = f.varint;
    }
    blob_buf.resize(datasize);
    if (fread(blob_buf.data(), 1, datasize, fp) != datasize) { fclose(fp); return 2; }
    if (type != "OSMData") continue;

    Slice bs{blob_buf.data(), blob_buf.data() + datasize};
    Slice raw_slice{nullptr, nullptr}, z_slice{nullptr, nullptr};
    uint64_t raw_size = 0;
    while (next_field(bs, f)) {
      if (f.num == 1 && f.wire == 2) raw_slice = f.bytes;
      else if (f.num == 2 && f.wire == 0) raw_size = f.varint;
      else if (f.num == 3 && f.wire == 2) z_slice = f.bytes;
    }
    if (raw_slice.p) {
      parse_primitive_block(raw_slice, st);
    } else if (z_slice.p) {
      if (!inflate_blob(z_slice.p, z_slice.size(), raw_size, raw)) {
        fclose(fp);
        return 3;
      }
      parse_primitive_block({raw.data(), raw.data() + raw.size()}, st);
    }
  }
  fclose(fp);

  int64_t n = int64_t(st.classes.size());
  *out_n = n;
  *out_classes = (int32_t*)malloc(n * sizeof(int32_t));
  *out_lats = (double*)malloc(n * sizeof(double));
  *out_lons = (double*)malloc(n * sizeof(double));
  *out_areas = (double*)malloc(n * sizeof(double));
  memcpy(*out_classes, st.classes.data(), n * sizeof(int32_t));
  memcpy(*out_lats, st.lats.data(), n * sizeof(double));
  memcpy(*out_lons, st.lons.data(), n * sizeof(double));
  memcpy(*out_areas, st.areas.data(), n * sizeof(double));
  return 0;
}

void esucd_free(void* p) { free(p); }

// Batch point-in-polygon with a uniform grid index.
// Polygons: concatenated exterior rings; poly_starts has n_polys+1 entries.
// out[i] = index of first polygon containing point i, else -1.
void esucd_assign_points(const double* px, const double* py, int64_t n_points,
                         const double* ring_x, const double* ring_y,
                         const int64_t* poly_starts, int64_t n_polys,
                         int32_t* out) {
  // bounding boxes
  std::vector<double> bx0(n_polys), bx1(n_polys), by0(n_polys), by1(n_polys);
  double gx0 = 1e300, gx1 = -1e300, gy0 = 1e300, gy1 = -1e300;
  for (int64_t p = 0; p < n_polys; ++p) {
    double x0 = 1e300, x1 = -1e300, y0 = 1e300, y1 = -1e300;
    for (int64_t i = poly_starts[p]; i < poly_starts[p + 1]; ++i) {
      x0 = std::min(x0, ring_x[i]); x1 = std::max(x1, ring_x[i]);
      y0 = std::min(y0, ring_y[i]); y1 = std::max(y1, ring_y[i]);
    }
    bx0[p] = x0; bx1[p] = x1; by0[p] = y0; by1[p] = y1;
    gx0 = std::min(gx0, x0); gx1 = std::max(gx1, x1);
    gy0 = std::min(gy0, y0); gy1 = std::max(gy1, y1);
  }
  const int G = 512;
  double sx = (gx1 > gx0) ? G / (gx1 - gx0) : 1.0;
  double sy = (gy1 > gy0) ? G / (gy1 - gy0) : 1.0;
  auto cell_of = [&](double x, double y, int& cx, int& cy) {
    cx = std::min(G - 1, std::max(0, int((x - gx0) * sx)));
    cy = std::min(G - 1, std::max(0, int((y - gy0) * sy)));
  };
  std::vector<std::vector<int32_t>> grid(size_t(G) * G);
  for (int64_t p = 0; p < n_polys; ++p) {
    int cx0, cy0, cx1, cy1;
    cell_of(bx0[p], by0[p], cx0, cy0);
    cell_of(bx1[p], by1[p], cx1, cy1);
    for (int cy = cy0; cy <= cy1; ++cy)
      for (int cx = cx0; cx <= cx1; ++cx)
        grid[size_t(cy) * G + cx].push_back(int32_t(p));
  }
  auto inside = [&](int64_t p, double x, double y) {
    bool in = false;
    int64_t s = poly_starts[p], e = poly_starts[p + 1];
    for (int64_t i = s, j = e - 1; i < e; j = i++) {
      double xi = ring_x[i], yi = ring_y[i], xj = ring_x[j], yj = ring_y[j];
      if ((yi > y) != (yj > y) &&
          x < (xj - xi) * (y - yi) / (yj - yi) + xi)
        in = !in;
    }
    return in;
  };
  for (int64_t i = 0; i < n_points; ++i) {
    out[i] = -1;
    double x = px[i], y = py[i];
    if (x < gx0 || x > gx1 || y < gy0 || y > gy1) continue;
    int cx, cy;
    cell_of(x, y, cx, cy);
    for (int32_t p : grid[size_t(cy) * G + cx]) {
      if (x < bx0[p] || x > bx1[p] || y < by0[p] || y > by1[p]) continue;
      if (inside(p, x, y)) { out[i] = p; break; }
    }
  }
}

}  // extern "C"
