// Minimal NetCDF3 classic (CDF-1/CDF-2) reader with a C ABI.
//
// The port's own copy of ltjax's reader (ltjax/native/ncread.cpp), the
// counterpart of the reference's NetCDF Fortran input layer
// (hydrodynamic_module.f90 initHydro/updateHydro).  The CLI's prefetch
// worker reads whole records through it off the Python GIL (ctypes calls
// release it), and the ranks of a sharded run read only their eta rows
// (ltnc_read_rows: one copy per level).  A file is mapped read-only once
// at open and every read converts straight from the mapping (the page
// cache, one pass, as scipy's mmap reads): pread(2) of the same records
// measured several times slower than scipy on the H100 machine's disk.
// A file that cannot be mapped is read with pread(2).  No libc FILE
// locking; reads are thread-safe per handle.
//
// Format reference: the public NetCDF classic format spec (CDF-1:
// 32-bit offsets, CDF-2: 64-bit offsets).  Big-endian on disk.
//
// Built at first use by ltjax_torch/native/__init__.py:
//   g++ -O3 -shared -fPIC -std=c++17 -o ltnc-<hash>.so ncread.cpp

#include <cstdint>
#include <cstring>
#include <string>
#include <vector>

#include <fcntl.h>
#include <sys/mman.h>
#include <sys/stat.h>
#include <unistd.h>

namespace {

constexpr uint32_t NC_DIMENSION = 0x0A;
constexpr uint32_t NC_VARIABLE = 0x0B;
constexpr uint32_t NC_ATTRIBUTE = 0x0C;

inline uint16_t bswap16(uint16_t v) { return __builtin_bswap16(v); }
inline uint32_t bswap32(uint32_t v) { return __builtin_bswap32(v); }
inline uint64_t bswap64(uint64_t v) { return __builtin_bswap64(v); }

int type_size(int t) {
  switch (t) {
    case 1: return 1;  // byte
    case 2: return 1;  // char
    case 3: return 2;  // short
    case 4: return 4;  // int
    case 5: return 4;  // float
    case 6: return 8;  // double
  }
  return 0;
}

struct Var {
  std::string name;
  std::vector<int> dimids;
  int type = 0;
  bool record = false;
  int64_t begin = 0;
  int64_t n_per_rec = 0;   // elements per record (or total for non-record)
  int64_t slab_bytes = 0;  // unpadded bytes per record slab
};

struct File {
  int fd = -1;
  int version = 0;
  int64_t numrecs = 0;
  std::vector<int64_t> dimlen;
  std::vector<Var> vars;
  int64_t recsize = 0;  // padded bytes of one whole record
  const char* map = nullptr;  // the whole file, read-only (or null)
  int64_t map_len = 0;
  std::string error;
};

// -- incremental big-endian header reader ----------------------------------
// (from the file's mapping where there is one: a header is hundreds of
// 4-byte fields, and one pread(2) each cost tenths of a second per file
// on the H100 machine's disk)
struct Reader {
  int fd;
  const char* map;
  int64_t len;
  int64_t pos = 0;
  bool ok = true;

  Reader(int fd_, const char* map_, int64_t len_)
      : fd(fd_), map(map_), len(len_) {}

  bool bytes(void* out, int64_t n) {
    if (!ok) return false;
    auto* p = static_cast<char*>(out);
    if (map) {
      if (pos < 0 || pos + n > len) { ok = false; return false; }
      std::memcpy(p, map + pos, n);
      pos += n;
      return true;
    }
    int64_t got = 0;
    while (got < n) {
      ssize_t r = pread(fd, p + got, n - got, pos + got);
      if (r <= 0) { ok = false; return false; }
      got += r;
    }
    pos += n;
    return true;
  }
  uint32_t u32() {
    uint32_t v = 0;
    bytes(&v, 4);
    return bswap32(v);
  }
  uint64_t u64() {
    uint64_t v = 0;
    bytes(&v, 8);
    return bswap64(v);
  }
  std::string name() {
    uint32_t n = u32();
    std::string s(n, '\0');
    bytes(s.data(), n);
    int64_t pad = (4 - (n % 4)) % 4;
    pos += pad;
    return s;
  }
  void skip(int64_t n) { pos += n; }
};

void skip_attrs(Reader& r) {
  uint32_t tag = r.u32();
  uint32_t count = r.u32();
  if (tag != NC_ATTRIBUTE && count != 0) { r.ok = false; return; }
  for (uint32_t a = 0; a < count && r.ok; ++a) {
    r.name();
    uint32_t t = r.u32();
    uint32_t n = r.u32();
    int64_t nbytes = (int64_t)n * type_size((int)t);
    r.skip(nbytes + ((4 - (nbytes % 4)) % 4));
  }
}

File* parse(const char* path) {
  auto* f = new File();
  f->fd = open(path, O_RDONLY);
  if (f->fd < 0) { f->error = "open failed"; return f; }
  struct stat sb;
  if (fstat(f->fd, &sb) == 0 && sb.st_size > 0) {
    void* m = mmap(nullptr, (size_t)sb.st_size, PROT_READ, MAP_SHARED,
                   f->fd, 0);
    if (m != MAP_FAILED) {
      f->map = static_cast<const char*>(m);
      f->map_len = (int64_t)sb.st_size;
    }
  }
  Reader r(f->fd, f->map, f->map_len);
  char magic[4];
  if (!r.bytes(magic, 4) || magic[0] != 'C' || magic[1] != 'D' ||
      magic[2] != 'F' || (magic[3] != 1 && magic[3] != 2)) {
    f->error = "not a CDF-1/CDF-2 file";
    return f;
  }
  f->version = magic[3];
  uint32_t nr = r.u32();
  f->numrecs = (nr == 0xFFFFFFFFu) ? -1 : (int64_t)nr;  // -1 = STREAMING

  // dim_list
  uint32_t tag = r.u32();
  uint32_t ndims = r.u32();
  if (!(tag == NC_DIMENSION || (tag == 0 && ndims == 0))) {
    f->error = "bad dim_list";
    return f;
  }
  for (uint32_t i = 0; i < ndims && r.ok; ++i) {
    r.name();
    f->dimlen.push_back((int64_t)r.u32());  // 0 => record dim
  }
  skip_attrs(r);  // global attributes

  // var_list
  tag = r.u32();
  uint32_t nvars = r.u32();
  if (!(tag == NC_VARIABLE || (tag == 0 && nvars == 0))) {
    f->error = "bad var_list";
    return f;
  }
  int n_record_vars = 0;
  for (uint32_t i = 0; i < nvars && r.ok; ++i) {
    Var v;
    v.name = r.name();
    uint32_t nd = r.u32();
    for (uint32_t d = 0; d < nd; ++d) v.dimids.push_back((int)r.u32());
    skip_attrs(r);
    v.type = (int)r.u32();
    r.u32();  // vsize (unreliable for large vars; recomputed below)
    v.begin = (f->version == 1) ? (int64_t)r.u32() : (int64_t)r.u64();
    v.record = !v.dimids.empty() && f->dimlen[v.dimids[0]] == 0;
    int64_t n = 1;
    for (size_t d = v.record ? 1 : 0; d < v.dimids.size(); ++d)
      n *= f->dimlen[v.dimids[d]];
    v.n_per_rec = n;
    v.slab_bytes = n * type_size(v.type);
    if (v.record) ++n_record_vars;
    f->vars.push_back(std::move(v));
  }
  if (!r.ok) { f->error = "truncated header"; return f; }

  // record size: sum of padded slabs; a SINGLE record var is unpadded
  for (auto& v : f->vars) {
    if (!v.record) continue;
    int64_t padded = (n_record_vars == 1)
                         ? v.slab_bytes
                         : (v.slab_bytes + 3) & ~int64_t(3);
    f->recsize += padded;
  }
  return f;
}

template <typename SRC, typename DST, typename SWAP>
void convert(const char* raw, int64_t n, DST* out, SWAP swp) {
  for (int64_t i = 0; i < n; ++i) {
    SRC v;
    std::memcpy(&v, raw + i * sizeof(SRC), sizeof(SRC));
    v = swp(v);
    out[i] = (DST)v;
  }
}

template <typename DST>
bool read_convert(File* f, const Var& v, int64_t off, int64_t n, DST* out) {
  const int64_t nbytes = n * type_size(v.type);
  std::vector<char> buf;
  const char* raw;
  if (f->map && off >= 0 && off + nbytes <= f->map_len) {
    raw = f->map + off;
  } else {
    buf.resize((size_t)nbytes);
    int64_t got = 0;
    while (got < nbytes) {
      ssize_t r = pread(f->fd, buf.data() + got, nbytes - got, off + got);
      if (r <= 0) return false;
      got += r;
    }
    raw = buf.data();
  }
  switch (v.type) {
    case 1:
    case 2: {
      auto* s = reinterpret_cast<const int8_t*>(raw);
      for (int64_t i = 0; i < n; ++i) out[i] = (DST)s[i];
      break;
    }
    case 3: {
      for (int64_t i = 0; i < n; ++i) {
        uint16_t u;
        std::memcpy(&u, raw + i * 2, 2);
        u = bswap16(u);
        int16_t s;
        std::memcpy(&s, &u, 2);
        out[i] = (DST)s;
      }
      break;
    }
    case 4: {
      for (int64_t i = 0; i < n; ++i) {
        uint32_t u;
        std::memcpy(&u, raw + i * 4, 4);
        u = bswap32(u);
        int32_t s;
        std::memcpy(&s, &u, 4);
        out[i] = (DST)s;
      }
      break;
    }
    case 5: {
      if (sizeof(DST) == 4) {   // float to float32: a byte swap the
        uint32_t* o = reinterpret_cast<uint32_t*>(out);   // compiler
        for (int64_t i = 0; i < n; ++i) {                  // vectorizes
          uint32_t u;
          std::memcpy(&u, raw + i * 4, 4);
          o[i] = bswap32(u);
        }
        break;
      }
      for (int64_t i = 0; i < n; ++i) {
        uint32_t u;
        std::memcpy(&u, raw + i * 4, 4);
        u = bswap32(u);
        float s;
        std::memcpy(&s, &u, 4);
        out[i] = (DST)s;
      }
      break;
    }
    case 6: {
      if (sizeof(DST) == 8) {   // double to float64: a byte swap
        uint64_t* o = reinterpret_cast<uint64_t*>(out);
        for (int64_t i = 0; i < n; ++i) {
          uint64_t u;
          std::memcpy(&u, raw + i * 8, 8);
          o[i] = bswap64(u);
        }
        break;
      }
      for (int64_t i = 0; i < n; ++i) {
        uint64_t u;
        std::memcpy(&u, raw + i * 8, 8);
        u = bswap64(u);
        double s;
        std::memcpy(&s, &u, 8);
        out[i] = (DST)s;
      }
      break;
    }
    default:
      return false;
  }
  return true;
}

}  // namespace

extern "C" {

void ltnc_close(void* h) {
  auto* f = static_cast<File*>(h);
  if (!f) return;
  if (f->map) munmap(const_cast<char*>(f->map), (size_t)f->map_len);
  if (f->fd >= 0) close(f->fd);
  delete f;
}

void* ltnc_open(const char* path) {
  File* f = parse(path);
  if (!f->error.empty() || f->fd < 0) {
    ltnc_close(f);
    return nullptr;
  }
  return f;
}

long long ltnc_numrecs(void* h) { return static_cast<File*>(h)->numrecs; }

int ltnc_num_vars(void* h) {
  return (int)static_cast<File*>(h)->vars.size();
}

// Copies the variable name into out (cap bytes incl. NUL); returns len.
int ltnc_var_name(void* h, int vid, char* out, int cap) {
  auto* f = static_cast<File*>(h);
  if (vid < 0 || vid >= (int)f->vars.size()) return -1;
  const auto& s = f->vars[vid].name;
  int n = (int)s.size() < cap - 1 ? (int)s.size() : cap - 1;
  std::memcpy(out, s.data(), n);
  out[n] = '\0';
  return (int)s.size();
}

int ltnc_find_var(void* h, const char* name) {
  auto* f = static_cast<File*>(h);
  for (size_t i = 0; i < f->vars.size(); ++i)
    if (f->vars[i].name == name) return (int)i;
  return -1;
}

int ltnc_var_ndims(void* h, int vid) {
  auto* f = static_cast<File*>(h);
  if (vid < 0 || vid >= (int)f->vars.size()) return -1;
  return (int)f->vars[vid].dimids.size();
}

int ltnc_var_isrec(void* h, int vid) {
  auto* f = static_cast<File*>(h);
  if (vid < 0 || vid >= (int)f->vars.size()) return -1;
  return f->vars[vid].record ? 1 : 0;
}

// shape with the record dim resolved to numrecs
void ltnc_var_shape(void* h, int vid, long long* out) {
  auto* f = static_cast<File*>(h);
  const auto& v = f->vars[vid];
  for (size_t d = 0; d < v.dimids.size(); ++d) {
    int64_t len = f->dimlen[v.dimids[d]];
    out[d] = (d == 0 && v.record) ? f->numrecs : len;
  }
}

// Read one record (rec >= 0: of a record variable, or index rec of a
// fixed-size variable's leading dimension) or the whole variable
// (rec < 0).  out receives float32 (want=0) or float64 (want=1).
// Returns number of elements written, or -1.
long long ltnc_read(void* h, int vid, long long rec, void* out, int want) {
  auto* f = static_cast<File*>(h);
  if (vid < 0 || vid >= (int)f->vars.size()) return -1;
  const auto& v = f->vars[vid];
  int64_t n, off;
  if (v.record && rec >= 0) {
    n = v.n_per_rec;
    off = v.begin + rec * f->recsize;
  } else if (!v.record && rec >= 0) {  // one slab of a fixed leading dim
    const int64_t d0 = v.dimids.empty() ? 0 : f->dimlen[v.dimids[0]];
    if (rec >= d0) return -1;
    n = v.n_per_rec / d0;
    off = v.begin + rec * n * type_size(v.type);
  } else if (!v.record) {
    n = v.n_per_rec;
    off = v.begin;
  } else {  // whole record variable: strided, read record by record
    if (f->numrecs < 0) return -1;
    int64_t total = 0;
    for (int64_t rr = 0; rr < f->numrecs; ++rr) {
      char* dst = static_cast<char*>(out) +
                  (int64_t)v.n_per_rec * rr * (want ? 8 : 4);
      long long w = ltnc_read(h, vid, rr, dst, want);
      if (w < 0) return -1;
      total += w;
    }
    return total;
  }
  bool ok = want ? read_convert<double>(f, v, off, n, (double*)out)
                 : read_convert<float>(f, v, off, n, (float*)out);
  return ok ? n : -1;
}

// Read rows [row_lo, row_hi) of the second-to-last axis (ROMS eta of
// ([K,] eta, xi) records) of one record (rec >= 0: of a record variable,
// or index rec of a fixed-size variable's leading dimension) or of a
// whole fixed-size variable (rec < 0), every leading index in turn: one
// copy per level.  out receives float32 (want=0) or float64 (want=1),
// shape (..., row_hi - row_lo, xi).  Returns the number of elements
// written, or -1 (too few dims, rows outside the axis).
long long ltnc_read_rows(void* h, int vid, long long rec, long long row_lo,
                         long long row_hi, void* out, int want) {
  auto* f = static_cast<File*>(h);
  if (vid < 0 || vid >= (int)f->vars.size()) return -1;
  const auto& v = f->vars[vid];
  if (v.record && rec < 0) return -1;
  const size_t first = rec >= 0 ? 1 : 0;   // the leading index picked
  if (v.dimids.size() < first + 2) return -1;
  const int64_t nx = f->dimlen[v.dimids.back()];
  const int64_t ny = f->dimlen[v.dimids[v.dimids.size() - 2]];
  if (row_lo < 0 || row_hi > ny || row_lo > row_hi) return -1;
  int64_t lead = 1;
  for (size_t d = first; d + 2 < v.dimids.size(); ++d)
    lead *= f->dimlen[v.dimids[d]];
  const int64_t ts = type_size(v.type);
  int64_t base = v.begin;
  if (v.record) {
    base += rec * f->recsize;
  } else if (rec >= 0) {
    if (rec >= f->dimlen[v.dimids[0]]) return -1;
    base += rec * lead * ny * nx * ts;
  }
  const int64_t nrow = row_hi - row_lo;
  const int64_t n = nrow * nx;
  for (int64_t k = 0; k < lead; ++k) {
    const int64_t off = base + (k * ny + row_lo) * nx * ts;
    bool ok = want ? read_convert<double>(f, v, off, n,
                                          (double*)out + k * n)
                   : read_convert<float>(f, v, off, n, (float*)out + k * n);
    if (!ok) return -1;
  }
  return lead * n;
}

}  // extern "C"
