// Parallel chunk reader/decompressor for the zarr-v2 store (the port's
// copy of deepsphere_weather_tpu/native/chunkio.cpp).
//
// Native equivalent of the reference's C++-backed data loading (the torch
// DataLoader worker machinery, SURVEY.md §2.14 "host data loading"): reads
// N chunk files and zlib-inflates them into a caller-provided contiguous
// buffer using a thread pool — one syscall + inflate per chunk with zero
// Python-interpreter involvement. Missing chunk files are left untouched
// (caller pre-fills the buffer with fill_value).
//
// Built at first use by native/build.py (g++, linked against the system
// zlib; libblosc is opened with dlopen when a blosc store is read).

#include <atomic>
#include <cerrno>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <mutex>
#include <thread>
#include <vector>

#include <dlfcn.h>
#include <zlib.h>

namespace {

// codec ids shared with native/chunkio.py
enum Codec { kRaw = 0, kZlib = 1, kBlosc = 2 };

// blosc enters via dlopen of the system c-blosc (the library numcodecs
// wraps — the reference's stores are numcodecs.Blosc zstd/lz4,
// reference scripts/03c:320-331). Only the thread-safe _ctx call is used.
typedef int (*blosc_decompress_ctx_t)(const void*, void*, size_t, int);
blosc_decompress_ctx_t g_blosc_decompress = nullptr;
std::once_flag g_blosc_once;

void load_blosc() {
  const char* names[] = {"libblosc.so.1", "libblosc.so", "libblosc.1.dylib"};
  for (const char* name : names) {
    void* h = dlopen(name, RTLD_NOW | RTLD_GLOBAL);
    if (!h) continue;
    void* sym = dlsym(h, "blosc_decompress_ctx");
    if (sym) {
      g_blosc_decompress = reinterpret_cast<blosc_decompress_ctx_t>(sym);
      return;
    }
    dlclose(h);
  }
}

// Inflate `src` (zlib stream) into exactly `dst_len` bytes at `dst`.
// Returns 0 on success.
int inflate_exact(const unsigned char* src, size_t src_len,
                  unsigned char* dst, size_t dst_len) {
  z_stream zs;
  std::memset(&zs, 0, sizeof(zs));
  if (inflateInit(&zs) != Z_OK) return -1;
  zs.next_in = const_cast<unsigned char*>(src);
  zs.avail_in = static_cast<uInt>(src_len);
  zs.next_out = dst;
  zs.avail_out = static_cast<uInt>(dst_len);
  int rc = inflate(&zs, Z_FINISH);
  inflateEnd(&zs);
  return (rc == Z_STREAM_END && zs.total_out == dst_len) ? 0 : -2;
}

int read_one(const char* path, unsigned char* out, int64_t chunk_bytes,
             int codec, std::vector<unsigned char>& scratch) {
  FILE* f = std::fopen(path, "rb");
  if (!f) {
    // only true absence is "missing"; transient failures (EMFILE,
    // EACCES, ...) must surface as errors, not silent fill-value rows
    return errno == ENOENT ? 1 : -5;
  }
  std::fseek(f, 0, SEEK_END);
  long fsize = std::ftell(f);
  std::fseek(f, 0, SEEK_SET);
  int rc = 0;
  if (codec == kRaw) {
    if (fsize != chunk_bytes) {
      rc = -3;
    } else if (std::fread(out, 1, (size_t)fsize, f) != (size_t)fsize) {
      rc = -4;
    }
  } else {
    scratch.resize((size_t)fsize);
    if (std::fread(scratch.data(), 1, (size_t)fsize, f) != (size_t)fsize) {
      rc = -4;
    } else if (codec == kZlib) {
      rc = inflate_exact(scratch.data(), (size_t)fsize, out,
                         (size_t)chunk_bytes);
    } else if (codec == kBlosc) {
      if (!g_blosc_decompress) {
        rc = -6;  // libblosc unavailable (Python side pre-checks this)
      } else {
        int n = g_blosc_decompress(scratch.data(), out,
                                   (size_t)chunk_bytes, 1);
        rc = (n == (int)chunk_bytes) ? 0 : -7;
      }
    } else {
      rc = -8;  // unknown codec id
    }
  }
  std::fclose(f);
  return rc < 0 ? rc : 0;
}

}  // namespace

extern "C" {

// paths: array of n char pointers. out: n * chunk_bytes buffer.
// status: n bytes, set to 1 where the chunk file was absent (the caller
// fills those rows with the array fill value — no pre-existence check on
// the Python side, so there is no check/read race). Returns 0 on success,
// the first I/O/decompress error code otherwise.
int64_t dsw_read_chunks(const char** paths, int64_t n, int64_t chunk_bytes,
                        int32_t codec, unsigned char* out,
                        unsigned char* status, int32_t n_threads) {
  if (n <= 0) return 0;
  if (codec == kBlosc) std::call_once(g_blosc_once, load_blosc);
  if (n_threads < 1) n_threads = 1;
  if (n_threads > n) n_threads = (int32_t)n;
  std::atomic<int64_t> next(0);
  std::atomic<int64_t> err(0);
  auto worker = [&]() {
    std::vector<unsigned char> scratch;
    for (;;) {
      int64_t i = next.fetch_add(1);
      if (i >= n) break;
      int rc = read_one(paths[i], out + i * chunk_bytes, chunk_bytes,
                        codec, scratch);
      status[i] = (rc == 1) ? 1 : 0;
      if (rc < 0) {
        int64_t expect = 0;
        err.compare_exchange_strong(expect, (int64_t)rc);
      }
    }
  };
  if (n_threads == 1) {
    worker();
  } else {
    std::vector<std::thread> pool;
    pool.reserve(n_threads);
    for (int32_t t = 0; t < n_threads; ++t) pool.emplace_back(worker);
    for (auto& th : pool) th.join();
  }
  return err.load();
}

}  // extern "C"
