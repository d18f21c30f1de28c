// Native Analyze 7.5 decoder, a copy of the single-volume decoder of
// tpureg's native/analyze_reader.cc for tpureg_torch (its threaded batch
// loader, which nothing calls, is left out).
//
// The byte-level work of reading a volume, in C++: type conversion
// (uint8/int16/int32/float32 → float32) and an optional byte swap.
//
// Exposed C ABI (consumed from Python via ctypes, tpureg_torch/data/analyze.py):
//   analyze_decode(path, count, offset, datatype, swap, out) -> 0 on success
//
// Built at first use by tpureg_torch/data/analyze.py with the host C++
// compiler and native/Makefile's flags (-O3 -std=c++17 -fPIC -Wall -pthread
// -shared) into build/tpureg_torch/.

#include <cstdint>
#include <cstdio>
#include <cstring>
#include <algorithm>
#include <vector>

namespace {

template <typename T>
bool convert(FILE* f, int64_t count, bool swap, float* out) {
  constexpr int64_t kChunk = 1 << 20;
  std::vector<T> buf(static_cast<size_t>(std::min(count, kChunk)));
  int64_t done = 0;
  while (done < count) {
    int64_t n = std::min(count - done, kChunk);
    if (fread(buf.data(), sizeof(T), n, f) != static_cast<size_t>(n))
      return false;
    if (swap && sizeof(T) > 1) {
      for (int64_t i = 0; i < n; ++i) {
        T v = buf[i];
        unsigned char* p = reinterpret_cast<unsigned char*>(&v);
        for (size_t a = 0, b = sizeof(T) - 1; a < b; ++a, --b)
          std::swap(p[a], p[b]);
        buf[i] = v;
      }
    }
    for (int64_t i = 0; i < n; ++i)
      out[done + i] = static_cast<float>(buf[i]);
    done += n;
  }
  return true;
}

int decode_one(const char* path, int64_t count, int64_t offset, int datatype,
               int swap, float* out) {
  FILE* f = fopen(path, "rb");
  if (!f) return 1;
  if (offset > 0 && fseek(f, static_cast<long>(offset), SEEK_SET) != 0) {
    fclose(f);
    return 2;
  }
  bool ok = false;
  switch (datatype) {
    case 2:  ok = convert<uint8_t>(f, count, false, out); break;
    case 4:  ok = convert<int16_t>(f, count, swap != 0, out); break;
    case 8:  ok = convert<int32_t>(f, count, swap != 0, out); break;
    case 16: ok = convert<float>(f, count, swap != 0, out); break;
    default: ok = false;
  }
  fclose(f);
  return ok ? 0 : 3;
}

}  // namespace

extern "C" {

int analyze_decode(const char* path, long long count, long long offset,
                   int datatype, int swap, float* out) {
  return decode_one(path, count, offset, datatype, swap, out);
}

}  // extern "C"
