// ThreadSanitizer harness: drives every threaded pipeline in the library
// (pass-1 slice walkers, sectioned/chunked model+encode pool, the shared
// nz-mode probe threads, chunk-parallel decompress) in one process so TSAN
// can watch them. Build + run (tests/test_coder.py::test_tsan_clean does
// this when ARTC_TSAN=1):
//
//   g++ -fsanitize=thread -O1 -g -I avrecode_jax/native \
//       -o /tmp/tsan_check avrecode_jax/native/recode.cc tools/tsan_check.cc \
//       -lpthread
//   /tmp/tsan_check <clip> ...
//
// Exits 0 on bit-exact roundtrips; TSAN itself exits non-zero on a race.
#include <cstdio>
#include <cstring>
#include <fstream>
#include <vector>

#include "recode.h"

extern "C" {
void* artc_session_open(const uint8_t*, size_t, int, int, uint32_t, int);
void artc_session_close(void*);
int artc_session_analyze_begin(void*, int, int);
int artc_session_analyze_header(void*, uint8_t**, size_t*);
int artc_session_analyze_chunk(void*, uint32_t, uint8_t**, size_t*);
void artc_free(uint8_t*);
const char* artc_last_error();
}

int main(int argc, char** argv) {
  if (argc < 2) {
    fprintf(stderr, "usage: tsan_check <clip> [clip ...]\n");
    return 2;
  }
  for (int a = 1; a < argc; ++a) {
    std::ifstream f(argv[a], std::ios::binary);
    std::vector<uint8_t> data((std::istreambuf_iterator<char>(f)),
                              std::istreambuf_iterator<char>());
    if (data.empty()) {
      fprintf(stderr, "cannot read %s\n", argv[a]);
      return 2;
    }
    for (int chunk_mode = 0; chunk_mode <= 1; ++chunk_mode) {
      artc::Options opt;
      opt.chunk_mode = chunk_mode;
      opt.batch_size = 1024;
      opt.section_bins = 50000;  // tiny sections: force the section pool
      artc::Stats st;
      auto comp = artc::compress(data.data(), data.size(), opt, &st);
      auto dec = artc::decompress(comp.data(), comp.size(), nullptr);
      if (dec != data) {
        fprintf(stderr, "roundtrip mismatch on %s (chunk_mode=%d)\n", argv[a],
                chunk_mode);
        return 1;
      }
    }
    // Session analyze ABI: pipelined open (pass1 + probe + chunk-0
    // pre-analyze threads) feeding the streaming per-chunk export workers.
    {
      setenv("ARTC_SECTION_BINS", "50000", 1);
      void* h = artc_session_open(data.data(), data.size(), 16, 0, 1024, 2);
      if (!h) {
        fprintf(stderr, "session_open failed: %s\n", artc_last_error());
        return 1;
      }
      int n = artc_session_analyze_begin(h, 16, 0);
      if (n < 0) {
        fprintf(stderr, "analyze_begin failed: %s\n", artc_last_error());
        return 1;
      }
      uint8_t* out = nullptr;
      size_t out_len = 0;
      if (artc_session_analyze_header(h, &out, &out_len)) return 1;
      artc_free(out);
      for (int c = 0; c < n; ++c) {
        if (artc_session_analyze_chunk(h, uint32_t(c), &out, &out_len)) {
          fprintf(stderr, "analyze_chunk %d failed: %s\n", c, artc_last_error());
          return 1;
        }
        artc_free(out);
      }
      artc_session_close(h);
      unsetenv("ARTC_SECTION_BINS");
    }
    printf("%s ok\n", argv[a]);
  }
  return 0;
}
