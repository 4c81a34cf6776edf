// M2 validation harness: for every CABAC slice in an Annex-B H.264 stream,
// spec-decode all bins with the syntax walker, then re-encode them with the
// spec CABAC encoder and byte-compare against the original slice data.
// Any context-derivation or binarization error diverges the re-encoded bytes
// (usually the decode itself derails first). This is the test shape SURVEY.md
// §4 identifies from the reference's own debugging relics
// (reference test/arithmetic_code.cpp:66-91).
//
// Usage: check_syntax <stream.264> [-v]
#include <cstdio>
#include <cstring>
#include <fstream>
#include <map>
#include <vector>

#include "avrecode_jax/native/bitstream.h"
#include "avrecode_jax/native/h264_params.h"
#include "avrecode_jax/native/h264_slice.h"
#include "avrecode_jax/native/nal.h"
#include "avrecode_jax/native/symbol_stream.h"

using namespace artc;

int main(int argc, char** argv) {
  if (argc < 2) { fprintf(stderr, "usage: %s stream.264 [-v]\n", argv[0]); return 2; }
  bool verbose = argc > 2 && !strcmp(argv[2], "-v");
  std::ifstream f(argv[1], std::ios::binary);
  std::vector<uint8_t> data((std::istreambuf_iterator<char>(f)), std::istreambuf_iterator<char>());
  if (data.empty()) { fprintf(stderr, "empty file\n"); return 1; }

  auto nals = find_nals_annexb(data.data(), data.size());
  std::map<int, SPS> sps_map;
  std::map<int, PPS> pps_map;
  PictureState pic;
  int slice_id = 0;
  int n_slices = 0, n_ok = 0, n_fail = 0, n_unsupported = 0;
  size_t total_bins = 0;

  for (const auto& nal : nals) {
    const uint8_t* p = data.data() + nal.offset;
    if (nal.size < 1) continue;  // zero-length unit (adjacent start codes)
    std::vector<uint8_t> rbsp;
    try {
      rbsp = ebsp_to_rbsp(p + 1, nal.size - 1);
      if (nal.type == 7) {
        SPS s = parse_sps(rbsp.data(), rbsp.size());
        sps_map[s.sps_id] = s;
        if (verbose) fprintf(stderr, "SPS %d: %dx%d mbs profile %d\n", s.sps_id, s.mb_width(), s.mb_height(), s.profile_idc);
      } else if (nal.type == 8) {
        PPS q = parse_pps(rbsp.data(), rbsp.size());
        pps_map[q.pps_id] = q;
        if (verbose) fprintf(stderr, "PPS %d: cabac=%d 8x8=%d\n", q.pps_id, q.entropy_coding_mode, q.transform_8x8_mode);
      } else if (nal.type == 1 || nal.type == 5) {
        const SPS* sps; const PPS* pps;
        SliceHeader sh = parse_slice_header(rbsp.data(), rbsp.size(), nal.type, nal.ref_idc,
                                            sps_map, pps_map, &sps, &pps);
        if (!pps->entropy_coding_mode) { ++n_unsupported; continue; }  // CAVLC
        ++n_slices;
        if (sh.first_mb_in_slice == 0) {
          pic.reset(sps->mb_width(), sh.pic_mb_height(*sps));
        }
        ++slice_id;
        SymbolStream ss;
        int slice_class = sh.is_intra() ? 0 : (sh.is_b() ? 2 : 1);
        ss.event(kEvBeginSlice,
                 (sh.is_intra() ? 1 : 0) | (sh.first_mb_in_slice == 0 ? 2 : 0) | (slice_class << 2),
                 sps->mb_width(), sh.pic_mb_height(*sps),
                 sh.slice_qp | (sh.cabac_init_idc << 16));
        RecordingSource src(rbsp.data(), rbsp.size(), sh.data_bit_offset, sh.is_intra(),
                            sh.cabac_init_idc, sh.slice_qp, &ss);
        SliceWalker<RecordingSource> walker(*sps, *pps, sh, pic, slice_id, src);
        int mbs = walker.run();
        total_bins += ss.bins.size();

        // Re-encode and byte-compare against the original slice data.
        std::vector<uint8_t> re = reencode_symbol_stream(ss, sh.is_intra(), sh.cabac_init_idc,
                                                         sh.slice_qp);
        size_t data_start = sh.data_bit_offset / 8;
        size_t orig_len = rbsp.size() - data_start;
        size_t diff0 = 0;
        size_t lim0 = std::min(re.size(), orig_len);
        while (diff0 < lim0 && re[diff0] == rbsp[data_start + diff0]) ++diff0;
        bool exact = re.size() <= orig_len && diff0 == re.size();
        // x264 injects a frame-number-derived padding bit in its CABAC flush,
        // so the final 1-2 bytes may differ from the spec-exact flush; the
        // container stores those as a tiny tail patch (the reference's
        // last_byte/length_parity analogue, recode.proto:15-16).
        bool ok = exact || (re.size() == orig_len && diff0 + 2 >= re.size());
        size_t tail = exact ? orig_len - re.size() : re.size() - diff0;
        if (ok) {
          ++n_ok;
          if (verbose)
            fprintf(stderr, "slice ok: type=%d mbs=%d bins=%zu bytes=%zu tail=%zu overread=%zu\n",
                    int(sh.slice_type), mbs, ss.bins.size(), re.size(), tail,
                    src.decoder().overread_bits());
        } else {
          ++n_fail;
          size_t diff = 0;
          size_t lim = std::min(re.size(), orig_len);
          while (diff < lim && re[diff] == rbsp[data_start + diff]) ++diff;
          fprintf(stderr,
                  "slice FAIL: type=%d first_mb=%d mbs=%d bins=%zu re=%zu orig=%zu first_diff=%zu\n",
                  int(sh.slice_type), sh.first_mb_in_slice, mbs, ss.bins.size(), re.size(),
                  orig_len, diff);
        }
      }
    } catch (const UnsupportedStream& e) {
      ++n_unsupported;
      fprintf(stderr, "unsupported NAL type=%d: %s\n", nal.type, e.what());
    } catch (const std::exception& e) {
      ++n_fail;
      fprintf(stderr, "ERROR NAL type=%d offset=%zu: %s\n", nal.type, nal.offset, e.what());
    }
  }
  printf("slices=%d ok=%d fail=%d unsupported=%d total_bins=%zu\n", n_slices, n_ok, n_fail,
         n_unsupported, total_bins);
  return n_fail == 0 && n_ok > 0 ? 0 : 1;
}
