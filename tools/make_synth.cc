// Synthetic H.264 stream generator for syntax configurations x264 cannot emit
// (PAFF field pictures; progressive mode also available for cross-checks).
//
// Method: drive this repo's SliceWalker with a pseudorandom decision source —
// the walker only follows decisions, so any decision sequence it accepts forms
// a spec-consistent slice_data() by construction; the source encodes every bin
// with the spec CABAC encoder at the walker-chosen contexts, yielding valid
// slice bytes. SPS/PPS/slice headers are written directly. The generated
// stream is then decoded with the SYSTEM libavcodec (fully independent of our
// engine) under AV_EF_EXPLODE as a strict spec-validity oracle.
//
// Semantic-legality policy (so the oracle passes, not just the parse):
//  - unary runs capped (ref_idx <= 1 < num_ref_idx_active=2; qp_delta small),
//  - MBs whose left or top neighbor is unavailable ("safe MBs") are forced to
//    all-DC intra prediction: I slices pick I_NxN with
//    prev_intra_pred_flag=1 everywhere (predicted mode degrades to DC when a
//    neighbor is missing, 8.3.1.1) and chroma DC; P slices pick inter.
//    MBs with both neighbors available get unrestricted syntax (every pred
//    mode is legal there; top-right is substituted per 8.3.1.2.1).
//
// Usage: make_synth <out.264> [w=320] [h=240] [fields=8] [seed=1] [qp=26]
//                   [ptype=1 (0: I fields only)] [slices=1] [pcm=0]
//                   [paff=1 (0: progressive frames)] [cavlc=0]
//                   [planes=1 (3: separate colour planes)] [oracle=1]
//
// Reference context: the reference cannot recompress field-coded streams (its
// hooks were only exercised on progressive footage). x264 implements MBAFF
// only, so PAFF coverage requires synthesis.
#include <algorithm>
#include <cstdio>
#include <cstring>
#include <map>
#include <string>
#include <vector>

#include "avrecode_jax/native/bitstream.h"
#include "avrecode_jax/native/cabac.h"
#include "avrecode_jax/native/cavlc_stream.h"
#include "avrecode_jax/native/h264_cavlc.h"
#include "avrecode_jax/native/h264_params.h"
#include "avrecode_jax/native/h264_slice.h"
#include "avrecode_jax/native/nal.h"

extern "C" {
#include <libavcodec/avcodec.h>
}

using namespace artc;

namespace {

// xorshift64* PRNG (deterministic across platforms).
struct Rng {
  uint64_t s;
  explicit Rng(uint64_t seed) : s(seed ? seed : 0x9E3779B97F4A7C15ull) {}
  uint64_t next() {
    s ^= s >> 12;
    s ^= s << 25;
    s ^= s >> 27;
    return s * 0x2545F4914F6CDD1Dull;
  }
  bool chance(int num) { return int(next() >> 58) < num; }  // P = num/64
};

class SynthSource {
 public:
  SynthSource(bool intra_slice, int cabac_init_idc, int slice_qp, int first_mb, int num_mbs,
              int mb_width, Rng& rng, bool allow_pcm, int max_ref)
      : rng_(rng),
        intra_slice_(intra_slice),
        first_mb_(first_mb),
        num_mbs_(num_mbs),
        mb_w_(mb_width),
        allow_pcm_(allow_pcm),
        max_ref_(max_ref) {
    ctxs_.init(intra_slice, cabac_init_idc, slice_qp);
  }

  int decision(int ctx, BinKlass, int = -1) {
    int bit;
    if (safe_ && first_dec_ && intra_slice_) {
      bit = 0;  // I_NxN
    } else if (safe_ && ctx == kCtxIntra4x4PredFlag) {
      bit = 1;  // use predicted mode (degrades to DC at unavailable edges)
    } else if (safe_ && ctx >= kCtxChromaPred && ctx <= kCtxChromaPred + 3) {
      bit = 0;  // chroma DC
    } else if (safe_ && ctx == kCtxMbTypeP) {
      bit = 0;  // inter MB in safe P MBs
    } else if (ctx == kCtxRefIdx + 4 || ctx == kCtxRefIdx + 5) {
      bit = 0;  // ref_idx unary continuation: cap ref_idx at 1 (< active 2)
    } else if (max_ref_ <= 1 && ctx >= kCtxRefIdx && ctx < kCtxRefIdx + 4) {
      bit = 0;  // single-entry list: ref_idx must be 0
    } else {
      bit = pick(ctx);
      // Unary-run cap at 7 consecutive ones (mvd prefix, qp_delta, level
      // prefix all stay far inside their legal/semantic ranges).
      if (bit && run_ctx_ == ctx && run_len_ >= 7) bit = 0;
      if (bit && run_ctx_ == ctx) ++run_len_;
      else if (bit) { run_ctx_ = ctx; run_len_ = 1; }
      else if (run_ctx_ == ctx) { run_ctx_ = -1; run_len_ = 0; }
    }
    first_dec_ = false;
    enc_.encode_decision(ctxs_, ctx, bit);
    return bit;
  }
  int bypass(BinKlass, int aux = -1) {
    (void)aux;
    int bit = rng_.chance(24) ? 1 : 0;  // p(1) = 3/8, keeps EG suffixes short
    if (bit && ++byp_run_ > 3) bit = 0;
    if (!bit) byp_run_ = 0;
    enc_.encode_bypass(bit);
    return bit;
  }
  int terminate(bool end_of_slice = true) {
    int bit;
    if (end_of_slice) {
      ++mbs_done_;
      bit = mbs_done_ >= num_mbs_ ? 1 : 0;
    } else {
      // I_PCM selection bin: occasionally pick PCM in unrestricted MBs.
      bit = (allow_pcm_ && !safe_ && rng_.chance(6)) ? 1 : 0;
    }
    enc_.encode_terminate(bit);
    return bit;
  }
  int sig_bin(int ctx, int) {
    int bit = pick(ctx);
    enc_.encode_decision(ctxs_, ctx, bit);
    return bit;
  }
  int eob_bin(int ctx, int) {
    int bit = pick(ctx);
    enc_.encode_decision(ctxs_, ctx, bit);
    return bit;
  }
  int res_bin(int ctx, int) {
    int bit = pick(ctx);
    enc_.encode_decision(ctxs_, ctx, bit);
    return bit;
  }
  void implicit_sig_last(int) {}
  void pcm_block(int n) {
    int npad = enc_.pcm_pad_width();
    uint32_t pad = 0;
    for (int b = 0; b < npad; ++b) pad = (pad << 1) | (rng_.chance(32) ? 1 : 0);
    std::vector<uint8_t> buf(static_cast<size_t>(n), 0);
    for (int i = 0; i < n; ++i) buf[i] = uint8_t(rng_.next());
    enc_.pcm_bytes(buf.data(), buf.size(), pad, npad);
  }
  void begin_mb(int x, int y) {
    int addr = y * mb_w_ + x;
    bool left = x > 0 && addr - 1 >= first_mb_;
    bool top = y > 0 && addr - mb_w_ >= first_mb_;
    safe_ = !(left && top);
    first_dec_ = true;
  }
  void begin_block(int, int, int) {}
  void end_block() {}

  std::vector<uint8_t> take_bytes() { return enc_.take_bytes(); }

 private:
  int pick(int ctx) {
    // P(bit == MPS) grows with the state index: 40/64 at state 0 to ~63/64.
    int st = ctxs_.p_state[ctx];
    int mps_num = 40 + (st * 23) / 63;
    int mps = ctxs_.val_mps[ctx];
    return rng_.chance(mps_num) ? mps : 1 - mps;
  }

  Rng& rng_;
  CabacContexts ctxs_;
  CabacEncoder enc_;
  bool intra_slice_;
  int first_mb_, num_mbs_, mb_w_;
  bool allow_pcm_;
  int max_ref_;
  int mbs_done_ = 0;
  int run_ctx_ = -1, run_len_ = 0, byp_run_ = 0;
  bool safe_ = true, first_dec_ = true;
};

// CAVLC generating value source: plugs into CavlcReplayer as its ValueSource;
// invents spec-valid syntax values (ranges derived from each role's aux and
// remembered block state), the replayer renders the canonical VLC bits.
// Intra-legality policy mirrors SynthSource: MBs missing a left/top neighbor
// are all-DC I_NxN (or inter in P slices).
class CavlcGenSource {
 public:
  CavlcGenSource(Rng& rng, bool intra_slice, int first_mb, int num_mbs, int mb_w,
                 bool allow_pcm, int max_ref)
      : rng_(rng),
        intra_(intra_slice),
        first_mb_(first_mb),
        num_mbs_(num_mbs),
        mb_w_(mb_w),
        allow_pcm_(allow_pcm),
        max_ref_(max_ref) {}

  bool more_data() const { return mbs_done_ < num_mbs_; }
  void begin_mb(int x, int y) {
    ++mbs_done_;
    int addr = y * mb_w_ + x;
    bool left = x > 0 && addr - 1 >= first_mb_;
    bool top = y > 0 && addr - mb_w_ >= first_mb_;
    safe_ = !(left && top);
  }

  int32_t next(uint8_t role, uint8_t aux) {
    switch (role) {
      case kRMbSkipRun: {
        int rem = num_mbs_ - mbs_done_;
        int r = int(rng_.next() % 3);  // 0..2, occasionally a trailing run
        if (rng_.chance(4)) r = rem;
        return r < rem ? r : rem;
      }
      case kRMbType:
        if (intra_) {
          if (safe_) return 0;  // I_NxN, all-DC via pred flags
          if (allow_pcm_ && rng_.chance(3)) return 25;  // I_PCM
          return rng_.chance(40) ? 0 : int32_t(1 + rng_.next() % 24);
        }
        if (!safe_ && rng_.chance(8)) return int32_t(5 + rng_.next() % 25);  // intra in P
        return int32_t(rng_.next() % 5);  // P_L0 16x16/16x8/8x16/8x8/8x8ref0
      case kRIntraPredFlag: return safe_ ? 1 : int32_t(rng_.next() & 1);
      case kRIntraPredRem: return int32_t(rng_.next() & 7);
      case kRChromaPred: return safe_ ? 0 : int32_t(rng_.next() & 3);
      case kRRefIdx: return max_ref_ > 1 ? int32_t(rng_.next() & 1) : 0;
      case kRMvd: return int32_t(rng_.next() % 7) - 3;
      case kRCbp: return int32_t(rng_.next() & 15);
      case kRQpDelta: return int32_t(rng_.next() % 5) - 2;
      case kRSubMbType: return int32_t(rng_.next() & 3);
      case kRTransform8x8: return int32_t(rng_.next() & 1);
      case kRTotalCoeff: {
        // Small counts keep every downstream bound valid regardless of the
        // block's max_coeff (>= 4 for the smallest, 2x2 chroma DC).
        int tc = 0;
        while (tc < 4 && rng_.chance(28)) ++tc;
        last_tc_ = tc;
        return tc;
      }
      case kRT1s: {
        int cap = last_tc_ < 3 ? last_tc_ : 3;
        return int32_t(rng_.next() % uint64_t(cap + 1));
      }
      case kRT1Sign: return int32_t(rng_.next() & 1);
      case kRLevelPrefix: return int32_t(rng_.next() % 3);
      case kRLevelSuffix: {
        int nbits = aux >> 3;
        return int32_t(rng_.next() & ((1u << nbits) - 1));
      }
      case kRTotalZeros: {
        int tc = aux & 0x3f;
        int maxc = (aux & 0xC0) == 0x80 ? 4 : ((aux & 0xC0) == 0xC0 ? 8 : 15);
        int cap = maxc - tc;
        if (cap > 2) cap = 2;
        if (cap < 0) cap = 0;
        return int32_t(rng_.next() % uint64_t(cap + 1));
      }
      case kRRunBefore: {
        int zl = aux & 15;
        int cap = zl < 2 ? zl : 2;
        return int32_t(rng_.next() % uint64_t(cap + 1));
      }
      case kRPcmPad: {
        int nb = aux & 7;
        return nb ? int32_t(rng_.next() & ((1u << nb) - 1)) : 0;
      }
      case kRPcmByte: return int32_t(rng_.next() & 255);
      default:
        fprintf(stderr, "CavlcGenSource: unexpected role %d\n", role);
        abort();
    }
  }

 private:
  Rng& rng_;
  bool intra_;
  int first_mb_, num_mbs_, mb_w_;
  bool allow_pcm_;
  int max_ref_;
  int mbs_done_ = 0;
  int last_tc_ = 0;
  bool safe_ = true;
};

void append_nal(std::vector<uint8_t>& out, int ref_idc, int type,
                const std::vector<uint8_t>& rbsp) {
  out.insert(out.end(), {0, 0, 0, 1});
  out.push_back(uint8_t((ref_idc << 5) | type));
  std::vector<uint8_t> ebsp = rbsp_to_ebsp(rbsp.data(), rbsp.size());
  out.insert(out.end(), ebsp.begin(), ebsp.end());
}

std::vector<uint8_t> trailing(BitWriter& bw) {
  bw.put_bit(1);
  while (!bw.byte_aligned()) bw.put_bit(0);
  return bw.bytes();
}

// Strict spec-validity oracle: system libavcodec with AV_EF_EXPLODE.
int oracle_decode(const std::vector<uint8_t>& stream, int expect_frames) {
  if (getenv("SYNTH_LOG")) av_log_set_level(AV_LOG_DEBUG);
  const AVCodec* codec = avcodec_find_decoder(AV_CODEC_ID_H264);
  AVCodecContext* c = avcodec_alloc_context3(codec);
  AVCodecParserContext* parser = av_parser_init(AV_CODEC_ID_H264);
  c->err_recognition = AV_EF_EXPLODE;
  c->thread_count = 1;
  if (!parser || avcodec_open2(c, codec, nullptr) < 0) {
    fprintf(stderr, "oracle: decoder init failed\n");
    return -1;
  }
  AVPacket* pkt = av_packet_alloc();
  AVFrame* frame = av_frame_alloc();
  int decoded = 0, rc = 0;
  const uint8_t* p = stream.data();
  size_t left = stream.size();
  bool parser_done = false;
  while (!parser_done && rc == 0) {
    uint8_t* od = nullptr;
    int os = 0;
    // size 0 = parser flush round (drains the last buffered access unit).
    int used = av_parser_parse2(parser, c, &od, &os, p, int(left), AV_NOPTS_VALUE,
                                AV_NOPTS_VALUE, 0);
    if (used < 0) { rc = 1; break; }
    if (left == 0) parser_done = true;
    p += used;
    left -= size_t(used);
    if (os > 0) {
      pkt->data = od;
      pkt->size = os;
      if (avcodec_send_packet(c, pkt) < 0) { rc = 1; break; }
      while (avcodec_receive_frame(c, frame) == 0) ++decoded;
    }
  }
  if (rc == 0) {
    avcodec_send_packet(c, nullptr);
    while (avcodec_receive_frame(c, frame) == 0) ++decoded;
  }
  av_frame_free(&frame);
  av_packet_free(&pkt);
  av_parser_close(parser);
  avcodec_free_context(&c);
  if (rc) {
    fprintf(stderr, "oracle: libavcodec rejected the stream\n");
    return -1;
  }
  if (decoded < expect_frames) {
    fprintf(stderr, "oracle: decoded %d frames, expected >= %d\n", decoded, expect_frames);
    return -1;
  }
  return decoded;
}

}  // namespace

int main(int argc, char** argv) {
  if (argc < 2) {
    fprintf(stderr, "usage: %s out.264 [k=v ...]\n", argv[0]);
    return 2;
  }
  int w = 320, h = 240, fields = 8, seed = 1, qp = 26, ptype = 1, slices = 1, pcm = 0, paff = 1;
  int planes = 1;  // 3 = separate_colour_plane_flag (each plane its own slices)
  int oracle = 1;  // 0 = skip the libavcodec validity check (see planes=3)
  int cavlc = 0;   // 1 = CAVLC slice data (entropy_coding_mode = 0)
  for (int i = 2; i < argc; ++i) {
    int v = 0;
    char k[32];
    if (sscanf(argv[i], "%31[a-z]=%d", k, &v) == 2) {
      std::string key = k;
      if (key == "w") w = v;
      else if (key == "h") h = v;
      else if (key == "fields") fields = v;
      else if (key == "seed") seed = v;
      else if (key == "qp") qp = v;
      else if (key == "ptype") ptype = v;
      else if (key == "slices") slices = v;
      else if (key == "pcm") pcm = v;
      else if (key == "paff") paff = v;
      else if (key == "planes") planes = v;
      else if (key == "oracle") oracle = v;
      else if (key == "cavlc") cavlc = v;
    }
  }
  if (planes == 3) {
    paff = 0;  // keep the separate-plane variant progressive
    // libavcodec rejects separate_colour_plane streams outright ("separate
    // color planes are not supported") — no independent oracle exists for
    // them (the reference's ffmpeg-based pipeline could never decode such
    // files either). Coverage is self-consistency only: the per-plane syntax
    // is the oracle-proven monochrome path plus the colour_plane_id field.
    oracle = 0;
  }
  if (w % 16 || h % (paff ? 32 : 16)) {
    fprintf(stderr, "w must be /16, h must be /32 for PAFF (/16 progressive)\n");
    return 2;
  }
  const int mb_w = w / 16, frame_mb_h = h / 16;
  const int pic_mb_h = paff ? frame_mb_h / 2 : frame_mb_h;
  const int num_mbs = mb_w * pic_mb_h;

  // ---- SPS (High profile; frame_mbs_only=0 + MBAFF off => pure PAFF;
  // planes=3 => High 4:4:4 Predictive with separate_colour_plane_flag) ----
  BitWriter sps;
  sps.put_bits(planes == 3 ? 244 : 100, 8);  // profile_idc
  sps.put_bits(0, 8);    // constraint flags
  sps.put_bits(30, 8);   // level 3.0
  sps.put_ue(0);         // sps_id
  sps.put_ue(planes == 3 ? 3 : 1);  // chroma_format_idc
  if (planes == 3) sps.put_bit(1);  // separate_colour_plane_flag
  sps.put_ue(0);         // bit_depth_luma_minus8
  sps.put_ue(0);         // bit_depth_chroma_minus8
  sps.put_bit(0);        // qpprime_y_zero_transform_bypass
  sps.put_bit(0);        // seq_scaling_matrix_present
  sps.put_ue(4);         // log2_max_frame_num_minus4 (=> 8 bits)
  sps.put_ue(2);         // pic_order_cnt_type 2 (POC from frame_num)
  sps.put_ue(4);         // max_num_ref_frames
  sps.put_bit(0);        // gaps_in_frame_num_value_allowed
  sps.put_ue(uint32_t(mb_w - 1));      // pic_width_in_mbs_minus1
  sps.put_ue(uint32_t(pic_mb_h - 1));  // pic_height_in_map_units_minus1
  sps.put_bit(paff ? 0 : 1);  // frame_mbs_only_flag
  if (paff) sps.put_bit(0);   // mb_adaptive_frame_field_flag = 0 (PAFF)
  sps.put_bit(1);        // direct_8x8_inference_flag
  sps.put_bit(0);        // frame_cropping
  sps.put_bit(0);        // vui_parameters_present
  std::vector<uint8_t> sps_rbsp = trailing(sps);

  // ---- PPS (CABAC, 8x8 transform on) ----
  BitWriter pps;
  pps.put_ue(0);         // pps_id
  pps.put_ue(0);         // sps_id
  pps.put_bit(cavlc ? 0 : 1);  // entropy_coding_mode
  pps.put_bit(0);        // bottom_field_pic_order_in_frame_present
  pps.put_ue(0);         // num_slice_groups_minus1
  pps.put_ue(1);         // num_ref_idx_l0_default_active_minus1 (=> 2 refs)
  pps.put_ue(0);         // num_ref_idx_l1_default_active_minus1
  pps.put_bit(0);        // weighted_pred
  pps.put_bits(0, 2);    // weighted_bipred_idc
  pps.put_se(qp - 26);   // pic_init_qp_minus26
  pps.put_se(0);         // pic_init_qs_minus26
  pps.put_se(0);         // chroma_qp_index_offset
  pps.put_bit(0);        // deblocking_filter_control_present
  pps.put_bit(0);        // constrained_intra_pred
  pps.put_bit(0);        // redundant_pic_cnt_present
  pps.put_bit(1);        // transform_8x8_mode
  pps.put_bit(0);        // pic_scaling_matrix_present
  pps.put_se(0);         // second_chroma_qp_index_offset
  std::vector<uint8_t> pps_rbsp = trailing(pps);

  std::vector<uint8_t> out;
  append_nal(out, 3, 7, sps_rbsp);
  append_nal(out, 3, 8, pps_rbsp);

  SPS psps = parse_sps(sps_rbsp.data(), sps_rbsp.size());
  PPS ppps = parse_pps(pps_rbsp.data(), pps_rbsp.size());
  std::map<int, SPS> sps_map{{0, psps}};
  std::map<int, PPS> pps_map{{0, ppps}};

  Rng rng(uint64_t(seed) * 0x9E3779B97F4A7C15ull + 7);
  PictureState pic;
  CavlcPicture cpic;
  int slice_id = 0;
  const int n_pics = paff ? fields : std::max(1, fields / 2);
  for (int f = 0; f < n_pics; ++f) {
    bool idr = f == 0;
    // Fields pair into frames: both fields of a frame share frame_num.
    int frame_num = paff ? ((f / 2) & 0xff) : (f & 0xff);
    bool bottom = paff && (f & 1) != 0;
    // ptype 2: SP slices (Extended profile switching pictures) — entropy
    // layer identical to P; header adds sp_for_switch_flag + slice_qs_delta.
    bool is_p = ptype >= 1 && f >= (paff ? 2 : 1);
    bool is_sp = ptype == 2 && is_p;
    int mbs_per_slice = (num_mbs + slices - 1) / slices;
    for (int plane = 0; plane < planes; ++plane)
    for (int s = 0; s < slices; ++s) {
      int first_mb = s * mbs_per_slice;
      int n_mbs = std::min(mbs_per_slice, num_mbs - first_mb);
      if (n_mbs <= 0) break;
      BitWriter sh;
      sh.put_ue(uint32_t(first_mb));
      sh.put_ue(is_p ? (is_sp ? 3u : 0u) : 2u);  // slice_type SP / P / I
      sh.put_ue(0);             // pps_id
      if (planes == 3) sh.put_bits(uint32_t(plane), 2);  // colour_plane_id
      sh.put_bits(uint32_t(frame_num), 8);
      if (paff) {
        sh.put_bit(1);  // field_pic_flag
        sh.put_bit(bottom ? 1 : 0);
      }
      if (idr) sh.put_ue(uint32_t(f));  // idr_pic_id
      if (is_p) {
        // Active ref count must not exceed what the DPB holds (field refs
        // for PAFF, frame refs progressive), else list entries are missing.
        int navail = paff ? f : f;  // pics decoded so far = f
        int nactive = std::min(2, navail);
        if (nactive != 2) {
          sh.put_bit(1);  // num_ref_idx_active_override
          sh.put_ue(uint32_t(nactive - 1));
        } else {
          sh.put_bit(0);  // PPS default: 2
        }
        sh.put_bit(0);  // ref_pic_list_modification_flag_l0
      }
      if (idr) {
        sh.put_bit(0);  // no_output_of_prior_pics
        sh.put_bit(0);  // long_term_reference_flag
      } else {
        sh.put_bit(0);  // adaptive_ref_pic_marking_mode
      }
      if (is_p && !cavlc) sh.put_ue(0);  // cabac_init_idc
      sh.put_se(0);            // slice_qp_delta
      if (is_sp) {
        sh.put_bit(0);  // sp_for_switch_flag
        sh.put_se(0);   // slice_qs_delta
      }
      if (!cavlc)
        while (!sh.byte_aligned()) sh.put_bit(1);  // cabac_alignment_one_bit
      std::vector<uint8_t> hdr = sh.bytes();

      // Parse the header back through our own parser (walker input).
      std::vector<uint8_t> probe = hdr;
      probe.resize(hdr.size() + 64, 0xff);
      const SPS* sp;
      const PPS* pp;
      SliceHeader shp = parse_slice_header(probe.data(), probe.size(), idr ? 5 : 1, 1,
                                           sps_map, pps_map, &sp, &pp);

      std::vector<uint8_t> rbsp;
      if (cavlc) {
        // CAVLC slice_data() continues unaligned after the header: the
        // generating source feeds values into the replayer, which renders
        // canonical VLC bits into the same writer.
        if (first_mb == 0) cpic.reset(mb_w, pic_mb_h);
        CavlcGenSource gsrc(rng, shp.is_intra(), first_mb, n_mbs, mb_w, pcm != 0,
                            is_p ? std::min(2, f) : 0);
        CavlcReplayer<CavlcGenSource> rep(gsrc, sh);
        CavlcWalker<CavlcReplayer<CavlcGenSource>> w(psps, ppps, shp, cpic, ++slice_id, rep);
        w.run();
        sh.put_bit(1);  // rbsp_stop_one_bit
        while (!sh.byte_aligned()) sh.put_bit(0);
        rbsp = sh.bytes();
      } else {
        if (first_mb == 0) pic.reset(mb_w, pic_mb_h);
        SynthSource src(shp.is_intra(), shp.cabac_init_idc, shp.slice_qp, first_mb, n_mbs,
                        mb_w, rng, pcm != 0, is_p ? std::min(2, f) : 0);
        SliceWalker<SynthSource> walker(psps, ppps, shp, pic, ++slice_id, src);
        walker.run();
        std::vector<uint8_t> data = src.take_bytes();
        rbsp = hdr;
        rbsp.insert(rbsp.end(), data.begin(), data.end());
      }
      append_nal(out, 1, idr ? 5 : 1, rbsp);
    }
  }

  int expect = paff ? n_pics / 2 : n_pics;
  int decoded = oracle ? oracle_decode(out, expect) : 0;
  if (decoded < 0) return 1;

  FILE* fo = fopen(argv[1], "wb");
  if (!fo || fwrite(out.data(), 1, out.size(), fo) != out.size()) {
    fprintf(stderr, "write failed\n");
    return 1;
  }
  fclose(fo);
  fprintf(stderr, "wrote %s (%zu bytes, %d pics, oracle %d frames)\n", argv[1], out.size(),
          n_pics, decoded);
  return 0;
}
