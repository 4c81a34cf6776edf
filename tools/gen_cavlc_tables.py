#!/usr/bin/env python3
"""Generates the H.264 CAVLC VLC tables (ITU-T H.264 Tables 9-5..9-10 and the
coded_block_pattern me(v) mappings of Table 9-4) into
avrecode_jax/native/gen/cavlc_tables.h, extracting the numeric spec data from
the system libavcodec static library (same approach as gen_cabac_tables.py)."""
import os
import subprocess
import tempfile

import numpy as np

AR = "/usr/lib/x86_64-linux-gnu/libavcodec.a"
OUT = os.path.join(os.path.dirname(__file__), "..", "avrecode_jax", "native", "gen")


def rodata(obj):
    with tempfile.TemporaryDirectory() as td:
        subprocess.run(["ar", "x", AR, obj], cwd=td, check=True)
        subprocess.run(["objcopy", "-O", "binary", "--only-section=.rodata",
                        os.path.join(td, obj), os.path.join(td, "r.bin")], check=True)
        data = open(os.path.join(td, "r.bin"), "rb").read()
        out = subprocess.run(["nm", os.path.join(td, obj)], capture_output=True, text=True,
                             check=True)
        syms = {}
        for line in out.stdout.splitlines():
            parts = line.split()
            if len(parts) == 3 and parts[1] in ("r", "R", "d", "D"):
                syms[parts[2]] = int(parts[0], 16)
        return np.frombuffer(data, np.uint8), syms


def main():
    cav, s = rodata("h264_cavlc.o")

    def arr(name, n):
        off = s[name]
        return cav[off:off + n].copy()

    coeff_token_len = arr("coeff_token_len", 4 * 68).reshape(4, 68)
    coeff_token_bits = arr("coeff_token_bits", 4 * 68).reshape(4, 68)
    chroma_dc_coeff_token_len = arr("chroma_dc_coeff_token_len", 20)
    chroma_dc_coeff_token_bits = arr("chroma_dc_coeff_token_bits", 20)
    # 4:2:2 chroma DC (Table 9-5 nC == -2 column): total_coeff 0..8.
    chroma422_dc_coeff_token_len = arr("chroma422_dc_coeff_token_len", 36)
    chroma422_dc_coeff_token_bits = arr("chroma422_dc_coeff_token_bits", 36)
    chroma422_dc_total_zeros_len = arr("chroma422_dc_total_zeros_len", 7 * 8).reshape(7, 8)
    chroma422_dc_total_zeros_bits = arr("chroma422_dc_total_zeros_bits", 7 * 8).reshape(7, 8)
    # ChromaArrayType 0/3 coded_block_pattern me(v) mappings (Table 9-4).
    golomb_to_intra4x4_cbp_gray = arr("golomb_to_intra4x4_cbp_gray", 16)
    golomb_to_inter_cbp_gray = arr("golomb_to_inter_cbp_gray", 16)
    total_zeros_len = arr("total_zeros_len", 16 * 16).reshape(16, 16)
    total_zeros_bits = arr("total_zeros_bits", 16 * 16).reshape(16, 16)
    chroma_dc_total_zeros_len = arr("chroma_dc_total_zeros_len", 3 * 4).reshape(3, 4)
    chroma_dc_total_zeros_bits = arr("chroma_dc_total_zeros_bits", 3 * 4).reshape(3, 4)
    run_len = arr("run_len", 7 * 16).reshape(7, 16)
    run_bits = arr("run_bits", 7 * 16).reshape(7, 16)

    # Spot checks from Table 9-5: coeff_token for nC 0..1 (table 0):
    # totalcoeff=0,t1=0 -> len 1 bits 1; totalcoeff=1,t1=1 -> len 2 bits 1.
    # ffmpeg indexing: [4*total_coeff + trailing_ones].
    assert coeff_token_len[0][0] == 1 and coeff_token_bits[0][0] == 1
    assert coeff_token_len[0][4 * 1 + 1] == 2 and coeff_token_bits[0][4 * 1 + 1] == 1
    # run_before (Table 9-10): zeros_left=1: run 0 -> '1'(1), run 1 -> '0'(1)
    assert run_len[0][0] == 1 and run_bits[0][0] == 1
    assert run_len[0][1] == 1 and run_bits[0][1] == 0
    # Table 9-5 nC==-2: coeff_token(0,0) = '1' (len 1).
    assert chroma422_dc_coeff_token_len[0] == 1 and chroma422_dc_coeff_token_bits[0] == 1
    # Table 9-9(b) 4:2:2: tzVlcIndex=1, total_zeros=0 -> '1' (len 1).
    assert chroma422_dc_total_zeros_len[0][0] == 1 and chroma422_dc_total_zeros_bits[0][0] == 1
    # Table 9-4 ChromaArrayType 0/3: codeNum 0 -> 15 (intra), 0 (inter).
    assert golomb_to_intra4x4_cbp_gray[0] == 15 and golomb_to_inter_cbp_gray[0] == 0

    h264data, s2 = rodata("h264data.o")

    def arr2(name, n):
        off = s2[name]
        return h264data[off:off + n].copy()

    golomb_to_intra4x4_cbp = arr2("ff_h264_golomb_to_intra4x4_cbp", 48)
    golomb_to_inter_cbp = arr2("ff_h264_golomb_to_inter_cbp", 48)
    assert golomb_to_intra4x4_cbp[0] == 47  # Table 9-4: codeNum 0 -> cbp 47 (intra)
    assert golomb_to_inter_cbp[0] == 0

    def fmt(a, per=16):
        flat = a.reshape(-1).tolist()
        return "\n".join("  " + ", ".join(str(v) for v in flat[i:i + per]) + ","
                         for i in range(0, len(flat), per))

    with open(os.path.join(OUT, "cavlc_tables.h"), "w") as f:
        f.write(
            "// Auto-generated by tools/gen_cavlc_tables.py — DO NOT EDIT.\n"
            "// Numeric constants from ITU-T Rec. H.264 Tables 9-4..9-10 (CAVLC VLC\n"
            "// codes and coded_block_pattern mappings), validated against libavcodec.\n"
            "// ffmpeg-style indexing: coeff_token tables index [4*total_coeff + t1s].\n"
            "#pragma once\n#include <cstdint>\n\nnamespace artc {\n\n")
        f.write("inline constexpr uint8_t kCoeffTokenLen[4][68] = {\n%s\n};\n\n" % fmt(coeff_token_len))
        f.write("inline constexpr uint8_t kCoeffTokenBits[4][68] = {\n%s\n};\n\n" % fmt(coeff_token_bits))
        f.write("inline constexpr uint8_t kChromaDcCoeffTokenLen[20] = {\n%s\n};\n\n" % fmt(chroma_dc_coeff_token_len))
        f.write("inline constexpr uint8_t kChromaDcCoeffTokenBits[20] = {\n%s\n};\n\n" % fmt(chroma_dc_coeff_token_bits))
        f.write("inline constexpr uint8_t kTotalZerosLen[16][16] = {\n%s\n};\n\n" % fmt(total_zeros_len))
        f.write("inline constexpr uint8_t kTotalZerosBits[16][16] = {\n%s\n};\n\n" % fmt(total_zeros_bits))
        f.write("inline constexpr uint8_t kChromaDcTotalZerosLen[3][4] = {\n%s\n};\n\n" % fmt(chroma_dc_total_zeros_len))
        f.write("inline constexpr uint8_t kChromaDcTotalZerosBits[3][4] = {\n%s\n};\n\n" % fmt(chroma_dc_total_zeros_bits))
        f.write("inline constexpr uint8_t kRunBeforeLen[7][16] = {\n%s\n};\n\n" % fmt(run_len))
        f.write("inline constexpr uint8_t kRunBeforeBits[7][16] = {\n%s\n};\n\n" % fmt(run_bits))
        f.write("inline constexpr uint8_t kGolombToIntra4x4Cbp[48] = {\n%s\n};\n\n" % fmt(golomb_to_intra4x4_cbp))
        f.write("inline constexpr uint8_t kGolombToInterCbp[48] = {\n%s\n};\n\n" % fmt(golomb_to_inter_cbp))
        f.write("inline constexpr uint8_t kChromaDc422CoeffTokenLen[36] = {\n%s\n};\n\n" % fmt(chroma422_dc_coeff_token_len))
        f.write("inline constexpr uint8_t kChromaDc422CoeffTokenBits[36] = {\n%s\n};\n\n" % fmt(chroma422_dc_coeff_token_bits))
        f.write("inline constexpr uint8_t kChromaDc422TotalZerosLen[7][8] = {\n%s\n};\n\n" % fmt(chroma422_dc_total_zeros_len))
        f.write("inline constexpr uint8_t kChromaDc422TotalZerosBits[7][8] = {\n%s\n};\n\n" % fmt(chroma422_dc_total_zeros_bits))
        f.write("inline constexpr uint8_t kGolombToIntra4x4CbpGray[16] = {\n%s\n};\n\n" % fmt(golomb_to_intra4x4_cbp_gray))
        f.write("inline constexpr uint8_t kGolombToInterCbpGray[16] = {\n%s\n};\n\n" % fmt(golomb_to_inter_cbp_gray))
        f.write("}  // namespace artc\n")
    print("wrote cavlc_tables.h")


if __name__ == "__main__":
    main()
