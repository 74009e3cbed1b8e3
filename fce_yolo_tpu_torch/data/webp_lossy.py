"""The VP8 (lossy WebP) key-frame decoder, plain version: Python over the
bitstream, bit-equal to the libwebp that ``cv2.imdecode`` carries.

It follows libwebp's decoder (``src/dec/vp8_dec.c``, ``tree_dec.c``,
``quant_dec.c``, ``frame_dec.c`` and ``dsp/dec.c``) step for step, so that
every rounding, border and context is libwebp's:

- the boolean decoder keeps libwebp's state (``range - 1``, the bit count
  below an 8-bit window, byte-wise loads, one zero byte past the end and the
  end-of-data flag), and reads a sign as ``VP8GetSigned`` does;
- the frame header: segments and their map, the filter header (simple or
  normal, level, sharpness, reference and mode deltas), 1/2/4/8 token
  partitions, the quantiser (RFC 6386 section 14.1 tables, the Y2 AC factor
  ``x * 155 / 100`` at least 8, UV DC index at most 117) and the
  coefficient-probability updates (section 13.4 and 13.5 tables);
- per macroblock: segment, skip, 16x16 or 4x4 intra modes (the key-frame
  sub-block mode probabilities of section 11.5, contexts from the modes above
  and to the left), the chroma mode, then the residual tokens with their
  non-zero contexts;
- reconstruction in libwebp's 32-byte-stride work buffer: borders of 127
  above and 129 to the left, the top-right samples of 4x4 blocks, DC
  prediction without top or left at the frame edges, the inverse WHT and DCT
  added with clipping;
- the loop filter after all rows (prediction reads unfiltered samples):
  simple or normal, macroblock and inner edges, interior and edge limits from
  level and sharpness, high-edge-variance thresholds, inner edges skipped in
  a 16x16 macroblock without coefficients.

The output is the three planes Y (H, W), U and V ((H + 1) // 2, (W + 1) // 2),
cropped from the macroblock grid; ``webp.py::webp_color_reference`` turns them
into BGR. Anything libwebp refuses raises ``ValueError``.
"""

from __future__ import annotations

import numpy as np

__all__ = ["decode_vp8", "vp8_size", "VP8Error"]


class VP8Error(ValueError):
    """A VP8 stream that libwebp refuses."""


# RFC 6386 section 13.5: default coefficient probabilities [type][band][context][node]
COEFFS_PROBA0 = bytes([
    128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128,
    128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 253, 136, 254, 255, 228, 219, 128, 128, 128, 128, 128,
    189, 129, 242, 255, 227, 213, 255, 219, 128, 128, 128, 106, 126, 227, 252, 214, 209, 255, 255, 128, 128, 128,
    1, 98, 248, 255, 236, 226, 255, 255, 128, 128, 128, 181, 133, 238, 254, 221, 234, 255, 154, 128, 128, 128,
    78, 134, 202, 247, 198, 180, 255, 219, 128, 128, 128, 1, 185, 249, 255, 243, 255, 128, 128, 128, 128, 128,
    184, 150, 247, 255, 236, 224, 128, 128, 128, 128, 128, 77, 110, 216, 255, 236, 230, 128, 128, 128, 128, 128,
    1, 101, 251, 255, 241, 255, 128, 128, 128, 128, 128, 170, 139, 241, 252, 236, 209, 255, 255, 128, 128, 128,
    37, 116, 196, 243, 228, 255, 255, 255, 128, 128, 128, 1, 204, 254, 255, 245, 255, 128, 128, 128, 128, 128,
    207, 160, 250, 255, 238, 128, 128, 128, 128, 128, 128, 102, 103, 231, 255, 211, 171, 128, 128, 128, 128, 128,
    1, 152, 252, 255, 240, 255, 128, 128, 128, 128, 128, 177, 135, 243, 255, 234, 225, 128, 128, 128, 128, 128,
    80, 129, 211, 255, 194, 224, 128, 128, 128, 128, 128, 1, 1, 255, 128, 128, 128, 128, 128, 128, 128, 128,
    246, 1, 255, 128, 128, 128, 128, 128, 128, 128, 128, 255, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128,
    198, 35, 237, 223, 193, 187, 162, 160, 145, 155, 62, 131, 45, 198, 221, 172, 176, 220, 157, 252, 221, 1,
    68, 47, 146, 208, 149, 167, 221, 162, 255, 223, 128, 1, 149, 241, 255, 221, 224, 255, 255, 128, 128, 128,
    184, 141, 234, 253, 222, 220, 255, 199, 128, 128, 128, 81, 99, 181, 242, 176, 190, 249, 202, 255, 255, 128,
    1, 129, 232, 253, 214, 197, 242, 196, 255, 255, 128, 99, 121, 210, 250, 201, 198, 255, 202, 128, 128, 128,
    23, 91, 163, 242, 170, 187, 247, 210, 255, 255, 128, 1, 200, 246, 255, 234, 255, 128, 128, 128, 128, 128,
    109, 178, 241, 255, 231, 245, 255, 255, 128, 128, 128, 44, 130, 201, 253, 205, 192, 255, 255, 128, 128, 128,
    1, 132, 239, 251, 219, 209, 255, 165, 128, 128, 128, 94, 136, 225, 251, 218, 190, 255, 255, 128, 128, 128,
    22, 100, 174, 245, 186, 161, 255, 199, 128, 128, 128, 1, 182, 249, 255, 232, 235, 128, 128, 128, 128, 128,
    124, 143, 241, 255, 227, 234, 128, 128, 128, 128, 128, 35, 77, 181, 251, 193, 211, 255, 205, 128, 128, 128,
    1, 157, 247, 255, 236, 231, 255, 255, 128, 128, 128, 121, 141, 235, 255, 225, 227, 255, 255, 128, 128, 128,
    45, 99, 188, 251, 195, 217, 255, 224, 128, 128, 128, 1, 1, 251, 255, 213, 255, 128, 128, 128, 128, 128,
    203, 1, 248, 255, 255, 128, 128, 128, 128, 128, 128, 137, 1, 177, 255, 224, 255, 128, 128, 128, 128, 128,
    253, 9, 248, 251, 207, 208, 255, 192, 128, 128, 128, 175, 13, 224, 243, 193, 185, 249, 198, 255, 255, 128,
    73, 17, 171, 221, 161, 179, 236, 167, 255, 234, 128, 1, 95, 247, 253, 212, 183, 255, 255, 128, 128, 128,
    239, 90, 244, 250, 211, 209, 255, 255, 128, 128, 128, 155, 77, 195, 248, 188, 195, 255, 255, 128, 128, 128,
    1, 24, 239, 251, 218, 219, 255, 205, 128, 128, 128, 201, 51, 219, 255, 196, 186, 128, 128, 128, 128, 128,
    69, 46, 190, 239, 201, 218, 255, 228, 128, 128, 128, 1, 191, 251, 255, 255, 128, 128, 128, 128, 128, 128,
    223, 165, 249, 255, 213, 255, 128, 128, 128, 128, 128, 141, 124, 248, 255, 255, 128, 128, 128, 128, 128, 128,
    1, 16, 248, 255, 255, 128, 128, 128, 128, 128, 128, 190, 36, 230, 255, 236, 255, 128, 128, 128, 128, 128,
    149, 1, 255, 128, 128, 128, 128, 128, 128, 128, 128, 1, 226, 255, 128, 128, 128, 128, 128, 128, 128, 128,
    247, 192, 255, 128, 128, 128, 128, 128, 128, 128, 128, 240, 128, 255, 128, 128, 128, 128, 128, 128, 128, 128,
    1, 134, 252, 255, 255, 128, 128, 128, 128, 128, 128, 213, 62, 250, 255, 255, 128, 128, 128, 128, 128, 128,
    55, 93, 255, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128,
    128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128,
    202, 24, 213, 235, 186, 191, 220, 160, 240, 175, 255, 126, 38, 182, 232, 169, 184, 228, 174, 255, 187, 128,
    61, 46, 138, 219, 151, 178, 240, 170, 255, 216, 128, 1, 112, 230, 250, 199, 191, 247, 159, 255, 255, 128,
    166, 109, 228, 252, 211, 215, 255, 174, 128, 128, 128, 39, 77, 162, 232, 172, 180, 245, 178, 255, 255, 128,
    1, 52, 220, 246, 198, 199, 249, 220, 255, 255, 128, 124, 74, 191, 243, 183, 193, 250, 221, 255, 255, 128,
    24, 71, 130, 219, 154, 170, 243, 182, 255, 255, 128, 1, 182, 225, 249, 219, 240, 255, 224, 128, 128, 128,
    149, 150, 226, 252, 216, 205, 255, 171, 128, 128, 128, 28, 108, 170, 242, 183, 194, 254, 223, 255, 255, 128,
    1, 81, 230, 252, 204, 203, 255, 192, 128, 128, 128, 123, 102, 209, 247, 188, 196, 255, 233, 128, 128, 128,
    20, 95, 153, 243, 164, 173, 255, 203, 128, 128, 128, 1, 222, 248, 255, 216, 213, 128, 128, 128, 128, 128,
    168, 175, 246, 252, 235, 205, 255, 255, 128, 128, 128, 47, 116, 215, 255, 211, 212, 255, 255, 128, 128, 128,
    1, 121, 236, 253, 212, 214, 255, 255, 128, 128, 128, 141, 84, 213, 252, 201, 202, 255, 219, 128, 128, 128,
    42, 80, 160, 240, 162, 185, 255, 205, 128, 128, 128, 1, 1, 255, 128, 128, 128, 128, 128, 128, 128, 128,
    244, 1, 255, 128, 128, 128, 128, 128, 128, 128, 128, 238, 1, 255, 128, 128, 128, 128, 128, 128, 128, 128,
])
# RFC 6386 section 13.4: coefficient update probabilities
COEFFS_UPDATE_PROBA = bytes([
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 176, 246, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    223, 241, 252, 255, 255, 255, 255, 255, 255, 255, 255, 249, 253, 253, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 244, 252, 255, 255, 255, 255, 255, 255, 255, 255, 234, 254, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    253, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 246, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    239, 253, 254, 255, 255, 255, 255, 255, 255, 255, 255, 254, 255, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 248, 254, 255, 255, 255, 255, 255, 255, 255, 255, 251, 255, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 253, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    251, 254, 254, 255, 255, 255, 255, 255, 255, 255, 255, 254, 255, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 254, 253, 255, 254, 255, 255, 255, 255, 255, 255, 250, 255, 254, 255, 254, 255, 255, 255, 255, 255, 255,
    254, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    217, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 225, 252, 241, 253, 255, 255, 254, 255, 255, 255, 255,
    234, 250, 241, 250, 253, 255, 253, 254, 255, 255, 255, 255, 254, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    223, 254, 254, 255, 255, 255, 255, 255, 255, 255, 255, 238, 253, 254, 254, 255, 255, 255, 255, 255, 255, 255,
    255, 248, 254, 255, 255, 255, 255, 255, 255, 255, 255, 249, 254, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 253, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    247, 254, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 253, 254, 255, 255, 255, 255, 255, 255, 255, 255, 252, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 254, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    253, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 254, 253, 255, 255, 255, 255, 255, 255, 255, 255, 250, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    254, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    186, 251, 250, 255, 255, 255, 255, 255, 255, 255, 255, 234, 251, 244, 254, 255, 255, 255, 255, 255, 255, 255,
    251, 251, 243, 253, 254, 255, 254, 255, 255, 255, 255, 255, 253, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    236, 253, 254, 255, 255, 255, 255, 255, 255, 255, 255, 251, 253, 253, 254, 254, 255, 255, 255, 255, 255, 255,
    255, 254, 254, 255, 255, 255, 255, 255, 255, 255, 255, 254, 254, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 254, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    254, 254, 255, 255, 255, 255, 255, 255, 255, 255, 255, 254, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 254, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    248, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 250, 254, 252, 254, 255, 255, 255, 255, 255, 255, 255,
    248, 254, 249, 253, 255, 255, 255, 255, 255, 255, 255, 255, 253, 253, 255, 255, 255, 255, 255, 255, 255, 255,
    246, 253, 253, 255, 255, 255, 255, 255, 255, 255, 255, 252, 254, 251, 254, 254, 255, 255, 255, 255, 255, 255,
    255, 254, 252, 255, 255, 255, 255, 255, 255, 255, 255, 248, 254, 253, 255, 255, 255, 255, 255, 255, 255, 255,
    253, 255, 254, 254, 255, 255, 255, 255, 255, 255, 255, 255, 251, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    245, 251, 254, 255, 255, 255, 255, 255, 255, 255, 255, 253, 253, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 251, 253, 255, 255, 255, 255, 255, 255, 255, 255, 252, 253, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 254, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 252, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    249, 255, 254, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 253, 255, 255, 255, 255, 255, 255, 255, 255, 250, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    254, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
])
# RFC 6386 section 11.5: key-frame sub-block mode probabilities [above][left][node]
BMODES_PROBA = bytes([
    231, 120, 48, 89, 115, 113, 120, 152, 112, 152, 179, 64, 126, 170, 118, 46, 70, 95,
    175, 69, 143, 80, 85, 82, 72, 155, 103, 56, 58, 10, 171, 218, 189, 17, 13, 152,
    114, 26, 17, 163, 44, 195, 21, 10, 173, 121, 24, 80, 195, 26, 62, 44, 64, 85,
    144, 71, 10, 38, 171, 213, 144, 34, 26, 170, 46, 55, 19, 136, 160, 33, 206, 71,
    63, 20, 8, 114, 114, 208, 12, 9, 226, 81, 40, 11, 96, 182, 84, 29, 16, 36,
    134, 183, 89, 137, 98, 101, 106, 165, 148, 72, 187, 100, 130, 157, 111, 32, 75, 80,
    66, 102, 167, 99, 74, 62, 40, 234, 128, 41, 53, 9, 178, 241, 141, 26, 8, 107,
    74, 43, 26, 146, 73, 166, 49, 23, 157, 65, 38, 105, 160, 51, 52, 31, 115, 128,
    104, 79, 12, 27, 217, 255, 87, 17, 7, 87, 68, 71, 44, 114, 51, 15, 186, 23,
    47, 41, 14, 110, 182, 183, 21, 17, 194, 66, 45, 25, 102, 197, 189, 23, 18, 22,
    88, 88, 147, 150, 42, 46, 45, 196, 205, 43, 97, 183, 117, 85, 38, 35, 179, 61,
    39, 53, 200, 87, 26, 21, 43, 232, 171, 56, 34, 51, 104, 114, 102, 29, 93, 77,
    39, 28, 85, 171, 58, 165, 90, 98, 64, 34, 22, 116, 206, 23, 34, 43, 166, 73,
    107, 54, 32, 26, 51, 1, 81, 43, 31, 68, 25, 106, 22, 64, 171, 36, 225, 114,
    34, 19, 21, 102, 132, 188, 16, 76, 124, 62, 18, 78, 95, 85, 57, 50, 48, 51,
    193, 101, 35, 159, 215, 111, 89, 46, 111, 60, 148, 31, 172, 219, 228, 21, 18, 111,
    112, 113, 77, 85, 179, 255, 38, 120, 114, 40, 42, 1, 196, 245, 209, 10, 25, 109,
    88, 43, 29, 140, 166, 213, 37, 43, 154, 61, 63, 30, 155, 67, 45, 68, 1, 209,
    100, 80, 8, 43, 154, 1, 51, 26, 71, 142, 78, 78, 16, 255, 128, 34, 197, 171,
    41, 40, 5, 102, 211, 183, 4, 1, 221, 51, 50, 17, 168, 209, 192, 23, 25, 82,
    138, 31, 36, 171, 27, 166, 38, 44, 229, 67, 87, 58, 169, 82, 115, 26, 59, 179,
    63, 59, 90, 180, 59, 166, 93, 73, 154, 40, 40, 21, 116, 143, 209, 34, 39, 175,
    47, 15, 16, 183, 34, 223, 49, 45, 183, 46, 17, 33, 183, 6, 98, 15, 32, 183,
    57, 46, 22, 24, 128, 1, 54, 17, 37, 65, 32, 73, 115, 28, 128, 23, 128, 205,
    40, 3, 9, 115, 51, 192, 18, 6, 223, 87, 37, 9, 115, 59, 77, 64, 21, 47,
    104, 55, 44, 218, 9, 54, 53, 130, 226, 64, 90, 70, 205, 40, 41, 23, 26, 57,
    54, 57, 112, 184, 5, 41, 38, 166, 213, 30, 34, 26, 133, 152, 116, 10, 32, 134,
    39, 19, 53, 221, 26, 114, 32, 73, 255, 31, 9, 65, 234, 2, 15, 1, 118, 73,
    75, 32, 12, 51, 192, 255, 160, 43, 51, 88, 31, 35, 67, 102, 85, 55, 186, 85,
    56, 21, 23, 111, 59, 205, 45, 37, 192, 55, 38, 70, 124, 73, 102, 1, 34, 98,
    125, 98, 42, 88, 104, 85, 117, 175, 82, 95, 84, 53, 89, 128, 100, 113, 101, 45,
    75, 79, 123, 47, 51, 128, 81, 171, 1, 57, 17, 5, 71, 102, 57, 53, 41, 49,
    38, 33, 13, 121, 57, 73, 26, 1, 85, 41, 10, 67, 138, 77, 110, 90, 47, 114,
    115, 21, 2, 10, 102, 255, 166, 23, 6, 101, 29, 16, 10, 85, 128, 101, 196, 26,
    57, 18, 10, 102, 102, 213, 34, 20, 43, 117, 20, 15, 36, 163, 128, 68, 1, 26,
    102, 61, 71, 37, 34, 53, 31, 243, 192, 69, 60, 71, 38, 73, 119, 28, 222, 37,
    68, 45, 128, 34, 1, 47, 11, 245, 171, 62, 17, 19, 70, 146, 85, 55, 62, 70,
    37, 43, 37, 154, 100, 163, 85, 160, 1, 63, 9, 92, 136, 28, 64, 32, 201, 85,
    75, 15, 9, 9, 64, 255, 184, 119, 16, 86, 6, 28, 5, 64, 255, 25, 248, 1,
    56, 8, 17, 132, 137, 255, 55, 116, 128, 58, 15, 20, 82, 135, 57, 26, 121, 40,
    164, 50, 31, 137, 154, 133, 25, 35, 218, 51, 103, 44, 131, 131, 123, 31, 6, 158,
    86, 40, 64, 135, 148, 224, 45, 183, 128, 22, 26, 17, 131, 240, 154, 14, 1, 209,
    45, 16, 21, 91, 64, 222, 7, 1, 197, 56, 21, 39, 155, 60, 138, 23, 102, 213,
    83, 12, 13, 54, 192, 255, 68, 47, 28, 85, 26, 85, 85, 128, 128, 32, 146, 171,
    18, 11, 7, 63, 144, 171, 4, 4, 246, 35, 27, 10, 146, 174, 171, 12, 26, 128,
    190, 80, 35, 99, 180, 80, 126, 54, 45, 85, 126, 47, 87, 176, 51, 41, 20, 32,
    101, 75, 128, 139, 118, 146, 116, 128, 85, 56, 41, 15, 176, 236, 85, 37, 9, 62,
    71, 30, 17, 119, 118, 255, 17, 18, 138, 101, 38, 60, 138, 55, 70, 43, 26, 142,
    146, 36, 19, 30, 171, 255, 97, 27, 20, 138, 45, 61, 62, 219, 1, 81, 188, 64,
    32, 41, 20, 117, 151, 142, 20, 21, 163, 112, 19, 12, 61, 195, 128, 48, 4, 24,
])
# RFC 6386 section 14.1: quantiser step by index
DC_TABLE = [
    4, 5, 6, 7, 8, 9, 10, 10, 11, 12, 13, 14, 15, 16, 17, 17,
    18, 19, 20, 20, 21, 21, 22, 22, 23, 23, 24, 25, 25, 26, 27, 28,
    29, 30, 31, 32, 33, 34, 35, 36, 37, 37, 38, 39, 40, 41, 42, 43,
    44, 45, 46, 46, 47, 48, 49, 50, 51, 52, 53, 54, 55, 56, 57, 58,
    59, 60, 61, 62, 63, 64, 65, 66, 67, 68, 69, 70, 71, 72, 73, 74,
    75, 76, 76, 77, 78, 79, 80, 81, 82, 83, 84, 85, 86, 87, 88, 89,
    91, 93, 95, 96, 98, 100, 101, 102, 104, 106, 108, 110, 112, 114, 116, 118,
    122, 124, 126, 128, 130, 132, 134, 136, 138, 140, 143, 145, 148, 151, 154, 157,
]
AC_TABLE = [
    4, 5, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15, 16, 17, 18, 19,
    20, 21, 22, 23, 24, 25, 26, 27, 28, 29, 30, 31, 32, 33, 34, 35,
    36, 37, 38, 39, 40, 41, 42, 43, 44, 45, 46, 47, 48, 49, 50, 51,
    52, 53, 54, 55, 56, 57, 58, 60, 62, 64, 66, 68, 70, 72, 74, 76,
    78, 80, 82, 84, 86, 88, 90, 92, 94, 96, 98, 100, 102, 104, 106, 108,
    110, 112, 114, 116, 119, 122, 125, 128, 131, 134, 137, 140, 143, 146, 149, 152,
    155, 158, 161, 164, 167, 170, 173, 177, 181, 185, 189, 193, 197, 201, 205, 209,
    213, 217, 221, 225, 229, 234, 239, 245, 249, 254, 259, 264, 269, 274, 279, 284,
]
ZIGZAG = (0, 1, 4, 8, 5, 2, 3, 6, 9, 12, 13, 10, 7, 11, 14, 15)
BANDS = (0, 1, 2, 3, 6, 4, 5, 6, 6, 6, 6, 6, 6, 6, 6, 7, 0)  # the 17th entry is a sentinel
CAT3456 = ((173, 148, 140), (176, 155, 140, 135), (180, 157, 141, 134, 130),
           (254, 254, 243, 230, 196, 177, 153, 140, 133, 130, 129))
# libwebp's mode numbers: B_DC_PRED 0, B_TM_PRED 1, B_VE_PRED 2, B_HE_PRED 3, B_RD_PRED 4, B_VR_PRED 5,
# B_LD_PRED 6, B_VL_PRED 7, B_HD_PRED 8, B_HU_PRED 9; the 16x16 and chroma modes DC 0, TM 1, V 2, H 3
DC_PRED, TM_PRED, V_PRED, H_PRED = 0, 1, 2, 3
# DC prediction at the frame's edges (CheckMode)
DC_NOTOP, DC_NOLEFT, DC_NOTOPLEFT = 4, 5, 6

BPS = 32  # libwebp's work buffer: 17 rows of luma + 9 of chroma, 32 bytes a row
Y_OFF = BPS * 1 + 8
U_OFF = Y_OFF + BPS * 16 + BPS
V_OFF = U_OFF + 16
YUV_SIZE = BPS * 17 + BPS * 9
SCAN = tuple((n & 3) * 4 + (n >> 2) * 4 * BPS for n in range(16))


_U64 = (1 << 64) - 1


def _i16(v: int) -> int:
    return ((v + 32768) & 0xFFFF) - 32768


class _BoolReader:
    """libwebp's VP8BitReader as its x86-64 build runs it: a 64-bit value
    loaded 56 bits (7 bytes) at a time while 8 bytes remain, then byte by
    byte, one zero byte past the end (``eof``); the 8-bit window compared as
    a 32-bit ``range_t``. On a valid stream this is the spec's decoder; on a
    corrupt one the 64-bit wrap and the truncation decide as cv2 decides."""

    __slots__ = ("buf", "pos", "end", "value", "range", "bits", "eof")

    def __init__(self, buf: bytes, start: int, size: int):
        self.buf, self.pos, self.end = buf, start, start + size
        self.value, self.range, self.bits, self.eof = 0, 255 - 1, -8, False
        self._load()

    def _load(self) -> None:
        if self.pos + 8 <= self.end:
            self.value = (int.from_bytes(self.buf[self.pos: self.pos + 7], "big") | (self.value << 56)) & _U64
            self.pos += 7
            self.bits += 56
        elif self.pos < self.end:
            self.bits += 8
            self.value = (self.buf[self.pos] | (self.value << 8)) & _U64
            self.pos += 1
        elif not self.eof:
            self.value = (self.value << 8) & _U64
            self.bits += 8
            self.eof = True
        else:
            self.bits = 0

    def get(self, prob: int) -> int:
        rng = self.range
        if self.bits < 0:
            self._load()
        pos = self.bits
        split = (rng * prob) >> 8
        if ((self.value >> pos) & 0xFFFFFFFF) > split:
            rng -= split
            self.value -= (split + 1) << pos
            bit = 1
        else:
            rng = split + 1
            bit = 0
        shift = 8 - rng.bit_length()
        self.bits -= shift
        self.range = (rng << shift) - 1
        return bit

    def signed(self, v: int) -> int:
        """VP8GetSigned: a sign at probability 1/2, the range kept and the
        window moved by one bit."""
        if self.bits < 0:
            self._load()
        pos = self.bits
        split = self.range >> 1
        self.bits -= 1
        if (split - ((self.value >> pos) & 0xFFFFFFFF)) & 0x80000000:  # libwebp's int32 sign mask
            self.range = (self.range - 1) | 1
            self.value -= (split + 1) << pos
            return -v
        self.range |= 1
        return v

    def value_bits(self, n: int) -> int:
        v = 0
        while n > 0:
            n -= 1
            v |= self.get(0x80) << n
        return v

    def signed_value(self, n: int) -> int:
        v = self.value_bits(n)
        return -v if self.get(0x80) else v


def vp8_size(data: bytes, chunk_size: int) -> tuple[int, int] | None:
    """VP8GetInfo: (width, height) of a key frame, or None for data libwebp
    does not take as VP8."""
    if len(data) < 10 or data[3:6] != b"\x9d\x01\x2a":
        return None
    bits = data[0] | (data[1] << 8) | (data[2] << 16)
    w = ((data[7] << 8) | data[6]) & 0x3FFF
    h = ((data[9] << 8) | data[8]) & 0x3FFF
    if bits & 1 or ((bits >> 1) & 7) > 3 or not (bits >> 4) & 1 or (bits >> 5) >= chunk_size or w == 0 or h == 0:
        return None
    return w, h


class _Header:
    pass


def _segment_header(br: _BoolReader, hd: _Header) -> None:
    hd.use_segment = br.get(0x80)
    hd.update_map = 0
    hd.absolute_delta = 1
    hd.quantizer = [0] * 4
    hd.filter_strength = [0] * 4
    hd.segments = [255, 255, 255]
    if hd.use_segment:
        hd.update_map = br.get(0x80)
        if br.get(0x80):  # update data
            hd.absolute_delta = br.get(0x80)
            hd.quantizer = [br.signed_value(7) if br.get(0x80) else 0 for _ in range(4)]
            hd.filter_strength = [br.signed_value(6) if br.get(0x80) else 0 for _ in range(4)]
        if hd.update_map:
            hd.segments = [br.value_bits(8) if br.get(0x80) else 255 for _ in range(3)]


def _filter_header(br: _BoolReader, hd: _Header) -> None:
    hd.simple = br.get(0x80)
    hd.level = br.value_bits(6)
    hd.sharpness = br.value_bits(3)
    hd.use_lf_delta = br.get(0x80)
    hd.ref_lf_delta = [0] * 4
    hd.mode_lf_delta = [0] * 4
    if hd.use_lf_delta and br.get(0x80):  # update the deltas
        for i in range(4):
            if br.get(0x80):
                hd.ref_lf_delta[i] = br.signed_value(6)
        for i in range(4):
            if br.get(0x80):
                hd.mode_lf_delta[i] = br.signed_value(6)
    hd.filter_type = 0 if hd.level == 0 else (1 if hd.simple else 2)


def _quant(br: _BoolReader, hd: _Header) -> None:
    q0 = br.value_bits(7)
    dy1_dc, dy2_dc, dy2_ac, duv_dc, duv_ac = (br.signed_value(4) if br.get(0x80) else 0 for _ in range(5))

    def clip(v, m):
        return 0 if v < 0 else (m if v > m else v)

    hd.dqm = []
    for s in range(4):
        if hd.use_segment:
            q = hd.quantizer[s] + (0 if hd.absolute_delta else q0)
        elif s > 0:
            hd.dqm.append(hd.dqm[0])
            continue
        else:
            q = q0
        y2_ac = (AC_TABLE[clip(q + dy2_ac, 127)] * 101581) >> 16
        hd.dqm.append(((DC_TABLE[clip(q + dy1_dc, 127)], AC_TABLE[clip(q, 127)]),
                       (DC_TABLE[clip(q + dy2_dc, 127)] * 2, max(y2_ac, 8)),
                       (DC_TABLE[clip(q + duv_dc, 117)], AC_TABLE[clip(q + duv_ac, 127)])))


def _proba(br: _BoolReader, hd: _Header) -> None:
    flat = [br.value_bits(8) if br.get(COEFFS_UPDATE_PROBA[i]) else COEFFS_PROBA0[i] for i in range(4 * 8 * 3 * 11)]
    bands = [[[flat[((t * 8 + b) * 3 + c) * 11: ((t * 8 + b) * 3 + c + 1) * 11] for c in range(3)] for b in range(8)]
             for t in range(4)]
    hd.bands = [[bands[t][BANDS[n]] for n in range(17)] for t in range(4)]
    hd.use_skip_proba = br.get(0x80)
    hd.skip_p = br.value_bits(8) if hd.use_skip_proba else 0


def _parse_header(data: bytes, name: str) -> tuple[_Header, _BoolReader, list[_BoolReader]]:
    n = len(data)
    if n < 4:
        raise VP8Error(f"{name}: truncated VP8 header")
    bits = data[0] | (data[1] << 8) | (data[2] << 16)
    if bits & 1:
        raise VP8Error(f"{name}: a VP8 inter frame (not a key frame)")
    if ((bits >> 1) & 7) > 3:
        raise VP8Error(f"{name}: incorrect VP8 key-frame parameters")
    if not (bits >> 4) & 1:
        raise VP8Error(f"{name}: a VP8 frame that is not displayable")
    part_len = bits >> 5
    if n - 3 < 7:
        raise VP8Error(f"{name}: cannot parse the VP8 picture header")
    if data[3:6] != b"\x9d\x01\x2a":
        raise VP8Error(f"{name}: bad VP8 code word")
    hd = _Header()
    hd.width = ((data[7] << 8) | data[6]) & 0x3FFF
    hd.height = ((data[9] << 8) | data[8]) & 0x3FFF
    hd.mb_w, hd.mb_h = (hd.width + 15) >> 4, (hd.height + 15) >> 4
    pos, left = 10, n - 10
    if part_len > left:
        raise VP8Error(f"{name}: bad VP8 partition length")
    br = _BoolReader(data, pos, part_len)
    pos, left = pos + part_len, left - part_len
    br.get(0x80)  # colour space
    br.get(0x80)  # clamping type
    _segment_header(br, hd)
    if br.eof:
        raise VP8Error(f"{name}: cannot parse the VP8 segment header")
    _filter_header(br, hd)
    if br.eof:
        raise VP8Error(f"{name}: cannot parse the VP8 filter header")
    last = (1 << br.value_bits(2)) - 1
    if left < 3 * last:
        raise VP8Error(f"{name}: cannot parse the VP8 partitions")
    start, left_p = pos + 3 * last, left - 3 * last
    parts = []
    for p in range(last):
        psize = data[pos + 3 * p] | (data[pos + 3 * p + 1] << 8) | (data[pos + 3 * p + 2] << 16)
        psize = min(psize, left_p)
        parts.append(_BoolReader(data, start, psize))
        start, left_p = start + psize, left_p - psize
    parts.append(_BoolReader(data, start, left_p))
    if start >= n:
        raise VP8Error(f"{name}: cannot parse the VP8 partitions (the last one is empty)")
    _quant(br, hd)
    br.get(0x80)  # refresh entropy probabilities (ignored on a key frame)
    _proba(br, hd)
    return hd, br, parts


def _intra_modes(br: _BoolReader, hd: _Header, top: list[int], mb_x: int, block: dict) -> None:
    """ParseIntraMode: one macroblock's segment, skip flag and modes."""
    left = hd.intra_l
    if hd.update_map:
        s = hd.segments
        block["segment"] = br.get(s[1]) if not br.get(s[0]) else br.get(s[2]) + 2
    else:
        block["segment"] = 0
    block["skip"] = br.get(hd.skip_p) if hd.use_skip_proba else 0
    t = 4 * mb_x
    block["is_i4x4"] = i4 = not br.get(145)
    if not i4:
        ymode = (TM_PRED if br.get(128) else H_PRED) if br.get(156) else (V_PRED if br.get(163) else DC_PRED)
        block["imodes"] = [ymode]
        top[t: t + 4] = [ymode] * 4
        left[:] = [ymode] * 4
    else:
        modes = []
        for y in range(4):
            ymode = left[y]
            for x in range(4):
                o = (top[t + x] * 10 + ymode) * 9
                p = BMODES_PROBA[o: o + 9]
                if not br.get(p[0]):
                    ymode = 0
                elif not br.get(p[1]):
                    ymode = 1
                elif not br.get(p[2]):
                    ymode = 2
                elif not br.get(p[3]):
                    ymode = 3 if not br.get(p[4]) else (4 if not br.get(p[5]) else 5)
                else:
                    ymode = 6 if not br.get(p[6]) else (7 if not br.get(p[7]) else (8 if not br.get(p[8]) else 9))
                top[t + x] = ymode
            modes += top[t: t + 4]
            left[y] = ymode
        block["imodes"] = modes
    if not br.get(142):
        block["uvmode"] = DC_PRED
    else:
        block["uvmode"] = V_PRED if not br.get(114) else (TM_PRED if br.get(183) else H_PRED)


def _large_value(br: _BoolReader, p) -> int:
    if not br.get(p[3]):
        return 2 if not br.get(p[4]) else 3 + br.get(p[5])
    if not br.get(p[6]):
        if not br.get(p[7]):
            return 5 + br.get(159)
        return 7 + 2 * br.get(165) + br.get(145)
    bit1 = br.get(p[8])
    cat = 2 * bit1 + br.get(p[9 + bit1])
    v = 0
    for prob in CAT3456[cat]:
        v += v + br.get(prob)
    return v + 3 + (8 << cat)


def _coeffs(br: _BoolReader, prob, ctx: int, dq, n: int, out: list[int], o: int) -> int:
    """GetCoeffs: one block's tokens, dequantised into ``out[o:o + 16]``
    (natural order, int16 as libwebp stores them); returns the position
    after the last token read."""
    p = prob[n][ctx]
    while n < 16:
        if not br.get(p[0]):
            return n  # end of block
        while not br.get(p[1]):  # a run of zeros
            n += 1
            p = prob[n][0]
            if n == 16:
                return 16
        pc = prob[n + 1]
        if not br.get(p[2]):
            v, p = 1, pc[1]
        else:
            v, p = _large_value(br, p), pc[2]
        out[o + ZIGZAG[n]] = _i16(br.signed(v) * dq[n > 0])
        n += 1
    return 16


def _wht(dc: list[int], out: list[int]) -> None:
    tmp = [0] * 16
    for i in range(4):
        a0, a1 = dc[i] + dc[12 + i], dc[4 + i] + dc[8 + i]
        a2, a3 = dc[4 + i] - dc[8 + i], dc[i] - dc[12 + i]
        tmp[i], tmp[8 + i], tmp[4 + i], tmp[12 + i] = a0 + a1, a0 - a1, a3 + a2, a3 - a2
    for i in range(4):
        d = tmp[4 * i] + 3
        a0, a1 = d + tmp[4 * i + 3], tmp[4 * i + 1] + tmp[4 * i + 2]
        a2, a3 = tmp[4 * i + 1] - tmp[4 * i + 2], d - tmp[4 * i + 3]
        o = 64 * i
        out[o], out[o + 16], out[o + 32], out[o + 48] = (_i16((a0 + a1) >> 3), _i16((a3 + a2) >> 3),
                                                         _i16((a0 - a1) >> 3), _i16((a3 - a2) >> 3))


def _nz_bits(nz_coeffs: int, nz: int, dc_nz: bool) -> int:
    return (nz_coeffs << 2) | (3 if nz > 3 else (2 if nz > 1 else int(dc_nz)))


def _residuals(br: _BoolReader, hd: _Header, mb_x: int, block: dict) -> int:
    """ParseResiduals: the macroblock's 384 coefficients into
    ``block["coeffs"]``; returns 1 when all are zero (libwebp's skip)."""
    bands = hd.bands
    q = hd.dqm[block["segment"]]
    dst = block["coeffs"] = [0] * 384
    top, left = hd.nz[mb_x], hd.nz_left
    if not block["is_i4x4"]:
        dc = [0] * 16
        ctx = hd.nz_dc[mb_x] + hd.nz_dc_left
        nz = _coeffs(br, bands[1], ctx, q[1], 0, dc, 0)
        hd.nz_dc[mb_x] = hd.nz_dc_left = int(nz > 0)
        _wht(dc, dst)
        first, ac_proba = 1, bands[0]
    else:
        first, ac_proba = 0, bands[3]
    tnz, lnz = top & 0x0F, left & 0x0F
    non_zero_y = non_zero_uv = 0
    o = 0
    for _ in range(4):
        l_ = lnz & 1
        nz_coeffs = 0
        for _ in range(4):
            nz = _coeffs(br, ac_proba, l_ + (tnz & 1), q[0], first, dst, o)
            l_ = int(nz > first)
            tnz = (tnz >> 1) | (l_ << 7)
            nz_coeffs = _nz_bits(nz_coeffs, nz, dst[o] != 0)
            o += 16
        tnz >>= 4
        lnz = (lnz >> 1) | (l_ << 7)
        non_zero_y = (non_zero_y << 8) | nz_coeffs
    out_t, out_l = tnz, lnz >> 4
    for ch in (0, 2):
        nz_coeffs = 0
        tnz, lnz = top >> (4 + ch), left >> (4 + ch)
        for _ in range(2):
            l_ = lnz & 1
            for _ in range(2):
                nz = _coeffs(br, bands[2], l_ + (tnz & 1), q[2], 0, dst, o)
                l_ = int(nz > 0)
                tnz = (tnz >> 1) | (l_ << 3)
                nz_coeffs = _nz_bits(nz_coeffs, nz, dst[o] != 0)
                o += 16
            tnz >>= 2
            lnz = (lnz >> 1) | (l_ << 5)
        non_zero_uv |= nz_coeffs << (4 * ch)
        out_t |= (tnz << 4) << ch
        out_l |= (lnz & 0xF0) << ch
    hd.nz[mb_x], hd.nz_left = out_t & 0xFF, out_l & 0xFF
    block["non_zero_y"], block["non_zero_uv"] = non_zero_y, non_zero_uv
    return int(not (non_zero_y | non_zero_uv))


def _decode_mb(br: _BoolReader, hd: _Header, mb_x: int, block: dict) -> None:
    """VP8DecodeMB: tokens (or the skip) and the filter info."""
    skip = block["skip"] if hd.use_skip_proba else 0
    if not skip:
        skip = _residuals(br, hd, mb_x, block)
    else:
        hd.nz[mb_x] = hd.nz_left = 0
        if not block["is_i4x4"]:
            hd.nz_dc[mb_x] = hd.nz_dc_left = 0
        block["non_zero_y"] = block["non_zero_uv"] = 0
        block["coeffs"] = None
    block["f_inner"] = int(block["is_i4x4"]) | int(not skip)


# ------------------------------------------------------------------ reconstruction
def _clip8(v: int) -> int:
    return 0 if v < 0 else (255 if v > 255 else v)


def _avg3(a, b, c):
    return (a + 2 * b + c + 2) >> 2


def _avg2(a, b):
    return (a + b + 1) >> 1


def _pred4(b: bytearray, d: int, mode: int) -> None:
    """VP8PredLuma4: a 4x4 block's prediction at offset ``d``."""
    if mode == 0:  # DC
        dc = 4
        for i in range(4):
            dc += b[d + i - BPS] + b[d - 1 + i * BPS]
        dc >>= 3
        for i in range(4):
            b[d + i * BPS: d + i * BPS + 4] = bytes([dc]) * 4
        return
    if mode == 1:  # TM
        _true_motion(b, d, 4)
        return
    top = [b[d - BPS + i] for i in range(-1, 8)]  # top[0] is the top-left sample
    X, A, B, C, D, E, F, G, H = top
    I, J, K, L = (b[d - 1 + i * BPS] for i in range(4))
    px = [[0] * 4 for _ in range(4)]  # px[y][x]
    if mode == 2:  # VE
        vals = [_avg3(X, A, B), _avg3(A, B, C), _avg3(B, C, D), _avg3(C, D, E)]
        px = [vals[:] for _ in range(4)]
    elif mode == 3:  # HE
        px = [[_avg3(X, I, J)] * 4, [_avg3(I, J, K)] * 4, [_avg3(J, K, L)] * 4, [_avg3(K, L, L)] * 4]
    elif mode == 4:  # RD
        e = [_avg3(J, K, L), _avg3(I, J, K), _avg3(X, I, J), _avg3(A, X, I), _avg3(B, A, X), _avg3(C, B, A),
             _avg3(D, C, B)]
        px = [[e[3 - y + x] for x in range(4)] for y in range(4)]
    elif mode == 5:  # VR
        px[0][0] = px[2][1] = _avg2(X, A)
        px[0][1] = px[2][2] = _avg2(A, B)
        px[0][2] = px[2][3] = _avg2(B, C)
        px[0][3] = _avg2(C, D)
        px[3][0] = _avg3(K, J, I)
        px[2][0] = _avg3(J, I, X)
        px[1][0] = px[3][1] = _avg3(I, X, A)
        px[1][1] = px[3][2] = _avg3(X, A, B)
        px[1][2] = px[3][3] = _avg3(A, B, C)
        px[1][3] = _avg3(B, C, D)
    elif mode == 6:  # LD
        e = [_avg3(A, B, C), _avg3(B, C, D), _avg3(C, D, E), _avg3(D, E, F), _avg3(E, F, G), _avg3(F, G, H),
             _avg3(G, H, H)]
        px = [[e[x + y] for x in range(4)] for y in range(4)]
    elif mode == 7:  # VL
        px[0][0] = _avg2(A, B)
        px[0][1] = px[2][0] = _avg2(B, C)
        px[0][2] = px[2][1] = _avg2(C, D)
        px[0][3] = px[2][2] = _avg2(D, E)
        px[1][0] = _avg3(A, B, C)
        px[1][1] = px[3][0] = _avg3(B, C, D)
        px[1][2] = px[3][1] = _avg3(C, D, E)
        px[1][3] = px[3][2] = _avg3(D, E, F)
        px[2][3] = _avg3(E, F, G)
        px[3][3] = _avg3(F, G, H)
    elif mode == 8:  # HD
        px[0][0] = px[1][2] = _avg2(I, X)
        px[1][0] = px[2][2] = _avg2(J, I)
        px[2][0] = px[3][2] = _avg2(K, J)
        px[3][0] = _avg2(L, K)
        px[0][3] = _avg3(A, B, C)
        px[0][2] = _avg3(X, A, B)
        px[0][1] = px[1][3] = _avg3(I, X, A)
        px[1][1] = px[2][3] = _avg3(J, I, X)
        px[2][1] = px[3][3] = _avg3(K, J, I)
        px[3][1] = _avg3(L, K, J)
    else:  # HU
        px[0][0] = _avg2(I, J)
        px[0][2] = px[1][0] = _avg2(J, K)
        px[1][2] = px[2][0] = _avg2(K, L)
        px[0][1] = _avg3(I, J, K)
        px[0][3] = px[1][1] = _avg3(J, K, L)
        px[1][3] = px[2][1] = _avg3(K, L, L)
        px[2][3] = px[2][2] = px[3][0] = px[3][1] = px[3][2] = px[3][3] = L
    for y in range(4):
        b[d + y * BPS: d + y * BPS + 4] = bytes(px[y])


def _true_motion(b: bytearray, d: int, size: int) -> None:
    tl = b[d - BPS - 1]
    top = b[d - BPS: d - BPS + size]
    for y in range(size):
        lv = b[d - 1 + y * BPS] - tl
        b[d + y * BPS: d + y * BPS + size] = bytes(_clip8(t + lv) for t in top)


def _pred_block(b: bytearray, d: int, mode: int, size: int) -> None:
    """VP8PredLuma16 (size 16) and VP8PredChroma8 (size 8)."""
    shift = 4 if size == 8 else 5
    if mode == TM_PRED:
        _true_motion(b, d, size)
        return
    if mode == V_PRED:
        row = bytes(b[d - BPS: d - BPS + size])
        for y in range(size):
            b[d + y * BPS: d + y * BPS + size] = row
        return
    if mode == H_PRED:
        for y in range(size):
            b[d + y * BPS: d + y * BPS + size] = bytes([b[d - 1 + y * BPS]]) * size
        return
    top = sum(b[d - BPS: d - BPS + size])
    left = sum(b[d - 1 + y * BPS] for y in range(size))
    if mode == DC_PRED:
        v = (top + left + (1 << (shift - 1))) >> shift
    elif mode == DC_NOTOP:
        v = (left + (1 << (shift - 2))) >> (shift - 1)
    elif mode == DC_NOLEFT:
        v = (top + (1 << (shift - 2))) >> (shift - 1)
    else:
        v = 0x80
    for y in range(size):
        b[d + y * BPS: d + y * BPS + size] = bytes([v]) * size


def _check_mode(mb_x: int, mb_y: int, mode: int) -> int:
    if mode == DC_PRED:
        if mb_x == 0:
            return DC_NOTOPLEFT if mb_y == 0 else DC_NOLEFT
        return DC_NOTOP if mb_y == 0 else DC_PRED
    return mode


def _mul1(a: int) -> int:
    return ((a * 20091) >> 16) + a


def _mul2(a: int) -> int:
    return (a * 35468) >> 16


def _transform(src: list[int], o: int, b: bytearray, d: int, sse2: bool = False) -> None:
    """TransformOne: the inverse DCT of ``src[o:o + 16]`` added to the 4x4
    block at ``d`` with clipping. ``sse2``: as libwebp's SSE2 ``Transform``
    (the one cv2 runs for blocks with coefficients past position 2 and for
    chroma with any AC), whose 16-bit lanes wrap after the first pass, before
    the final shift and on the add; on coefficients an encoder emits the two
    agree, on corrupt ones they do not."""
    w = _i16 if sse2 else (lambda v: v)
    tmp = [0] * 16
    for i in range(4):
        a = src[o + i] + src[o + 8 + i]
        bb = src[o + i] - src[o + 8 + i]
        c = _mul2(src[o + 4 + i]) - _mul1(src[o + 12 + i])
        dd = _mul1(src[o + 4 + i]) + _mul2(src[o + 12 + i])
        tmp[4 * i: 4 * i + 4] = (w(a + dd), w(bb + c), w(bb - c), w(a - dd))
    for i in range(4):
        dc = tmp[i] + 4
        a, bb = dc + tmp[8 + i], dc - tmp[8 + i]
        c = _mul2(tmp[4 + i]) - _mul1(tmp[12 + i])
        dd = _mul1(tmp[4 + i]) + _mul2(tmp[12 + i])
        r = d + i * BPS
        for k, v in enumerate((a + dd, bb + c, bb - c, a - dd)):
            b[r + k] = _clip8(w(b[r + k] + (w(v) >> 3)))


def _reconstruct_row(hd: _Header, mb_y: int, blocks: list[dict], planes) -> None:
    """ReconstructRow: predict and add the residuals of one macroblock row
    in the work buffer, then copy it out (unfiltered)."""
    b = hd.yuv_b
    for j in range(16):
        b[Y_OFF + j * BPS - 1] = 129
    for j in range(8):
        b[U_OFF + j * BPS - 1] = 129
        b[V_OFF + j * BPS - 1] = 129
    if mb_y > 0:
        b[Y_OFF - 1 - BPS] = b[U_OFF - 1 - BPS] = b[V_OFF - 1 - BPS] = 129
    else:
        b[Y_OFF - BPS - 1: Y_OFF - BPS + 20] = bytes([127]) * 21
        b[U_OFF - BPS - 1: U_OFF - BPS + 8] = bytes([127]) * 9
        b[V_OFF - BPS - 1: V_OFF - BPS + 8] = bytes([127]) * 9
    py, pu, pv = planes
    yw, uvw = hd.mb_w * 16, hd.mb_w * 8
    for mb_x in range(hd.mb_w):
        blk = blocks[mb_x]
        if mb_x > 0:  # rotate in the left samples
            for j in range(-1, 16):
                r = Y_OFF + j * BPS
                b[r - 4: r] = b[r + 12: r + 16]
            for j in range(-1, 8):
                for off in (U_OFF, V_OFF):
                    r = off + j * BPS
                    b[r - 4: r] = b[r + 4: r + 8]
        top_y, top_u, top_v = hd.top_y, hd.top_u, hd.top_v
        if mb_y > 0:
            b[Y_OFF - BPS: Y_OFF - BPS + 16] = top_y[16 * mb_x: 16 * mb_x + 16]
            b[U_OFF - BPS: U_OFF - BPS + 8] = top_u[8 * mb_x: 8 * mb_x + 8]
            b[V_OFF - BPS: V_OFF - BPS + 8] = top_v[8 * mb_x: 8 * mb_x + 8]
        coeffs, bits = blk["coeffs"], blk["non_zero_y"]
        if blk["is_i4x4"]:
            tr = Y_OFF - BPS + 16
            if mb_y > 0:
                if mb_x >= hd.mb_w - 1:
                    b[tr: tr + 4] = bytes([top_y[16 * mb_x + 15]]) * 4
                else:
                    b[tr: tr + 4] = top_y[16 * mb_x + 16: 16 * mb_x + 20]
            for k in (4, 8, 12):  # the top-right samples again below, for the right column
                b[tr + k * BPS: tr + k * BPS + 4] = b[tr: tr + 4]
            for n in range(16):
                d = Y_OFF + SCAN[n]
                _pred4(b, d, blk["imodes"][n])
                if bits >> 30:
                    _transform(coeffs, 16 * n, b, d, bits >> 30 == 3)
                bits = (bits << 2) & 0xFFFFFFFF
        else:
            _pred_block(b, Y_OFF, _check_mode(mb_x, mb_y, blk["imodes"][0]), 16)
            if bits:
                for n in range(16):
                    if bits >> 30:
                        _transform(coeffs, 16 * n, b, Y_OFF + SCAN[n], bits >> 30 == 3)
                    bits = (bits << 2) & 0xFFFFFFFF
        uv_mode = _check_mode(mb_x, mb_y, blk["uvmode"])
        _pred_block(b, U_OFF, uv_mode, 8)
        _pred_block(b, V_OFF, uv_mode, 8)
        bits_uv = blk["non_zero_uv"]
        for sh, off, c0 in ((0, U_OFF, 256), (8, V_OFF, 320)):
            if (bits_uv >> sh) & 0xFF:
                for n in range(4):
                    _transform(coeffs, c0 + 16 * n, b, off + (n & 1) * 4 + (n >> 1) * 4 * BPS, (bits_uv >> sh) & 0xAA)
        if mb_y < hd.mb_h - 1:  # the top samples of the next row, unfiltered
            top_y[16 * mb_x: 16 * mb_x + 16] = b[Y_OFF + 15 * BPS: Y_OFF + 15 * BPS + 16]
            top_u[8 * mb_x: 8 * mb_x + 8] = b[U_OFF + 7 * BPS: U_OFF + 7 * BPS + 8]
            top_v[8 * mb_x: 8 * mb_x + 8] = b[V_OFF + 7 * BPS: V_OFF + 7 * BPS + 8]
        for j in range(16):
            o = (16 * mb_y + j) * yw + 16 * mb_x
            py[o: o + 16] = b[Y_OFF + j * BPS: Y_OFF + j * BPS + 16]
        for j in range(8):
            o = (8 * mb_y + j) * uvw + 8 * mb_x
            pu[o: o + 8] = b[U_OFF + j * BPS: U_OFF + j * BPS + 8]
            pv[o: o + 8] = b[V_OFF + j * BPS: V_OFF + j * BPS + 8]


# ------------------------------------------------------------------ loop filter
def _sclip1(v: int) -> int:  # [-1020, 1020] -> [-128, 127]
    return -128 if v < -128 else (127 if v > 127 else v)


def _sclip2(v: int) -> int:  # [-112, 112] -> [-16, 15]
    return -16 if v < -16 else (15 if v > 15 else v)


def _filter2(p: bytearray, i: int, s: int) -> None:
    p1, p0, q0, q1 = p[i - 2 * s], p[i - s], p[i], p[i + s]
    a = 3 * (q0 - p0) + _sclip1(p1 - q1)
    a1, a2 = _sclip2((a + 4) >> 3), _sclip2((a + 3) >> 3)
    p[i - s] = _clip8(p0 + a2)
    p[i] = _clip8(q0 - a1)


def _filter4(p: bytearray, i: int, s: int) -> None:
    p1, p0, q0, q1 = p[i - 2 * s], p[i - s], p[i], p[i + s]
    a = 3 * (q0 - p0)
    a1, a2 = _sclip2((a + 4) >> 3), _sclip2((a + 3) >> 3)
    a3 = (a1 + 1) >> 1
    p[i - 2 * s] = _clip8(p1 + a3)
    p[i - s] = _clip8(p0 + a2)
    p[i] = _clip8(q0 - a1)
    p[i + s] = _clip8(q1 - a3)


def _filter6(p: bytearray, i: int, s: int) -> None:
    p2, p1, p0, q0, q1, q2 = p[i - 3 * s], p[i - 2 * s], p[i - s], p[i], p[i + s], p[i + 2 * s]
    a = _sclip1(3 * (q0 - p0) + _sclip1(p1 - q1))
    a1, a2, a3 = (27 * a + 63) >> 7, (18 * a + 63) >> 7, (9 * a + 63) >> 7
    p[i - 3 * s] = _clip8(p2 + a3)
    p[i - 2 * s] = _clip8(p1 + a2)
    p[i - s] = _clip8(p0 + a1)
    p[i] = _clip8(q0 - a1)
    p[i + s] = _clip8(q1 - a2)
    p[i + 2 * s] = _clip8(q2 - a3)


def _simple_edge(p: bytearray, i: int, s: int, step: int, thresh: int) -> None:
    """SimpleVFilter16 / SimpleHFilter16: 16 positions along an edge."""
    t2 = 2 * thresh + 1
    for k in range(16):
        j = i + k * step
        if 4 * abs(p[j - s] - p[j]) + abs(p[j - 2 * s] - p[j + s]) <= t2:
            _filter2(p, j, s)


def _normal_edge(p: bytearray, i: int, s: int, step: int, size: int, thresh: int, ithresh: int, hev: int,
                 mb_edge: bool) -> None:
    """FilterLoop26 (macroblock edge) / FilterLoop24 (inner edge)."""
    t2 = 2 * thresh + 1
    for k in range(size):
        j = i + k * step
        p3, p2, p1, p0 = p[j - 4 * s], p[j - 3 * s], p[j - 2 * s], p[j - s]
        q0, q1, q2, q3 = p[j], p[j + s], p[j + 2 * s], p[j + 3 * s]
        if 4 * abs(p0 - q0) + abs(p1 - q1) > t2:
            continue
        if (abs(p3 - p2) > ithresh or abs(p2 - p1) > ithresh or abs(p1 - p0) > ithresh or abs(q3 - q2) > ithresh
                or abs(q2 - q1) > ithresh or abs(q1 - q0) > ithresh):
            continue
        if abs(p1 - p0) > hev or abs(q1 - q0) > hev:
            _filter2(p, j, s)
        elif mb_edge:
            _filter6(p, j, s)
        else:
            _filter4(p, j, s)


def _filter_strengths(hd: _Header) -> list[list[tuple[int, int, int]]]:
    """PrecomputeFilterStrengths: (limit, interior limit, hev threshold) a
    segment and 16x16 / 4x4."""
    out = []
    for s in range(4):
        base = hd.filter_strength[s] + (0 if hd.absolute_delta else hd.level) if hd.use_segment else hd.level
        row = []
        for i4 in (0, 1):
            level = base
            if hd.use_lf_delta:
                level += hd.ref_lf_delta[0]
                if i4:
                    level += hd.mode_lf_delta[0]
            level = 0 if level < 0 else (63 if level > 63 else level)
            if level > 0:
                ilevel = level
                if hd.sharpness > 0:
                    ilevel >>= 2 if hd.sharpness > 4 else 1
                    ilevel = min(ilevel, 9 - hd.sharpness)
                ilevel = max(ilevel, 1)
                row.append((2 * level + ilevel, ilevel, 2 if level >= 40 else (1 if level >= 15 else 0)))
            else:
                row.append((0, 0, 0))
        out.append(row)
    return out


def _loop_filter(hd: _Header, infos: list[list[tuple]], planes) -> None:
    """DoFilter over every macroblock in raster order."""
    py, pu, pv = planes
    ys, uvs = hd.mb_w * 16, hd.mb_w * 8
    for mb_y in range(hd.mb_h):
        for mb_x in range(hd.mb_w):
            limit, ilevel, hev, inner = infos[mb_y][mb_x]
            if limit == 0:
                continue
            y0 = mb_y * 16 * ys + mb_x * 16
            if hd.filter_type == 1:
                if mb_x > 0:
                    _simple_edge(py, y0, 1, ys, limit + 4)
                if inner:
                    for k in (4, 8, 12):
                        _simple_edge(py, y0 + k, 1, ys, limit)
                if mb_y > 0:
                    _simple_edge(py, y0, ys, 1, limit + 4)
                if inner:
                    for k in (4, 8, 12):
                        _simple_edge(py, y0 + k * ys, ys, 1, limit)
                continue
            c0 = mb_y * 8 * uvs + mb_x * 8
            if mb_x > 0:
                _normal_edge(py, y0, 1, ys, 16, limit + 4, ilevel, hev, True)
                for pc in (pu, pv):
                    _normal_edge(pc, c0, 1, uvs, 8, limit + 4, ilevel, hev, True)
            if inner:
                for k in (4, 8, 12):
                    _normal_edge(py, y0 + k, 1, ys, 16, limit, ilevel, hev, False)
                for pc in (pu, pv):
                    _normal_edge(pc, c0 + 4, 1, uvs, 8, limit, ilevel, hev, False)
            if mb_y > 0:
                _normal_edge(py, y0, ys, 1, 16, limit + 4, ilevel, hev, True)
                for pc in (pu, pv):
                    _normal_edge(pc, c0, uvs, 1, 8, limit + 4, ilevel, hev, True)
            if inner:
                for k in (4, 8, 12):
                    _normal_edge(py, y0 + k * ys, ys, 1, 16, limit, ilevel, hev, False)
                for pc in (pu, pv):
                    _normal_edge(pc, c0 + 4 * uvs, uvs, 1, 8, limit, ilevel, hev, False)


def decode_vp8(data: bytes, name: str = "<vp8>") -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """A VP8 key frame (the payload of a ``VP8 `` chunk and whatever
    follows it in the buffer, as libwebp reads it) -> Y (H, W), U and V
    ((H + 1) // 2, (W + 1) // 2) uint8 planes."""
    hd, br, parts = _parse_header(data, name)
    hd.intra_t = [DC_PRED] * (4 * hd.mb_w)
    hd.nz, hd.nz_dc = [0] * hd.mb_w, [0] * hd.mb_w
    hd.top_y, hd.top_u, hd.top_v = bytearray(16 * hd.mb_w), bytearray(8 * hd.mb_w), bytearray(8 * hd.mb_w)
    hd.yuv_b = bytearray(YUV_SIZE)
    yw, uvw = 16 * hd.mb_w, 8 * hd.mb_w
    planes = (bytearray(yw * 16 * hd.mb_h), bytearray(uvw * 8 * hd.mb_h), bytearray(uvw * 8 * hd.mb_h))
    strengths = _filter_strengths(hd) if hd.filter_type else None
    infos = []
    for mb_y in range(hd.mb_h):
        token_br = parts[mb_y & (len(parts) - 1)]
        hd.intra_l = [DC_PRED] * 4
        blocks = [dict() for _ in range(hd.mb_w)]
        for mb_x in range(hd.mb_w):
            _intra_modes(br, hd, hd.intra_t, mb_x, blocks[mb_x])
        if br.eof:
            raise VP8Error(f"{name}: premature end of VP8 partition 0")
        hd.nz_left = hd.nz_dc_left = 0
        for mb_x in range(hd.mb_w):
            _decode_mb(token_br, hd, mb_x, blocks[mb_x])
            if token_br.eof:
                raise VP8Error(f"{name}: premature end of VP8 data")
        if strengths is not None:
            infos.append([strengths[blk["segment"]][int(blk["is_i4x4"])][:3] + (blk["f_inner"],) for blk in blocks])
        _reconstruct_row(hd, mb_y, blocks, planes)
    if strengths is not None:
        _loop_filter(hd, infos, planes)
    w, h = hd.width, hd.height
    y = np.frombuffer(bytes(planes[0]), np.uint8).reshape(16 * hd.mb_h, yw)[:h, :w]
    u = np.frombuffer(bytes(planes[1]), np.uint8).reshape(8 * hd.mb_h, uvw)[: (h + 1) // 2, : (w + 1) // 2]
    v = np.frombuffer(bytes(planes[2]), np.uint8).reshape(8 * hd.mb_h, uvw)[: (h + 1) // 2, : (w + 1) // 2]
    return np.ascontiguousarray(y), np.ascontiguousarray(u), np.ascontiguousarray(v)
