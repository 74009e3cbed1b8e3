// Runs csrc/jpeg.cu on the CPU (see cuda_runtime.h; link with runtime.cpp).
// The test writes jpeg_emu.cu: jpeg.cu with each launch turned into
// emu_launch; every "device" buffer is host memory.
//
//   jpeg in.jpg info.bin coef.bin qt.bin bgr.bin
//
// info.bin: the int32[48] record (after the decode, info[8] says whether a
// marker cut the data short); coef.bin: fce_jpeg_coefficients' int16
// planes; qt.bin: its int32 (3, 64) tables; bgr.bin: fce_jpeg_decode's BGR
// uint8 (H, W, 3), not oriented. Each entry point is first called with no
// room, as the wrapper's first call is: it must fill the record and ask for
// room (kGrow) without writing a buffer. The buffers then start as garbage,
// as torch.empty leaves them. Exit 3: an entry point refused the file (its
// code on stderr); exit 4: one wrote past its room or did not ask for it.
#include <cstdio>
#include <cstdlib>
#include <vector>

#include "cuda_runtime.h"
#include "jpeg_emu.cu"

int main(int argc, char** argv) {
  if (argc != 6) return 2;
  const std::vector<char> buf = emu_read_file(argv[1]);
  const long long len = static_cast<long long>(buf.size());
  int info[kInfoLen];
  int32_t qt0[3 * 64];
  int err = fce_jpeg_coefficients(buf.data(), len, nullptr, 0, qt0, info);
  if (err != kGrow) {
    std::fprintf(stderr, "fce_jpeg_coefficients %d\n", err);
    return err ? 3 : 4;
  }
  const size_t total = static_cast<size_t>(info[7]), out_n = static_cast<size_t>(info[0]) * info[1] * 3;
  // one guard element past each buffer's room: no entry point may touch it
  std::vector<int16_t> coef(total + 1, 0x5a5a), h_coef(total + 1, 0x5a5a), d_coef(total + 1, 0x5a5a);
  std::vector<int32_t> qt(3 * 64, -1);
  std::vector<uint8_t> planes(total + 1, 0xa5), d_out(out_n + 1, 0xa5), h_out(out_n + 1, 0xa5);
  int info2[kInfoLen];
  err = fce_jpeg_coefficients(buf.data(), len, coef.data(), static_cast<long long>(total), qt.data(), info2);
  if (err) {
    std::fprintf(stderr, "fce_jpeg_coefficients %d\n", err);
    return 3;
  }
  float times[5];
  err = fce_jpeg_decode(buf.data(), len, info, h_coef.data(), d_coef.data(), planes.data(),
                        static_cast<long long>(total) - 1, d_out.data(), h_out.data(),
                        static_cast<long long>(out_n), times, nullptr);
  if (err != kGrow || h_coef[0] != 0x5a5a || h_out[0] != 0xa5) {
    std::fprintf(stderr, "fce_jpeg_decode with a coefficient short: %d\n", err);
    return 4;
  }
  err = fce_jpeg_decode(buf.data(), len, info, h_coef.data(), d_coef.data(), planes.data(),
                        static_cast<long long>(total), d_out.data(), h_out.data(), static_cast<long long>(out_n),
                        times, nullptr);
  if (err) {
    std::fprintf(stderr, "fce_jpeg_decode %d\n", err);
    return 3;
  }
  if (coef[total] != 0x5a5a || h_coef[total] != 0x5a5a || d_coef[total] != 0x5a5a || planes[total] != 0xa5 ||
      d_out[out_n] != 0xa5 || h_out[out_n] != 0xa5) {
    std::fprintf(stderr, "a buffer was written past its room\n");
    return 4;
  }
  emu_write_file(argv[2], info, sizeof info);
  emu_write_file(argv[3], coef.data(), total * 2);
  emu_write_file(argv[4], qt.data(), qt.size() * 4);
  emu_write_file(argv[5], h_out.data(), out_n);
  return 0;
}
