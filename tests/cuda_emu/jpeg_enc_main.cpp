// Runs the JPEG writer of csrc/jpeg.cu on the CPU (see cuda_runtime.h; link
// with runtime.cpp): jpeg_fdct_kernel through fce_jpeg_fdct, then
// fce_jpeg_entropy, first with too little room (it must ask for more and
// write nothing).
//
//   jpeg_enc in.raw H W ncomp quality coef.bin out.jpg
//
// in.raw: the uint8 (H, W, ncomp) image; coef.bin: the kernel's int16
// coefficients; out.jpg: the file. Exit 3: an entry point failed (its code
// on stderr); exit 4: one wrote past its room or did not ask for it.
#include <cstdio>
#include <cstdlib>
#include <vector>

#include "cuda_runtime.h"
#include "jpeg_emu.cu"

int main(int argc, char** argv) {
  if (argc != 8) return 2;
  const std::vector<char> img = emu_read_file(argv[1]);
  const int h = std::atoi(argv[2]), w = std::atoi(argv[3]), nc = std::atoi(argv[4]), q = std::atoi(argv[5]);
  const EncGeom g = enc_geom(w, h, nc, q);
  const size_t total = static_cast<size_t>(g.blk_off[nc]) * 64;
  // garbage in every coefficient, as torch.empty leaves it, and one guard element past the room
  std::vector<int16_t> coef(total + 1, 0x5a5a);
  int err = fce_jpeg_fdct(img.data(), coef.data(), h, w, nc, q, nullptr);
  if (err || coef[total] != 0x5a5a) {
    std::fprintf(stderr, "fce_jpeg_fdct %d\n", err);
    return err ? 3 : 4;
  }
  long long size = -1;
  std::vector<uint8_t> out(16, 0xa5);
  err = fce_jpeg_entropy(coef.data(), h, w, nc, q, out.data(), 15, &size);
  if (err != kGrow || size <= 15 || out[0] != 0xa5) {
    std::fprintf(stderr, "fce_jpeg_entropy with too little room: %d\n", err);
    return 4;
  }
  out.assign(static_cast<size_t>(size) + 1, 0xa5);
  err = fce_jpeg_entropy(coef.data(), h, w, nc, q, out.data(), size, &size);
  if (err || out[static_cast<size_t>(size)] != 0xa5) {
    std::fprintf(stderr, "fce_jpeg_entropy %d\n", err);
    return err ? 3 : 4;
  }
  emu_write_file(argv[6], coef.data(), total * 2);
  emu_write_file(argv[7], out.data(), static_cast<size_t>(size));
  return 0;
}
