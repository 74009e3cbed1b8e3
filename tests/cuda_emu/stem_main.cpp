// Runs csrc/stem.cu's kernel on the CPU (see cuda_runtime.h; link with
// runtime.cpp). The test writes stem_emu.cu: stem.cu with the bodies of its
// inline-PTX helpers replaced by calls into the runtime and the launch
// replaced by emu_launch.
//
//   emu B H W c0 c1 c2 ch n c3k sms x.bin w.bin out.bin
//
// x.bin: uint8 (B, H, W, 3); w.bin: the packed bf16 weights; out.bin: bf16
// (B, H/4, W/4, c2). The kernel's plan goes to stderr. Exit 3: the entry
// point refused the spec.
#include <cstdio>
#include <cstdlib>
#include <vector>

#include "cuda_runtime.h"
#include "cuda_bf16.h"
#define EMU_ASM(...)
#include "stem_emu.cu"

void emu_launch(int grid, int bytes, const StemArgs& a) {
  std::fprintf(stderr, "plan R=%d S=%d Wc=%d Hb=%d items=%d grid=%d smem=%d\n", a.R, a.S, a.Wc, a.Hb, a.items,
               grid, bytes);
  emu_grid(dim3(grid), dim3(kThreads), [&a] { stem_kernel(a); });
}

int main(int argc, char** argv) {
  if (argc != 14) return 2;
  const int B = std::atoi(argv[1]), H = std::atoi(argv[2]), W = std::atoi(argv[3]), c2 = std::atoi(argv[6]);
  g_sms = std::atoi(argv[10]);
  const std::vector<char> x = emu_read_file(argv[11]), w = emu_read_file(argv[12]);
  std::vector<char> out(static_cast<size_t>(B) * (H / 4) * (W / 4) * c2 * 2, 0);
  const int err = fce_fused_stem(x.data(), w.data(), out.data(), B, H, W, std::atoi(argv[4]), std::atoi(argv[5]),
                                 c2, std::atoi(argv[7]), std::atoi(argv[8]), std::atoi(argv[9]), nullptr);
  if (err) return 3;
  emu_write_file(argv[13], out.data(), out.size());
  return 0;
}
