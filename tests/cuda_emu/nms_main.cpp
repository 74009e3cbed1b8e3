// Runs csrc/nms.cu's three kernels on the CPU (see cuda_runtime.h; link with
// runtime.cpp). The test writes nms_emu.cu: nms.cu with the bodies of its
// cp.async helpers replaced by copies and each launch by emu_launch.
//
//   nms B K max_det iou_thres words boxes.bin scores.bin valid.bin idx.bin ok.bin
//
// boxes.bin: f32 (B, K, 4); scores.bin: f32 (B, K); valid.bin: uint8 (B, K);
// idx.bin: int32 (B, max_det); ok.bin: uint8 (B, max_det). words is the
// wrapper's mask row length (ops/nms.py mask_words). The scratch starts as
// garbage, as torch.empty leaves it. Exit 3: the entry point refused the
// shape; exit 4: the wrapper's mask row length is not the kernel's.
#include <cstdio>
#include <cstdlib>
#include <vector>

#include "cuda_runtime.h"
#define EMU_ASM(...)
#include "nms_emu.cu"

int main(int argc, char** argv) {
  if (argc != 11) return 2;
  const int B = std::atoi(argv[1]), K = std::atoi(argv[2]), max_det = std::atoi(argv[3]);
  const float thres = std::strtof(argv[4], nullptr);
  const int words = std::atoi(argv[5]);
  if (K >= 1 && words != mask_words(K)) return 4;
  const std::vector<char> boxes = emu_read_file(argv[6]), scores = emu_read_file(argv[7]),
                          valid = emu_read_file(argv[8]);
  const size_t bk = static_cast<size_t>(B) * (K > 0 ? K : 0);
  std::vector<int32_t> idx(static_cast<size_t>(B) * max_det, -7);
  std::vector<uint8_t> ok(static_cast<size_t>(B) * max_det, 7);
  std::vector<float4> sboxes(bk);
  std::vector<int32_t> order(bk), count(B);
  std::vector<uint4> mask(bk * words / 4 + 1);
  std::memset(sboxes.data(), 0xff, sboxes.size() * sizeof(float4));
  std::memset(order.data(), 0xa5, order.size() * 4);
  std::memset(count.data(), 0xa5, count.size() * 4);
  std::memset(mask.data(), 0xa5, mask.size() * sizeof(uint4));
  const int err = fce_pick_suppress(boxes.data(), scores.data(), valid.data(), idx.data(), ok.data(), sboxes.data(),
                                    order.data(), count.data(), mask.data(), B, K, max_det, thres, nullptr);
  if (err) return 3;
  emu_write_file(argv[9], idx.data(), idx.size() * 4);
  emu_write_file(argv[10], ok.data(), ok.size());
  return 0;
}
