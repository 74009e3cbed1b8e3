"""`python -m fce_yolo_tpu_torch TASK MODE k=v...` — the same grammar as the `yolo-tpu-torch` console script."""

from fce_yolo_tpu_torch.cfg import entrypoint

if __name__ == "__main__":
    entrypoint()
