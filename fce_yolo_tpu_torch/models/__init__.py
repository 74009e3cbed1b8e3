"""Named model facades (reference ``fce_yolo_tpu/models/``)."""
