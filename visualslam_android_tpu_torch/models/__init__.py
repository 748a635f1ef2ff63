"""Map stores, frame front-end, tracker and the per-frame step of the
PyTorch port."""
