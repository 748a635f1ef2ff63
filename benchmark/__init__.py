"""The benchmark of the PyTorch and CUDA port (``visualslam_android_tpu_torch``):
full SLAM through ``SLAMSystem.track_frame`` on one H100.

``python benchmark/run.py --workload <cell> --seed <n> --seconds <s>
--trace <0|1>`` runs one cell of ``BENCHMARK.json`` once and prints one
JSON line. Configurations (``configs/``), workloads (``workloads/``) and
per-layer metric readers (``metrics/``) are found by the names that
``BENCHMARK.json`` gives them. ``reference/`` holds the plain reference
that decides ``correct``; it imports nothing of the port.
"""
