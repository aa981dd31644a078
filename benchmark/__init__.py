"""The benchmark of ``runet_tpu_torch`` on the NVIDIA H100: one command
(``python3 -m benchmark.run``) runs one cell of ``BENCHMARK.json`` once."""
