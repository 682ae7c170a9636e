"""The benchmark of the PyTorch and CUDA port (`infomax3d_tpu_torch`): one
cell of `BENCHMARK.json` per run of `bench_port/run.py` (see README.md)."""
