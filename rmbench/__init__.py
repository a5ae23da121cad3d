"""The benchmark of the PyTorch and CUDA port: `python3 -m rmbench.run`
(`run.py`), driven by `BENCHMARK.json` at the root of the checkout."""
