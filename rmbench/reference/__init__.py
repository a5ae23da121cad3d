"""The benchmark's plain reference: frozen copies of the port's plain
PyTorch pieces that import nothing of the port (`render.py`, `train.py`
are the entry points)."""
