"""The host side of the CUDA kernels, on the CPU: the ctypes bindings of
`kernels/march.py` against the C sources they call.

No kernel runs here (there is no nvcc and no card), so these read
`csrc/`: every entry point takes as many parameters as its `CudaKernel`
declares argument types, and every argument structure mirrors its C
struct field for field, in order (a field out of place would hand the
kernel another scalar, and no CPU test would see it).
"""
import ctypes
import re

import pytest

from raymarchrenderer_tpu_torch.kernels import march
from raymarchrenderer_tpu_torch.kernels.build import CSRC, CudaKernel

KERNELS = sorted((name for name in dir(march)
                  if isinstance(getattr(march, name), CudaKernel)))


def _c_params(source: str, entry: str) -> list:
    text = (CSRC / source).read_text()
    m = re.search(rf'extern "C" int {entry}\(([^)]*)\)', text)
    assert m, f"{entry} not in {source}"
    return [p.strip() for p in m.group(1).split(",")]


def _c_fields(struct: str) -> list:
    """The field names of a C struct of csrc/, in order, nested structs
    spelled out."""
    for path in sorted(CSRC.iterdir()):
        m = re.search(rf"struct {struct} {{(.*?)\n}};", path.read_text(),
                      re.S)
        if m:
            break
    else:
        raise AssertionError(f"struct {struct} not in csrc/")
    body = re.sub(r"//[^\n]*", "", m.group(1))
    names = []
    for stmt in filter(None, (x.strip() for x in body.split(";"))):
        ctype, rest = stmt.split(None, 1)
        fields = [f.strip() for f in rest.split(",")]
        if ctype in ("int", "float", "uint32_t"):
            names += fields
        else:
            names += [n for _ in fields for n in _c_fields(ctype)]
    return names


def test_every_kernel_is_bound():
    assert len(KERNELS) == 9


@pytest.mark.parametrize("name", KERNELS)
def test_entry_takes_the_bound_arguments(name):
    k = getattr(march, name)
    params = _c_params(k.source.name, k.entry)
    assert len(params) == len(k.argtypes), (params, k.argtypes)
    assert params[-2:] == ["cudaStream_t stream", "int device"]
    # a pointer parameter (the stream is one) is bound as a pointer, an
    # int as an int
    for p, t in zip(params, k.argtypes):
        pointer = "*" in p or p.startswith("cudaStream_t")
        assert pointer == (t is not ctypes.c_int), (p, t)


@pytest.mark.parametrize("cls", [march.MarchArgs, march.PathArgs,
                                 march.SpecArgs, march.SceneDims],
                         ids=lambda c: c.__name__)
def test_argument_structs_mirror_the_c_structs(cls):
    assert [f[0] for f in cls._fields_] == _c_fields(cls.__name__)


@pytest.mark.parametrize("name", ["MARCH_FUSED", "MEGA_PATHS",
                                  "WAVEFRONT_PATHS",
                                  "WAVEFRONT_SPECTRAL", "MEGA_PATHS_DEFER",
                                  "RECORD_PATHS", "RECORD_SPECTRAL",
                                  "RECORD_WAVEFRONT"])
def test_persistent_entries_take_a_queue(name):
    """The entries that run on a queue take its counter before the
    stream (`rmr_mega_paths`'s may be null: one lane per pixel)."""
    k = getattr(march, name)
    assert _c_params(k.source.name, k.entry)[-3] == "int* queue"


Q = march.QUEUE_MAX_PATHS


@pytest.mark.parametrize("n_samples, dispersion, queued", [
    (1, False, True), (128, False, False), (Q, False, True),
    (Q + 1, False, False), (1, True, 3 <= Q), (Q // 3, True, True),
    (Q // 3 + 1, True, False), (Q, True, False)])
def test_mega_paths_queued_reads_paths_a_lane(n_samples, dispersion, queued):
    """A constant- or SH-sky launch runs on the pixel queue at one path a
    lane and up to `QUEUE_MAX_PATHS`, one lane per pixel above it and at
    128; dispersion runs 3 paths a sample."""
    assert march.mega_paths_queued(n_samples, dispersion) is queued
