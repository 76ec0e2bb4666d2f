"""Host-side rules of the port's CUDA kernels, checked on the CPU (no card,
no nvcc): B5's choice of the route that fills its ring of time tiles, and
the build's content hash, which must see every header a source includes."""
import pytest

torch = pytest.importorskip("torch")

from repro_torch import kernels as K  # noqa: E402
from repro_torch.kernels.rglru import kernel as RK  # noqa: E402

BASE = 1 << 20                     # a 16-byte aligned address


@pytest.mark.parametrize("elem,S,C,ptrs,route", [
    (4, 4096, 2560, (BASE, BASE + 4096), "tma"),        # the slice's shape
    (4, 17, 36, (BASE, BASE), "tma"),                   # 144-byte rows
    (2, 17, 2560, (BASE, BASE), "tma"),                 # bf16
    (2, 5, 8, (BASE, BASE + 16), "tma"),                # bf16, 16-byte rows
    (4, 1001, 333, (BASE, BASE), "cp.async"),           # C % 4 != 0
    (4, 10, 70, (BASE, BASE), "cp.async"),              # 280-byte rows
    (2, 10, 2564, (BASE, BASE), "cp.async"),            # bf16, 5128-byte rows
    (4, 10, 2560, (BASE + 4, BASE), "cp.async"),        # log_a misaligned
    (2, 10, 2560, (BASE, BASE + 2), "cp.async"),        # b misaligned
    (4, 0, 2560, (BASE, BASE), "cp.async"),             # no steps: no map
])
def test_rglru_route_rule(elem, S, C, ptrs, route):
    assert RK.route(elem, S, C, *ptrs) == route


def test_rglru_routes_are_the_c_entry_codes():
    assert RK.ROUTES == {"tma": 0, "cp.async": 1}


def _source(tmp_path, monkeypatch, header_text):
    (tmp_path / "local.cuh").write_text(header_text)
    src = tmp_path / "k.cu"
    src.write_text('#include <cuda_runtime.h>\n#include "local.cuh"\n'
                   '  #  include "tf32_mma.cuh"\nint f() { return 0; }\n')
    monkeypatch.setitem(K.SOURCES, "probe", src)
    return src


def test_build_hash_sees_every_included_header(tmp_path, monkeypatch):
    src = _source(tmp_path, monkeypatch, "// v1\n")
    names = [p.name for p in K.included(src.resolve())]
    assert names == ["k.cu", "local.cuh", "tf32_mma.cuh"]  # not <system>
    first = K._target("probe")
    assert K._target("probe") == first                       # stable
    (tmp_path / "local.cuh").write_text("// v2\n")
    assert K._target("probe") != first                       # header edit


def test_build_hash_follows_headers_of_headers(tmp_path, monkeypatch):
    src = _source(tmp_path, monkeypatch, '#include "inner.cuh"\n')
    (tmp_path / "inner.cuh").write_text("// a\n")
    first = K._target("probe")
    (tmp_path / "inner.cuh").write_text("// b\n")
    assert K._target("probe") != first
    assert [p.name for p in K.included(src.resolve())] == [
        "k.cu", "local.cuh", "inner.cuh", "tf32_mma.cuh"]


def test_build_refuses_a_missing_header(tmp_path, monkeypatch):
    src = _source(tmp_path, monkeypatch, '#include "nowhere.cuh"\n')
    with pytest.raises(FileNotFoundError, match="nowhere.cuh"):
        K.included(src.resolve())


@pytest.mark.parametrize("name", sorted(K.SOURCES))
def test_every_kernel_source_resolves_its_headers(name):
    """Every shipped source's quoted includes exist, so its hash (and nvcc)
    finds them; the sources that share the 3xTF32 product include its one
    header."""
    found = [p.name for p in K.included(K.SOURCES[name].resolve())]
    assert found[0] == K.SOURCES[name].name
    if name in ("ssd", "flash_attention_mma"):
        assert "tf32_mma.cuh" in found
