"""The kernel libraries' build recipe, on the CPU (no ``nvcc`` needed): each
library compiles with the common flags and then its own, and its built path
is named by a hash of both, so a change of flags rebuilds it."""
import pytest

pytest.importorskip("torch")

from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels.flash_attention import kernel as fkernel  # noqa: E402
from repro_torch.kernels.quantize import kernel as qkernel  # noqa: E402
from repro_torch.kernels.zones_pairs import kernel as zkernel  # noqa: E402

LIBRARIES = {"zones_pairs": zkernel.LIBRARY, "quantize": qkernel.LIBRARY,
             "flash_attention": fkernel.LIBRARY}
EXACT = {"zones_pairs": True, "quantize": True, "flash_attention": False}


@pytest.mark.parametrize("name", sorted(LIBRARIES))
def test_library_flags_enter_its_path(name):
    lib = LIBRARIES[name]
    flags = lib.nvcc_flags()
    assert flags[:len(_build.NVCC_FLAGS)] == _build.NVCC_FLAGS
    assert ("-fmad=false" in flags) == EXACT[name]
    same = _build.Library(lib.name, lib.sources, None, flags=lib.flags)
    other = _build.Library(lib.name, lib.sources, None,
                           flags=(*lib.flags, "-DREPRO_TORCH_PROBE=1"))
    assert same.path() == lib.path()
    assert other.path() != lib.path()
    assert other.path().parent == lib.path().parent


def test_library_path_follows_flag_order_and_build_dir(tmp_path, monkeypatch):
    src = zkernel.LIBRARY.sources
    a = _build.Library("probe", src, None, flags=("-DA", "-DB"))
    b = _build.Library("probe", src, None, flags=("-DB", "-DA"))
    plain = _build.Library("probe", src, None)
    assert plain.flags == () and plain.nvcc_flags() == _build.NVCC_FLAGS
    assert len({a.path(), b.path(), plain.path()}) == 3
    monkeypatch.setenv("REPRO_TORCH_BUILD_DIR", str(tmp_path))
    assert a.path().parent == tmp_path
    assert a.path().name.startswith("probe-") and a.path().suffix == ".so"
