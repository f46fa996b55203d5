"""The port stands alone: ``repro_torch`` and ``chip_smoke.py`` load neither
``jax`` nor the JAX package, and the entry points never fall back to the
CPU on their own."""
import ast
import os
import subprocess
import sys
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

ROOT = Path(__file__).resolve().parent.parent
PKG = ROOT / "src" / "repro_torch"
FORBIDDEN = ("jax", "jaxlib", "repro")


def _forbidden(name: str) -> bool:
    return any(name == f or name.startswith(f + ".") for f in FORBIDDEN)


def test_imports_load_no_jax_or_repro():
    """conftest imports jax into this process, so look from a fresh one."""
    mods = sorted(
        "repro_torch." + ".".join(p.relative_to(PKG).with_suffix("").parts)
        for p in PKG.rglob("*.py") if p.name != "__init__.py")
    code = (
        "import sys\n"
        f"sys.path[:0] = [{str(ROOT / 'src')!r}, {str(ROOT)!r}]\n"
        "import importlib, repro_torch, chip_smoke\n"
        f"for m in {mods!r}: importlib.import_module(m)\n"
        "chip_smoke.zone_jobs('int8')\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
        f"{FORBIDDEN!r})\n"
        "print(len(sys.modules), bad)\n"
        "assert not bad, bad\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300, env=env, cwd=ROOT)
    assert out.returncode == 0, out.stdout + out.stderr


@pytest.mark.parametrize("path", sorted(
    str(p.relative_to(ROOT)) for p in [
        *PKG.rglob("*.py"), ROOT / "chip_smoke.py",
        *ROOT.glob("scripts/torch_*.py"), *ROOT.glob("examples/torch_*.py"),
        ROOT / "tests" / "test_torch_cuda.py", ROOT / "tests" / "test_torch_cases.py",
        ROOT / "tests" / "test_torch_lanes_cards_cuda.py"]))
def test_source_never_imports_jax_or_repro(path):
    """Also catches imports inside functions, which run only on the card."""
    tree = ast.parse((ROOT / path).read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            names = [node.module or ""]
        else:
            continue
        assert not any(map(_forbidden, names)), (path, node.lineno, names)


def test_default_device_without_a_card_raises(monkeypatch):
    from repro_torch.data import sky
    from repro_torch.mapreduce import (ZonePartitioner, catalog_from_numpy,
                                       catalog_to_numpy, neighbor_search_job,
                                       run_job, run_jobs, shuffle_once)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    xyz = sky.make_catalog(200, 0)
    job = neighbor_search_job(0.05)
    for call in (lambda: run_jobs([job], xyz), lambda: run_job(job, xyz),
                 lambda: shuffle_once(ZonePartitioner(0.05), xyz)):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            call()
    cat = shuffle_once(ZonePartitioner(0.05), xyz, device="cpu")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        catalog_from_numpy(catalog_to_numpy(cat))
    assert isinstance(cat.run(job)[0].output, int)      # stays where it is
    # the LM serving path
    from repro_torch.configs import RunConfig, get_arch
    from repro_torch.launch import serve
    from repro_torch.models import convert
    from repro_torch.models import model as mdl
    from repro_torch.serving import (ServeEngine, make_decode_step,
                                     make_prefill_step)
    cfg, rc = get_arch("tinyllama-1.1b").reduced(), RunConfig()
    lm = mdl.init(cfg, device="cpu")
    for call in (lambda: mdl.LM(cfg), lambda: mdl.init(cfg),
                 lambda: mdl.init_cache(cfg, 2, 16),
                 lambda: make_prefill_step(cfg, rc, 16),
                 lambda: make_decode_step(cfg, rc),
                 lambda: ServeEngine(cfg, rc, lm),
                 lambda: serve.main(["--reduced"]),
                 lambda: convert.params_from_numpy({}, cfg),
                 lambda: convert.cache_from_numpy({}, cfg)):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            call()
    assert ServeEngine(cfg, rc, lm, device="cpu").cache[0]["attn"]["k"] \
        .device.type == "cpu"


def test_chip_smoke_refuses_to_run_without_a_card(tmp_path):
    """Alone in a directory, or on a machine without CUDA, the script exits
    non-zero and prints no result line."""
    lone = tmp_path / "chip_smoke.py"
    lone.write_text((ROOT / "chip_smoke.py").read_text())
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["CUDA_VISIBLE_DEVICES"] = ""
    for script in (lone, ROOT / "chip_smoke.py"):
        out = subprocess.run([sys.executable, str(script), "--n", "1000"],
                             capture_output=True, text=True, timeout=300,
                             env=env, cwd=script.parent)
        assert out.returncode != 0
        assert '"ok"' not in out.stdout


# nvcc -Xptxas -v's report in the form the kernel builds write it (the
# mangled names are those of zones_pairs.cu, quantize.cu and
# flash_attention.cu): a bool and an int literal argument, a class-type
# argument, and a performance warning
PTXAS_LOG = """\
ptxas info    : 0 bytes gmem
ptxas info    : Compiling entry function '_ZN12_GLOBAL__N_117hist_tiled_kernelILb0EEEvPKfS2_PKiS4_iiiS2_iiPy' for 'sm_90a'
ptxas info    : Function properties for _ZN12_GLOBAL__N_117hist_tiled_kernelILb0EEEvPKfS2_PKiS4_iiiS2_iiPy
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 64 registers, 6144 bytes smem, 456 bytes cmem[0]
ptxas info    : Compiling entry function '_ZN12_GLOBAL__N_115quantize_kernelI13__nv_bfloat16EEvPKT_PaPfi' for 'sm_90a'
ptxas info    : Function properties for _ZN12_GLOBAL__N_115quantize_kernelI13__nv_bfloat16EEvPKT_PaPfi
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 32 registers, 380 bytes cmem[0]
ptxas info    : (C7512) Potential Performance Loss: wgmma.mma_async instructions are serialized due to insufficient register resources for the function '_ZN12_GLOBAL__N_115flash_tc_kernelILi256EEEvPKvS2_S2_Pviiiiiffiif'
ptxas info    : Compiling entry function '_ZN12_GLOBAL__N_115flash_tc_kernelILi64EEEvPKvS2_S2_Pviiiiiffiif' for 'sm_90a'
ptxas info    : Function properties for _ZN12_GLOBAL__N_115flash_tc_kernelILi64EEEvPKvS2_S2_Pviiiiiffiif
    16 bytes stack frame, 16 bytes spill stores, 28 bytes spill loads
ptxas info    : Used 96 registers, 384 bytes cmem[0]
"""


def test_chip_smoke_reads_ptxas_names_and_spills():
    """``chip_smoke.ptxas_summary`` names each kernel with its template
    arguments, a class type included, and keeps its registers, shared
    memory, spills and warnings."""
    sys.path.insert(0, str(ROOT))
    import chip_smoke
    rows = {r["kernel"]: r for r in chip_smoke.ptxas_summary(PTXAS_LOG)}
    assert list(rows) == ["hist_tiled_kernel<0>",
                          "quantize_kernel<__nv_bfloat16>",
                          "flash_tc_kernel<256>", "flash_tc_kernel<64>"]
    assert rows["hist_tiled_kernel<0>"] == {
        "kernel": "hist_tiled_kernel<0>", "warnings": [], "stack_bytes": 0,
        "spill_stores": 0, "spill_loads": 0, "registers": 64,
        "static_smem_bytes": 6144}
    assert rows["quantize_kernel<__nv_bfloat16>"]["static_smem_bytes"] == 0
    assert rows["flash_tc_kernel<256>"]["warnings"] == [
        "C7512 Potential Performance Loss: wgmma.mma_async instructions are "
        "serialized due to insufficient register resources"]
    assert {k: rows["flash_tc_kernel<64>"][k] for k in (
        "stack_bytes", "spill_stores", "spill_loads", "registers")} == {
        "stack_bytes": 16, "spill_stores": 16, "spill_loads": 28,
        "registers": 96}


@pytest.mark.parametrize("mangled,name", [
    ("_ZN12_GLOBAL__N_118count_tiled_kernelILb1EEEvPKfS2_PKiS4_iiifiPy",
     "count_tiled_kernel<1>"),
    ("_ZN12_GLOBAL__N_115quantize_kernelIfEEvPKT_PaPfi",
     "quantize_kernel<float>"),
    ("_ZN12_GLOBAL__N_117dequantize_kernelEPKaPKfPfi", "dequantize_kernel"),
    ("_Z10tmp_kernelIN3c108BFloat16ELin5EEvv", "tmp_kernel<c10::BFloat16,-5>"),
    ("_ZN12_GLOBAL__N_1", "_ZN12_GLOBAL__N_1"),
    ("not_mangled", "not_mangled"),
])
def test_chip_smoke_demangles_kernel_names(mangled, name):
    """Nested and length-prefixed names, literals and builtin types; a
    name it cannot read comes back whole."""
    sys.path.insert(0, str(ROOT))
    import chip_smoke
    assert chip_smoke.kernel_name(mangled) == name
