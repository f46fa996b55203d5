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
        ROOT / "tests" / "test_torch_cuda.py", ROOT / "tests" / "test_torch_cases.py"]))
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
