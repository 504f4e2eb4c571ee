"""Package rules of the PyTorch port.

* ``src/repro_torch``, ``chip_smoke.py`` and the card timing tools
  (``tools/*_times.py``) import neither JAX nor anything of the JAX
  package ``repro`` (checked on the AST, so an import inside a function
  counts too).
* An entry point called without ``device=`` means the CUDA card: with no
  card visible it raises instead of running on the CPU.
"""
import ast
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

ROOT = Path(__file__).resolve().parents[1]
SOURCES = sorted((ROOT / "src" / "repro_torch").rglob("*.py")) + [
    ROOT / "chip_smoke.py"] + sorted((ROOT / "tools").glob("*_times.py"))


def _imports(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield node.lineno, a.name
        elif isinstance(node, ast.ImportFrom):
            if node.level == 0 and node.module:
                yield node.lineno, node.module


def _forbidden(module: str) -> bool:
    top = module.split(".")[0]
    return top in ("jax", "jaxlib", "repro") or module.startswith("jax.")


@pytest.mark.parametrize("path", SOURCES,
                         ids=[str(p.relative_to(ROOT)) for p in SOURCES])
def test_port_imports_no_jax_and_nothing_of_repro(path):
    bad = [f"{path.name}:{ln} imports {m}" for ln, m in _imports(path)
           if _forbidden(m)]
    assert not bad, bad


def test_scan_sees_the_whole_package():
    names = {p.relative_to(ROOT / "src" / "repro_torch").as_posix()
             for p in SOURCES if "repro_torch" in p.parts}
    assert {"kernels/flash_attention/ops.py", "serve/scheduler.py",
            "core/context.py", "launch/serve.py", "bridge.py"} <= names
    assert _forbidden("jax.numpy") and _forbidden("repro.configs")
    assert not _forbidden("repro_torch.configs")


@pytest.fixture
def no_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


def test_entry_points_without_device_raise_without_a_card(no_card):
    from repro_torch.configs import get_arch, reduced
    from repro_torch.core.context import ContextSwitchEngine
    from repro_torch.core.env import resolve_device
    from repro_torch.launch.serve import build_server
    from repro_torch.models.model import build_model
    from repro_torch.serve.switching import SwitchableServer

    cfg = reduced(get_arch("supersub-super"))
    for call in (lambda: resolve_device(),
                 lambda: resolve_device("cuda"),
                 lambda: build_model(cfg),
                 lambda: ContextSwitchEngine(),
                 lambda: SwitchableServer(),
                 lambda: build_server(["supersub-super"], 2, 32)):
        with pytest.raises(RuntimeError, match="CUDA"):
            call()
    assert resolve_device("cpu") == torch.device("cpu")
    assert build_model(cfg, device="cpu").device == torch.device("cpu")


def test_launcher_without_platform_raises_without_a_card(no_card):
    from repro_torch.launch.serve import main
    with pytest.raises(RuntimeError, match="no CUDA device"):
        main(["--requests", "1"])
