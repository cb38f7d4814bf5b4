"""The port imports torch and numpy, never JAX, nothing of the JAX
package and not ``requests`` (the card's machine lacks it): an AST scan
of every module of determined_tpu_torch and of chip_smoke.py, plus a
fresh interpreter that imports the serving (the fixture, the HTTP service,
the load generator and the proposer too), trainer (the timeline too),
core, storage and common packages, the TensorBoard writer and the
profiler agent, and finds none of them loaded."""
import ast
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parent.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "determined_tpu", "requests")
SOURCES = sorted(
    str(p.relative_to(ROOT))
    for p in [*(ROOT / "determined_tpu_torch").rglob("*.py"),
              ROOT / "chip_smoke.py"]
)


def _forbidden(name: str) -> bool:
    return name.split(".")[0] in FORBIDDEN


def _imports(tree):
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (alias.name for alias in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module or ""
        elif (isinstance(node, ast.Call)
              and getattr(node.func, "attr", getattr(node.func, "id", ""))
              in ("import_module", "__import__")
              and node.args and isinstance(node.args[0], ast.Constant)):
            yield str(node.args[0].value)


@pytest.mark.parametrize("source", ["<subprocess>", *SOURCES])
def test_port_never_imports_jax(source):
    if source == "<subprocess>":
        code = (
            "import sys, determined_tpu_torch.serving, "
            "determined_tpu_torch.ops.flash_attention, "
            "determined_tpu_torch.ops.paged_attention, "
            "determined_tpu_torch.trainer, determined_tpu_torch.core, "
            "determined_tpu_torch.trainer.profile, "
            "determined_tpu_torch.storage, determined_tpu_torch.common, "
            "determined_tpu_torch.common.faults, "
            "determined_tpu_torch.common.resilience, "
            "determined_tpu_torch.common.metrics, "
            "determined_tpu_torch.serving.fixture, "
            "determined_tpu_torch.serving.service, "
            "determined_tpu_torch.serving.loadgen, "
            "determined_tpu_torch.serving.speculation, "
            "determined_tpu_torch.tensorboard, "
            "determined_tpu_torch.profiler, "
            "determined_tpu_torch.trainer._timeline\n"
            "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
            f"{FORBIDDEN!r})\n"
            "print(','.join(bad))\n"
        )
        out = subprocess.run(
            [sys.executable, "-c", code], cwd=ROOT, capture_output=True,
            text=True, timeout=120, check=True,
        )
        assert out.stdout.strip() == ""
        return
    tree = ast.parse((ROOT / source).read_text(), filename=source)
    bad = [name for name in _imports(tree) if _forbidden(name)]
    assert not bad, f"{source} imports {bad}"
