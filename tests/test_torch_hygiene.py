"""The port stands alone: no module of ``runet_tpu_torch`` and not
``chip_smoke.py`` imports JAX, flax or anything of ``runet_tpu``."""

import ast
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "orbax", "runet_tpu")
SOURCES = sorted((ROOT / "runet_tpu_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"]


def _imported_roots(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".")[0], node.lineno
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module.split(".")[0], node.lineno
        elif (isinstance(node, ast.Call) and getattr(node.func, "id", None) == "__import__"
              and node.args and isinstance(node.args[0], ast.Constant)):
            yield str(node.args[0].value).split(".")[0], node.lineno


@pytest.mark.parametrize("path", SOURCES, ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_or_reference_imports(path):
    bad = [(m, ln) for m, ln in _imported_roots(path) if m in FORBIDDEN]
    assert not bad, f"{path.relative_to(ROOT)} imports {bad}"


def test_package_imports_with_jax_blocked():
    """Every module imports in a process where importing JAX fails."""
    mods = [".".join(p.relative_to(ROOT).with_suffix("").parts)
            for p in SOURCES if p.parent != ROOT]
    mods = [m[: -len(".__init__")] if m.endswith(".__init__") else m for m in mods]
    code = ("import sys\n"
            + "".join(f"sys.modules[{m!r}] = None\n" for m in FORBIDDEN)
            + "".join(f"import {m}\n" for m in mods)
            + "import runpy; runpy.run_path('chip_smoke.py', run_name='not_main')\n")
    subprocess.run([sys.executable, "-c", code], cwd=ROOT, check=True, timeout=120)


def test_only_the_multi_device_request_is_left_unported():
    """Nothing of the port raises NotImplementedError any more: the last
    requests that did, ``train(mesh=...)`` and ``ModelConfig.spatial_axis``,
    run on ``parallel/`` (and no source names the exception at all)."""
    raising = []
    for path in SOURCES:
        for node in ast.walk(ast.parse(path.read_text(), filename=str(path))):
            if isinstance(node, ast.Name) and node.id == "NotImplementedError":
                raising.append((str(path.relative_to(ROOT)), node.lineno))
    assert raising == []


def test_every_kernel_module_names_a_source_that_exists():
    """Each ``*SOURCE`` a kernel module names is a ``.cu`` under csrc/, and
    every ``.cu`` there is named by one (no orphan, no missing kernel): the
    seven of the model's path and the four of the attic."""
    from runet_tpu_torch.kernels import build, fused_block, norm_act, strided_conv
    from runet_tpu_torch.kernels.attic import conv3d, conv_v3_deep, fused_norm

    mods = (fused_block, strided_conv, norm_act, conv3d, conv_v3_deep, fused_norm)
    named = {v for mod in mods for k, v in vars(mod).items()
             if k.endswith("SOURCE") and isinstance(v, str)}
    on_disk = {p.stem for p in build.CSRC.glob("*.cu")}
    assert named == on_disk and len(named) == 11
