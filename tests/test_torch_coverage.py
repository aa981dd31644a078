"""The port covers the JAX package's public surface, checked from the source
text alone (``ast``; neither package is imported).

For every module ``runet_tpu/<path>.py`` the port has ``runet_tpu_torch/<path>.py``
unless the module is in ``MODULE_EXEMPT``, and for every public top-level
``def`` or ``class`` of a JAX module the port's module of the same path
defines the same name, or the counterpart that ``RENAMES`` names, or the name
is in ``EXEMPT``. The two tables are also the map from each JAX name without
a namesake to what stands for it in the port.

    python -m pytest tests/test_torch_coverage.py -q
"""

from __future__ import annotations

import ast
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parent.parent
JAX_ROOT = ROOT / "runet_tpu"
PORT_ROOT = ROOT / "runet_tpu_torch"

# JAX module (path under the package) -> why the port has no module there.
MODULE_EXEMPT = {
    "utils/cache.py": "XLA's persistent compilation cache; the port's compiled artifacts "
                      "are the kernel libraries that kernels/build.py keeps in BUILD_DIR",
}

# (JAX module, JAX name) -> "port module::port name" that does its job.
RENAMES = {
    ("kernels/fused_block.py", "conv3x3_dchw_m"): "kernels/fused_block.py::ConvStats",
    ("kernels/fused_block.py", "conv3x3_dchw"): "kernels/fused_block.py::ConvStatsV2",
    ("kernels/fused_block.py", "conv3x3_dhcw"): "kernels/fused_block.py::ConvStatsV1",
    ("kernels/fused_block.py", "conv3x3_dchw_dw"): "kernels/fused_block.py::conv3x3_dw",
    ("kernels/fused_block.py", "reference_conv3x3_dchw"):
        "kernels/fused_block.py::conv3x3_stats_plain",
    ("kernels/fused_block.py", "reference_conv3x3_dhcw"):
        "kernels/fused_block.py::conv3x3_stats_dhcw_plain",
    ("kernels/strided_conv.py", "conv3x3_s2"): "kernels/strided_conv.py::ConvS2Stats",
    ("kernels/attic/conv3d.py", "pallas_conv3x3"): "kernels/attic/conv3d.py::attic_conv3x3",
    ("kernels/attic/conv3d.py", "pallas_conv_applicable"):
        "kernels/attic/conv3d.py::conv_applicable",
    ("kernels/attic/conv3d.py", "pallas_conv_shape_ok"): "kernels/attic/conv3d.py::conv_shape_ok",
    ("parallel/dp.py", "split_key_data"): "data/augment.py::sample_seed",
    ("utils/export.py", "export_stablehlo"): "utils/export.py::export_program",
}

# (JAX module, JAX name) -> why the port has no counterpart.
EXEMPT = {
    ("kernels/fused_block.py", "fused_block_applicable"):
        "a TPU tile gate on W; the Hopper kernels take every W (runet_tpu_torch/config.py)",
    ("kernels/strided_conv.py", "conv3x3_s2_applicable"):
        "a TPU tile gate on W; the Hopper kernels take every W (runet_tpu_torch/config.py)",
    ("parallel/comm.py", "batch_spec"):
        "a PartitionSpec constructor; the port shards with parallel/comm.py::shard_batch",
    ("parallel/comm.py", "batch_sharding"):
        "a NamedSharding constructor; the port shards with parallel/comm.py::shard_batch",
    ("parallel/comm.py", "replicated"):
        "a NamedSharding constructor; the port broadcasts with parallel/comm.py::replicate",
    ("infer/ensemble.py", "stack_params"):
        "the port's ensemble runs its members' bundles in a loop, with no stacked tree",
    ("utils/debug.py", "audit_donation"): "torch has no buffer donation",
}


def public_names(path: Path) -> list[str]:
    """Top-level ``def`` / ``class`` names of a module not starting with _."""
    tree = ast.parse(path.read_text(), filename=str(path))
    return [n.name for n in tree.body
            if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef, ast.ClassDef))
            and not n.name.startswith("_")]


def defined_names(path: Path) -> set[str]:
    """Names a module binds at top level by ``def``, ``class`` or assignment."""
    tree = ast.parse(path.read_text(), filename=str(path))
    names = set()
    for n in tree.body:
        if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef, ast.ClassDef)):
            names.add(n.name)
        elif isinstance(n, ast.Assign):
            names.update(t.id for t in n.targets if isinstance(t, ast.Name))
        elif isinstance(n, ast.AnnAssign) and isinstance(n.target, ast.Name):
            names.add(n.target.id)
    return names


def modules(root: Path) -> list[str]:
    return sorted(p.relative_to(root).as_posix() for p in root.rglob("*.py"))


def _target_exists(port_root: Path, target: str) -> bool:
    module, _, name = target.partition("::")
    path = port_root / module
    return path.is_file() and name in defined_names(path)


def module_gaps(jax_root: Path, port_root: Path, module: str, module_exempt=MODULE_EXEMPT,
                renames=RENAMES, exempt=EXEMPT) -> list[str]:
    """What the port lacks of one JAX module, one line each (empty: covered)."""
    if module in module_exempt:
        return []
    port = port_root / module
    if not port.is_file():
        return [f"{module}: no module runet_tpu_torch/{module}"]
    have = defined_names(port)
    gaps = []
    for name in public_names(jax_root / module):
        if name in have or (module, name) in exempt:
            continue
        target = renames.get((module, name))
        if target is None:
            gaps.append(f"{module}::{name}: no counterpart")
        elif not _target_exists(port_root, target):
            gaps.append(f"{module}::{name}: its counterpart {target} does not exist")
    return gaps


@pytest.mark.parametrize("module", modules(JAX_ROOT))
def test_port_covers_jax_module(module):
    assert module_gaps(JAX_ROOT, PORT_ROOT, module) == []


def test_tables_name_live_entries_with_reasons():
    """Every entry names a public name its JAX module still defines, which
    the port has not since defined under the same name; every rename target
    exists; every exemption carries a reason."""
    for module, reason in MODULE_EXEMPT.items():
        assert (JAX_ROOT / module).is_file() and not (PORT_ROOT / module).exists(), module
        assert reason.strip(), module
    for (module, name), target in RENAMES.items():
        assert name in public_names(JAX_ROOT / module), (module, name)
        assert name not in defined_names(PORT_ROOT / module), (module, name)
        assert _target_exists(PORT_ROOT, target), target
    for (module, name), reason in EXEMPT.items():
        assert name in public_names(JAX_ROOT / module), (module, name)
        assert name not in defined_names(PORT_ROOT / module), (module, name)
        assert reason.strip(), (module, name)


def test_checker_reports_what_a_synthetic_port_lacks(tmp_path):
    jax_root, port_root = tmp_path / "jax", tmp_path / "port"
    for d in (jax_root / "sub", port_root / "sub"):
        d.mkdir(parents=True)
    (jax_root / "sub" / "a.py").write_text(
        "def kept(): ...\ndef dropped(): ...\ndef _private(): ...\n"
        "class Renamed: ...\nclass BadRename: ...\ndef waived(): ...\n")
    (port_root / "sub" / "a.py").write_text(
        "from os import path as dropped\nkept = None\nclass NewName: ...\n")
    (jax_root / "b.py").write_text("def f(): ...\n")
    (jax_root / "c.py").write_text("def g(): ...\n")
    renames = {("sub/a.py", "Renamed"): "sub/a.py::NewName",
               ("sub/a.py", "BadRename"): "sub/a.py::Missing"}
    exempt = {("sub/a.py", "waived"): "a reason"}
    kw = dict(module_exempt={"c.py": "a reason"}, renames=renames, exempt=exempt)
    assert modules(jax_root) == ["b.py", "c.py", "sub/a.py"]
    # An import does not define the name; a rename to a missing target is
    # reported as such.
    assert module_gaps(jax_root, port_root, "sub/a.py", **kw) == [
        "sub/a.py::dropped: no counterpart",
        "sub/a.py::BadRename: its counterpart sub/a.py::Missing does not exist",
    ]
    assert module_gaps(jax_root, port_root, "b.py", **kw) == [
        "b.py: no module runet_tpu_torch/b.py"]
    assert module_gaps(jax_root, port_root, "c.py", **kw) == []
