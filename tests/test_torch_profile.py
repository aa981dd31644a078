"""The profile scripts' device-time groups name kernels that exist.

``utils/profile_train.py`` and ``utils/profile_serve.py`` sum the device
time of the port's own kernels by a substring of the kernel's name. A
renamed or deleted kernel would leave its group empty and its time in
"other" without a word, so each such substring must be the name of a
``__global__`` function under ``runet_tpu_torch/kernels/csrc/``.
"""

import re
from pathlib import Path

import pytest

from runet_tpu_torch.utils import profile_serve, profile_train

CSRC = Path(__file__).resolve().parents[1] / "runet_tpu_torch" / "kernels" / "csrc"
GLOBAL = re.compile(r"__global__\s+void\s+(?:__launch_bounds__\([^)]*\)\s+)?(\w+)\s*\(")
OWN = re.compile(r"^(conv3x3_\w+|reduce_splits|reduce_moments|norm_lrelu_planes_kernel)$")


def _global_names():
    return {m.group(1) for p in CSRC.iterdir() if p.suffix in (".cu", ".cuh")
            for m in GLOBAL.finditer(p.read_text())}


def _own_symbols():
    out = []
    for mod in (profile_train, profile_serve):
        script = mod.__name__.rsplit(".", 1)[1]
        for _, subs in mod.GROUPS:
            out += [(script, s) for s in subs if s.startswith(("conv3x3_", "reduce_splits",
                                                               "reduce_moments", "norm_lrelu_"))]
    return out


def test_global_names_are_found():
    names = _global_names()
    assert {"conv3x3_dw_s1_kernel", "conv3x3_dw_s2_kernel", "reduce_splits",
            "reduce_moments"} <= names, sorted(names)


@pytest.mark.parametrize("script,symbol", _own_symbols(), ids=lambda v: v)
def test_profile_group_names_a_kernel(script, symbol):
    assert OWN.match(symbol), f"{script}: {symbol!r} is not a plain kernel name"
    assert symbol in _global_names(), (
        f"{script} groups device time by {symbol!r}, which no __global__ function in "
        f"{CSRC.relative_to(CSRC.parents[2])} is named")
