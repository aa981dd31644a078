"""The command's own contract where there is no card: no result, a non-zero
exit, the reason on standard error; and an unknown cell is refused."""

import subprocess
import sys

import pytest

from benchmark import run


@pytest.fixture
def no_card():
    import torch

    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA device")


def test_exits_without_a_card(no_card, capsys):
    rc = run.main(["--workload", "fine_kits.serve.kits", "--seed", "5", "--seconds", "1"])
    out, err = capsys.readouterr()
    assert rc == run.EXIT_NO_CARD and out == "" and "CUDA" in err


def test_unknown_cell_is_refused():
    with pytest.raises(SystemExit):
        run.load_cell(run.ROOT, "no.such.cell")


def test_command_line_without_a_card(no_card):
    p = subprocess.run([sys.executable, "-m", "benchmark.run", "--workload",
                        "renal_anatomy.train.p128", "--seed", str(2**33), "--seconds", "1",
                        "--trace", "1"], cwd=run.ROOT, capture_output=True, text=True,
                       timeout=120)
    assert p.returncode != 0 and p.stdout == ""
