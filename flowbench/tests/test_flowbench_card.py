"""On the card: a short run of each cell prints a correct result line."""

import json
import subprocess
import sys

import pytest

from flowbench import layout


@pytest.mark.card
@pytest.mark.parametrize("name", [w["name"] for w in layout.load_benchmark()["workloads"]])
def test_short_run_on_the_card(card, name):
    out = subprocess.run([sys.executable, "-m", "flowbench.run", "--workload",
                          name, "--seed", str(2**31 + 3), "--seconds", "3",
                          "--trace", "0"], capture_output=True, text=True,
                         cwd=layout.ROOT, timeout=600)
    assert out.returncode == 0, out.stderr[-2000:]
    result = json.loads(out.stdout.strip().splitlines()[-1])
    assert result["correct"] and result["device"]["platform"] == "gpu"
