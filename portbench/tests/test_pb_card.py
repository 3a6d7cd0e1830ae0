"""The harness on the card at SMOKE size (skips without one): both
drivers through the program's CUDA kernels against the plain reference,
and the float8 control failing there too.  Run on a card machine with
``python -m pytest -m gpu portbench/tests/test_pb_card.py``."""
import time

import pytest
import torch

from portbench import core
from portbench.drivers import fl_round
from portbench.tests import smoke

pytestmark = pytest.mark.gpu


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the program's kernels run only there")
    return torch.device("cuda", 0)


@pytest.mark.parametrize("cell", ["olmoe.fl-smoke", "qwen.serve-smoke"])
def test_smoke_cells_on_the_card(tmp_path, card, cell):
    root = smoke.write(tmp_path)
    res = core.run(root, cell, 2**35 + 3, 0.5, True, card,
                   time.perf_counter())
    assert res["correct"], res["checks"]
    assert res["device"]["platform"] == "gpu"
    assert res["device"]["busy_s"] > 0


def test_fp8_control_fails_on_the_card(tmp_path, card):
    root = smoke.write(tmp_path)
    c = core.load_cell(root, "olmoe.fl-smoke")
    drv = fl_round.Driver(c, card)
    drv.setup(11)
    drv.free_program()
    got = drv.stand_in(precision="fp8")
    assert not all(j["ok"] for j in core.judge(got, c.limits).values())
