"""On the card: each cell's control, the reference computed in fp8 in the
program's place, comes out not correct on three seeds, while the program
on the same seeds comes out correct; and each planted fault of a cell
(tools/readings.py MODE_FAULTS) comes out not correct. Both go through
the harness's own path (`run.run_cell`).

    python -m pytest benchmarks/tests/test_bench_card.py -q

Every test needs an NVIDIA GPU and skips without one (decided in a
fixture). The cells run at their own sizes with a 2-second window.
"""

import json
from pathlib import Path

import pytest

from benchmarks import compare

ROOT = Path(__file__).resolve().parents[2]
CELLS = [w["name"] for w in json.loads((ROOT / "BENCHMARK.json").read_text())["workloads"]]
SEEDS = (101, 2 ** 31 + 5, 77777)


@pytest.fixture
def card():
    torch = pytest.importorskip("torch")
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    from benchmarks import run

    run._cache_dirs()
    return torch.device("cuda", 0)


def _mode(cell):
    from benchmarks import run

    return run.load_cell(cell)["traffic"]["mode"]


@pytest.mark.cuda
@pytest.mark.parametrize("cell", CELLS)
def test_control_fails_and_program_passes(card, cell):
    from benchmarks.tools.readings import reading

    for seed in SEEDS:
        out = reading(cell, seed, 2.0, control=True, device=card)
        assert compare.verdict(out["numbers"], out["limits"]), (seed, out["numbers"])
        assert not compare.verdict(out["control"], out["limits"]), (seed, out["control"])


@pytest.mark.cuda
@pytest.mark.parametrize("cell", CELLS)
def test_faults_fail(card, cell, monkeypatch):
    from benchmarks.tools.readings import FAULTS as PLANT
    from benchmarks.tools.readings import MODE_FAULTS, reading

    for fault in MODE_FAULTS[_mode(cell)]:
        with monkeypatch.context() as m:
            PLANT[fault](m.setattr)
            out = reading(cell, SEEDS[0], 2.0, control=False, device=card)
        assert not compare.verdict(out["numbers"], out["limits"]), (fault, out["numbers"])
