"""One cap on torch's CPU threads for the port's tests, imported first by
every tests/test_torch_*.py.

The suite runs as six pytest-xdist workers (`-n 6 --dist loadfile`) on
one machine, each beside XLA's own thread pool. With torch's default of
one intra-op thread per core in every worker, the workers' threads
outnumber the cores several times over and each file runs several times
slower than alone. One intra-op and one inter-op thread per worker keeps
the cores busy without that contention (on 8 cores the whole suite took
1,407 s without the cap, 390 s with one thread, 424 s with two). The cap
is set at import, before any torch op runs; under `--dist loadfile` every
worker imports every test file while it collects, so the cap holds in the
whole worker, for the JAX package's tests that call torch too. It changes
no result a test checks: the tests' bars do not depend on how torch
splits its sums over threads.
"""

import pytest

torch = pytest.importorskip("torch")

INTRA_OP_THREADS = 1

torch.set_num_threads(INTRA_OP_THREADS)
if torch.get_num_interop_threads() != 1:
    try:
        torch.set_num_interop_threads(1)
    except RuntimeError:        # inter-op work already ran in this process
        pass


def test_torch_threads_are_capped():
    assert torch.get_num_threads() == INTRA_OP_THREADS
