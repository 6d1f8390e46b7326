"""The solvers' CUDA graph loop without a graph, for the CPU tests
(``test_torch_solve.py``, ``test_torch_trace.py``): ``cpu_graph`` makes
every solve take the graph loop's path, with ``CpuLoop`` in place of the
captured graph."""

import pytest

from spmv_tpu_torch import solve


class CpuLoop(solve._GraphLoop):
    """The graph loop's chunked, masked iteration without a graph: each
    "replay" runs ``chunk`` masked copies of the body on the CPU."""

    def _capture(self):
        def replay():
            self.flag = self._chunk()
        self.replay = replay


@pytest.fixture
def cpu_graph(monkeypatch):
    monkeypatch.setattr(solve, "_GraphLoop", CpuLoop)
    monkeypatch.setattr(solve, "_uses_graph", lambda device, graph: graph)
