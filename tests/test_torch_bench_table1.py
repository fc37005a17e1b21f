"""Table I of the port (``repro_torch.bench.table1``) against the JAX
package's ``benchmarks/bench_table1.py`` on the CPU: its child script
runs once in a subprocess with 8 forced host devices while the port
solves here, and every (stand-in graph, root, variant) row matches on
``ok``, the graph's size and the ``metrics.as_dict()`` fields, and on
``model_ms`` under the reference's cost figures."""

import pytest
import torch

from repro_torch.bench import table1
from test_torch_bench import (
    METRIC_KEYS,
    REF_COST,
    assert_row,
    finish,
    reference_driver,
    start_reference,
)

bench_table1 = reference_driver("bench_table1")

#: (stand-in, root) in bench_table1.py's order; four variants each
POINTS = [("soc-live-proxy", r) for r in ("delta:3", "kla:1", "chaotic")] + \
    [("wiki-talk-proxy", r) for r in ("delta:3", "kla:1", "chaotic")] + \
    [("roadnet-proxy", r) for r in ("delta:1200", "kla:10", "chaotic")] + \
    [("orkut-proxy", r) for r in ("delta:10", "kla:5", "chaotic")]


@pytest.fixture(scope="module")
def rows():
    ref = start_reference(bench_table1.CHILD)
    n_threads = torch.get_num_threads()
    torch.set_num_threads(1)  # leave the cores to the reference process
    try:
        port = table1.run(device="cpu", cost=REF_COST)
    finally:
        torch.set_num_threads(n_threads)
        ref_rows = finish(ref)
    return port, ref_rows


@pytest.mark.parametrize("i", range(len(POINTS)), ids=["/".join(p) for p in POINTS])
def test_table1_rows(rows, i):
    port, ref = rows
    assert len(port) == len(ref) == 4 * len(POINTS)
    for j in range(4 * i, 4 * i + 4):
        p, r = port[j], ref[j]
        assert (p["graph"], p["root"]) == POINTS[i]
        assert p["variant"] == table1.VARIANTS[j % 4]
        assert set(p) == set(r)
        assert_row(p, r, ["graph", "n", "m", "root", "variant", "ok", "model_ms"]
                   + METRIC_KEYS)
