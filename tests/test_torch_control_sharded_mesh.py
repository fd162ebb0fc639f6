"""The sharded control plane on a client mesh: gloo ranks on the CPU.

One job of four CPU processes (``tests/_torch_mesh_worker.py``, a
``FileStore`` under the test's temporary directory) runs every case once,
on one-rank, two-rank and four-rank axes (subgroups of the one world) with
the flat top-k tree, and at four ranks also with fan-in 2 (contiguous
groups {0, 1}, {2, 3}, a tree of both stages) and 1; and it checks each
collective primitive over each axis against its one-process form. Each
rank's history must equal the port's one-device run of the same config:
``num_scheduled``
and ``avail_count`` exactly, every other field within the reference's
``FMA_TOL`` (rtol 2e-5, atol 2e-6, ``tests/test_control_sharded.py``),
λ stitched back to global client order. The cases cover the four exact-K
methods, GCA (its O(N) threshold gather and the ``*_psum_tree``
aggregates), the four transports, a temporal scenario, a battery that
gates clients, a per-client pathloss and the strided λ recorder.
"""
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from _torch_mesh_worker import CASES, WORLD  # noqa: E402
from repro_torch.core.draws import HashDraws  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]


@pytest.fixture(scope="module")
def verdicts(tmp_path_factory):
    """Every rank's verdicts, from one spawned job of ``WORLD`` ranks."""
    work = tmp_path_factory.mktemp("mesh")
    env = dict(os.environ, OMP_NUM_THREADS="1",
               PYTHONPATH=os.pathsep.join([str(ROOT / "src"),
                                           os.environ.get("PYTHONPATH", "")]))
    worker = str(Path(__file__).with_name("_torch_mesh_worker.py"))
    procs = [subprocess.Popen([sys.executable, worker, str(r), str(WORLD),
                               str(work / "store"), str(work)],
                              env=env, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for r in range(WORLD)]
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=240)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    out = {}
    for r in range(WORLD):
        f = work / f"rank{r}.json"
        assert f.exists(), f"rank {r} wrote no verdicts:\n{logs[r][-4000:]}"
        out[r] = json.loads(f.read_text())
    return out


def _check(verdicts, case):
    for rank, v in verdicts.items():
        got = v[case]
        assert "error" not in got, f"rank {rank}:\n{got.get('error')}"
        bad = {f: d for f, d in got["deviation"].items() if d != 0}
        assert got["ok"] and not bad, \
            f"rank {rank}: beyond tolerance {bad} {got.get('detail', '')}"


@pytest.mark.parametrize("case", [c[0] for c in CASES])
def test_mesh_run_equals_one_device_run(verdicts, case):
    _check(verdicts, case)


@pytest.mark.parametrize("d", [1, 2, 4])
def test_collective_primitives_equal_their_one_process_forms(verdicts, d):
    """The top-k tree and ``distributed_top_k`` (ties, −inf shards, k above
    a shard's rows), ownership assembly (bit for bit, an inf row
    included), the bisection, ``lambda_summary`` and GCA's three psum
    aggregates over a D-rank axis against their one-process forms."""
    _check(verdicts, f"primitives_d{d}")


def test_battery_case_gates_clients(verdicts):
    """The battery case is not vacuous: some round has fewer schedulable
    clients than N, and some round schedules fewer than K."""
    v = verdicts[0]["d4_afl_battery"]
    assert min(v["avail_count"]) < 16
    assert min(v["num_scheduled"]) < 5


@pytest.mark.parametrize("n_shards", [1, 2, 3, 5, 8])
def test_hash_stream_is_bit_equal_for_any_split_of_the_ids(n_shards):
    """A client's values depend on (seed, round, stream, id, element) only:
    the draws of any split of the ids, or of a permuted subset, equal the
    rows of the whole draw bit for bit, for every kind of draw."""
    src = HashDraws(7, "cpu")
    r = src.round(3)
    ids = torch.arange(40, dtype=torch.int64)
    draws = {"normal": lambda i: r.chan.normal(i, (2, 3)),
             "shadow": lambda i: r.chan.fold(1).normal(i),
             "uniform": lambda i: r.noise.fold(7).uniform(i, (11,)),
             "gumbel": lambda i: r.asel.gumbel(i),
             "randint": lambda i: r.batch.randint(i, (5,), 9),
             "init": lambda i: src.init().normal(i, (2, 1))}
    perm = torch.from_numpy(np.random.default_rng(n_shards).permutation(40)[:17])
    for name, draw in draws.items():
        full = draw(ids)
        parts = torch.cat([draw(p) for p in torch.tensor_split(ids, n_shards)])
        assert torch.equal(parts, full), name
        assert torch.equal(draw(perm), full[perm]), name
