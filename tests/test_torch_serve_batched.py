"""``examples/serve_batched_torch.py --device cpu``, the port's twin of
``examples/serve_batched.py``: the reduced qwen2-0.5b, xlstm-1.3b and
zamba2-1.2b serve to the end with real tokens, and the rolling cache of
qwen2-0.5b at window 8 holds 8 slots after 24 decode steps."""
import importlib.util
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def test_serve_batched_twin_on_the_cpu(capsys):
    path = Path(__file__).resolve().parents[1] / "examples" / "serve_batched_torch.py"
    spec = importlib.util.spec_from_file_location("serve_batched_torch", path)
    ex = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(ex)
    ids, leaf = ex.main(["--device", "cpu"])
    assert set(ids) == {"qwen2-0.5b", "xlstm-1.3b", "zamba2-1.2b"}
    for toks in ids.values():
        assert toks.shape == (2, 16)
        assert bool(((toks >= 0) & (toks < 512)).all())
    # [L, B, window, Hkv, hd]: O(window), not O(position)
    assert leaf == (2, 2, 8, 2, 64)
    out = capsys.readouterr().out
    assert "zamba2-1.2b" in out and "O(window)" in out
