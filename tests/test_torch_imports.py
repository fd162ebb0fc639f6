"""The port stands alone: it imports neither JAX nor the JAX package (nor
does ``chip_smoke.py``, the port's proof on the card), and its entry points
never fall back to the CPU on their own."""
import dataclasses
import os
import pkgutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import repro_torch  # noqa: E402
from repro_torch.configs.base import FLConfig  # noqa: E402
from repro_torch.core.simulator import run_simulation  # noqa: E402
from repro_torch.models.logreg import logistic_regression  # noqa: E402

SRC = Path(repro_torch.__file__).resolve().parent
CHIP_SMOKE = SRC.parents[1] / "chip_smoke.py"


def test_port_imports_no_jax_and_no_reference_package():
    modules = sorted(m.name for m in pkgutil.walk_packages([str(SRC)], "repro_torch."))
    assert {"repro_torch.core.simulator", "repro_torch.models.xlstm",
            "repro_torch.kernels.slstm.ops", "repro_torch.configs.xlstm_1_3b",
            "repro_torch.federated.server", "repro_torch.federated.rounds",
            "repro_torch.optim.adamw", "repro_torch.data.pipeline",
            "repro_torch.core.sharding", "repro_torch.launch.train",
            "repro_torch.data.synthetic", "repro_torch.models.moe",
            "repro_torch.models.ssm", "repro_torch.models.hybrid",
            "repro_torch.configs.qwen3_moe_30b_a3b",
            "repro_torch.configs.qwen3_moe_235b_a22b",
            "repro_torch.configs.zamba2_1_2b"} <= set(modules)
    code = ("import importlib, sys\n"
            f"for m in {modules!r}: importlib.import_module(m)\n"
            "bad = sorted(n for n in sys.modules if n == 'jax' or n.startswith('jax.')\n"
            "             or n == 'repro' or n.startswith('repro.'))\n"
            "print(','.join(bad))\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, check=True, cwd=SRC.parent, timeout=120)
    assert out.stdout.strip() == ""


def test_port_sources_name_no_jax_or_reference_import():
    """The port, ``chip_smoke.py`` and the mesh tests' worker, which runs
    where only PyTorch and the port are imported."""
    assert CHIP_SMOKE.is_file()
    worker = Path(__file__).with_name("_torch_mesh_worker.py")
    twin = SRC.parents[1] / "examples" / "serve_batched_torch.py"
    for path in [*SRC.rglob("*.py"), CHIP_SMOKE, worker, twin]:
        for line in path.read_text().splitlines():
            words = line.split()
            if words[:1] in (["import"], ["from"]) and len(words) > 1:
                top = words[1].split(".")[0]
                assert top not in ("jax", "jaxlib", "repro"), f"{path}: {line}"


def test_entry_point_without_device_raises_when_no_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    x = np.zeros((4, 5, 3), np.float32)
    y = np.zeros((4, 5), np.int32)
    fl = FLConfig(num_clients=4, clients_per_round=2, rounds=1, batch_size=2)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        run_simulation(logistic_regression(3, 10), fl, (x, y, x, y))


@pytest.mark.parametrize("entry", ["init_sim_state", "transport_from_config",
                                   "scenario_from_config", "sweep_point_from_config",
                                   "logreg_init", "logreg_params_from_jax",
                                   "ParameterServer", "server_init_state",
                                   "sgd_init", "adamw_init", "chain_init",
                                   "HashDraws", "sharded_init_sim_state",
                                   "run_simulation_control_sharded"])
def test_public_function_without_device_raises_when_no_card(monkeypatch, entry):
    """``device=None`` means the card, as at every entry point: without one
    these raise, and with ``device="cpu"`` they build on the CPU."""
    from repro_torch import optim
    from repro_torch.core import (channel, draws, sharding, simulator, sweep,
                                  transport)
    from repro_torch.federated.server import ParameterServer
    from repro_torch.models import logreg
    fl = FLConfig(num_clients=4, clients_per_round=2, rounds=1, batch_size=2)
    model = logistic_regression(3, 10)
    params = {"b": np.zeros(10, np.float32), "w": np.zeros((3, 10), np.float32)}
    tparams = {k: torch.from_numpy(v) for k, v in params.items()}
    sharded = dataclasses.replace(fl, control_plane="sharded")
    data = (np.zeros((4, 2, 3), np.float32), np.zeros((4, 2), np.int32),
            np.zeros((4, 2, 3), np.float32), np.zeros((4, 2), np.int32))
    server = lambda dev: ParameterServer(logreg.logistic_regression_prod(3, 10),  # noqa: E731
                                         optim.sgd(0.1), fl, device=dev)
    call = {"init_sim_state": lambda dev: simulator.init_sim_state(model, fl, dev),
            "transport_from_config": lambda dev: transport.transport_from_config(fl, dev),
            "scenario_from_config": lambda dev: channel.scenario_from_config(fl, dev),
            "sweep_point_from_config": lambda dev: sweep.sweep_point_from_config(fl, dev),
            "logreg_init": lambda dev: model.init(dev),
            "logreg_params_from_jax": lambda dev: logreg.params_from_jax(params, dev),
            "ParameterServer": lambda dev: server(dev).scenario,
            "server_init_state": lambda dev: server(dev).init_state(),
            "sgd_init": lambda dev: optim.sgd(0.1, momentum=0.9).init(tparams, dev),
            "adamw_init": lambda dev: optim.adamw(0.1).init(tparams, dev),
            "chain_init": lambda dev: optim.chain(optim.clip_by_global_norm(1.0),
                                                  optim.sgd(0.1)).init(tparams, dev),
            "HashDraws": lambda dev: draws.HashDraws(0, dev).round(0).awgn(4),
            "sharded_init_sim_state": lambda dev: simulator.init_sim_state(
                model, sharded, dev),
            "run_simulation_control_sharded": lambda dev:
                sharding.run_simulation_control_sharded(model, sharded, data,
                                                        device=dev)}[entry]
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        call(None)

    def tensors(obj):
        if isinstance(obj, torch.Tensor):
            return [obj]
        if dataclasses.is_dataclass(obj):
            obj = [getattr(obj, f.name) for f in dataclasses.fields(obj)]
        elif isinstance(obj, dict):
            obj = list(obj.values())
        return ([x for v in obj for x in tensors(v)]
                if isinstance(obj, (list, tuple)) else [])

    leaves = tensors(call("cpu"))
    assert leaves and all(x.device.type == "cpu" for x in leaves)


def test_chip_smoke_fails_without_a_card(tmp_path):
    """Without a CUDA card the script exits non-zero and prints no result
    line, both in the checkout and alone in an empty directory. Any card is
    hidden from it, so the test means the same on a machine that has one."""
    alone = tmp_path / "chip_smoke.py"
    alone.write_bytes(CHIP_SMOKE.read_bytes())
    env = {**os.environ, "CUDA_VISIBLE_DEVICES": ""}
    for script in (CHIP_SMOKE, alone):
        out = subprocess.run([sys.executable, str(script)], capture_output=True,
                             text=True, cwd=script.parent, timeout=120, env=env)
        assert out.returncode != 0
        assert '"ok"' not in out.stdout
