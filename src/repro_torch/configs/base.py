"""FL run configuration: a field-for-field copy of ``repro.configs.base``'s
``FLConfig`` and ``GCAParams`` (the port imports nothing from ``repro``)."""
from __future__ import annotations

from dataclasses import dataclass
from typing import NamedTuple


class GCAParams(NamedTuple):
    """GCA [10] selection knobs (the GCA selection branch is not ported yet)."""

    lambda_E: float = 0.5
    lambda_V: float = 0.5
    rho1: float = 0.5
    rho2: float = 0.5
    sigma_t: float = 1.0
    alpha: float = 1500.0


@dataclass(frozen=True)
class FLConfig:
    """Federated-learning run configuration (paper's Section IV defaults).

    Field meanings are documented on the reference ``repro.configs.base``;
    the port raises ``NotImplementedError`` for settings whose code paths it
    does not carry yet (see ``repro_torch.core.simulator``).
    """

    num_clients: int = 100          # N
    clients_per_round: int = 40     # K
    rounds: int = 500               # T
    batch_size: int = 50
    lr0: float = 0.1                # eta^(0)
    lr_decay: float = 0.998
    ascent_lr: float = 8e-3         # gamma
    energy_C: float = 8.0           # energy-conservation tuning factor C
    local_steps: int = 1
    eval_every: int = 1
    record_lambda_every: int = 1
    # channel / physical layer
    num_subcarriers: int = 64       # N_sc
    flat_fading: bool = True        # paper §IV-A: flat-fading channel block
    channel_floor: float = 0.05     # truncation h >= 0.05
    psi: float = 0.5e-3             # scaling factor psi = 0.5 mW
    tau: float = 1e-3               # symbol period (LTE, 1 ms)
    noise_std: float = 0.0          # AWGN std on the aggregated signal (eq. 10)
    shadowing_std: float = 0.0
    pathloss_db_spread: float = 0.0
    # uplink transport scheme
    transport: str = "analog"       # analog | quantized | digital | sparse
    quant_bits: float = 8.0
    tx_power: float = 0.1
    ofdma_bandwidth: float = 1e5
    rx_noise: float = 1e-2
    sparse_density: float = 0.05
    dl_rx_power: float = 0.0
    # temporal scenario dynamics
    temporal: bool = False
    rho_fading: float = 0.0
    rho_shadow: float = 0.0
    shadow_walk_std: float = 0.0
    p_dropout: float = 0.0
    p_return: float = 1.0
    battery_init: float = float("inf")
    method: str = "ca_afl"          # ca_afl | afl | fedavg | greedy | gca
    gca: GCAParams = GCAParams()
    control_plane: str = "replicated"  # replicated | sharded
    seed: int = 0
