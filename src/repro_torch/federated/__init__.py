from repro_torch.federated.partition import sorted_label_shards
from repro_torch.federated.client import client_weights
from repro_torch.federated.rounds import make_fl_round, per_client_losses, FLRoundMetrics
from repro_torch.federated.server import ParameterServer, ServerState

__all__ = ["sorted_label_shards", "client_weights", "make_fl_round",
           "per_client_losses", "FLRoundMetrics", "ParameterServer",
           "ServerState"]
