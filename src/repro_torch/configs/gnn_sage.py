"""Paper's own GraphSAGE (App. B): 3 layers, hidden 256."""
from repro_torch.models.gnn.models import GNNConfig

CONFIG = GNNConfig(kind="sage", hidden=256, num_layers=3, dropout=0.3)
SMOKE = GNNConfig(kind="sage", hidden=32, num_layers=2, dropout=0.0,
                  in_dim=16, out_dim=5)
