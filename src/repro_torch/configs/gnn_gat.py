"""Paper's own GAT (App. B): 3 layers, hidden 128, 4 heads (ogbn) /
2 layers, hidden 64, 4 heads (Reddit)."""
from repro_torch.models.gnn.models import GNNConfig

CONFIG = GNNConfig(kind="gat", hidden=128, num_layers=3, heads=4, dropout=0.3)
CONFIG_REDDIT = GNNConfig(kind="gat", hidden=64, num_layers=2, heads=4,
                          dropout=0.3)
SMOKE = GNNConfig(kind="gat", hidden=32, num_layers=2, heads=4, dropout=0.0,
                  in_dim=16, out_dim=5)
