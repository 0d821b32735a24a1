"""Paper's own GCN (App. B): 3 layers, hidden 256 (ogbn datasets) /
2 layers, hidden 512 (Reddit). LayerNorm + ReLU + dropout.
Used with IBMB node-wise and batch-wise batch construction."""
from repro_torch.models.gnn.models import GNNConfig

# dataset-parametric: in/out dims filled by the caller from the dataset
CONFIG = GNNConfig(kind="gcn", hidden=256, num_layers=3, dropout=0.3)
CONFIG_REDDIT = GNNConfig(kind="gcn", hidden=512, num_layers=2, dropout=0.3)
SMOKE = GNNConfig(kind="gcn", hidden=32, num_layers=2, dropout=0.0,
                  in_dim=16, out_dim=5)
