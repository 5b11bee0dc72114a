from gnnflow_tpu_torch.utils.early_stop import EarlyStopMonitor
from gnnflow_tpu_torch.utils.metrics import (average_precision_score,
                                             roc_auc_score)

__all__ = ["average_precision_score", "roc_auc_score", "EarlyStopMonitor"]
