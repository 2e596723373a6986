from repro_torch.metrics.metrics import (METRICS, accuracy, auroc, get_metric,
                                         mad, metric_for_task)
