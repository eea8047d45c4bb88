"""EMA loss tracker (counterpart of ``ppst_tpu/util/metric_tracker.py``;
reference util/metric_tracker.py: 0.98 smoothing, D_R1 never smoothed)."""

from collections import OrderedDict


class MetricTracker:
    def __init__(self, opt=None):
        self.metrics = {}

    @staticmethod
    def moving_average(old, new, s: float = 0.98):
        return old * s + new * (1 - s)

    def update_metrics(self, metric_dict, smoothe=True):
        for k, v in metric_dict.items():
            if k in self.metrics and smoothe and k != "D_R1":
                self.metrics[k] = self.moving_average(self.metrics[k], v)
            else:
                self.metrics[k] = v

    def current_metrics(self):
        return OrderedDict((k, self.metrics[k]) for k in sorted(self.metrics))
